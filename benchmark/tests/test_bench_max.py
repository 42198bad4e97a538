"""The u32 max cell (``u32cmp_d128.max_graph``) on the CPU at a tiny size,
the look for a card skipped: its parameters and type at 4 pairs a request.
A sound run is correct; under the control, or with a fault planted
underneath the timed path, it is not.  The op file's maximum on edge
values, and the cell's three readers on planted records."""

from __future__ import annotations

import time
import types

import pytest
import torch

from benchmark import control, harness, program

END_TO_END = ["setup_s", "ops_per_s.graph", "request_p95_ms.graph"]
READERS = ["compare_device_ms.graph", "mux_device_ms.graph", "expand_copy_mb.graph"]


def spec(end_to_end=(), per_layer=()) -> dict:
    return dict(
        cell={"name": "tiny_max", "chips": 1},
        config={"parameters": dict(d=128, dp=128, delta=1, tau=128), "type": "U32"},
        traffic={"entry": "graph", "op": "HomomorphicMaximum", "pairs": 4, "pool": 3, "basis": 8,
                 "keep": 2, "trace_requests": 2},
        end_to_end=[{"name": n, "unit": "u"} for n in end_to_end],
        per_layer=[{"name": n, "unit": "u"} for n in per_layer],
        bench=harness.BENCH,
    )


def run(s: dict, trace: bool = False) -> dict:
    return harness.run_cell(s, 2**31 + 29, 0.15, trace, "cpu", time.perf_counter())


def test_a_sound_run_is_correct():
    line = run(spec(END_TO_END))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"] == {"wrong_bits": {"value": 0, "limit": 0}}
    assert set(line["metrics"]) == set(END_TO_END)


def test_the_control_is_not_correct():
    with control.truncated_products():
        line = run(spec())
    assert not line["correct"] and line["checks"]["wrong_bits"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_a_fault_is_not_correct(kind):
    from homomorph_tpu_torch.models import HomomorphicMaximum

    with control.fault(HomomorphicMaximum, kind):
        line = run(spec())
    assert not line["correct"] and line["failed"] >= 1
    assert HomomorphicMaximum.unsafe_apply.__module__ == "homomorph_tpu_torch.models.numbers"


def test_the_op_file_takes_the_maximum_at_the_edges():
    op = harness.load_module("ops", "HomomorphicMaximum")
    top = 2**32 - 1
    a = torch.tensor([0, top, 0, top, 7, 123456789, 2**31], dtype=torch.int64)
    b = torch.tensor([0, top, top, 0, 7, 123456788, 2**31 - 1], dtype=torch.int64)
    assert op.expected(a, b, 32).tolist() == [0, top, top, top, 7, 123456789, 2**31]


def rec(name, request, **counts):
    return types.SimpleNamespace(name=name, request=request, seconds=None, counts=counts)


#: two requests of the max's graph, and one of another graph with no region
RECORDS = [
    rec("compiled.call", 1, launches=300, expand_limbs=16384 * 32 * 384),
    rec("circuit.select", 1, device_ms=9.5), rec("circuit.lt_tree", 1, device_ms=4.0),
    rec("compiled.call", 2, launches=300, expand_limbs=16384 * 32 * 384),
    rec("circuit.select", 2, device_ms=10.0), rec("circuit.lt_tree", 2, device_ms=4.5),
    rec("circuit.lt_tree", 2),  # a host span of the tree (no device time) is not read
]


@pytest.mark.parametrize("metric,want", [
    ("compare_device_ms.graph", (4.0 + 4.5) / 2),
    ("mux_device_ms.graph", (9.5 + 10.0) / 2),
    ("expand_copy_mb.graph", 16384 * 32 * 384 * 4 / 1e6),
])
def test_each_reader_takes_its_mean_over_the_recorded_requests(monkeypatch, metric, want):
    monkeypatch.setattr(program, "records", lambda: list(RECORDS))
    assert harness.load_module("metrics", metric).read(None) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
def test_no_records_no_value(monkeypatch, metric):
    reader = harness.load_module("metrics", metric)
    monkeypatch.setattr(program, "records", lambda: [])
    assert reader.read(None) is None
    # a graph of the parent, whose calls carry no expand_limbs and hold no region
    monkeypatch.setattr(program, "records", lambda: [rec("compiled.call", 1, launches=63)])
    assert reader.read(None) is None


def test_a_cpu_run_prints_none_of_the_readers():
    from homomorph_tpu_torch.utils import profiling

    with profiling.tracing():
        pass  # an empty session: no other test's records
    line = run(spec(per_layer=READERS), trace=True)
    assert line["correct"] and line["metrics"] == {}
