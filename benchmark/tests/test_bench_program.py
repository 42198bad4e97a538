"""The readers of the per-layer metrics that the program measures itself
(its spans and counters), on fabricated records, on a program that keeps
none, and in a CPU run, where nothing is traced."""

from __future__ import annotations

import types

import pytest

from benchmark import harness, program
from benchmark.tests import cpu_cells

PROGRAM_METRICS = ["launches_per_request.graph", "host_issue_ms.graph", "bits_h2d_ms.roundtrip",
                   "decrypt_device_ms.roundtrip"]


def rec(name, request, seconds=None, **counts):
    return types.SimpleNamespace(name=name, request=request, seconds=seconds, counts=counts)


#: three requests of a graph cell and two of a round trip, with the spans
#: inside them that no reader reads; the first round trip's request has
#: two copies in
RECORDS = [
    rec("compiled.call", 1, 0.0002, launches=424), rec("graph.replay", 1, 0.0001),
    rec("compiled.call", 2, 0.0004, launches=424), rec("graph.clone", 2, 0.00005),
    rec("compiled.call", 3, 0.0003, launches=424),
    rec("compiled.call", 4, 0.030), rec("roundtrip.bits_in", 4, 0.002),
    rec("roundtrip.bits_in", 4, 0.001), rec("roundtrip.decrypt", 4, None, device_ms=6.5),
    rec("compiled.call", 5, 0.026), rec("roundtrip.bits_in", 5, 0.0025),
    rec("roundtrip.decrypt", 5, None, device_ms=6.25),
]


@pytest.mark.parametrize("metric,want", [
    ("launches_per_request.graph", 424.0),
    ("host_issue_ms.graph", (0.2 + 0.4 + 0.3 + 30 + 26) / 5),
    ("bits_h2d_ms.roundtrip", (3.0 + 2.5) / 2),
    ("decrypt_device_ms.roundtrip", (6.5 + 6.25) / 2),
])
def test_each_reader_takes_its_mean_over_the_recorded_requests(monkeypatch, metric, want):
    monkeypatch.setattr(program, "records", lambda: list(RECORDS))
    run = types.SimpleNamespace(requests=1000, trace={"requests": 7})  # neither is read
    assert harness.load_module("metrics", metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_no_records_no_value(monkeypatch, metric):
    from homomorph_tpu_torch.utils import profiling

    reader = harness.load_module("metrics", metric)
    monkeypatch.setattr(program, "records", lambda: [])
    assert reader.read(None) is None
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "records")  # a program that keeps no records
    assert program.records() == [] and reader.read(None) is None


def test_a_cpu_run_prints_none_of_the_program_metrics():
    from homomorph_tpu_torch.utils import profiling

    with profiling.tracing():
        pass  # an empty session: no other test's records
    line = cpu_cells.run(cpu_cells.spec("graph_add", per_layer=PROGRAM_METRICS), trace=True)
    assert line["correct"] and line["metrics"] == {}
    assert profiling.records() == []
