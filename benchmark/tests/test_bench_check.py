"""The whole of a run on the CPU at a tiny size, the look for a card
skipped: sound runs come out correct; under the control, or with a fault
planted underneath the timed path, ``correct`` comes out false."""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark.tests import cpu_cells

END_TO_END = ["setup_s", "ops_per_s.graph", "request_p95_ms.graph"]


@pytest.mark.parametrize("cell", sorted(cpu_cells.CELLS))
def test_a_sound_run_is_correct(cell):
    line = cpu_cells.run(cpu_cells.spec(cell, END_TO_END))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"] == {"wrong_bits": {"value": 0, "limit": 0}}
    assert list(line)[-2] == "checks"  # the compared numbers come last in the printed line
    assert set(line["metrics"]) == set(END_TO_END)
    assert line["metrics"]["ops_per_s.graph"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(cpu_cells.CELLS))
def test_the_control_is_not_correct(cell):
    with control.truncated_products():
        line = cpu_cells.run(cpu_cells.spec(cell))
    assert not line["correct"] and line["checks"]["wrong_bits"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", sorted(cpu_cells.CELLS))
def test_a_fault_is_not_correct(cell, kind):
    from homomorph_tpu_torch import models

    op = getattr(models, cpu_cells.CELLS[cell][1])
    with control.fault(op, kind):
        line = cpu_cells.run(cpu_cells.spec(cell))
    assert not line["correct"] and line["failed"] >= 1
    assert op.unsafe_apply.__module__ == "homomorph_tpu_torch.models.numbers"  # restored


def test_host_span_metrics_read_in_the_window():
    line = cpu_cells.run(cpu_cells.spec("graph_mul", per_layer=["request_p95_ms.graph",
                                                               "device_idle_pct.graph"]), trace=True)
    m = line["metrics"]
    assert m["request_p95_ms.graph"]["value"] > 0
    # no card, no trace: a device metric is left out, never read as 0
    assert "device_idle_pct.graph" not in m and "busy_s" not in line["device"]
    line = cpu_cells.run(cpu_cells.spec("roundtrip_add", per_layer=["host_io_ms.roundtrip",
                                                                   "request_p95_ms.roundtrip"]),
                         trace=True)
    assert line["metrics"]["host_io_ms.roundtrip"]["value"] > 0
    assert line["metrics"]["request_p95_ms.roundtrip"]["value"] > 0
