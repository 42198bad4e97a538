"""Reading a trace: device busy time, idle gaps by host span, and a trace
without device records failing instead of reporting a device metric."""

from __future__ import annotations

import pytest

from benchmark import harness, trace
from benchmark.tests import cpu_cells

DEPTH = harness.SPAN_DEPTH


def test_busy_idle_and_gaps_by_span():
    spans = [(0, 100, "request"), (100, 120, "between_requests"), (120, 200, "request"),
             (120, 150, "bits_in"), (150, 190, "wait"), (190, 200, "bits_out")]
    dev = [(10, 60, "k1"), (40, 90, "k2"), (130, 180, "k1"), (300, 400, "outside")]
    s = trace.summarize(dev, spans, DEPTH)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(130e-6)  # 10-90 and 130-180
    assert s["requests"] == 2
    assert s["idle_gaps"] == pytest.approx({"request": 20e-6, "between_requests": 20e-6,
                                            "bits_in": 10e-6, "wait": 10e-6, "bits_out": 10e-6})
    assert s["by_name"]["k1"] == pytest.approx(100e-6) and s["counts"]["k1"] == 2
    b = trace.breakdown(s)
    assert "outside" not in s["by_name"]  # after the traced window
    assert b["device_ops"] == [["k1", pytest.approx(100e-6)], ["k2", pytest.approx(50e-6)]]
    assert len(b["idle_gaps"]) == 5


def test_no_device_record_is_an_error():
    with pytest.raises(trace.NoDeviceRecords):
        trace.summarize([], [(0, 10, "request")], DEPTH)
    with pytest.raises(trace.NoDeviceRecords):
        trace.summarize([(20, 30, "k")], [(0, 10, "request")], DEPTH)


def test_a_traced_window_without_device_records_fails():
    # on the CPU the profiler sees no device: the traced window is taken
    # twice, then the run fails
    import torch

    s = cpu_cells.spec("graph_add")
    run = harness.Run(s, 3, torch.device("cpu"))
    entry = harness.set_up(run)
    with pytest.raises(trace.NoDeviceRecords):
        harness.traced(run, entry, 0)


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::encrypt_table_kernel<4>(unsigned int)") \
        == "void__anonymous_namespace___encrypt_table_kernel_4__unsigned_int"
    assert len(trace.short_name("x" * 100)) == 64
