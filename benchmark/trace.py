"""The device trace of a run's traced window, read after the window.

``torch.profiler`` records the card's kernels and copies and the
benchmark's own host spans (``record_function``) on one clock.  From them:
the seconds in which some device operation ran (the union of their
intervals, inside the traced window), the device time and count of each
operation by name, and the device's idle gaps, each put down to the
innermost host span that was open while the card idled.
"""

from __future__ import annotations

import re
from collections import defaultdict


class NoDeviceRecords(RuntimeError):
    """The trace holds no device record: no device metric can be read."""


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's name, cut to 64 characters of ``[A-Za-z0-9_.-]``."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def summarize(device_events, span_events, span_depth: dict) -> dict:
    """``device_events``: (start_us, end_us, name) of kernels and copies;
    ``span_events``: (start_us, end_us, name) of the host spans; a span of a
    greater ``span_depth`` lies inside one of a lesser.  The traced window
    runs from the first ``request`` span's start to the last one's end."""
    requests = [(s, e) for s, e, n in span_events if n == "request"]
    if not requests:
        raise RuntimeError("the traced window holds no request span")
    w0, w1 = min(s for s, _ in requests), max(e for _, e in requests)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device_events if e > w0 and s < w1]
    if not inside:
        raise NoDeviceRecords("the trace holds no device record inside the traced window")
    by_name: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for s, e, n in device_events:
        if e <= w0 or s >= w1:
            continue
        by_name[n] += (e - s) / 1e6
        counts[n] += 1
    busy = _union([(s, e) for s, e, _ in inside])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    idle: dict = defaultdict(float)
    spans = sorted(span_events, key=lambda x: -span_depth.get(x[2], 0))
    for g0, g1 in gaps:
        # split the gap at every span edge, then name each piece after the
        # deepest span that covers it
        cuts = sorted({g0, g1} | {x for s, e, _ in span_events for x in (s, e) if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            name = next((n for s, e, n in spans if s <= mid < e), "outside_spans")
            idle[name] += (b - a) / 1e6
    return dict(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy_s,
        requests=len(requests),
        by_name=dict(by_name),
        counts=dict(counts),
        idle_gaps=dict(idle),
    )


def profile_events(prof, span_names) -> "tuple[list, list]":
    """(device events, host span events) of a finished ``torch.profiler``
    session, as (start_us, end_us, name)."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if ev.name in span_names or getattr(ev, "is_user_annotation", False):
                continue  # a host span's shadow on the device's timeline
            dev.append((tr.start, tr.end, ev.name))
        elif ev.name in span_names:
            spans.append((tr.start, tr.end, ev.name))
    return dev, spans


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short_name(n), s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
