"""What the metric readers under ``metrics/`` share.  Each reader is
``read(run) -> float | None``: ``None`` where the run holds nothing to read,
so the metric is left out of the line."""

from __future__ import annotations

import numpy as np

from . import roofline


def ops_per_s(run):
    """Pairs of every request in the window, over the whole window."""
    return run.pairs_done / run.window_s if run.window_s else None


def p95_ms(run):
    """95th percentile of every request's latency in the window."""
    return float(np.percentile(run.latencies, 95)) * 1e3 if run.latencies else None


def mean_span_ms(run, *names):
    """Mean over the window's requests of the named spans' summed time."""
    if not run.requests or not all(run.spans.get(n) for n in names):
        return None
    return sum(sum(run.spans[n]) for n in names) / run.requests * 1e3


def idle_pct(run):
    """Share of the traced window in which no kernel or copy ran."""
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None


def clmul_roofline_pct(run):
    """The least time of a request's products (:func:`roofline.clmul_bound_s`
    on the shapes the circuit hands the dispatcher) over the device time of
    the clmul family, a request of the traced window."""
    if not run.trace or not run.products:
        return None
    spent = run.family_seconds("clmul")
    if not spent:
        return None
    bound = sum(roofline.clmul_bound_s(B, La, Lb, run.peaks) for B, La, Lb in run.products)
    return 100.0 * bound * run.trace["requests"] / spent


def encrypt_roofline_pct(run):
    """The bytes of a request's encrypts (:func:`roofline.encrypt_bytes`)
    over HBM's rate, over the device time of the encrypt family."""
    if not run.trace or not run.encrypt_bits:
        return None
    spent = run.family_seconds("encrypt")
    if not spent:
        return None
    p = run.config["parameters"]
    n_limbs = (p["d"] + p["dp"]) // 32 + 1
    need = roofline.encrypt_bytes(run.encrypt_bits, p["tau"], n_limbs) / run.peaks["hbm_bw"]
    return 100.0 * need * run.trace["requests"] / spent
