"""Timing and set-up shared by the port's bench and experiments.

:class:`Timer` is the one timing layer: wall time is the host's clock
around windows of work that each end in a synchronisation; device time
comes from ``torch.profiler``'s device records
(:func:`~homomorph_tpu_torch.utils.profiling.device_busy`) and is ``None``
off the card, where no device time exists.  Bounds use the card's peaks
(:func:`~homomorph_tpu_torch.utils.profiling.chip_peaks`); off the card
they use the H100 SXM's 132 SMs at 1,980 MHz, so a CPU run can still print
the model.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Timer", "peaks", "context", "key_s0", "CHECK_SEED", "leaf_shape",
           "recorded_products", "products_sol"]

#: SM count and maximum SM clock of the H100 SXM, for bounds computed off the card
H100_SMS, H100_MHZ = 132, 1980.0

#: windows a throughput is the median of
WINDOWS = 3

#: ``ThreefrySource`` seed of the keys that check a product by decrypting it.
#: Its secret key has ``S(0) = 1`` at every d (``S(0)`` is bit 0 of the first
#: threefry block, whatever d is).  Inside a circuit's noise envelope such a
#: key decrypts right only if every coefficient of the product is right; a
#: key with ``S(0) = 0`` (the JAX package's bench and experiments use seed 11,
#: which gives one) reads only the constant term.
CHECK_SEED = 1


class Timer:
    """Timed windows on one device, and the spread of each labelled
    metric (p50/p95/min seconds a step) in :attr:`stats`."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.stats: dict = {}

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _record(self, label, ts, steps) -> None:
        if label:
            self.stats[label] = {
                "windows": len(ts),
                "steps_per_window": steps,
                "p50_s_per_step": float(np.median(ts)),
                "p95_s_per_step": float(np.quantile(ts, 0.95)),
                "min_s_per_step": float(np.min(ts)),
            }

    def throughput(self, fn, n_steps, warmup=2, windows=WINDOWS, label=None) -> float:
        """Median seconds a step over ``windows`` windows of ``n_steps``
        back-to-back calls, each window ended by one synchronisation."""
        for _ in range(warmup):
            fn()
        self.sync()
        ts = []
        for _ in range(windows):
            t0 = time.perf_counter()
            outs = [fn() for _ in range(n_steps)]
            self.sync()
            ts.append((time.perf_counter() - t0) / n_steps)
            del outs
        self._record(label, ts, n_steps)
        return float(np.median(ts))

    def latency(self, fn, n_steps, warmup=2, label=None) -> float:
        """Median wall time of a synchronised call (host launch time included)."""
        for _ in range(warmup):
            fn()
        self.sync()
        times = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append(time.perf_counter() - t0)
        self._record(label, times, 1)
        return float(np.median(times))

    def device_s(self, fn, reps=2) -> "tuple[float | None, dict]":
        """(device seconds a call, {record name: us a call}) from the
        profiler over ``reps`` calls after a warm-up; ``(None, {})`` off the
        card.  On the card a trace with no device records raises."""
        if self.dev.type != "cuda":
            return None, {}
        from homomorph_tpu_torch.utils.profiling import device_busy

        return device_busy(fn, reps=reps)

    def device_rate(self, fn, n_items, reps=4) -> "float | None":
        """Items a second of device-busy time, ``None`` off the card."""
        secs, _ = self.device_s(fn, reps)
        return None if secs is None else n_items / secs


def peaks(dev: torch.device) -> dict:
    """The card's peaks, or the H100 SXM's off the card."""
    from homomorph_tpu_torch.utils.profiling import chip_peaks

    if dev.type == "cuda":
        return chip_peaks(dev)
    return chip_peaks(sms=H100_SMS, mhz=H100_MHZ)


def context(params, seed: int, dev):
    """A context with both keys from ``ThreefrySource(seed)``."""
    import homomorph_tpu_torch as ht

    ctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(seed), device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    return ctx


def key_s0(ctx) -> int:
    """``S(0)``, the constant term of the context's secret key: with
    ``S(0) = 0`` a decrypt reads only the product's constant term, so every
    depth decrypts right; inside the noise envelope a key with ``S(0) = 1``
    decrypts right only if the whole product is right."""
    return int(ctx.get_secret_key().limbs[0].item()) & 1


def leaf_shape(B: int, La: int, Lb: int, kmin: "int | None" = None) -> "tuple[int, int, int]":
    """The K1 launch ``(rows, Ls, Lg)`` the Karatsuba route makes for a
    ``[B, La] x [B, Lb]`` product at the threshold ``kmin`` (default: the
    route's, :func:`~homomorph_tpu_torch.gf2.kernels.karatsuba_min`)."""
    from homomorph_tpu_torch.gf2 import kernels as k

    kmin = k.karatsuba_min() if kmin is None else kmin
    Ls, Lg = min(La, Lb), max(La, Lb)
    for kind, _, _, n in k.route_plan(Ls, Lg, kmin):
        B, Ls, Lg = (B * n, Ls, Ls) if kind == "chunk" else (B * 3, n, n)
    return B, Ls, Lg


def recorded_products(fn):
    """``(fn(), shapes)``: the ``(B, La, Lb)`` of every product the clmul
    dispatcher took while ``fn`` ran (each is one K1 launch on the card)."""
    from homomorph_tpu_torch.gf2 import kernels as k

    shapes = []
    rows = k.clmul_rows

    def recording(af, bf):
        shapes.append((af.shape[0], af.shape[1], bf.shape[1]))
        return rows(af, bf)

    k.clmul_rows = recording
    try:
        return fn(), shapes
    finally:
        k.clmul_rows = rows


def products_sol(shapes, pk: dict) -> float:
    """Least seconds of the products ``shapes`` as the card runs them: for
    each, K1's comb work at the Karatsuba route's leaf shape
    (:func:`~homomorph_tpu_torch.gf2.kernels.route_plan` at the route's
    threshold) against the product's bytes, each operand read once and the
    product written once."""
    from homomorph_tpu_torch.utils.profiling import bound, clmul_bytes, clmul_comb_work

    total = 0.0
    for B, La, Lb in shapes:
        smem, ops = clmul_comb_work(*leaf_shape(B, La, Lb))
        total += bound(clmul_bytes(B, La, Lb), [(smem, "smem_bw"), (ops, "int32_ops")], pk)[0]
    return total
