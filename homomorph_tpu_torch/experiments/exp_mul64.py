"""The u64 product at the all-keys-sound bound, on the card.

Counterpart of ``experiments/exp_mul64.py``.  The carry-save tree with the
majority-form ripple needs d/delta >= 13,373 for u64 (``models/noise.py``);
at ``Parameters(13440, 128, 1, 128)`` and one pair the product's degree
bound is about 90.3M (2,821,493 limbs), held in the degree class of
3,145,728 limbs a lane, 0.81 GB for its 64 lanes.  The decrypt mask of
that class is 100.7M rows of the native host engine's recurrence; the
decrypt itself is the usual masked parity on the card.

The tree runs eagerly (op by op), as the JAX experiment runs it.  The
experiment records keygen time, the tree's first and warm wall time, its
device time as one CUDA graph replay, its K1 launches, peak device memory,
the mask's host time and the decrypt, and that the product decrypts to
``x * y mod 2^64``.  It refuses parameters below the bound.  The key comes
from :data:`~homomorph_tpu_torch.experiments.common.CHECK_SEED` (``S(0) =
1``), so the decrypt reads every coefficient of the product; the JAX
experiment's seed 11 gives ``S(0) = 0``, with which it reads only the
constant term.

    python -m homomorph_tpu_torch.experiments.exp_mul64 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from homomorph_tpu_torch.experiments.common import CHECK_SEED, Timer, context, key_s0

#: d >= the exact tree bound 13,373, a multiple of 128
PARAMS = (13440, 128, 1, 128)


def operands(ctx):
    """One random u64 pair and its ciphertexts: ``(x, y, a, b)``."""
    import homomorph_tpu_torch as ht

    rng = np.random.default_rng(7)
    x = int(rng.integers(0, 1 << 64, dtype=np.uint64))
    y = int(rng.integers(0, 1 << 64, dtype=np.uint64))
    return x, y, ctx.encrypt(x, ht.U64), ctx.encrypt(y, ht.U64)


def graph_device_s(a, b) -> float:
    """Device seconds of one replay of the tree captured as a CUDA graph,
    from CUDA events around the replay: the eager tree's kernels with no
    host gaps between them, timed without a profiler trace of the tens of
    thousands of records two eager calls would make."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicMultiplication
    from homomorph_tpu_torch.models.compiled import compile_op2

    fn = compile_op2(HomomorphicMultiplication, ht.U64, a.bound)
    fn(a, b)  # capture
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn(a, b)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def run(params=PARAMS, seed: int = CHECK_SEED, device=None, log=print) -> dict:
    """The u64 product of one random pair (:func:`operands`), refused below
    the checked bound; raises if it decrypts wrong.  Returns the
    measurements and the key's ``S(0)``."""
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.gf2 import kernels as gf2k
    from homomorph_tpu_torch.models import HomomorphicMultiplication, circuits

    dev = resolve(device)
    t = Timer(dev)
    t0 = time.perf_counter()
    ctx = context(params, seed, dev)
    t.sync()
    keygen = time.perf_counter() - t0
    mp, s0 = ctx.parameters, key_s0(ctx)
    log(f"keygen ({mp}) on {dev}: {keygen:.3f} s; key S(0) = {s0}")

    x, y, a, b = operands(ctx)
    want = (x * y) & 0xFFFFFFFFFFFFFFFF
    req = HomomorphicMultiplication.requirement_for(a, b)
    if mp.d // mp.delta < req:
        raise ValueError(f"d/delta = {mp.d // mp.delta} is below the u64 bound {req}")
    log(f"checked gate: requirement {req}, d/delta {mp.d // mp.delta}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k1 = gf2k.clmul_flat.launches
    t.sync()
    t0 = time.perf_counter()
    prod = circuits.mul_unsigned(a, b)
    t.sync()
    t_tree = time.perf_counter() - t0
    k1 = gf2k.clmul_flat.launches - k1
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    shape = tuple(prod.limbs.shape)
    gb = prod.limbs.numel() * 4 / 1e9
    log(f"tree: {t_tree:.3f} s, {k1} K1 launches, product {shape} ({gb:.3f} GB), "
        f"peak device memory {peak} GB")

    t0 = time.perf_counter()
    ctx.get_secret_key().decrypt_mask(shape[-1])
    t_mask = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = int(ctx.decrypt(prod))
    t_dec = time.perf_counter() - t0
    if got != want:
        raise RuntimeError(f"the u64 product decrypts wrong: {got:#x} != {want:#x}")
    log(f"u64 product decrypts correctly on {dev}: mask {t_mask:.3f} s on the host "
        f"({shape[-1] * 32} rows), decrypt {t_dec:.3f} s; {x:#x} * {y:#x} = {got:#x}")
    del prod

    t.sync()
    t0 = time.perf_counter()
    circuits.mul_unsigned(a, b)
    t.sync()
    warm = time.perf_counter() - t0
    dv = graph_device_s(a, b) if dev.type == "cuda" else None
    log(f"tree warm: wall {warm:.3f} s; as one CUDA graph: device "
        f"{'not measured' if dv is None else f'{dv:.3f} s'}")
    return dict(params=[mp.d, mp.dp, mp.delta, mp.tau], requirement=req, s0=s0, keygen_s=keygen,
                tree_first_s=t_tree, tree_warm_s=warm, tree_device_s=dv, k1_launches=k1,
                peak_gb=peak, product_shape=list(shape), product_gb=gb, mask_host_s=t_mask,
                decrypt_s=t_dec, correct=True, device=str(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
