"""u16 and u32 products at the all-keys-sound parameters, on the card.

Counterpart of ``experiments/exp_mul32.py``.  The carry-save tree with the
majority-form ripple needs d/delta >= 417 for u16 and 2,385 for u32 (exact
bounds, ``models/noise.py``); the experiment runs the checked bound at
``Parameters(1024, 128, 1, 128)`` with 512 u16 pairs and ``(2432, 128, 1,
128)`` with 8 u32 pairs, decrypts the product and compares it with the
plaintext product, then times the tree: wall time over back-to-back calls
and device time from the profiler.  It refuses parameters below the bound.
The key comes from :data:`~homomorph_tpu_torch.experiments.common.
CHECK_SEED` (``S(0) = 1``), so the decrypt reads every coefficient of the
product; the JAX experiment's seed 11 gives ``S(0) = 0``, with which it
reads only the constant term.

The step is a compiled callable (one CUDA graph replay a call,
:func:`~homomorph_tpu_torch.models.compiled.compile_op2`), the counterpart
of the JAX experiment's ``jax.jit``; ``--eager`` runs the circuit op by op,
the counterpart of ``EXP_MUL_EAGER=1``.

    python -m homomorph_tpu_torch.experiments.exp_mul32 [u16|u32|both] [--eager]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from homomorph_tpu_torch.experiments.common import CHECK_SEED, Timer, context, key_s0

#: width -> (d, pairs): d just above the exact tree bound at delta = 1; u16
#: stays at d = 1024, the bench's configuration
CONFIGS = {"u16": (1024, 512), "u32": (2432, 8)}


def operands(width: str, params=None, B: "int | None" = None, seed: int = CHECK_SEED,
             device=None):
    """The context and the operands of one width's product: ``(ctx, a, b,
    xs, ys)``; ``params`` default to ``(d, 128, 1, 128)`` and ``B`` to the
    pairs of :data:`CONFIGS`."""
    import homomorph_tpu_torch as ht

    d0, B0 = CONFIGS[width]
    ctx = context(tuple(params or (d0, 128, 1, 128)), seed, device)
    desc = {"u16": ht.U16, "u32": ht.U32}[width]
    rng = np.random.default_rng(7)
    xs = [int(v) for v in rng.integers(0, 1 << desc.bits, size=B or B0)]
    ys = [int(v) for v in rng.integers(0, 1 << desc.bits, size=B or B0)]
    return ctx, ctx.encrypt(xs, desc, batch=True), ctx.encrypt(ys, desc, batch=True), xs, ys


def product_step(a, b, eager: bool = False):
    """``step() -> Ciphered``: the tree's product of ``a`` and ``b``, as a
    compiled callable or, with ``eager``, op by op."""
    from homomorph_tpu_torch.models import HomomorphicMultiplication, circuits
    from homomorph_tpu_torch.models.compiled import compile_op2

    if eager:
        return lambda: circuits.mul_unsigned(a, b)
    fn = compile_op2(HomomorphicMultiplication, a.desc, a.bound)
    return lambda: fn(a, b)


def run(width: str, params=None, B: "int | None" = None, seed: int = CHECK_SEED, device=None,
        eager: bool = False, log=print) -> dict:
    """One width's product (:func:`operands`), refused below the product's
    checked bound; raises if it decrypts wrong, then times four
    back-to-back calls.  Returns the measurements (device time ``None``
    off the card) and the key's ``S(0)``."""
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.models import HomomorphicMultiplication

    dev = resolve(device)
    ctx, a, b, xs, ys = operands(width, params, B, seed, dev)
    mp, B, s0 = ctx.parameters, len(xs), key_s0(ctx)
    mask = (1 << a.desc.bits) - 1
    req = HomomorphicMultiplication.requirement_for(a, b)
    if mp.d // mp.delta < req:
        raise ValueError(f"d/delta = {mp.d // mp.delta} is below the {width} bound {req}")
    log(f"\n== {width} mul, B={B}, {mp} on {dev}: requirement {req}, key S(0) = {s0}, "
        f"{'eager' if eager else 'compiled'} ==")

    step = product_step(a, b, eager)
    t = Timer(dev)
    t.sync()
    t0 = time.perf_counter()
    prod = step()
    t.sync()
    first = time.perf_counter() - t0
    got = [int(v) for v in ctx.decrypt(prod)]
    if got != [(x * y) & mask for x, y in zip(xs, ys)]:
        raise RuntimeError(f"the {width} product decrypts wrong on {dev}")
    shape = tuple(prod.limbs.shape)
    log(f"product decrypts correctly (first call {first:.3f} s; result {shape})")
    del prod
    wall = t.throughput(step, 4, warmup=1, windows=1)
    dv, _ = t.device_s(step)
    log(f"tree: wall {wall * 1e3:9.3f} ms  {B / wall:9,.1f}/s | device "
        f"{'not measured' if dv is None else f'{dv * 1e3:9.3f} ms  {B / dv:9,.1f}/s'}")
    return dict(width=width, params=[mp.d, mp.dp, mp.delta, mp.tau], pairs=B, requirement=req,
                s0=s0, eager=eager, first_call_s=first, wall_s=wall, device_s=dv,
                product_shape=list(shape), correct=True, device=str(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("width", nargs="?", default="both", choices=("u16", "u32", "both"))
    ap.add_argument("--eager", action="store_true", help="op by op instead of a CUDA graph")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    widths = ["u16", "u32"] if args.width == "both" else [args.width]
    out = [run(w, device=args.device, eager=args.eager) for w in widths]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
