"""The carry-save tree multiplier against the reference's column
accumulation, on the card.

Counterpart of ``experiments/exp_mul.py``.  At the reference's u8 bench
configuration ``Parameters(128, 128, 1, 128)`` with 1,024 pairs, the tree
(:func:`~homomorph_tpu_torch.models.circuits.mul_unsigned`) and, for u8, the
reference circuit (:func:`~homomorph_tpu_torch.models.circuits.
mul_unsigned_ref`) must decrypt to the same products, equal to the
plaintext products; then each is timed as a compiled callable (one CUDA
graph replay a call): wall time and device time.  Both circuits are beyond
their noise envelopes at d = 128, so the key must have ``S(0) = 0``
(``ThreefrySource(2)`` gives one), with which every depth decrypts right.

    python -m homomorph_tpu_torch.experiments.exp_mul [u8|u16|both] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import numpy as np

from homomorph_tpu_torch.experiments.common import Timer, context, key_s0

PARAMS = (128, 128, 1, 128)


def run(width: str = "u8", B: int = 1024, params=PARAMS, seed: int = 2, device=None,
        log=print) -> dict:
    """Tree (and, for u8, the reference circuit) at ``params``: products
    checked against each other and the plaintexts, then timed."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.models import circuits
    from homomorph_tpu_torch.models.compiled import compile_op2

    dev = resolve(device)
    ctx = context(params, seed, dev)
    if key_s0(ctx) != 0:
        raise ValueError(f"ThreefrySource({seed}) gives a key with S(0) = 1: the products "
                         "would decrypt wrong beyond the noise envelope")
    mp = ctx.parameters
    desc = {"u8": ht.U8, "u16": ht.U16}[width]
    mask = (1 << desc.bits) - 1
    rng = np.random.default_rng(3)
    xs = [int(v) for v in rng.integers(0, mask + 1, size=B)]
    ys = [int(v) for v in rng.integers(0, mask + 1, size=B)]
    a = ctx.encrypt(xs, desc, batch=True)
    b = ctx.encrypt(ys, desc, batch=True)
    want = [(x * y) & mask for x, y in zip(xs, ys)]
    log(f"\n== {width} mul, B={B}, {mp}, S(0)=0 key, on {dev} ==")

    circuits_to_run = {"tree": circuits.mul_unsigned}
    if width == "u8":
        circuits_to_run["ref"] = circuits.mul_unsigned_ref
    out = dict(width=width, pairs=B, params=list(params), device=str(dev))
    timer = Timer(dev)
    for name, circuit in circuits_to_run.items():
        op = types.SimpleNamespace(unsafe_apply=circuit, __name__=circuit.__name__)
        fn = compile_op2(op, desc, mp.pk_degree)
        got = [int(v) for v in ctx.decrypt(fn(a, b))]
        if got != want:
            raise RuntimeError(f"the {name} product decrypts wrong on {dev}")
        log(f"{name} product decrypts correctly")
        t = timer.throughput(lambda: fn(a, b), 4, warmup=1, windows=1)
        dv, _ = timer.device_s(lambda: fn(a, b))
        log(f"{name}: wall {t * 1e3:8.3f} ms  {B / t:10,.1f}/s | device "
            f"{'not measured' if dv is None else f'{dv * 1e3:8.3f} ms  {B / dv:10,.1f}/s'}")
        out[name] = dict(wall_s=t, device_s=dv, decrypts=got)
    if "ref" in out and out["tree"]["device_s"] and out["ref"]["device_s"]:
        log(f"tree speedup: {out['ref']['wall_s'] / out['tree']['wall_s']:.2f}x wall, "
            f"{out['ref']['device_s'] / out['tree']['device_s']:.2f}x device-busy")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("width", nargs="?", default="u8", choices=("u8", "u16", "both"))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    widths = ["u8", "u16"] if args.width == "both" else [args.width]
    out = []
    for w in widths:
        r = run(w, device=args.device)
        for name in ("tree", "ref"):
            r.get(name, {}).pop("decrypts", None)
        out.append(r)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
