"""The carry-save tree multiplier stage by stage against its bound, on the card.

Counterpart of ``experiments/exp_mul_roofline.py``:

1. runs each stage as its own call (the partial-product tensor, each
   compressor level: its C1 launch, grouped clmuls and C2 launch, the final
   ripple's chain), threading the live tensors from one stage to the next
   (``models/circuit_kernels.py``: ``tree_start``, ``tree_level``,
   ``tree_ripple``), and checks that the staged product decrypts right;
2. bounds each stage by the summed bound of the products it launched, as
   the card runs them (K1's comb at the Karatsuba route's leaf shape,
   :func:`~homomorph_tpu_torch.experiments.common.products_sol`), and takes
   each stage's device time from the profiler;
3. prints measured against bound for each stage.

    python -m homomorph_tpu_torch.experiments.exp_mul_roofline [u8|u16]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from homomorph_tpu_torch.experiments.common import (
    CHECK_SEED,
    Timer,
    context,
    peaks,
    products_sol,
    recorded_products,
)

#: width -> (d, pairs)
CONFIGS = {"u8": (160, 512), "u16": (1024, 512)}


def run(width: str = "u16", params=None, B: "int | None" = None, seed: int = CHECK_SEED,
        device=None, log=print) -> dict:
    """Stage-by-stage device time against the bound; the staged product
    must decrypt to the plaintext products (the default key has ``S(0) = 1``
    and the parameters are inside the product's noise envelope, so every
    coefficient is checked)."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.models import circuit_kernels, circuits, csaplan

    dev = resolve(device)
    d0, B0 = CONFIGS[width]
    params = tuple(params or (d0, 128, 1, 128))
    B = B or B0
    desc = {"u8": ht.U8, "u16": ht.U16}[width]
    n = desc.bits
    ctx = context(params, seed, dev)
    rng = np.random.default_rng(7)
    mask = (1 << n) - 1
    xs = [int(v) for v in rng.integers(0, mask + 1, size=B)]
    ys = [int(v) for v in rng.integers(0, mask + 1, size=B)]
    a = ctx.encrypt(xs, desc, batch=True)
    b = ctx.encrypt(ys, desc, batch=True)
    plan = csaplan.csa_plan(n)

    def stage_pp():
        return circuit_kernels.tree_start(circuits._pp_bits(circuits._pp_tensor(a, b), n), plan,
                                          a.batch_shape)

    def make_level(k):
        return lambda state: circuit_kernels.tree_level(state, k)

    def stage_ripple(state):
        return circuit_kernels.tree_ripple(state)

    pk = peaks(dev)
    state, shapes = recorded_products(stage_pp)
    states, sol = [state], {"pp": products_sol(shapes, pk)}
    for k in range(len(plan.levels)):
        state, shapes = recorded_products(lambda: make_level(k)(states[-1]))
        states.append(state)
        sol[f"level{k}"] = products_sol(shapes, pk)
    out_lanes, shapes = recorded_products(lambda: stage_ripple(states[-1]))
    sol["ripple"] = products_sol(shapes, pk)
    t = Timer(dev)
    t.sync()
    got = [int(v) for v in ctx.decrypt(out_lanes.ciphered(desc))]
    if got != [(x * y) & mask for x, y in zip(xs, ys)]:
        raise RuntimeError(f"the staged {width} product decrypts wrong on {dev}")
    log(f"\n== {width} mul roofline, B={B}, {ctx.parameters} on {dev}: the staged product "
        "decrypts correctly ==")

    stages = [("pp", stage_pp)]
    stages += [(f"level{k}", (lambda k=k: make_level(k)(states[k])))
               for k in range(len(plan.levels))]
    stages.append(("ripple", lambda: stage_ripple(states[-1])))
    rows = []
    for name, fn in stages:
        dv, _ = t.device_s(fn, reps=1)
        rows.append(dict(stage=name, device_s=dv, bound_s=sol[name],
                         share=(sol[name] / dv if dv else None)))
    tot_m = sum(r["device_s"] or 0.0 for r in rows) if dev.type == "cuda" else None
    tot_s = sum(r["bound_s"] for r in rows)
    log(f"{'stage':>8} {'measured':>12} {'bound':>12} {'share':>7}")
    for r in rows + [dict(stage="TOTAL", device_s=tot_m, bound_s=tot_s,
                          share=(tot_s / tot_m if tot_m else None))]:
        m = "not measured" if r["device_s"] is None else f"{r['device_s'] * 1e3:10.3f}ms"
        share = "" if r["share"] is None else f"{100 * r['share']:6.1f}%"
        log(f"{r['stage']:>8} {m:>12} {r['bound_s'] * 1e3:10.4f}ms {share:>7}")
    return dict(width=width, pairs=B, params=list(params), stages=rows, device_total_s=tot_m,
                bound_total_s=tot_s, device=str(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("width", nargs="?", default="u16", choices=tuple(CONFIGS))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.width, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
