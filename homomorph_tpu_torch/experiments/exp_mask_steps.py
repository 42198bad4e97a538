"""The decrypt mask's step kinds against each other, on the card.

The plan (:func:`homomorph_tpu_torch.gf2.mask_kernel.mask_plan`) runs the
Newton steps whose output has at most ``SMALL_CAP`` limbs in one M3
launch and every wider step as one M2 launch.  This experiment measures
what those two choices rest on, at the degree classes of the paths:

* M3's cap: each class's whole mask (``series_mask`` from ``S*``) at each
  of :data:`CAPS` (M2 after the cap), by warm wall (median of 3), wall a
  call over 5 back-to-back calls (the host's issue included) and device
  time, with M3 alone up to the cap by device time; every cap's mask equal
  to the default plan's;
* M2 against PR 10's route: each step past the cap both ways on the same
  series, M2 (one launch) and M1 with the product by ``S*`` through the
  Karatsuba route (K1), equal limb for limb below ``k``, by device time
  and by wall a call, beside the step's bound (the fewer of M2's comb
  pairs and the route's leaf pairs,
  :func:`~homomorph_tpu_torch.experiments.common.newton_step_work`).

Keys come from ``ThreefrySource(CHECK_SEED)`` at each degree.  Device
times come from ``torch.profiler`` and are ``None`` off the card or where
a trace held no device record.

    python -m homomorph_tpu_torch.experiments.exp_mask_steps [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from homomorph_tpu_torch.experiments.common import CHECK_SEED, Timer, newton_step_work, peaks

#: (degree, limbs): the mask classes of the paths whose series passes M3's
#: widest cap (the u16, u32 and bench u32 products and the u64 product)
CLASSES = ((1024, 8192), (2432, 98304), (5888, 262144), (13440, 3145728))
#: M3's caps swept, in limbs
CAPS = (32, 64, 128, 256, 512, 1024)


def _device_s(t: Timer, fn, reps: int) -> "float | None":
    """Device seconds a call, ``None`` off the card or where the profiler
    recorded nothing."""
    try:
        return t.device_s(fn, reps)[0]
    except RuntimeError:
        return None


def cap_sweep(t: Timer, sstar: torch.Tensor, d: int, n_limbs: int, caps=CAPS, log=print) -> list:
    """The class's whole mask at each cap of ``caps``; see the module's note."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    want = mk.series_mask(sstar, d, n_limbs)
    rows = []
    for cap in caps:
        plan = mk.mask_plan(d, n_limbs, cap)
        n_small = sum(1 for kind, _ in plan if kind == "M3")

        def run(plan=plan):
            return mk.series_mask(sstar, d, n_limbs, plan)

        if not torch.equal(run(), want):
            raise RuntimeError(f"the mask of d = {d}, {n_limbs} limbs at cap {cap} differs "
                               "from the default plan's")
        k_small = plan[n_small - 1][1] if n_small else None
        rows.append(dict(
            cap=cap, m3_steps=n_small, m2_steps=len(plan) - n_small,
            warm_s=t.latency(run, 3, warmup=1), call_s=t.throughput(run, 5, warmup=1, windows=1),
            device_s=_device_s(t, run, 1),
            m3_device_s=None if k_small is None
            else _device_s(t, lambda k=k_small: mk.series_small(sstar, k), 5)))
        r = rows[-1]
        log(f"d = {d}, {n_limbs} limbs, cap {cap}: {r['m3_steps']} M3 + {r['m2_steps']} M2 "
            f"steps; warm {r['warm_s']:.6e} s, call {r['call_s']:.6e} s, device "
            f"{r['device_s']} s; M3 alone {r['m3_device_s']} s")
    return rows


def step_sweep(t: Timer, sstar: torch.Tensor, d: int, n_limbs: int, pk: dict, log=print) -> list:
    """Each step past M3's cap by M2 and by the route; see the module's note."""
    from homomorph_tpu_torch.gf2 import kernels as gf2k
    from homomorph_tpu_torch.gf2 import mask_kernel as mk
    from homomorph_tpu_torch.utils.profiling import bound

    Ls = sstar.shape[0]
    plan = mk.mask_plan(d, n_limbs)
    n_small = sum(1 for kind, _ in plan if kind == "M3")
    inv = mk.series_small(sstar, plan[n_small - 1][1])
    rows = []
    for _, k in plan[n_small:]:
        Li, Lo = inv.shape[0], -(-k // 32)
        cut = sstar[: min(Ls, Lo)].view(1, -1)

        def fused(inv=inv, k=k):
            return mk.newton_step(inv, sstar, k)

        def route(inv=inv, k=k, Lo=Lo, cut=cut):
            return gf2k.clmul(cut, mk.square(inv.view(1, -1), k))[0, :Lo]

        got, want = fused(), route().clone()
        if k % 32:
            want[-1] &= (1 << k % 32) - 1
        if not torch.equal(got, want):
            raise RuntimeError(f"d = {d}, step to {k} bits: M2 and the route differ at "
                               f"{int((got != want).sum())} limbs")
        smem, ops = newton_step_work(Lo, Ls)
        rows.append(dict(
            k=k, Li=Li, Lo=Lo,
            bound_s=bound((Li + Ls + Lo) * 4, [(smem, "smem_bw"), (ops, "int32_ops")], pk)[0],
            m2_device_s=_device_s(t, fused, 3), route_device_s=_device_s(t, route, 3),
            m2_call_s=t.throughput(fused, 5, warmup=1, windows=1),
            route_call_s=t.throughput(route, 5, warmup=1, windows=1)))
        r = rows[-1]
        log(f"d = {d} (S* of {Ls} limbs), step {Li} -> {Lo} limbs: M2 device "
            f"{r['m2_device_s']} s, call {r['m2_call_s']:.6e} s; route device "
            f"{r['route_device_s']} s, call {r['route_call_s']:.6e} s; bound {r['bound_s']:.6e} s")
        inv = got
    return rows


def run(classes=CLASSES, caps=CAPS, device=None, log=print) -> dict:
    """Both sweeps at each ``(degree, limbs)`` of ``classes``; raises where
    two ways to the same mask or step differ."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    dev = resolve(device)
    t, pk = Timer(dev), peaks(dev)
    out = []
    for d, n_limbs in classes:
        sk = ht.SecretKey.random(d, ht.ThreefrySource(CHECK_SEED), device=dev)
        sstar = mk.reversed_key(sk.limbs, d)
        out.append(dict(degree=d, limbs=n_limbs, s_star_limbs=sstar.shape[0],
                        caps=cap_sweep(t, sstar, d, n_limbs, caps, log),
                        steps=step_sweep(t, sstar, d, n_limbs, pk, log)))
        del sk, sstar
    return dict(small_cap=mk.SMALL_CAP, classes=out, device=str(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
