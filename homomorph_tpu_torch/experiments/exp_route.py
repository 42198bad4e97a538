"""The Karatsuba route's split and join (R1, R2) on the card, and the
products around them, for the ``homomorph_tpu_torch`` that Python imports.

    PYTHONPATH=<tree> python homomorph_tpu_torch/experiments/exp_route.py [--json PATH]

``<tree>`` is a checkout's root, or an older tree unpacked beside it, so
that two designs of the kernels run in turns in one call; only entry points
both have are called.  Measured:

* R1 and R2 at :data:`ROUTES`, the busiest (u16) or widest route of each
  product path (:func:`route_kernels`, which ``chip_smoke.py``'s phase 3b
  runs too): each held against its plain version limb for limb
  (mismatches counted, never tolerated), its device time a call
  (``torch.profiler``, :data:`ITERS` calls), its CUDA-event time a call
  back to back, the plain version's device time, its launches a call, and
  the bytes of the function (:func:`function_bytes`) over the card's
  memory rate;
* the checked u16 product (512 pairs at ``Parameters(1024, 128, 1, 128)``)
  and u32 product (8 pairs at ``(2432, 128, 1, 128)``), eager: warm wall
  time and device time by kernel (K1, R1, R2 and the rest); the u32 product
  compiled as a CUDA graph: wall time of a replay (median of 5) and its
  device time by CUDA events;
* the u64 product (``exp_mul64``'s key and pair): warm wall time and device
  time by kernel of one eager call;
* with ``--sweep`` (this tree's design only), R2 at each route under other
  launch plans (:func:`plan_sweep`): the depth it ascends to and the depth
  of its tiles.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: (label, B, Ls, Lg): the u16 product's busiest route, and the widest of
#: the u32 product at d = 2432 and 5888 and of the u64 product, as the
#: dispatcher receives them on those paths (chip_smoke.py phases 5c, 10c
#: and 10e record them)
ROUTES = (("u16-busiest", 512, 1536, 8192), ("u32-widest", 8, 8192, 98304),
          ("d5888-widest", 8, 16384, 262144), ("u64-widest", 1, 131072, 3145728))
ITERS = 20
SEED = 1234


def by_kernel(records: "dict[str, float]") -> "dict[str, float]":
    """Device ms of K1 (``clmul``), R1 (``route_split``), R2 (``route_join``)
    and the rest, from records by name."""
    out = {key: sum(v for name, v in records.items() if sub in name)
           for key, sub in (("K1", "clmul"), ("R1", "route_split"), ("R2", "route_join"))}
    out["other"] = sum(records.values()) - sum(out.values())
    return out


def compare(got: torch.Tensor, want: torch.Tensor) -> "tuple[int, int]":
    """(limbs that differ, the largest difference as unsigned words)."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel()), 2**32 - 1
    if torch.equal(got, want):
        return 0, 0
    diff = ((got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)).abs()
    return int((diff != 0).sum()), int(diff.max())


def event_ms(fn, iters: int = 50) -> float:
    """CUDA-event ms a call over back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> "tuple[float, str]":
    """(device ms a call, what took it): the profiler's device time of
    ``iters`` calls, or, where no trace held device time, CUDA events over
    back-to-back calls (which include the host's issue gaps)."""
    from homomorph_tpu_torch.utils.profiling import device_records

    try:
        return sum(device_records(fn, iters).values()) / iters, "profiler"
    except RuntimeError:
        return event_ms(fn, iters), "events"


def function_bytes(B: int, Ls: int, Lg: int, steps) -> "tuple[int, int]":
    """HBM bytes of R1 (each operand row read once, each leaf row written
    once) and of R2 as a function (each leaf product read once, the product
    written once)."""
    from homomorph_tpu_torch.gf2 import kernels as k

    rows, w = k.leaf_rows(B, steps)
    return 4 * B * (Ls + Lg) + 8 * rows * w, 4 * (rows * 2 * w + B * (Ls + Lg))


def route_kernels(label: str, B: int, Ls: int, Lg: int, hbm_bw: float) -> dict:
    """R1 and R2 at one route: each held against its plain version (the
    level-by-level torch glue, on the card), timed (:func:`device_ms`,
    :func:`event_ms`; the plain version over 3 calls), counted, and bounded
    by :func:`function_bytes`."""
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.utils.profiling import counters

    steps = k.route_plan(Ls, Lg, k.karatsuba_min())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    small, big = (torch.randint(-(2**31), 2**31, (B, L), dtype=torch.int32, device="cuda",
                                generator=gen) for L in (Ls, Lg))
    before = counters["R1"]
    leaf_s, leaf_g = k.route_split(small, big, steps)
    r1_launches = counters["R1"] - before
    want_s, want_g = k._split_levels(small, big, steps)
    (bad_s, err_s), (bad_g, err_g) = compare(leaf_s, want_s), compare(leaf_g, want_g)
    del want_s, want_g
    rows, w = leaf_s.shape
    p = k.clmul_flat(leaf_s, leaf_g)
    del leaf_s, leaf_g
    before = counters["R2"]
    got = k.route_join(p, B, steps)
    r2_launches = counters["R2"] - before
    bad_j, err_j = compare(got, k._join_levels(p, B, steps))
    del got
    out = dict(label=label, B=B, Ls=Ls, Lg=Lg, leaves=[rows, w], steps=[list(s) for s in steps])
    for name, fn, plain, launches, bad, err, nbytes in (
            ("R1", lambda: k.route_split(small, big, steps),
             lambda: k._split_levels(small, big, steps), r1_launches, bad_s + bad_g,
             max(err_s, err_g), function_bytes(B, Ls, Lg, steps)[0]),
            ("R2", lambda: k.route_join(p, B, steps), lambda: k._join_levels(p, B, steps),
             r2_launches, bad_j, err_j, function_bytes(B, Ls, Lg, steps)[1])):
        ms, ms_by = device_ms(fn, ITERS)
        plain_ms, plain_by = device_ms(plain, 3)
        bound = nbytes / hbm_bw * 1e3
        out[name] = dict(ms=ms, ms_by=ms_by, call_ms=event_ms(fn), plain_ms=plain_ms,
                         plain_by=plain_by, launches=launches, mismatches=bad, max_abs_err=err,
                         bytes=nbytes, bound_ms=bound, share=bound / ms)
    del p
    torch.cuda.empty_cache()
    return out


def plan_sweep(label: str, B: int, Ls: int, Lg: int, hbm_bw: float, log=print) -> list:
    """R2's device time a call at one route under the ascents of
    ``join_plans`` near the plan's: tiles of the plan's depth and one level
    less, each ``top`` the tile leaves from the plan's less one to four
    below it, where the ascent fits; each product checked against the
    plan's.  Only for a tree whose ``kernels`` has ``join_plans``."""
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.utils.profiling import device_records

    steps = k.route_plan(Ls, Lg, k.karatsuba_min())
    n, h, lo = k._levels(steps)
    w2, rows0 = 2 * h[-1], B * max(n, 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    small, big = (torch.randint(-(2**31), 2**31, (B, L), dtype=torch.int32, device="cuda",
                                generator=gen) for L in (Ls, Lg))
    p = k.clmul_flat(*k.route_split(small, big, steps))
    del small, big
    plan = k.join_launches(B, steps)
    (top0, tile0, _) = plan[0]
    want = k._route_join(p, B, steps, plan)
    nbytes = 4 * (p.shape[0] * w2 + B * (Ls + Lg))
    rows = []
    for launches in k.join_plans(B, steps):
        top, tile, group = launches[0]
        words = k.ascent_layout(h, lo, top, tile, group)["words"] if tile else 0
        if (tile not in (tile0, max(1, tile0 - 1)) or not top0 - 1 <= top <= top0 + 4
                or group != k.ascent_group(h, rows0, top, tile) or words > k.JOIN_SMEM_WORDS):
            continue
        got = k._route_join(p, B, steps, launches)
        bad = compare(got, want)[0]
        del got
        records = device_records(lambda: k._route_join(p, B, steps, launches), 5)
        ms = sum(records.values()) / 5
        ascent = sum(v for name, v in records.items() if "ascent" in name) / 5
        rows.append(dict(label=label, top=top, tile=tile, group=group, nodes=rows0 * 3 ** top,
                         words=words, ms=ms, ascent_ms=ascent, share=nbytes / hbm_bw * 1e3 / ms,
                         mismatches=bad, plan=launches == plan))
        log(f"[sweep] {label} top {top} tile {tile} ({rows[-1]['nodes']} nodes, "
            f"{words * 4 / 1024:.1f} KB): R2 {ms:.5f} ms, ascent {ascent:.5f} "
            f"({rows[-1]['share']:.1%} of the function's bound), {bad} mismatches"
            + (" <- the plan" if rows[-1]["plan"] else ""))
    del p, want
    torch.cuda.empty_cache()
    return rows


def stage(fn, traces: int = 3) -> dict:
    """Warm wall ms of one call and its device ms by kernel."""
    from homomorph_tpu_torch.utils.profiling import device_records

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    split = by_kernel(device_records(fn, 1, traces))
    return dict(warm_ms=wall, device_ms=sum(split.values()), by_kernel=split)


def products() -> dict:
    """The u16, u32 (eager and compiled) and u64 product stages."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.experiments import exp_mul64
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models import HomomorphicMultiplication as Mul
    from homomorph_tpu_torch.models import circuits
    from homomorph_tpu_torch.models.compiled import compile_op2

    rng = np.random.default_rng(SEED)
    out = {}
    for name, params, n, desc, bits in (("u16", (1024, 128, 1, 128), 512, ht.U16, 16),
                                        ("u32", (2432, 128, 1, 128), 8, ht.U32, 32)):
        ctx = context(params, SEED, torch.device("cuda"))
        a, b = (ctx.encrypt(rng.integers(0, 2**bits, size=n, dtype=np.uint64).tolist(), desc,
                            batch=True) for _ in range(2))
        out[name] = stage(lambda: ctx.apply2(Mul, a, b))
        if name == "u32":
            fn = compile_op2(Mul, desc, a.bound)
            fn(a, b)  # capture
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(a, b)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out["u32_compiled"] = dict(replay_wall_ms=statistics.median(walls),
                                       replay_device_ms=event_ms(lambda: fn(a, b), 1))
        del ctx, a, b
        torch.cuda.empty_cache()
    ctx = context(exp_mul64.PARAMS, CHECK_SEED, torch.device("cuda"))
    _, _, a, b = exp_mul64.operands(ctx)
    out["u64"] = stage(lambda: circuits.mul_unsigned(a, b), traces=1)
    torch.cuda.empty_cache()
    return out


def run(sweep: bool = False, log=print) -> dict:
    import homomorph_tpu_torch
    from homomorph_tpu_torch.gf2 import cuda_build
    from homomorph_tpu_torch.utils.profiling import chip_peaks

    if not torch.cuda.is_available():
        raise RuntimeError("exp_route measures the card: torch.cuda.is_available() is False")
    cuda_build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(homomorph_tpu_torch.__file__)))
    log(f"[route] tree {tree}; {card}")
    hbm_bw = chip_peaks()["hbm_bw"]
    routes = []
    for label, B, Ls, Lg in ROUTES:
        r = route_kernels(label, B, Ls, Lg, hbm_bw)
        routes.append(r)
        for name in ("R1", "R2"):
            m = r[name]
            log(f"[route] {label} {name}: {m['ms']:.5f} ms device ({m['ms_by']}), "
                f"{m['call_ms']:.5f} ms a call, {m['launches']} launches, bound "
                f"{m['bound_ms']:.5f} ms ({m['share']:.1%}), plain {m['plain_ms']:.5f} ms, "
                f"{m['mismatches']} mismatches")
    stages = products()
    for name, s in stages.items():
        log(f"[route] {name}: {json.dumps(s)}")
    sweeps = []
    if sweep:
        for label, B, Ls, Lg in ROUTES:
            sweeps += plan_sweep(label, B, Ls, Lg, hbm_bw, log)
    return dict(tree=tree, card=card, routes=routes, stages=stages, sweep=sweeps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    ap.add_argument("--sweep", action="store_true",
                    help="also time R2 under other launch plans (plan_sweep)")
    args = ap.parse_args(argv)
    out = run(args.sweep)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    bad = (sum(r[name]["mismatches"] for r in out["routes"] for name in ("R1", "R2"))
           + sum(r["mismatches"] for r in out["sweep"]))
    print(json.dumps(dict(tree=out["tree"], mismatches=bad)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
