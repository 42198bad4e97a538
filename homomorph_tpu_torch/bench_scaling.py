"""Scaling harness: the same bulk encrypt on grids of 1..N places.

Counterpart of the repo's ``bench_scaling.py``.  At ``Parameters(128, 128,
64, 128)`` it encrypts ``--bits`` bits through
:func:`~homomorph_tpu_torch.parallel.bulk.sharded_encrypt_bits` on data-axis
grids of 1, 2, 4, ... up to ``--devices`` places, checks that every grid
gives the one-place grid's limbs, and prints the throughput of each grid
and its efficiency against linear scaling as one JSON line.

The JAX harness forces a virtual CPU mesh; here the places of a grid lie on
this process's one device, the card or the CPU (the port drives one card
per process; across cards it runs one process per card).  So on one card a
grid divides no work among devices and only adds launches and exchanges:
the efficiency is reported as measured, with the platform, the card count
and the number of places beside it.

    python -m homomorph_tpu_torch.bench_scaling [--devices 8] [--bits 65536]
        [--steps 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["grids", "run", "main"]


def grids(n_max: int) -> "list[int]":
    """The grid sizes the harness runs: 1, 2, 4, ... up to ``n_max``."""
    out, n = [], 1
    while n <= n_max:
        out.append(n)
        n *= 2
    return out


def run(devices: int = 8, bits: int = 1 << 16, steps: int = 8, device=None) -> dict:
    """Time the bulk encrypt on each grid; returns the JSON payload."""
    import homomorph_tpu_torch as ht
    from .device import resolve
    from .gf2 import poly as gf2
    from .parallel import bulk, make_mesh

    dev = resolve(device)
    params = ht.Parameters(128, 128, 64, 128)
    ctx = ht.Context(params, source=ht.ThreefrySource(0), device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    pk = ctx.get_public_key()
    L = gf2.limbs_for(params.pk_degree)
    B = bits

    rng = np.random.default_rng(0)
    plain = torch.from_numpy(rng.integers(0, 2, size=(B, 1)).astype(np.int32)).to(dev)
    sel = torch.from_numpy(rng.integers(0, 2, size=(B, 1, params.tau)).astype(np.int8)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results, first = {}, None
    for n in grids(devices):
        cfg = make_mesh(n, 1, [dev] * n)

        def step():
            return bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, plain, L)

        out = step()
        if first is None:
            first = out
        elif not torch.equal(out, first):
            raise RuntimeError(f"grid of {n} places: limbs differ from the one-place grid's")
        sync()
        t0 = time.perf_counter()
        outs = [step() for _ in range(steps)]
        sync()
        dt = (time.perf_counter() - t0) / steps
        del outs
        results[n] = B / dt
        print(f"{n} places: {B / dt:,.0f} bits/s", file=sys.stderr)

    base = results[1]
    payload = {
        "metric": "scaling_efficiency_bulk_encrypt",
        "throughput_bits_per_s": {str(k): v for k, v in results.items()},
        "efficiency_vs_linear": {str(n): v / (base * n) for n, v in results.items() if n > 1},
        "speedup_vs_single_device": {str(n): v / base for n, v in results.items() if n > 1},
        # the places of the largest grid all lie on this process's one device
        "devices": 1,
        "places": max(results),
        "cards": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "note": (
            "every place of a grid lies on this process's one device: a grid splits the work "
            "among places, not devices, so efficiency_vs_linear measures what the grid costs "
            "on one device, not scaling across devices"
        ),
    }
    if dev.type == "cpu":
        payload["physical_cores"] = os.cpu_count()
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8, help="places of the largest grid")
    ap.add_argument("--bits", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.devices, args.bits, args.steps, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
