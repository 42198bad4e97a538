"""Probes of R1 and R2 (``csrc/route.cu``): what holds each below its byte
bound, measured by taking parts of its work out.

    python -m homomorph_tpu_torch.experiments.exp_route_probe [--json PATH]

Each probe is a copy of ``csrc/route.cu`` with a few lines edited
(:data:`PROBES`: each edit must match the source exactly once), built by
``nvcc`` with the kernels' own flags into the build directory, and swapped
in for the route's library around the same wrappers, plans and layouts.  A
probe computes wrong limbs by design: it is timed, never used.  At each
route of ``exp_route.ROUTES`` the script takes the device time a call
(``torch.profiler``, ``exp_route.ITERS`` calls) of the kernel and of each
probe that edits it, with the function's byte bound beside:

* ``r1-one-term``: R1's staging reads one term a limb (the first) where the
  design XORs up to ``2^D`` of them, at ``D > 0`` from L2;
* ``r1-no-loads``: R1's staging loads nothing (it stores zeros): the splits
  in shared memory and the leaves' stores, with the same index arithmetic;
* ``r2-copies-only``: R2's ascent waits for its bulk copies and its block
  barriers but joins and stores nothing;
* ``r2-joins-only``: R2's ascent copies nothing (no bulk copy, no load of
  a tile) and joins what shared memory holds, barriers and stores as the
  kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

#: probe name -> (the kernel it edits, [(text of csrc/route.cu, its replacement)])
PROBES = {
    "r1-one-term": ("R1", [
        ("for (int e = depth0 ? g : 0, end = depth0 ? g + 1 : nterms; e < end; ++e)",
         "for (int e = depth0 ? g : 0, end = depth0 ? g + 1 : min(nterms, 1); e < end; ++e)"),
    ]),
    "r1-no-loads": ("R1", [
        ("stage_nodes<4>(src, staged, ng, len, base, off, lim, nterms, D == 0);",
         "stage_nodes<4>(src, staged, ng, len, base, off, lim, 0, false);"),
        ("stage_nodes<1>(src, staged, ng, len, base, off, lim, nterms, D == 0);",
         "stage_nodes<1>(src, staged, ng, len, base, off, lim, 0, false);"),
    ]),
    "r2-copies-only": ("R2", [
        ("                    join_nodes<4>(c, o, M, h, lo);\n", "                    {}\n"),
        ("                    join_nodes<1>(c, o, M, h, lo);\n", "                    {}\n"),
        ("                    accumulate<4>(c, acc, t, h, lo);\n", "                    {}\n"),
        ("                    accumulate<1>(c, acc, t, h, lo);\n", "                    {}\n"),
        ("st<4>(row + e, ld<4>(acc + e));", "{}"),
        ("for (int e = threadIdx.x; e < lo_top; e += blockDim.x) row[e] = acc[e];",
         "for (int e = threadIdx.x; e < lo_top; e += blockDim.x) {}"),
    ]),
    "r2-joins-only": ("R2", [
        ("    a.bulk = w % 2 == 0 && aligned(in);", "    a.bulk = 0;"),
        ("for (int e = threadIdx.x; e < ng * a.tile_words; e += blockDim.x) slot[e] = src[e];",
         "(void)src;"),
    ]),
}


def probe_source(name: str, source: str) -> str:
    """``csrc/route.cu`` with probe ``name``'s edits; raises where an edit
    does not match the source exactly once."""
    for old, new in PROBES[name][1]:
        if source.count(old) != 1:
            raise ValueError(f"probe {name}: {source.count(old)} matches of {old.strip()!r}")
        source = source.replace(old, new)
    return source


def build_probes(names) -> "dict[str, ctypes.CDLL]":
    """Each probe's library, built by one ``nvcc`` each, all at once."""
    from homomorph_tpu_torch.gf2 import cuda_build
    from homomorph_tpu_torch.utils.cache import build_dir

    source = (cuda_build.CSRC / "route.cu").read_text()
    pending = {}
    for name in names:
        text = probe_source(name, source)
        digest = hashlib.sha256(text.encode()).hexdigest()[:16]
        src = build_dir() / f"route-probe-{name}-{digest}.cu"
        lib = src.with_suffix(".so")
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        pending[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True), lib)
    libs = {}
    for name, (proc, lib) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe {name}: nvcc exit {proc.returncode}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def swapped(lib: "ctypes.CDLL | None"):
    """The route kernels' entries of ``lib`` (None: the kernel's own), as
    ``kernels._route_fns`` holds them."""
    from homomorph_tpu_torch.gf2 import kernels as k

    k._route_fns.clear()
    if lib is None:
        return
    for name, args in k._ROUTE_ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        k._route_fns[name] = fn


def probe_route(label: str, B: int, Ls: int, Lg: int, libs, hbm_bw: float, log=print) -> dict:
    """R1 and R2 at one route: device ms a call of the kernel and of each
    probe that edits it, and the function's byte bound."""
    from homomorph_tpu_torch.experiments.exp_route import ITERS, SEED, device_ms, function_bytes
    from homomorph_tpu_torch.gf2 import kernels as k

    steps = k.route_plan(Ls, Lg, k.karatsuba_min())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    small, big = (torch.randint(-(2**31), 2**31, (B, L), dtype=torch.int32, device="cuda",
                                generator=gen) for L in (Ls, Lg))
    p = k.clmul_flat(*k.route_split(small, big, steps))
    calls = {"R1": lambda: k.route_split(small, big, steps), "R2": lambda: k.route_join(p, B, steps)}
    out = dict(label=label, B=B, Ls=Ls, Lg=Lg, split_plan=list(k.split_plan(B, steps)),
               join_launches=k.join_launches(B, steps))
    for kernel, nbytes in zip(("R1", "R2"), function_bytes(B, Ls, Lg, steps)):
        bound = nbytes / hbm_bw * 1e3
        row = {"bound_ms": bound}
        for name, lib in [(None, None)] + [(n, lib) for n, lib in libs.items()
                                           if PROBES[n][0] == kernel]:
            swapped(lib)
            try:
                ms, by = device_ms(calls[kernel], ITERS)
            finally:
                swapped(None)
            row[name or "kernel"] = dict(ms=ms, ms_by=by, share=bound / ms)
            log(f"[probe] {label} {kernel} {name or 'kernel'}: {ms:.5f} ms ({by}), "
                f"{bound / ms:.1%} of the function's byte bound {bound:.5f} ms")
        out[kernel] = row
    del small, big, p
    torch.cuda.empty_cache()
    return out


def run(log=print) -> dict:
    from homomorph_tpu_torch.experiments.exp_route import ROUTES
    from homomorph_tpu_torch.gf2 import cuda_build
    from homomorph_tpu_torch.utils.profiling import chip_peaks

    if not torch.cuda.is_available():
        raise RuntimeError("exp_route_probe measures the card: torch.cuda.is_available() is False")
    cuda_build.build()
    libs = build_probes(PROBES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[probe] {card}")
    hbm_bw = chip_peaks()["hbm_bw"]
    return dict(card=card, routes=[probe_route(label, B, Ls, Lg, libs, hbm_bw, log)
                                   for label, B, Ls, Lg in ROUTES])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    args = ap.parse_args(argv)
    out = run()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
