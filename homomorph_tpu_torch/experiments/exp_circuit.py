"""C1, C2 and C3 at the programs the paths give them, against their plain versions.

    python -m homomorph_tpu_torch.experiments.exp_circuit [--device cuda|cpu]

1. records every program the three wrappers of ``models/circuit_kernels.py``
   take while an operation runs on the meta device at a path's shapes
   (:func:`recorded_programs`: the u16, u32, d = 5888 and u64 products of
   the paths, and the u32 add);
2. picks each kernel's busiest program (the most bytes) of a path, and the
   u32 product's widest (:func:`picks`);
3. runs each on random limbs through its wrapper and through its plain
   version on copies of the same inputs, and compares every tensor limb for
   limb (:func:`kernel_case`), with the program's bytes (each source read
   once, each destination written once) and its device time (``None`` off
   the card).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from homomorph_tpu_torch.models import circuit_kernels as ck

#: each wrapper's kernel
SPECS = {"csa_level_in": ck.CSA_IN, "csa_level_out": ck.CSA_OUT, "ripple_step": ck.RIPPLE}

#: path -> (operation, d, bits, rows): the products of chip_smoke.py's phase
#: 5c (u16, u32), the bench's u32 product (10e) and the u64 product (10c),
#: and phase 5's add
PATHS = {
    "u16": ("mul", 1024, 16, 512),
    "u32": ("mul", 2432, 32, 8),
    "d5888": ("mul", 5888, 32, 8),
    "u64": ("mul", 13440, 64, 1),
    "add": ("add", 128, 32, 2048),
}


def recorded_programs(path: str) -> "list[dict]":
    """Every program of the path's operation on the meta device that has
    an op, in order: ``kernel`` (the wrapper's name), ``prog``, ``extents`` (limbs
    of each slot's tensor), ``rows``."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.models import circuits

    op, d, bits, rows = PATHS[path]
    desc = {16: ht.U16, 32: ht.U32, 64: ht.U64}[bits]
    bound = d + 128
    shape = (rows, bits, gf2.limbs_for(bound))
    a = ht.Ciphered(torch.empty(shape, dtype=gf2.LIMB_DTYPE, device="meta"), bound, desc)
    out, run = [], ck._run
    wrappers = {spec: name for name, spec in SPECS.items()}

    def recording(spec, prog, tensors, rows):
        arr = prog.prog if isinstance(prog, ck._Prepared) else prog  # a plan's are prepared
        if arr.shape[0]:  # a level with no carry gives C2 no op
            out.append(dict(kernel=wrappers[spec], prog=arr.copy(),
                            extents=[ck._extent(t) for t in tensors], rows=rows))
        return run(spec, prog, tensors, rows)

    ck._run = recording
    try:
        (circuits.mul_unsigned if op == "mul" else circuits.add)(a, a)
    finally:
        ck._run = run
    # C1's roles: a product's levels, then the ripple's first launch and its
    # stack of the lanes; the add's one launch
    c1 = [r for r in out if r["kernel"] == "csa_level_in"]
    roles = ["level"] * (len(c1) - 2) + ["ripple", "stack"] if op == "mul" else ["add"]
    for r, role in zip(c1, roles):
        r["role"] = role
    return out


def program_bytes(kernel: str, prog, rows: int) -> int:
    """Bytes the program moves: each source read once, each destination
    written once."""
    src, dst = ck._split(SPECS[kernel], prog)
    return 4 * rows * int(src[..., 3].sum() + dst[..., 3].sum())


def described(rec: dict) -> dict:
    """A recorded program with its ``bytes``, its ``launches`` (the wrapper
    splits a program of more ops than a launch takes) and its widest
    destination (``width``)."""
    spec = SPECS[rec["kernel"]]
    return dict(rec, bytes=program_bytes(rec["kernel"], rec["prog"], rec["rows"]),
                launches=len(ck.launch_chunks(rec["prog"].shape[0], spec.ops)),
                width=int(ck._split(spec, rec["prog"])[1][..., 3].max()))


def picks(path: str, widest: bool = False) -> "dict[str, dict]":
    """The path's program of C1 at a carry-save level (``C1``; the add's one
    launch), C2 and C3 with the most bytes (``widest``: the widest
    destination first), and C1's stack of the ripple's lanes (``C1 stack``),
    each :func:`described`."""
    names = {"csa_level_in": "C1", "csa_level_out": "C2", "ripple_step": "C3"}
    out = {}
    for rec in map(described, recorded_programs(path)):
        name = names[rec["kernel"]] + (" stack" if rec.get("role") == "stack" else "")
        if rec.get("role") == "ripple":
            continue
        key = (rec["width"], rec["bytes"]) if widest else (rec["bytes"],)
        if name not in out or key > out[name]["key"]:
            out[name] = dict(rec, key=key)
    return out


def slot_tensors(extents, device, seed: int) -> "list[torch.Tensor]":
    """Random int32 limbs, one flat tensor of each slot's extent."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(-(2**31), 2**31, (max(e, 1),), dtype=torch.int32, device=device,
                          generator=gen) for e in extents]


def kernel_case(rec: dict, device, seed: int = 0):
    """The program of ``rec`` on random slots through its wrapper and, on
    copies of the same slots, through its plain version: (mismatched limbs,
    largest difference as unsigned words, the wrapper's call, the plain
    version's call), each call a closure that runs it again."""
    spec = SPECS[rec["kernel"]]
    wrapper = getattr(ck, rec["kernel"])
    got = slot_tensors(rec["extents"], device, seed)
    want = [t.clone() for t in got]
    prog = ck._prepare(spec, rec["prog"], rec["rows"])  # once, as a plan's programs are

    def kernel():
        wrapper(prog, got, rec["rows"])

    def plain():
        ck.xor_rows_plain(spec, rec["prog"], want, rec["rows"])

    kernel()
    plain()
    if got[0].is_cuda:
        torch.cuda.synchronize(got[0].device)
    bad, err = 0, 0
    for g, w in zip(got, want):
        diff = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF)
        bad += int((diff != 0).sum())
        err = max(err, int(diff.abs().max()))
    return bad, err, kernel, plain


def run(device=None, log=print) -> dict:
    """Each path's busiest program of each kernel (the u32 product's widest
    too) against its plain version, with bytes and device time."""
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.experiments.common import Timer

    dev = resolve(device)
    t = Timer(dev)
    rows = []
    for path in ("u16", "u32", "u64", "add"):
        for widest in ((False, True) if path == "u32" else (False,)):
            for name, rec in picks(path, widest).items():
                bad, err, kernel, _ = kernel_case(rec, dev)
                secs, _ = t.device_s(kernel, reps=5)
                rows.append(dict(path=path, pick="widest" if widest else "busiest", kernel=name,
                                 ops=int(rec["prog"].shape[0]), rows=rec["rows"],
                                 launches=rec["launches"], bytes=rec["bytes"],
                                 mismatches=bad, max_abs_err=err,
                                 device_ms=None if secs is None else secs * 1e3))
                log(json.dumps(rows[-1]))
    return dict(device=str(dev), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    out = run(args.device, log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(out))
    return 0 if all(r["mismatches"] == 0 for r in out["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
