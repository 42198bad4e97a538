"""The check's control and faults, planted underneath the timed path, and a
driver that reads the program's and the control's numbers over many seeds
in one process.

* :func:`truncated_products` is the control: every product the clmul
  dispatcher returns keeps only the lower 7/8 of its limbs, the degree
  class one step below (the classes are 1/8 of an octave apart).  It breaks
  the configurations' guarantee that ciphertext products are exact in every
  coefficient of their class, the step a change that drops limbs it takes
  for zero would take.
* :func:`fault` plants one of the faults a cell can have in the operation
  itself: ``unchanged`` (the operation returns an operand), ``half_batch``
  (only the first half of the batch is computed, the rest left zero) and
  ``altered`` (one coefficient of one result flipped where it is made).

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --control-seeds 4 5 6 \\
        --seconds 2 [--json out.json]

runs the cell's short window for each seed, then under the control for each
control seed, and prints each run's ``wrong_bits``.  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch


@contextlib.contextmanager
def truncated_products():
    from homomorph_tpu_torch.gf2 import kernels as k

    rows = k.clmul_rows

    def cut(af, bf):
        out = rows(af, bf)
        keep = -(-7 * out.shape[1] // 8)
        out[:, keep:] = 0
        return out

    k.clmul_rows = cut
    try:
        yield
    finally:
        k.clmul_rows = rows


@contextlib.contextmanager
def fault(op, kind: str):
    """Plant ``kind`` in ``op.unsafe_apply`` (an operation class of the
    program's ``models``)."""
    from homomorph_tpu_torch.cipher import Ciphered

    orig = op.__dict__["unsafe_apply"]
    apply = orig.__func__

    def rows(c, lo, hi):
        return Ciphered(c.limbs[lo:hi], c.bound, c.desc, noise=c.noise)

    def unchanged(a, b):
        apply(a, b)
        return a

    def half_batch(a, b):
        h = a.limbs.shape[0] // 2
        part = apply(rows(a, 0, h), rows(b, 0, h))
        rest = part.limbs.new_zeros((a.limbs.shape[0] - h,) + tuple(part.limbs.shape[1:]))
        return Ciphered(torch.cat([part.limbs, rest]), part.bound, part.desc,
                        zero_lanes=part.zero_lanes, noise=part.noise)

    def altered(a, b):
        out = apply(a, b)
        out.limbs[(0,) * (out.limbs.ndim - 1) + (0,)] ^= 1
        return out

    planted = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}[kind]
    setattr(op, "unsafe_apply", staticmethod(planted))
    try:
        yield
    finally:
        setattr(op, "unsafe_apply", orig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the check's readings over many seeds")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--json")
    args = p.parse_args(argv)

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    spec = harness.cell_spec(args.workload)
    rows = []
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            ctx = truncated_products() if kind == "control" else contextlib.nullcontext()
            with ctx:
                line = harness.run_cell(spec, seed, args.seconds, False, "cuda", time.perf_counter())
            chk = line["_check"]
            row = dict(kind=kind, seed=seed, correct=line["correct"], requests=line["attempted"],
                       **chk)
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(workload=args.workload, device=torch.cuda.get_device_name(), rows=rows), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
