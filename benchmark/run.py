"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line holds the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
traced window after the measured one.  The last line of standard output is
the result, one JSON object; the last lines of standard error are the
numbers the check compared, each beside its limit.  Without a CUDA card, or
with fewer cards than the cell asks for, the run exits with 3 and prints no
result; so it does where the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.cell_spec(args.workload)
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    line = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    check = line.pop("_check")
    print(json.dumps(line))
    sys.stdout.flush()
    print(f"checked {check['checked']} requests, {check['bits']} bits", file=sys.stderr)
    print(f"wrong_bits {check['wrong_bits']} limit 0", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
