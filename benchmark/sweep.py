"""A cell's rate against the pairs a request: a short window at each size,
one size after another in one process, each with keys, operands and a
capture of its own.

    python3 -m benchmark.sweep --workload <cell> --pairs 1 2 4 8 --seconds 5 \\
        --seed <n> [--json out.json]

prints one line a size: the pairs, the cell's end-to-end metrics, the peak
memory and the check's verdict.  It finds, once, the batch at which a mix's
rate stops rising; the benchmark's own runs never run it.  Each size holds
a pool of 4 batches, whatever the mix's table.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="a cell's rate against the pairs a request")
    p.add_argument("--workload", required=True)
    p.add_argument("--pairs", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--json")
    args = p.parse_args(argv)

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    base = harness.cell_spec(args.workload)
    rows = []
    for pairs in args.pairs:
        spec = copy.deepcopy(base)
        tr = spec["traffic"]
        tr.pop("table_gib", None)
        tr.update(pairs=pairs, pool=4)
        torch.cuda.reset_peak_memory_stats()
        line = harness.run_cell(spec, args.seed, args.seconds, False, "cuda", time.perf_counter())
        row = dict(pairs=pairs, correct=line["correct"], requests=line["attempted"],
                   peak_bytes=line["device"]["memory_peak_bytes"],
                   **{k: v["value"] for k, v in line["metrics"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(workload=args.workload, device=torch.cuda.get_device_name(),
                           seconds=args.seconds, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
