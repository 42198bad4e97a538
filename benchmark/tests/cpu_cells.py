"""Tiny cells for the CPU tests: the harness's entries on ``device="cpu"``,
where the program's kernel wrappers compute their plain versions."""

from __future__ import annotations

import time

from benchmark import harness

TINY = dict(d=128, dp=128, delta=1, tau=128)
CELLS = {
    "graph_add": ("graph", "HomomorphicAddition", "U32", 4),
    "graph_mul": ("graph", "HomomorphicMultiplication", "U8", 2),
    "roundtrip_add": ("roundtrip", "HomomorphicAddition", "U32", 4),
}


def spec(name: str, end_to_end=(), per_layer=()) -> dict:
    entry, op, typ, pairs = CELLS[name]
    return dict(
        cell={"name": name, "chips": 1},
        config={"parameters": dict(TINY), "type": typ},
        traffic={"entry": entry, "op": op, "pairs": pairs, "pool": 3, "keep": 2,
                 "trace_requests": 2, **({"basis": 8} if entry == "graph" else {})},
        end_to_end=[{"name": n, "unit": "u"} for n in end_to_end],
        per_layer=[{"name": n, "unit": "u"} for n in per_layer],
        bench=harness.BENCH,
    )


def run(s: dict, seed: int = 2**31 + 17, seconds: float = 0.15, trace: bool = False) -> dict:
    return harness.run_cell(s, seed, seconds, trace, "cpu", time.perf_counter())
