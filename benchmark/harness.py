"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry, operation
or metric sits in a file of its own, found by the name that
``BENCHMARK.json`` or the traffic file gives:

* ``configs/<config>.json``: the scheme's parameters and the value type;
* ``traffic/<traffic>.json``: the entry the window drives, the operation,
  the pairs a request, the pool of distinct operands (or the GiB of them
  the card holds) and the basis they are made from, the requests the trace
  holds and the results the check keeps (every mix is a closed loop
  of one client, who sends a request when the last one's result is ready);
* ``entries/<entry>.py``: how a request reaches the program;
* ``ops/<op>.py``: the operation's plaintext result, for the check;
* ``metrics/<metric>.py``: a reader, ``read(run)``, that returns the
  metric's value or ``None`` where it finds nothing to read;
* ``kernels/<family>.json``: the name patterns of a family of kernels.

The program is ``homomorph_tpu_torch``; the reference
(:mod:`benchmark.reference`) imports nothing of it.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import reference, trace as _trace
from .roofline import card_peaks

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: the program's kernel build directory: fixed, inside the checkout, so that
#: only a cell's first run in a checkout builds
BUILD = BENCH / "_build"
#: top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "homomorph_tpu")
#: the benchmark's host spans, and how deep each lies
SPAN_DEPTH = {"request": 1, "between_requests": 1, "bits_in": 2, "wait": 2, "bits_out": 2}
#: seconds the profiler runs before the first traced request: the first
#: kernels after the profiler starts are the ones most often left unrecorded
TRACE_LEAD_S = 0.02


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench: Path = BENCH):
    """``<bench>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_patterns(family: str, bench: Path = BENCH) -> "list[str]":
    return load_json(bench / "kernels" / f"{family}.json")["patterns"]


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json``, its configuration and traffic
    files, and the metrics it reports (end-to-end and per-layer)."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_file = next(c["file"] for c in spec["configs"] if c["name"] == cell["config"])

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        cell=cell,
        config=load_json(root / config_file),
        traffic=load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if listed(m)],
        per_layer=[m for m in spec["per_layer"] if listed(m)],
        bench=root / "benchmark",
    )


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.spec = spec
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.bench = spec.get("bench", BENCH)
        self.seed = seed
        self.dev = device
        self.spans: dict = defaultdict(list)
        self.latencies: "list[float]" = []
        self.requests = 0
        self.pairs_done = 0
        self.window_s: "float | None" = None
        self.setup_s: "float | None" = None
        self.trace: "dict | None" = None
        self.products: "list | None" = None
        self.encrypt_bits = 0
        self.peaks: "dict | None" = None
        self._tracing = False
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span: timed into :attr:`spans` in the measured window, and a
        ``record_function`` range in the traced one."""
        if self._tracing:
            with torch.profiler.record_function(name):
                yield
            return
        t = time.perf_counter()
        yield
        self.spans[name].append(time.perf_counter() - t)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def family_seconds(self, family: str) -> "float | None":
        """Device seconds of the kernels of ``family`` in the traced window."""
        if self.trace is None:
            return None
        pats = [re.compile(p) for p in kernel_patterns(family, self.bench)]
        return sum(s for n, s in self.trace["by_name"].items() if any(p.search(n) for p in pats))


def record_products(ht, op, shape, bound: int, desc) -> "list[tuple[int, int, int]]":
    """``(B, La, Lb)`` of every product the circuit hands the clmul
    dispatcher's entry (``gf2/kernels.py::clmul_rows``) on operands of
    ``shape``: one pass on the ``meta`` device, which does no device work."""
    from homomorph_tpu_torch.gf2 import kernels as k

    shapes = []
    rows = k.clmul_rows

    def recording(af, bf):
        shapes.append((int(af.shape[0]), int(af.shape[1]), int(bf.shape[1])))
        return rows(af, bf)

    meta = [ht.Ciphered(torch.empty(shape, dtype=torch.int32, device="meta"), bound, desc)
            for _ in range(2)]
    k.clmul_rows = recording
    try:
        op.unsafe_apply(*meta)
    finally:
        k.clmul_rows = rows
    return shapes


def set_up(run: Run):
    """Keys from the seed (the reference's), the program's context holding
    them, and the entry with its operands, warmed up."""
    import homomorph_tpu_torch as ht

    stamp(run, "import")
    ht.enable_compilation_cache(str(BUILD))
    d, dp, delta, tau = (run.config["parameters"][k] for k in ("d", "dp", "delta", "tau"))
    run.gen = torch.Generator(device=run.dev)
    run.gen.manual_seed(run.seed)
    run.keys = reference.Keys(d, dp, delta, tau, run.gen, run.dev)
    ctx = ht.Context(ht.Parameters(d, dp, delta, tau), device=run.dev)
    ctx.set_secret_key(ht.SecretKey(run.keys.secret_limbs().cpu().numpy().view(np.uint32),
                                    device=run.dev))
    ctx.set_public_key(ht.PublicKey(run.keys.public_limbs().cpu().numpy().view(np.uint32),
                                    device=run.dev))
    run.ht, run.ctx = ht, ctx
    stamp(run, "keys")
    entry = load_module("entries", run.traffic["entry"], run.bench).Entry(run)
    run.sync()
    stamp(run, "operands")
    entry.request(0)
    run.sync()
    stamp(run, "first request")
    # every shape the window uses, and the allocator's blocks for the
    # results the check keeps: as many results alive at once as the window
    # holds at most
    held = [entry.request(i) for i in range(run.traffic["keep"] + 2)]
    del held
    run.sync()
    stamp(run, "warm-up")
    return entry


def stamp(run, stage: str) -> None:
    """Log the seconds since the process started, at the end of a set-up stage."""
    print(f"set-up: {stage} done at {time.perf_counter() - run.t0:.3f} s", file=sys.stderr)


def measure(run: Run, entry, seconds: float) -> dict:
    """The closed loop: one client sends request after request until
    ``seconds`` have passed.  Returns the results the check keeps, a sample
    drawn from the seed over every request of the window (reservoir
    sampling), by request index."""
    keep = run.traffic["keep"]
    pick = random.Random(run.seed)
    run.spans.clear()  # the set-up's requests are no part of the window
    kept: dict = {}
    pairs = run.traffic["pairs"]
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        with run.span("request"):
            out = entry.request(i)
        t_end = time.perf_counter()
        run.latencies.append(t_end - t)
        with run.span("between_requests"):
            slot = len(kept) if len(kept) < keep else pick.randrange(i + 1)
            if slot < keep:
                kept[slot] = (i, out)
            del out
        i += 1
    run.requests = i
    run.pairs_done = i * pairs
    run.window_s = t_end - t0
    return dict(kept.values())


def traced(run: Run, entry, first: int) -> dict:
    """A traced window of the traffic's ``trace_requests`` requests, read
    after it closes.  A trace with no device record is taken once more, then
    raises :class:`~benchmark.trace.NoDeviceRecords`."""
    from torch.profiler import ProfilerActivity, profile

    n = run.traffic["trace_requests"]
    for attempt in range(2):
        run._tracing = True
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(TRACE_LEAD_S)
                for k in range(n):
                    with run.span("request"):
                        out = entry.request(first + k)
                    with run.span("between_requests"):
                        del out
                run.sync()
        finally:
            run._tracing = False
        dev, spans = _trace.profile_events(prof, SPAN_DEPTH)
        try:
            return _trace.summarize(dev, spans, SPAN_DEPTH)
        except _trace.NoDeviceRecords:
            if attempt:
                raise
            print("the trace held no device record: tracing once more", file=sys.stderr)
        first += n


def check(run: Run, entry, kept: dict) -> dict:
    """Decrypt each kept result by the reference and compare it with the
    operation's plaintext result: the wrong bits, over every bit checked."""
    decrypt = reference.Decryptor(run.keys.s)
    wrong = failed = bits = 0
    for i, out in sorted(kept.items()):
        if entry.output == "ciphertext":
            got = decrypt(out)
        else:
            got = torch.as_tensor(np.asarray(out)).to(run.dev).to(torch.uint8)
        want = entry.expected(i)
        if tuple(got.shape) != tuple(want.shape):
            bad = want.numel()
        else:
            bad = int((got != want).sum())
        wrong += bad
        failed += bad > 0
        bits += want.numel()
    return dict(wrong_bits=wrong, failed=failed, checked=len(kept), bits=bits)


def forbidden_modules() -> "list[str]":
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run; returns the result line's object (without printing it)."""
    dev = torch.device(device)
    run = Run(spec, seed, dev)
    run.t0 = t0
    entry = set_up(run)
    run.setup_s = time.perf_counter() - t0
    kept = measure(run, entry, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if trace:
        if dev.type == "cuda":
            run.peaks = card_peaks(dev.index or 0)
            run.trace = traced(run, entry, run.requests)
        run.products = entry.products()
        run.encrypt_bits = entry.encrypt_bits
    # the program's state goes before the reference runs
    entry.free()
    run.ctx = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result = check(run, entry, kept)
    del kept
    correct = result["wrong_bits"] == 0 and result["checked"] > 0
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = load_module("metrics", m["name"], run.bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": correct,
        "attempted": run.requests,
        "failed": result["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": spec["cell"]["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if run.trace is not None:
        line["device"]["busy_s"] = run.trace["busy_s"]
        line["device"]["window_s"] = run.trace["window_s"]
        line["breakdown"] = _trace.breakdown(run.trace)
    line["checks"] = {"wrong_bits": {"value": result["wrong_bits"], "limit": 0}}
    line["_check"] = result
    return line
