"""Tracing, profiling and speed-of-light accounting on the H100.

Counterpart of :mod:`homomorph_tpu.utils.profiling`, for the port's CUDA
kernels (``chip_smoke.py`` reads its bounds from here):

* :func:`chip_peaks` - the card's peaks: HBM bytes/s and the int8
  tensor-core rate (NVIDIA's H100 SXM data sheet), and the INT32 and
  shared-memory rates per SM per clock scaled by the card's SM count and
  maximum SM clock.
* :func:`clmul_sol` / :func:`encrypt_sol` / :func:`decrypt_sol` - the
  least time the card could take, modelled on the port's designs: K1's
  comb (shared-memory loads of the multiples), K2's table lookups, the
  decrypt parity; :func:`bound` takes any work count (``chip_smoke.py``
  bounds T1 by its INT32 rounds, :data:`THREEFRY_ALU_OPS_PER_WORD`).
  :func:`clmul_ops` keeps the bit-serial count of the first K1 design.
* :func:`device_records` / :func:`device_busy` - device time by record
  name from ``torch.profiler``'s device records.
* :func:`span`, :func:`tracing`, :func:`records` - the program's spans,
  kept in memory while tracing is on; :func:`device_region` - a stage's
  card time between two CUDA events, inside a captured graph too;
  :data:`counters` - its launches by kernel, a graph's replays included.

Nothing here holds a TPU number.  The peaks need a card (or the SM count
and clock given by hand); the device-time functions raise without one.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict, deque

import torch

__all__ = [
    "chip_peaks",
    "max_sm_clock_mhz",
    "bound",
    "clmul_ops",
    "clmul_comb_work",
    "clmul_bytes",
    "square_bytes",
    "encrypt_lookup_bytes",
    "clmul_sol",
    "encrypt_sol",
    "decrypt_sol",
    "device_records",
    "device_ms",
    "device_busy",
    "KERNELS",
    "Counters",
    "counters",
    "Record",
    "PROFILER_RANGES",
    "span",
    "annotate",
    "device_span",
    "device_region",
    "regions",
    "settle",
    "tracing",
    "tracing_on",
    "records",
]

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and dense int8
# tensor-core rate.  The per-SM rates below are scaled by the card's SM
# count and maximum SM clock (chip_peaks).
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_SM_PER_CLOCK = 64  # CUDA C guide, arithmetic throughput, cc 9.0
SMEM_BYTES_PER_SM_PER_CLOCK = 128  # 32 banks of 4 bytes
# K2's table chunk: the redesign's 8 selection bits per lookup
ENC_CHUNK_BITS = 8
# K1's comb: shared-memory loads per (limb of the smaller operand, limb of
# the multiples), 1 for nibble 0 and 2 for each of the other 7; and a funnel
# shift and an XOR per nibble
COMB_LOADS_PER_PAIR = 15
COMB_OPS_PER_PAIR = 8 * 2
# 32-bit operations of one threefry-2x32-20 word (csrc/threefry.cu) that only
# the INT32 pipe executes: 20 rotates (funnel shifts) and 21 XORs.  Its 32
# adds may also issue as IMAD on the FMA pipe, so they set no lower bound of
# their own (all 73 operations at twice the INT32 rate take less time).
THREEFRY_ALU_OPS_PER_WORD = 20 + 21
# M1 (csrc/mask.cu): per output limb the half's shift, the 16-bit mask and
# four shift-or-and steps of the bit spread
SQUARE_OPS_PER_LIMB = 2 + 4 * 3
# decrypt: per limb an AND and an XOR into the fold
DECRYPT_OPS_PER_LIMB = 2


def max_sm_clock_mhz(index: int = 0) -> float:
    """The card's maximum SM clock in MHz, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return float(out.strip().splitlines()[0])


def chip_peaks(device=None, sms: "int | None" = None, mhz: "float | None" = None) -> dict:
    """Peak rates of the H100 as a dict: ``hbm_bw`` (bytes/s),
    ``int8_tc_ops`` (ops/s), ``int32_ops`` (ops/s) and ``smem_bw``
    (bytes/s), with the ``sms`` and ``mhz`` they were scaled by.

    ``sms`` defaults to the card's ``multi_processor_count`` and ``mhz`` to
    its maximum SM clock (``nvidia-smi``); without a card both must be
    given, else this raises."""
    if sms is None or mhz is None:
        if not torch.cuda.is_available():
            raise RuntimeError("chip_peaks reads the card: give sms= and mhz= without one")
        index = torch.device("cuda" if device is None else device).index or 0
        if sms is None:
            sms = torch.cuda.get_device_properties(index).multi_processor_count
        if mhz is None:
            mhz = max_sm_clock_mhz(index)
    clock = sms * mhz * 1e6
    return dict(
        hbm_bw=HBM_BYTES_PER_S,
        int8_tc_ops=INT8_TC_OPS_PER_S,
        int32_ops=INT32_OPS_PER_SM_PER_CLOCK * clock,
        smem_bw=SMEM_BYTES_PER_SM_PER_CLOCK * clock,
        sms=sms,
        mhz=mhz,
    )


# --------------------------------------------------------------------------
# Speed-of-light models
# --------------------------------------------------------------------------


def bound(n_bytes: float, work, peaks: dict) -> "tuple[float, str]":
    """The least seconds for work that moves ``n_bytes`` through HBM and does
    each ``(amount, rate key)`` of ``work`` (``rate key`` names a rate of
    ``peaks``): the larger of the bytes' time and each amount's, and which
    of the two binds (``"bytes"`` or ``"operations"``)."""
    t_bytes = n_bytes / peaks["hbm_bw"]
    t_work = max((amount / peaks[key] for amount, key in work), default=0.0)
    return max(t_work, t_bytes), "operations" if t_work >= t_bytes else "bytes"


def clmul_ops(B: int, La: int, Lb: int) -> int:
    """The bit-serial count of K1's work on [B, La] x [B, Lb] (the first
    design's bound, kept beside the comb's): per row, Ls*(Lg+1) pairs of a
    limb of the smaller operand and an output limb, each 32 mask-and-XOR
    steps, counted at 2 ops a step as the JAX package's ``clmul_sol``
    counts them."""
    Ls, Lg = min(La, Lb), max(La, Lb)
    return B * 32 * Ls * (Lg + 1) * 2


def clmul_comb_work(B: int, La: int, Lb: int) -> "tuple[int, int]":
    """The comb's necessary work on [B, La] x [B, Lb]: per row, Ls*(Lg+1)
    pairs of a limb of the smaller operand and a limb of the 16 multiples
    (Lg+1 limbs each), each read 15 times from shared memory (4 bytes a
    read) and combined by 8 funnel shifts and 8 XORs.  Returns (shared
    memory bytes, INT32 operations)."""
    Ls, Lg = min(La, Lb), max(La, Lb)
    pairs = B * Ls * (Lg + 1)
    return pairs * COMB_LOADS_PER_PAIR * 4, pairs * COMB_OPS_PER_PAIR


def clmul_bytes(B: int, La: int, Lb: int) -> int:
    """K1's HBM bytes: both operands read once, the product written once."""
    return B * (La + Lb) * 4 * 2


def square_bytes(B: int, L: int, Lo: int) -> int:
    """M1's HBM bytes on [B, L] -> [B, Lo]: the input read once, the
    output written once."""
    return B * (L + Lo) * 4


def encrypt_lookup_bytes(B: int, tau: int, limbs: int) -> int:
    """The table encrypt's shared-memory reads: one 4-byte entry per chunk
    of 8 selection bits for every output limb the key reaches."""
    return B * -(-tau // ENC_CHUNK_BITS) * limbs * 4


def _peaks(peaks):
    return chip_peaks() if peaks is None else peaks


def clmul_sol(batch: int, La: int, Lb: int, peaks: "dict | None" = None) -> float:
    """Least seconds for a batched carry-less multiply on K1's comb: its
    shared-memory loads and INT32 operations (:func:`clmul_comb_work`)
    against the operands' and product's bytes."""
    smem, ops = clmul_comb_work(batch, La, Lb)
    return bound(clmul_bytes(batch, La, Lb), [(smem, "smem_bw"), (ops, "int32_ops")],
                 _peaks(peaks))[0]


def encrypt_sol(batch_bits: int, tau: int, n_limbs: int, peaks: "dict | None" = None) -> float:
    """Least seconds to encrypt ``batch_bits`` bits under a key of ``tau``
    rows of ``n_limbs`` limbs by K2's table lookups
    (:func:`encrypt_lookup_bytes`), against the selection words, key,
    plaintext bits and ciphertext limbs moved once."""
    W = -(-tau // 32)
    n_bytes = (batch_bits * W + tau * n_limbs + batch_bits + batch_bits * n_limbs) * 4
    return bound(n_bytes, [(encrypt_lookup_bytes(batch_bits, tau, n_limbs), "smem_bw")],
                 _peaks(peaks))[0]


def decrypt_sol(batch_bits: int, n_limbs: int, peaks: "dict | None" = None) -> float:
    """Least seconds to decrypt: read ``n_limbs`` limbs a bit, AND with the
    mask and XOR-fold them (the parity of the fold is per bit, not per
    limb)."""
    ops = batch_bits * n_limbs * DECRYPT_OPS_PER_LIMB
    return bound(batch_bits * (n_limbs + 1) * 4, [(ops, "int32_ops")], _peaks(peaks))[0]


# --------------------------------------------------------------------------
# Device time (torch.profiler device records)
# --------------------------------------------------------------------------


#: seconds a trace idles after the profiler starts, before the first call:
#: the first kernels launched right after the start can go unrecorded
TRACE_LEAD_S = 0.02
#: traces :func:`device_records` takes of the same calls
TRACES = 3


def device_records(fn, iters: int = 1, traces: int = TRACES) -> "dict[str, float]":
    """Device time in ms by record name (kernels and copies) of ``iters``
    calls of ``fn``, from ``torch.profiler`` tracing the card only, after
    one warm-up call.

    This is the card's own time: it leaves out the host's time to issue a
    call, which for a short kernel is longer than the kernel itself.  A
    trace can come back without some of its device records, so
    ``traces`` traces of ``iters`` calls are taken, each after
    :data:`TRACE_LEAD_S` of idle time.  Every call of ``fn`` launches the
    same kernels: a name's count a call is the most any trace holds,
    rounded up to whole calls, and its time is that count times ``iters``
    times its mean record time.  Raises when no trace holds a device
    record, and without a card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_records needs a CUDA card")
    fn()
    torch.cuda.synchronize()
    times: dict[str, list[float]] = defaultdict(list)
    most: dict[str, int] = defaultdict(int)
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_LEAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        counts: dict[str, int] = defaultdict(int)
        for ev in prof.events():
            # a record_function range's shadow on the device's timeline is
            # no device work
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
                times[ev.name].append(ev.time_range.elapsed_us() / 1e3)
                counts[ev.name] += 1
        for name, c in counts.items():
            most[name] = max(most[name], c)
    if not times:
        raise RuntimeError(f"torch.profiler recorded no device time in {traces} traces")
    return {name: sum(t) / len(t) * -(-most[name] // iters) * iters for name, t in times.items()}


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn`` in ms, averaged over ``iters`` calls."""
    return sum(device_records(fn, iters).values()) / iters


def device_busy(fn, reps: int = 2) -> "tuple[float, dict[str, float]]":
    """Device-busy time of a no-arg callable: ``(seconds per rep,
    {record name: us per rep})`` from :func:`device_records` over ``reps``
    calls after a warm-up.  The busy share of a stage is the first over its
    wall time.  Raises without a card (no CPU number is a device time)."""
    records = device_records(fn, reps)
    total_ms = sum(records.values())
    return total_ms / reps / 1e3, {k: v * 1e3 / reps for k, v in records.items()}




# --------------------------------------------------------------------------
# Counters
# --------------------------------------------------------------------------

#: the kernels' launch counters, by the ids of PERF.md's kernel table;
#: ``T1.dkey`` is T1's entry that reads its key from a device buffer
KERNELS = ("K1", "R1", "R2", "C1", "C2", "C3", "K2", "K3", "X1", "T1", "T1.dkey", "M1", "M2", "M3",
           "D1")


class Counters:
    """The program's counters, by key: each kernel's launches
    (:data:`KERNELS`; a CPU or ``meta`` call launches nothing),
    ``mask.K1`` (the share of K1's launches the decrypt masks' route steps
    make), ``K1.square`` (the share of K1's launches that take its
    square path), ``K1.square.tiled`` (the share of those whose lanes own
    several output columns) and ``clmul.expand`` (the limbs the clmul dispatcher
    writes to copy an operand whose rows are broadcast, on the CPU too).

    A count made eagerly adds at once.  A capture launches nothing: what is
    counted while a graph is captured is set aside (:meth:`aside`) as the
    graph's manifest, and each replay adds the manifest (:meth:`replay`)."""

    def __init__(self):
        self._counts: "dict[str, int]" = defaultdict(int)

    def add(self, key: str, n: int = 1) -> None:
        self._counts[key] += n

    def __getitem__(self, key: str) -> int:
        return self._counts.get(key, 0)

    def replay(self, manifest: "dict[str, int]") -> None:
        """Count one replay of a graph whose capture counted ``manifest``."""
        for key, n in manifest.items():
            self._counts[key] += n

    def snapshot(self) -> "dict[str, int]":
        """Every key's count (the kernels' always, at 0 if never counted)."""
        return {k: self[k] for k in sorted(set(KERNELS) | set(self._counts))}

    @contextlib.contextmanager
    def aside(self):
        """Counts made inside the block are taken off the counters at its
        end, and yielded as a dict filled then (key: count made inside)."""
        before = dict(self._counts)
        made: "dict[str, int]" = {}
        try:
            yield made
        finally:
            for k, v in self._counts.items():
                if v != before.get(k, 0):
                    made[k] = v - before.get(k, 0)
            self._counts = defaultdict(int, before)


#: the process's counters, incremented by the kernel wrappers and the
#: compiled pipelines
counters = Counters()


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------

#: records kept of the latest traced session (the oldest are dropped)
MAX_RECORDS = 65536
#: the spans that are also ``record_function`` ranges under a profiler, so
#: that a breakdown of the trace can name them: a range costs the host tens
#: of microseconds there, which the card idles through, so the other spans
#: stay records in memory
PROFILER_RANGES = frozenset({"compiled.call", "roundtrip.bits_in"})


class Record:
    """One span: ``name``, ``start`` and ``end`` (``time.perf_counter``
    seconds; ``None`` for a span timed on the card), the ``id`` of its
    ``parent`` span (``None`` at the top), the ``request`` id that every
    span of one top-level call shares, and the ``counts`` its site
    attached (a device span's ``device_ms`` among them)."""

    __slots__ = ("id", "name", "start", "end", "parent", "request", "counts")

    def __init__(self, rid, name, parent, request):
        self.id, self.name, self.parent, self.request = rid, name, parent, request
        self.start = self.end = None
        self.counts: "dict[str, float]" = {}

    @property
    def seconds(self) -> "float | None":
        return None if self.start is None or self.end is None else self.end - self.start


class _Tracer:
    # one for the process: the program issues its work from one host thread
    def __init__(self):
        self.blocks = 0  # open tracing() blocks
        self.session = False  # a traced session holds the records
        self.records: "deque[Record]" = deque(maxlen=MAX_RECORDS)
        self.stack: "list[Record]" = []
        self.ids = 0
        self.requests = 0
        self.pending: list = []  # (record, start event, end event)
        # the region lists of the graph captures open now, innermost last
        self.captures: "list[list]" = []

    def begin(self) -> None:
        self.records.clear()
        self.pending.clear()
        self.session = True

    def open(self, name: str) -> Record:
        if not self.session:
            self.begin()
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            self.requests += 1
        rec = Record(self.ids, name, None if parent is None else parent.id,
                     self.requests if parent is None else parent.request)
        self.ids += 1
        self.records.append(rec)
        return rec


_tracer = _Tracer()
_autograd_profiler = torch.autograd.profiler


def _profiler_on() -> bool:
    # torch keeps this flag for fast checks: True while a torch.profiler
    # (or autograd profiler) session records
    return _autograd_profiler._is_profiler_enabled


def tracing_on() -> bool:
    """Tracing is on while a ``torch.profiler`` session records, and inside
    :func:`tracing`."""
    return bool(_tracer.blocks) or _profiler_on()


class _Off:
    """The span of every site while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("record", "range")

    def __init__(self, name: str):
        self.record = _tracer.open(name)
        self.range = None

    def __enter__(self):
        _tracer.stack.append(self.record)
        if self.record.name in PROFILER_RANGES and _profiler_on():
            self.range = _autograd_profiler.record_function(self.record.name)
            self.range.__enter__()
        self.record.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record.end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _tracer.stack.pop()
        return False

    def add(self, key: str, n) -> None:
        """Attach a count to the span's record."""
        self.record.counts[key] = self.record.counts.get(key, 0) + n


def span(name: str):
    """A span around the work of a ``with`` block, the program's own tracing.

    While tracing is on (:func:`tracing_on`) it appends a :class:`Record`;
    ``with span(name) as s: s.add(key, n)`` attaches a count.  Under a
    profiler a span of :data:`PROFILER_RANGES` also opens a
    ``torch.profiler.record_function`` range of ``name``, which lies on the
    clock of the card's records.  The first span of a traced session drops the last session's
    records: :func:`tracing` starts a session, and so does a profiler's
    first span after a span opened while tracing was off (two profiler
    sessions with no span between them are read as one).  While tracing is
    off it returns one shared object that does nothing."""
    if not (_tracer.blocks or _autograd_profiler._is_profiler_enabled):
        _tracer.session = False
        return _OFF
    return _Span(name)


def annotate(key: str, n) -> None:
    """Add ``n`` to the count ``key`` of the innermost open span (none while
    tracing is off)."""
    if _tracer.stack:
        rec = _tracer.stack[-1]
        rec.counts[key] = rec.counts.get(key, 0) + n


def device_span(name: str, start, end) -> None:
    """While tracing is on: a record of ``name``, inside the open span, whose
    ``device_ms`` count is the card's time between two CUDA events
    (``enable_timing``), read once the later has completed, by :func:`settle`
    or :func:`records`.  Events that will be recorded again (in a graph, at
    its next replay) must be settled first."""
    if not (_tracer.blocks or _profiler_on()):
        return
    _tracer.pending.append((_tracer.open(name), start, end))


class _Region:
    """Two timing events around a block, on the current stream: kept by the
    capture that records them (``capture``), or eagerly a :func:`device_span`."""

    __slots__ = ("name", "events", "capture")

    def __init__(self, name: str, capture: "list | None"):
        self.name, self.capture = name, capture
        # external: each record is a node of its own in a captured graph
        self.events = tuple(torch.cuda.Event(enable_timing=True, external=capture is not None)
                            for _ in range(2))

    def __enter__(self):
        self.events[0].record()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.events[1].record()
            if self.capture is None:
                device_span(self.name, *self.events)
            else:
                self.capture.append((self.name, self.events))
        return False


def device_region(name: str, device: torch.device):
    """The card's time of a ``with`` block's work on ``device``, as a record
    of ``name`` with a ``device_ms`` count.

    While a CUDA graph is captured inside :func:`regions` (a compiled
    callable's capture), the graph records two timing events around the
    block and the capture keeps ``(name, events)``: the callable emits a
    :func:`device_span` of them after each replay.  Eagerly on the card
    while tracing is on, the events are recorded and left as a device span
    to settle.  Off the card it is :func:`span` of ``name``.  Otherwise
    (tracing off, or a capture no :func:`regions` keeps) it does nothing."""
    if device.type != "cuda":
        return span(name)
    if torch.cuda.is_current_stream_capturing():
        return _Region(name, _tracer.captures[-1]) if _tracer.captures else _OFF
    return _Region(name, None) if tracing_on() else _OFF


@contextlib.contextmanager
def regions():
    """The :func:`device_region` blocks a graph capture inside this block
    records, yielded as a list of ``(name, (start, end))`` filled then."""
    found: list = []
    _tracer.captures.append(found)
    try:
        yield found
    finally:
        _tracer.captures.pop()


def settle() -> None:
    """Read the device spans whose events are pending (waiting for them)."""
    while _tracer.pending:
        rec, start, end = _tracer.pending.pop(0)
        end.synchronize()
        rec.counts["device_ms"] = start.elapsed_time(end)


@contextlib.contextmanager
def tracing():
    """Tracing on without ``torch.profiler``: spans are kept in memory only
    (no ``record_function`` range), a new session that drops the last
    one's records.  Read them with :func:`records`."""
    if not _tracer.blocks:
        _tracer.begin()
    _tracer.blocks += 1
    try:
        yield
    finally:
        _tracer.blocks -= 1
        if not _tracer.blocks:
            _tracer.session = False


def records() -> "list[Record]":
    """The records of the latest traced session, in the order their spans
    opened (at most :data:`MAX_RECORDS`, the newest).  Reading leaves them
    in place."""
    settle()
    return list(_tracer.records)
