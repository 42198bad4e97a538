"""Tracing, profiling and speed-of-light accounting on the H100.

Counterpart of :mod:`homomorph_tpu.utils.profiling`, for the port's CUDA
kernels (``chip_smoke.py`` reads its bounds from here):

* :func:`chip_peaks` - the card's peaks: HBM bytes/s and the int8
  tensor-core rate (NVIDIA's H100 SXM data sheet), and the INT32 and
  shared-memory rates per SM per clock scaled by the card's SM count and
  maximum SM clock.
* :func:`trace` - context manager around ``torch.profiler`` that writes a
  Chrome trace.
* :func:`clmul_sol` / :func:`encrypt_sol` / :func:`decrypt_sol` - the
  least time the card could take, modelled on the port's designs: K1's
  comb (shared-memory loads of the multiples), K2's table lookups, the
  decrypt parity; :func:`bound` takes any work count (``chip_smoke.py``
  bounds T1 by its INT32 rounds, :data:`THREEFRY_ALU_OPS_PER_WORD`).
  :func:`clmul_ops` keeps the bit-serial count of the first K1 design.
* :func:`device_records` / :func:`device_busy` - device time by record
  name from ``torch.profiler``'s device records.
* :class:`Meter` - operation counters around the batch APIs.

Nothing here holds a TPU number.  The peaks need a card (or the SM count
and clock given by hand); the device-time functions raise without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch

__all__ = [
    "chip_peaks",
    "max_sm_clock_mhz",
    "trace",
    "bound",
    "clmul_ops",
    "clmul_comb_work",
    "clmul_bytes",
    "encrypt_lookup_bytes",
    "clmul_sol",
    "encrypt_sol",
    "decrypt_sol",
    "device_records",
    "device_ms",
    "device_busy",
    "Meter",
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


@contextlib.contextmanager
def trace(logdir: "str | None" = None):
    """Profile the body with ``torch.profiler`` (the card's activity too,
    where there is one) and write a Chrome trace, ``trace.json``, into
    ``logdir`` (default: a new temporary directory).  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="homomorph_tpu_torch_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
            if ev.device_type == DeviceType.CUDA:
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


@dataclasses.dataclass
class _Stat:
    calls: int = 0
    items: int = 0
    seconds: float = 0.0


class Meter:
    """Operation counters for observability around the batch APIs.

    Usage::

        meter = Meter()
        with meter.measure("encrypt", items=batch_bits):
            ct = ctx.encrypt(...)
        print(meter.report())

    The clock is the host's: around card work, synchronize inside the
    ``with`` block to count the work and not its enqueue.
    """

    def __init__(self):
        self._stats: dict[str, _Stat] = defaultdict(_Stat)

    @contextlib.contextmanager
    def measure(self, name: str, items: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self._stats[name]
            s.calls += 1
            s.items += items
            s.seconds += dt

    def report(self) -> dict[str, dict]:
        out = {}
        for name, s in sorted(self._stats.items()):
            out[name] = {
                "calls": s.calls,
                "items": s.items,
                "seconds": round(s.seconds, 6),
                "items_per_s": round(s.items / s.seconds, 1) if s.seconds else None,
            }
        return out

    def reset(self) -> None:
        self._stats.clear()
