#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, in order; any failure exits non-zero before the result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``homomorph_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. each kernel against its plain torch version on the card, at the shapes
   the paths give it (0 mismatches required), timed by its device time
   from ``torch.profiler`` (see :func:`timed`; by CUDA events, marked
   ``ms_by``, only when the profiler traced no device time): K1 clmul, the
   encrypt kernels K2, K3 and X1 at tau 128, 256 and 33, and T1 threefry,
   whose first words must also equal ``jax.random.bits``' (:data:`JAX_BITS`),
   and T1's device-key entry, for three keys eager and in a captured CUDA
   graph replayed after each rewrite of its key buffer; K1's two thread
   mappings, the comb and the square path, equal and timed in turns by CUDA
   events at 1-1,022 limbs (:func:`phase_square_sweep`: the u32 product's
   widest leaf launches at 32, 41 and 48), the crossover printed beside
   ``SQUARE_MIN`` in ``csrc/clmul.cu``, and the ``K1.square`` counter;
   the square path at each ``k`` (output columns a lane) it has, the best
   beside the code's ``SQUARE_COLUMNS``, one step's instructions from the
   library's SASS, and the ``K1.square.tiled`` counter;
   K2 also at tau 1 and 300, at L above the key's limbs and at keys whose
   tables the launcher tiles (checked only); beside each K3 and X1 row, its
   share of the bound and of the tensor-core count, and the device time of
   ``torch._int_mm`` on the bare count product (a yardstick the port never
   calls); D1 (``csrc/decrypt.cu``) at the decrypts of fresh ciphertexts,
   the round trip's sum and the u32 and u64 products, under a random mask
   and all ones (:func:`decipher_rows`);
4. replay of the interop fixtures (``tests/fixtures/interop_v1.json``):
   keygen and recorded-stream encryption on the card must give the
   fixture's bytes;
5. the main path at ``Parameters(128, 128, 1, 128)``: seeded keygen,
   encrypt 2,048 u32 pairs, checked ``HomomorphicAddition``, decrypt,
   assert ``(x + y) mod 2^32``; the card's sums against the CPU's plain path
   on a few rows; a U8 AND/OR/XOR/NOT gate check;
6. bulk round-trips: 2^21 bits at ``(128, 128, 64, 128)`` and 2^20 bits at
   ``(1024, 1024, 64, 256)``;
5b. the multiply/compare path at the same parameters with
   ``HOMOMORPH_TPU_TORCH_ENC_IMPL=pallas_v1`` (encrypt through K3): checked
   u8 multiplication of 1,024 pairs, u32 ``lt`` of 2,048 pairs, u8 max, eq
   and sub, each decrypted and asserted; 4 rows of the product and of
   ``lt`` against the CPU's plain path (limbs, bound, noise);
6b. the encrypt experiment's entry (``homomorph_tpu_torch.experiments.
   exp_enc``): K2, K3 and X1 on 2^21 bits, K3 and X1 held to K2;
3c. the clmul route sweep (:func:`phase_route_sweep`): one Karatsuba level
   (R1, the leaf launch, R2) against one direct K1 launch on
   balanced operands of 32-4,096 limbs, and the chunk route at ``Lg = 4 Ls``,
   by device time (K1, R1 and R2 apart); every routed product equal to the
   direct one, limb for limb; the crossover it measures printed beside the
   threshold in the code;
5c. the wide path (:func:`phase_wide`): checked u16 multiplication of 512
   pairs at ``Parameters(1024, 128, 1, 128)`` and u32 of 8 pairs at
   ``(2432, 128, 1, 128)``, decrypted and asserted, 2 and 1 of their rows
   again with the route off (direct K1) and equal limb for limb; the sum
   of 8 u8 operands, the u32 popcount, the u8 clamp, the i8 shifts, rotates
   and ``abs_``, each decrypted and asserted;
3b. K1 at the busiest shapes phase 5b's multiplication and ``lt`` launched
   it with, every distinct ``lt`` launch shape timed, and at the busiest
   launch of the u16 product and the widest of the u32 product (phase 5c),
   with the u32 product's widest operands timed direct and routed, and the
   u16 product end to end at thresholds from 48 limbs to the route off;
   R1 and R2 (``csrc/route.cu``) against their plain versions (the torch
   glue, level by level) at the u16 product's busiest route, the u32
   product's widest, and the widest of the d = 5888 u32 product and of the
   u64 product (``experiments/exp_route.py``'s ``ROUTES``; phases 10e and
   10c hold their paths' widest products to them), each timed as in phase 3
   (:func:`route_kernel_rows`); C1, C2 and C3 (``csrc/circuit.cu``) against
   their plain version on random limbs at the programs the u16 product's
   busiest level and step, the u32 product's widest, the u64 product's
   busiest and its first level (three launches of C1) give them, and at
   C1's stack of each product's lanes (:func:`circuit_kernel_rows`);
7. ``torch.profiler`` traces of the checked add, the first bulk round trip,
   the u8 multiplication, the u32 ``lt`` and the u16 and u32
   multiplications: warm wall time, device time by kernel, busy share; the
   two products' and the add's device time split into K1, R1, R2, C1, C2,
   C3 and the rest, with their device records a call; both products once
   more with the route's glue as torch ops (:func:`torch_glue_rows`, the
   port before R1 and R2), and the products and the add with the circuits'
   glue one torch op a bit (:func:`with_per_op_glue`, the port before
   C1-C3), whose outputs must equal the plan's limb for limb;
9. the verify gate (``run_verification()`` in full, scaled round trip
   included), a path of its own;
10. the decrypt masks on the card (:func:`phase_masks`, a path of its own)
   at the 9-, 65-, 8,192-, 98,304-, 262,144- and 3,145,728-limb classes,
   each through the plan (``mask_kernel.mask_plan``: M3 for the small
   steps, then M2 a step) and through the route forced (M1 and K1 a
   step): both against the native host engine word for word at every
   class, native against the Python-int recurrence up to 98,304 limbs, the
   widest class's last 64 bits against ``X^i mod S`` by square-and-multiply;
   each route's cold and warm wall, device time, device records a call,
   kernel launches and bound beside native's host time; then, outside the
   path's counts, M1, M2 and M3 against their plain versions
   (:func:`mask_kernel_rows`, timed as in phase 3);
10b. the mesh path (:func:`phase_mesh`), grids of places on the one card
   (one card cannot give NCCL two ranks, so every exchange stays in the
   process): ``sharded_encrypt_bits`` at ``(128, 128, 64, 128)``, 2^21
   bits, under the meshes (4, 1), (2, 2) and (1, 4), and at ``(1024, 1024,
   64, 256)``, 2^20 bits, under (1, 2), each bit-identical to K2's dense
   output and decrypted through ``sharded_decrypt_bits``, with K2's dense
   output held against its plain version and X1 held against its own at
   each grid's partial shapes (:func:`mesh_partials`); a
   ``Context(sharding=make_mesh(2, 2))`` u32 add of 2,048 pairs whose
   ciphertext bytes equal an unsharded context's under the same seed; the
   checked u32 product at ``(2432, 128, 1, 128)`` under a limb mesh of four
   places, equal to the dense product limb for limb, with the exchange
   primitive's bytes equal to ``comm_bytes_per_call``'s sum over the
   products the hook took (its own counters); K1's launches
   on the earlier paths must be :data:`K1_EARLIER_PATHS` (the hook is
   inert without a mesh); X1 at each grid's partial shape timed as in
   phase 3 (device, call and plain time, bound, ``torch._int_mm``);
10c. the u64 product at ``Parameters(13440, 128, 1, 128)``
   (``homomorph_tpu_torch.experiments.exp_mul64``), decrypted against
   ``x * y mod 2^64`` under a key with ``S(0) = 1``: keygen, the eager
   tree's wall, device time (as a CUDA graph, and by kernel: K1, R1, R2
   and the rest of an eager call), K1 launches and peak memory, the decrypt
   mask's wall and device time; K1's launch with the most rows and its widest held
   against the plain version on their first and last 256 rows
   (:func:`k1_spot_checked`);
10d. the entry points (``homomorph_tpu_torch.entry``): ``entry()``'s
   gate step and ``dryrun_multichip(4)`` on four places on the card, each
   checked by decrypt;
10e. the port's bench (``homomorph_tpu_torch.bench --with-mul32``) at full
   size, its JSON printed on a line of its own: the verify gate, then every
   section, the u16 and the d = 5888 u32 products decrypted on the card
   under keys with ``S(0) = 1`` (the u32 product's mask timed on the card),
   K1's largest and widest launches held against the plain version as in
   10c, every device-busy field a number;
10f. the bench's u32 product (d = 5888) and the u64 product from their
   plans against the per-op glue (limbs, bound, noise), each decrypted
   (:func:`phase_glue`; not a path);
11. the compiled pipelines as CUDA graphs (:func:`phase_compiled`): the u32
   add (2,048 pairs) and the u32 product (8 pairs) against eager limb for
   limb and decrypted, and the u32 add's encrypt -> add -> decrypt round
   trip under a new key each call: first call, replays, eager and one
   replay's device time; and the round trip through K3 (``HOMOMORPH_TPU_TORCH_ENC_IMPL=pallas_v1``), each replay
   against the same function run eagerly on its keys; their launches are
   those counted at warm-up and capture (a replay must count none);
8. one JSON line of kernels (launches counted over the paths: phases 5-6,
   5b, 6b, 5c, 9, 10, 10b-10e and 11, each counted from 0, where M3 and M2
   run each new decrypt mask and M1 runs in phase 10; each bound the larger of the
   bytes and the necessary work of the best design in the repo, see
   :func:`set_bounds` and ``homomorph_tpu_torch/utils/profiling.py``, with
   the older operation count's bound beside it);
12. last line ``{"ok": true, "device": {...}}``.

Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234  # keys, plaintexts and selection words all derive from it

# the peaks and the bounds' work counts live in the port (fails outside a checkout)
sys.path.insert(0, ROOT)
from homomorph_tpu_torch.experiments.common import (  # noqa: E402
    comb_pairs,
    leaf_shape,
    newton_step_work,
    products_sol,
    recorded_products,
)
from homomorph_tpu_torch.utils.profiling import (  # noqa: E402
    counters,
    DECRYPT_OPS_PER_LIMB,
    SQUARE_OPS_PER_LIMB,
    THREEFRY_ALU_OPS_PER_WORD,
    bound,
    chip_peaks,
    clmul_bytes,
    clmul_comb_work,
    clmul_ops,
    decrypt_sol,
    device_records,
    encrypt_lookup_bytes,
    square_bytes,
)

#: jax.random.bits(jax.random.key(seed), (8,), uint32), computed by the JAX
#: package on the CPU (JAX 0.9.0; tests/test_torch_threefry.py holds the
#: same words); T1 must reproduce them on the card
JAX_BITS = {
    0: [4070199207, 4202968722, 1427181096, 2012915765,
        2447653815, 710830403, 1332275837, 2961296638],
    17: [1083326455, 3794755506, 3288344309, 1599061380,
         3175417854, 1130779688, 1775367574, 3399734426],
    1234: [3715183467, 3461522409, 1578076316, 3641478021,
           607760917, 2701805931, 3332195204, 1640115702],
}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def call_ms(torch, fn, iters=50):
    """CUDA-event time per call over back-to-back calls: for a short kernel
    this is the host's issue rate of the wrapper, not the kernel."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, got, want):
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if torch.equal(got, want):
        return 0, 0
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    diff = (g - w).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def random_words(ctx, shape):
    torch = ctx["torch"]
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=ctx["dev"],
                         generator=ctx["gen"])


def profiled(fn, iters=1):
    """Device ms by record name over ``iters`` calls of ``fn`` from
    ``torch.profiler`` (:func:`device_records`), or None when its traces
    held no device time: the caller reports the value as not measured
    (null), never as a span of event or wall time."""
    try:
        return device_records(fn, iters)
    except RuntimeError as err:
        log(f"[profiler] not measured: {err}")
        return None


def profiled_ms(fn, iters):
    """Device ms per call of ``fn`` (:func:`profiled`), or None."""
    rec = profiled(fn, iters)
    return None if rec is None else sum(rec.values()) / iters


def ms_text(ms, digits=5):
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def timed(torch, kernel_fn, plain_fn, plain_events=False):
    """Device times of the kernel and its plain version, each with what
    took it (``ms_by``, ``plain_by``: "profiler" or "events").  The kernel:
    the profiler's device time of 20 calls (:func:`device_records`: three
    traces, a record one lost counted from the others).  Only if no trace
    held device time, CUDA events over back-to-back calls, which include
    the host's issue gaps.  With ``plain_events`` the plain
    version is timed by CUDA events over one call: at the wide path's row
    counts it runs ~10^5 small torch kernels a call, more than a profiler
    trace should hold; so too when its trace held no device time."""
    plain_ms = None if plain_events else profiled_ms(plain_fn, 3)
    plain_by = "events" if plain_ms is None else "profiler"
    if plain_ms is None:
        plain_ms = call_ms(torch, plain_fn, 1)
    traced = profiled_ms(kernel_fn, 20)
    calls = call_ms(torch, kernel_fn)
    return dict(ms=calls if traced is None else traced,
                ms_by="events" if traced is None else "profiler",
                call_ms=calls, plain_ms=plain_ms, plain_by=plain_by)


def stage(torch, fn):
    """(result, wall ms) of ``fn`` between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def with_env(name, value, fn):
    """``fn()`` with the environment variable ``name`` set to ``value``
    (deleted for None), restored after."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def set_bounds(ctx, rows):
    """``bound_ms``: the larger of the row's HBM bytes at 3.35 TB/s and each
    of its ``work`` terms (amount, rate of ``chip_peaks``), the necessary
    work of the best design in the repo for the function
    (``homomorph_tpu_torch.utils.profiling.bound``).  ``old_bound_ms``: the
    bytes against the row's ``old_ops`` at ``old_rate`` (the operation
    count the bounds took before the table and comb designs), kept beside it."""
    for r in rows:
        secs, r["bound_by"] = bound(r["bytes"], r["work"], ctx["peaks"])
        r["bound_ms"] = secs * 1e3
        r["old_bound_ms"] = bound(r["bytes"], [(r["old_ops"], r["old_rate"])], ctx["peaks"])[0] * 1e3
        r["work"] = [list(w) for w in r["work"]]
    return rows


def clmul_rows(ctx, shapes, plain_events=False):
    """K1 against its plain version at (label, B, La, Lb) shapes."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    rows = []
    for label, B, La, Lb in shapes:
        a, b = random_words(ctx, (B, La)), random_words(ctx, (B, Lb))
        got = k.clmul_flat(a, b)
        torch.cuda.synchronize()
        want = k.clmul_plain(a, b)
        bad, err = compare(torch, got, want)
        check(bad == 0, f"clmul {label} ({B}, {La}x{Lb}): {bad} mismatches")
        smem_bytes, ops = clmul_comb_work(B, La, Lb)
        rows.append(dict(
            kernel="clmul", label=label, shape=f"B={B} La={La} Lb={Lb}",
            mismatches=bad, max_abs_err=err,
            **timed(torch, lambda: k.clmul_flat(a, b), lambda: k.clmul_plain(a, b),
                    plain_events),
            work=[(smem_bytes, "smem_bw"), (ops, "int32_ops")],
            old_ops=clmul_ops(B, La, Lb), old_rate="int32_ops",
            bytes=clmul_bytes(B, La, Lb),
        ))
        log(f"[kernels] clmul {label:9s} B={B} {La}x{Lb}: mismatches {bad}, "
            f"kernel {rows[-1]['ms']} ms by {rows[-1]['ms_by']} (call {rows[-1]['call_ms']} ms), "
            f"plain {rows[-1]['plain_ms']} ms by {rows[-1]['plain_by']}")
    return set_bounds(ctx, rows)


# the square path's sweep (L, rows): the u32 product's (d = 2432) widest leaf
# launches at 32, 41 and 48 limbs; the add's whole-tensor AND at 9; keygen's
# S*Q_i at 5 (128 rows in set-up: here at 2^20 rows, for the launch); about
# as many comb pairs as the 48-limb leaves elsewhere
SQUARE_SWEEP = ((1, 1 << 22), (2, 1 << 22), (5, 1 << 20), (9, 524288), (16, 1 << 20),
                (24, 1 << 20), (32, 1259712), (41, 49152), (48, 384912), (63, 262144),
                (128, 65536), (1022, 1024))
SQUARE_WINDOW_MS = 20.0  # CUDA-event window a timed turn spans at least
# the scan that SQUARE_COLUMNS in csrc/clmul.cu is read from: every width to 64
# and some above, each at about the 32-limb leaf launch's limb pairs
SQUARE_SCAN = (*range(1, 65), 72, 80, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768, 1022)
SQUARE_SCAN_PAIRS = 1259712 * 32 * 32


def square_step_sass(lib):
    """The hot loop of each instance of K1's square path in the built
    ``clmul`` library (``cuobjdump -sass``): for each ``k``, the loop with
    the most shared loads, its steps a trip (its loads over the ``8 k + 8``
    of one step: ``S[i]``, ``k`` words for nibble 0, ``k + 1`` for each
    other), and its instructions a step by class: ``lds``, ``alu`` (the
    per-thread integer ops: ``IMAD``, ``IADD3``, ``LOP3``, ``SHF``, ``PRMT``,
    ``ISETP``, ``SEL``, ...), of it ``imad``, and ``other`` (branches,
    uniform-datapath ops).  An unnamed instance (no ``<k>``) is k = 1.  None
    where ``cuobjdump`` is missing or finds no loop."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs, name = {}, None  # each function's (address, instruction text), labels at their address
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = ([], {})
        elif name is not None:
            label = re.match(r"\s*(\.L_x_\d+):", line)
            inst = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if label:
                funcs[name][1][label.group(1)] = len(funcs[name][0])
            elif inst:
                funcs[name][0].append((int(inst.group(1), 16), inst.group(2)))
    out = {}
    for name, (items, labels) in funcs.items():
        if "clmul_comb_kernel_square" not in name:
            continue
        m = re.search(r"clmul_comb_kernel_squareILi(\d+)E", name)
        K = int(m.group(1)) if m else 1
        best = None
        for n, (addr, text_) in enumerate(items):
            target = re.search(r"BRA\s+(?:`\(?(\.L_x_\d+)\)?`?|(0x[0-9a-f]+))", text_)
            if not target:
                continue
            if target.group(1):
                start = labels.get(target.group(1), n)
            else:
                start = next((j for j, (a2, _) in enumerate(items) if a2 == int(target.group(2), 16)), n)
            if start >= n:
                continue
            ops = [re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0] for _, x in items[start:n + 1]]
            lds = sum(op == "LDS" for op in ops)
            if best is None or lds > best[0]:
                best = (lds, ops)
        if best is None or not best[0]:
            continue
        lds, ops = best
        steps = max(1, round(lds / (8 * K + 8)))
        other = [op for op in ops if op != "LDS" and (op.startswith(("U", "BRA", "BAR", "NOP"))
                                                    or op in ("EXIT", "BSSY", "BSYNC", "WARPSYNC"))]
        alu = len(ops) - lds - len(other)
        hist = {}
        for op in ops:
            hist[op] = hist.get(op, 0) + 1
        out[K] = dict(steps_a_trip=steps, lds=lds / steps, alu=alu / steps,
                      imad=sum(op == "IMAD" for op in ops) / steps, other=len(other) / steps,
                      ops=hist)
    return out or None


def square_case(ctx, L, B, sass=None):
    """K1's mappings on [B, L] x [B, L]: the comb of unbalanced products and
    the square path at each ``k`` it has, equal limb for limb (and to the
    plain version on the first and last 256 rows), each timed by CUDA
    events in turns (comb, k ascending, k descending, comb) over windows of
    at least SQUARE_WINDOW_MS; beside each ``k`` its bound: the larger of
    its shared loads (``8 k + 8`` words a lane-step) and, where ``sass``
    gives them, its ALU instructions a lane-step, over the card's rates."""
    import statistics

    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    a, b = random_words(ctx, (B, L)), random_words(ctx, (B, L))
    comb = lambda: k.clmul_mapping(a, b, False)  # noqa: E731
    runs = {K: (lambda K=K: k.clmul_mapping(a, b, True, K)) for K in k.SQUARE_KS}
    want = comb()
    for K, fn in runs.items():
        bad, _ = compare(torch, fn(), want)
        check(bad == 0, f"K1 square path {L}x{L} at B={B}, k={K}: {bad} limbs differ from the comb")
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    bad, _ = compare(torch, got, want)
    check(bad == 0, f"K1 {L}x{L} at B={B}: {bad} limbs of hm_clmul differ from the comb")
    for part in (slice(0, 256), slice(max(0, B - 256), B)):
        bad, _ = compare(torch, got[part], k.clmul_plain(a[part], b[part]))
        check(bad == 0, f"K1 square path {L}x{L} at B={B}: {bad} limbs differ from the plain version")
    del got, want
    iters = max(1, int(SQUARE_WINDOW_MS / call_ms(torch, comb, 1)))
    order = ["comb", *k.SQUARE_KS, *reversed(k.SQUARE_KS), "comb"]
    times = {name: [] for name in ("comb", *k.SQUARE_KS)}
    for name in order:
        times[name].append(call_ms(torch, comb if name == "comb" else runs[name], iters))
    med = {name: statistics.median(v) for name, v in times.items()}
    best = min(k.SQUARE_KS, key=lambda K: med[K])
    code_k = k.square_columns(L, L)
    peaks = ctx["peaks"]
    bounds = {}
    for K in k.SQUARE_KS:
        lane_steps = B * -(-(L + 2) // K) * L
        loads_ms = lane_steps * (8 * K + 8) * 4 / peaks["smem_bw"] * 1e3
        alu = (sass or {}).get(K, {}).get("alu")
        alu_ms = lane_steps * alu / peaks["int32_ops"] * 1e3 if alu else None
        bounds[K] = dict(loads_ms=loads_ms, alu_ms=alu_ms,
                         share=max(loads_ms, alu_ms or 0.0) / med[K])
    row = dict(L=L, B=B, iters=iters, comb_ms=times["comb"],
               k_ms={K: times[K] for K in k.SQUARE_KS}, best_k=best, code_k=code_k,
               speedup=med["comb"] / med[code_k] if code_k else None,
               speedup_k1=med["comb"] / med[1], bounds=bounds,
               rows_a_block={K: k.square_layout(L, K)[0] for K in k.SQUARE_KS})
    log(f"[K1 square] {L}x{L} B={B}: comb {med['comb']:.5f} ms; "
        + "; ".join(f"k={K} {med[K]:.5f} ms ({row['rows_a_block'][K]} rows a block, "
                    f"loads bound {bounds[K]['loads_ms']:.5f}"
                    + (f", ALU bound {bounds[K]['alu_ms']:.5f}" if bounds[K]["alu_ms"] else "")
                    + f", {bounds[K]['share']:.1%})" for K in k.SQUARE_KS)
        + f"; best k={best}, hm_clmul takes "
        + (f"k={code_k} ({row['speedup']:.3f}x the comb)" if code_k else "the comb") + "; equal")
    return row


def square_scan(ctx):
    """Each ``k`` of the square path at every width of SQUARE_SCAN (rows for
    about SQUARE_SCAN_PAIRS limb pairs, 1,024 to 2^22), equal to the comb
    and timed in turns (k ascending, then descending) over windows of at
    least 10 ms: the fastest ``k`` at each width beside the code's, and the
    runs of widths the fastest make (``SQUARE_COLUMNS`` is read from them,
    ties under 0.5% to the neighbouring run)."""
    import statistics

    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    rows, runs = [], []
    for L in SQUARE_SCAN:
        B = min(1 << 22, max(1024, SQUARE_SCAN_PAIRS // (L * L)))
        a, b = random_words(ctx, (B, L)), random_words(ctx, (B, L))
        want = k.clmul_mapping(a, b, False)
        for K in k.SQUARE_KS:
            bad, _ = compare(torch, k.clmul_mapping(a, b, True, K), want)
            check(bad == 0, f"K1 square path {L}x{L} at B={B}, k={K}: {bad} limbs differ from the comb")
        del want
        iters = max(2, int(10.0 / call_ms(torch, lambda: k.clmul_mapping(a, b, True, 1), 1)))
        times = {K: [] for K in k.SQUARE_KS}
        for K in (*k.SQUARE_KS, *reversed(k.SQUARE_KS)):
            times[K].append(call_ms(torch, lambda: k.clmul_mapping(a, b, True, K), iters))
        med = {K: statistics.median(v) for K, v in times.items()}
        best, code_k = min(med, key=med.get), k.square_columns(L, L)
        rows.append(dict(L=L, B=B, ms=med, best_k=best, code_k=code_k))
        if not runs or runs[-1][1] != best:
            runs.append((L, best))
        log(f"[K1 square scan] {L}x{L} B={B}: " + " ".join(f"k={K} {med[K]:.5f}" for K in k.SQUARE_KS)
            + f" ms; fastest k={best}, the code's k={code_k} at {med[code_k] / med[best]:.3f}x its time")
        del a, b
    log(f"[K1 square scan] runs of the fastest k (first width, k): {runs}")
    return dict(rows=rows, runs=runs)


def phase_square_sweep(ctx):
    """K1's phase, the square path: the comb and each ``k`` timed in turns at
    SQUARE_SWEEP's widths, the crossover (the least width from which the
    square path at the code's ``k`` wins at every wider one of the sweep)
    beside the code's ``SQUARE_MIN``, the best ``k`` beside the code's
    (``SQUARE_COLUMNS``) there and at every width of :func:`square_scan`,
    one step's instructions from the built library's SASS; and the counters ``K1.square`` (one a launch on square operands
    from the crossover, none on unbalanced ones) and ``K1.square.tiled``
    (one where the code's ``k`` is above 1)."""
    from homomorph_tpu_torch.gf2 import cuda_build
    from homomorph_tpu_torch.gf2 import kernels as k

    sass = square_step_sass(cuda_build.build(("clmul",))["clmul"])
    for K, st in sorted((sass or {}).items()):
        log(f"[K1 square] SASS, k={K}: a step {st['lds']:.2f} shared loads, {st['alu']:.2f} ALU "
            f"(IMAD {st['imad']:.2f}), {st['other']:.2f} other; per output column "
            f"{st['lds'] / K:.2f} loads, {st['alu'] / K:.2f} ALU; {st['steps_a_trip']} steps a trip; "
            f"{st['ops']}")
    if sass is None:
        log("[K1 square] SASS: cuobjdump missing or no loop found")
    rows = [square_case(ctx, L, B, sass) for L, B in SQUARE_SWEEP]
    scan = square_scan(ctx)
    least = None
    for r in sorted(rows, key=lambda r: -r["L"]):
        if not r["speedup"] or r["speedup"] <= 1.0:
            break
        least = r["L"]
    code_min = min((L for L in range(1, 1023) if k.square_path(L, L)), default=None)
    log(f"[K1 square] measured crossover {least} limbs; SQUARE_MIN in the code {code_min}; "
        "best k / the code's k: " + ", ".join(f"{r['L']}: {r['best_k']}/{r['code_k']}" for r in rows))
    for La, Lb in ((32, 32), (48, 48), (9, 256), (48, 64), (5, 5)):
        a, b = random_words(ctx, (4, La)), random_words(ctx, (4, Lb))
        before = (counters["K1"], counters["K1.square"], counters["K1.square.tiled"])
        k.clmul_flat(a, b)
        moved = tuple(n - m for n, m in zip(
            (counters["K1"], counters["K1.square"], counters["K1.square.tiled"]), before))
        square = La == Lb and code_min is not None and La >= code_min
        want = (1, int(square), int(square and k.square_columns(La, Lb) > 1))
        check(moved == want, f"K1 {La}x{Lb}: counters K1, K1.square, K1.square.tiled moved "
              f"{moved}, not {want}")
    return dict(rows=rows, crossover=least, square_min=code_min, sass=sass, scan=scan)


def phase_kernels(ctx):
    """K1 at the add path's shapes, K2, K3 and X1 at the encrypt grid, T1."""
    torch, dev = ctx["torch"], ctx["dev"]
    from homomorph_tpu_torch import prng
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import poly as gf2

    # (label, B, La, Lb): keygen S*Q_i, the adder's whole-tensor AND, its last
    # chain step, and small-batch wide operands
    rows = clmul_rows(ctx, (("keygen", 128, 5, 5), ("add-and", 65536, 9, 9),
                            ("add-chain", 2048, 9, 256), ("wide48", 7, 9, 48),
                            ("wide96", 7, 9, 96)))

    # (tau, Lpk): the slice's and the first bulk's key, the scaled key, an
    # unaligned tau; K2 and K3 share a plain version, X1 has its own
    enc_rows = []
    for tau, Lpk in ((128, 9), (256, 65), (33, 9)):
        for B in (65536, 1 << 21):
            W, D, L = -(-tau // 32), 32 * Lpk, Lpk
            pk = random_words(ctx, (tau, Lpk))
            planes = enc.pk_planes(enc.pk_columns(pk))
            selw = random_words(ctx, (B, W))
            sel = gf2.unpack_bits(selw, tau, dtype=torch.int8)
            plain = (random_words(ctx, (B,)) & 1).contiguous()
            want = enc.encrypt_plain(selw, planes, plain, L)
            want_sel = enc.encrypt_sel_plain(sel, planes, plain, L)
            check(torch.equal(want, want_sel), f"plain versions disagree at tau={tau} B={B}")
            out_bytes = (B + B * L) * 4  # plain in, limbs out
            # the function's necessary work: the table design's lookups
            lookups = [(encrypt_lookup_bytes(B, tau, L), "smem_bw")]
            variants = (
                ("encrypt", lambda: enc.encrypt_words_table(selw, pk, plain, L),
                 lambda: enc.encrypt_plain(selw, enc.pk_planes(enc.pk_columns(pk)), plain, L),
                 want, B * W * 4 + tau * Lpk * 4),
                ("encrypt_v1", lambda: enc.encrypt_words_mma(selw, planes, plain, L),
                 lambda: enc.encrypt_plain(selw, planes, plain, L),
                 want, B * W * 4 + D * 32 * W),
                ("encrypt_v3", lambda: enc.encrypt_sel_mma(sel, planes, plain, L),
                 lambda: enc.encrypt_sel_plain(sel, planes, plain, L),
                 want_sel, B * tau + D * 32 * W),
            )
            int_mm_ms = count_product_ms(ctx, selw, planes)
            for name, fn, plain_fn, ref, in_bytes in variants:
                got = fn()
                torch.cuda.synchronize()
                bad, err = compare(torch, got, ref)
                check(bad == 0, f"{name} tau={tau} B={B}: {bad} mismatches")
                enc_rows.append(dict(
                    kernel=name, label=f"tau{tau}", shape=f"B={B} tau={tau} D={D} L={L}",
                    mismatches=bad, max_abs_err=err, **timed(torch, fn, plain_fn),
                    work=lookups, old_ops=2 * B * tau * D, old_rate="int8_tc_ops",
                    bytes=in_bytes + out_bytes,
                    **({} if name == "encrypt" else dict(int_mm_ms=int_mm_ms)),
                ))
                log(f"[kernels] {name} tau={tau} B={B}: mismatches {bad}, "
                    f"kernel {enc_rows[-1]['ms']} ms by {enc_rows[-1]['ms_by']} "
                    f"(call {enc_rows[-1]['call_ms']} ms), "
                    f"plain {enc_rows[-1]['plain_ms']} ms by {enc_rows[-1]['plain_by']}")
                del got
            log(f"[kernels] torch._int_mm of the count product [B, Kp] x [Kp, D] alone, tau={tau} "
                f"B={B}: {ms_text(int_mm_ms)} ms (a yardstick: not the function, not used by the "
                f"port)")
            del want, want_sel, selw, sel, plain
            # the two encrypt designs on one card: which is faster at this shape
            (k2, k2_by), (k3, k3_by) = ((r["ms"], r["ms_by"]) for r in enc_rows[-3:-1])
            ctx.setdefault("k2_vs_k3", {})[f"tau={tau} B={B}"] = dict(
                k2_ms=k2, k3_ms=k3, by=[k2_by, k3_by], faster="K2" if k2 < k3 else "K3")
            log(f"[kernels] tau={tau} B={B}: {'K2' if k2 < k3 else 'K3'} is faster, K2 {k2} ms "
                f"by {k2_by}, K3 {k3} ms by {k3_by} ({max(k2, k3) / min(k2, k3):.2f}x)")
    rows += set_bounds(ctx, enc_rows)
    k2_edges(ctx)

    # T1: the encrypt path's words for 2^21 bits at tau = 128, and JAX's words
    key = hrng.threefry_key(ctx["seed"])
    shape = (1 << 21, 4)
    got = prng.random_bits(key, shape, dev)
    torch.cuda.synchronize()
    bad, err = compare(torch, got, prng.random_bits_plain(key, shape, dev))
    check(bad == 0, f"threefry {shape}: {bad} mismatches")
    for seed, want_words in JAX_BITS.items():
        first = prng.random_bits(hrng.threefry_key(seed), (8,), dev)
        have = [w & 0xFFFFFFFF for w in first.tolist()]
        check(have == want_words, f"threefry seed {seed}: {have} != jax.random.bits {want_words}")
    n = shape[0] * shape[1]
    t1_work = [(n * THREEFRY_ALU_OPS_PER_WORD, "int32_ops")]
    rows += set_bounds(ctx, [dict(
        kernel="threefry", label="words", shape=f"{shape[0]}x{shape[1]} words",
        mismatches=bad, max_abs_err=err,
        **timed(torch, lambda: prng.random_bits(key, shape, dev),
                lambda: prng.random_bits_plain(key, shape, dev)),
        work=t1_work, old_ops=n * THREEFRY_ALU_OPS_PER_WORD, old_rate="int32_ops", bytes=n * 4,
    )])
    log(f"[kernels] threefry {shape}: mismatches {bad}, seeds {sorted(JAX_BITS)} equal "
        f"jax.random.bits; kernel {rows[-1]['ms']} ms by {rows[-1]['ms_by']} (call "
        f"{rows[-1]['call_ms']} ms), plain {rows[-1]['plain_ms']} ms by {rows[-1]['plain_by']}")
    rows += set_bounds(ctx, [threefry_device_key(ctx, shape, t1_work)])
    rows += decipher_rows(ctx)
    return rows


#: (label, shape of the limbs) of D1's rows: fresh u32 ciphertexts at
#: d = 128 (9 limbs), the round trip's sum ([pairs, 32, 384]), the u32
#: product at d = 2432 and the u64 product's one row
DECIPHER_SHAPES = (("ciphertexts", (65536, 32, 9)), ("sum", (65536, 32, 384)),
                   ("u32-product", (512, 98304)), ("u64-product", (1, 3145728)))


def decipher_rows(ctx):
    """D1 against the torch expression at :data:`DECIPHER_SHAPES`, on the
    same random limbs under a random mask and under all ones, timed as in
    phase 3; its bound is ``decrypt_sol``'s (one read of the limbs, one
    word a row written, an AND and an XOR a limb)."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import poly as gf2

    rows = []
    for label, shape in DECIPHER_SHAPES:
        L, n = shape[-1], 1
        for k in shape[:-1]:
            n *= k
        c, w = random_words(ctx, shape), random_words(ctx, (L,))
        bad = err = 0
        for mask in (w, torch.full_like(w, -1)):
            got = gf2.decipher_bits(c, mask)
            torch.cuda.synchronize()
            b, e = compare(torch, got, gf2.decipher_bits_plain(c, mask))
            bad, err = bad + b, max(err, e)
        check(bad == 0, f"decipher {shape}: {bad} mismatches")
        row = set_bounds(ctx, [dict(
            kernel="decipher", label=label, shape="x".join(map(str, shape)), mismatches=bad,
            max_abs_err=err, **timed(torch, lambda: gf2.decipher_bits(c, w),
                                     lambda: gf2.decipher_bits_plain(c, w)),
            work=[(n * L * DECRYPT_OPS_PER_LIMB, "int32_ops")], old_ops=n * L * DECRYPT_OPS_PER_LIMB,
            old_rate="int32_ops", bytes=n * (L + 1) * 4)])[0]
        sol_ms = decrypt_sol(n, L, ctx["peaks"]) * 1e3
        check(abs(row["bound_ms"] - sol_ms) <= 1e-9 * sol_ms,
              f"decipher {shape}: bound {row['bound_ms']} ms, decrypt_sol {sol_ms} ms")
        log(f"[kernels] decipher {label} {row['shape']}: mismatches {bad}, kernel {row['ms']} ms by "
            f"{row['ms_by']} (call {row['call_ms']} ms), plain {row['plain_ms']} ms by "
            f"{row['plain_by']}, bound {row['bound_ms']:.5f} ms ({row['bound_ms'] / row['ms']:.1%})")
        rows.append(row)
        del c, w
        torch.cuda.empty_cache()
    return rows


def count_product_ms(ctx, selw, planes):
    """Device time of ``torch._int_mm`` on K3's and X1's count product, the
    selection unpacked to [B, Kp] int8 times the planes [Kp, D]: a library
    time for the product alone (no parity, pack or plaintext bit), which
    the port never calls; None if the profiler traced nothing."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import poly as gf2

    return int_mm_ms(ctx, gf2.unpack_bits(selw, planes.shape[1], dtype=torch.int8), planes)


def int_mm_ms(ctx, a, planes):
    """Device time of ``torch._int_mm`` of the int8 selections ``a``
    [B, Kp] by the planes [Kp, D] (:func:`count_product_ms`)."""
    torch = ctx["torch"]
    b = planes.T  # [Kp, D], column-major
    torch._int_mm(a, b)
    torch.cuda.synchronize()
    ms = profiled_ms(lambda: torch._int_mm(a, b), 5)
    del a
    torch.cuda.empty_cache()
    return ms


def threefry_device_key(ctx, shape, work):
    """T1's device-key entry against ``random_bits_plain`` for three keys,
    eager and inside a captured CUDA graph replayed after each rewrite of
    its key buffer; timed eager at ``shape``."""
    torch, dev = ctx["torch"], ctx["dev"]
    from homomorph_tpu_torch import prng

    keys = ((0, ctx["seed"]), (0xDEADBEEF, 0x12345678), (0xFFFFFFFF, 0x80000000))
    buf = prng.key_words(keys[0]).to(dev)
    bad = 0
    for key in keys:
        buf.copy_(prng.key_words(key))
        got = prng.random_bits_device_key(buf, shape)
        torch.cuda.synchronize()
        bad += compare(torch, got, prng.random_bits_plain(key, shape, dev))[0]
    check(bad == 0, f"threefry device key: {bad} mismatches eager")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        prng.random_bits_device_key(buf, shape)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = prng.random_bits_device_key(buf, shape)
    for key in keys:
        buf.copy_(prng.key_words(key))
        graph.replay()
        torch.cuda.synchronize()
        bad += compare(torch, captured, prng.random_bits_plain(key, shape, dev))[0]
    check(bad == 0, f"threefry device key: {bad} mismatches in graph replays")
    del graph, captured, got
    key = keys[1]
    buf.copy_(prng.key_words(key))
    row = dict(kernel="threefry_dkey", label="words", shape=f"{shape[0]}x{shape[1]} words",
               mismatches=bad, max_abs_err=0,
               **timed(torch, lambda: prng.random_bits_device_key(buf, shape),
                       lambda: prng.random_bits_plain(key, shape, dev)),
               work=work, old_ops=work[0][0], old_rate="int32_ops", bytes=shape[0] * shape[1] * 4)
    log(f"[kernels] threefry device key {shape}: 3 keys equal random_bits_plain eager and in "
        f"graph replays after each key rewrite; kernel {row['ms']} ms by {row['ms_by']} (call "
        f"{row['call_ms']} ms), plain {row['plain_ms']} ms by {row['plain_by']}")
    return row


def k2_edges(ctx):
    """K2 against its plain version where the table layout has edges: tau
    not a multiple of the chunk, more than 8 selection words (two passes),
    L above and below the key's limbs, keys the launcher cuts into tiles of
    28 and 167 limbs, a row count that is no multiple of a block's rows."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc

    cases = ((1, 2, 2), (1, 2, 5), (33, 9, 12), (128, 9, 12), (256, 65, 70), (300, 3, 3),
             (300, 10, 12), (128, 9, 7), (64, 300, 300), (1, 500, 500))
    for tau, Lpk, L in cases:
        B = 65537
        pk = random_words(ctx, (tau, Lpk))
        selw = random_words(ctx, (B, -(-tau // 32)))
        plain = (random_words(ctx, (B,)) & 1).contiguous()
        got = enc.encrypt_words_table(selw, pk, plain, L)
        torch.cuda.synchronize()
        bad, _ = compare(torch, got, enc.encrypt_plain(
            selw, enc.pk_planes(enc.pk_columns(pk)), plain, L))
        check(bad == 0, f"encrypt tau={tau} Lpk={Lpk} L={L}: {bad} mismatches")
    log(f"[kernels] encrypt at (tau, Lpk, L) {list(cases)}, B=65537: 0 mismatches")


def phase_fixtures(ctx):
    """Keygen and recorded-stream encryption on the card reproduce the fixture bytes."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import poly as gf2

    def padded_eq(got, want):
        n = max(len(got), len(want))
        return got.ljust(n, b"\0") == want.ljust(n, b"\0")

    with open(os.path.join(ROOT, "tests", "fixtures", "interop_v1.json")) as f:
        cases = json.load(f)["cases"]
    for case in cases:
        p = case["params"]
        c = ht.Context(
            ht.Parameters(p["d"], p["dp"], p["delta"], p["tau"]),
            source=ht.RecordedSource(bytes.fromhex(case["stream_hex"])), device=ctx["dev"],
        )
        c.generate_secret_key()
        c.generate_public_key()
        check(padded_eq(c.get_secret_key().to_bytes(), bytes.fromhex(case["secret_key_hex"])),
              f"fixture {p}: secret key bytes differ")
        for got, want in zip(c.get_public_key().to_bytes(), case["public_key_hex"]):
            check(padded_eq(got, bytes.fromhex(want)), f"fixture {p}: public key bytes differ")
        for pt_hex, ct_hexes in zip(case["plaintexts_hex"], case["ciphertexts_hex"]):
            pt = bytes.fromhex(pt_hex)
            ct = c.encrypt(pt, ht.BytesDescriptor(len(pt)))
            limbs = gf2.to_numpy(ct.limbs)
            for i, want in enumerate(ct_hexes):
                check(padded_eq(gf2.limbs_to_bytes(limbs[i]), bytes.fromhex(want)),
                      f"fixture {p}: ciphertext lane {i} differs")
            check(c.decrypt(ct) == pt, f"fixture {p}: decrypt differs")
    log(f"[fixtures] {len(cases)} interop cases reproduced byte for byte on {ctx['dev']}")


def seeded_context(ht, params, seed, dev):
    """A context whose keys and encryption stream all come from ``seed``."""
    c = ht.Context(params, encrypt_seed=seed, device=dev)
    sk = ht.keys.generate_secret_key(params, ht.ThreefrySource(seed), device=dev)
    c.set_secret_key(sk)
    c.set_public_key(ht.keys.generate_public_key(params, sk, ht.ThreefrySource(seed + 1)))
    return c


def phase_main(ctx):
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.models import (
        HomomorphicAddition, HomomorphicAndGate, HomomorphicNotGate,
        HomomorphicOrGate, HomomorphicXorGate,
    )

    torch, dev, seed = ctx["torch"], ctx["dev"], ctx["seed"]
    n = 2048
    rng = np.random.default_rng(seed)
    params = ht.Parameters(128, 128, 1, 128)
    t0 = time.perf_counter()
    c = seeded_context(ht, params, seed, dev)
    torch.cuda.synchronize()
    t_keygen = time.perf_counter() - t0
    xs = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    ys = rng.integers(0, 2**32, size=n, dtype=np.uint64)

    t0 = time.perf_counter()
    ca = c.encrypt(xs.tolist(), ht.U32, batch=True)
    cb = c.encrypt(ys.tolist(), ht.U32, batch=True)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    check(tuple(ca.limbs.shape) == (n, 32, 9), f"ciphertext shape {tuple(ca.limbs.shape)}")

    t0 = time.perf_counter()
    cs = c.apply2(HomomorphicAddition, ca, cb)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0

    t0 = time.perf_counter()
    got = np.array(c.decrypt(cs).tolist(), dtype=np.uint64)
    t_dec = time.perf_counter() - t0
    want = (xs + ys) % (1 << 32)
    check(np.array_equal(got, want), f"u32 add: {int((got != want).sum())} of {n} sums wrong")
    check(np.array_equal(np.array(c.decrypt(ca).tolist(), dtype=np.uint64), xs),
          "u32 round trip wrong")
    # lane 31 carries 30 chain steps: bound 2*B0 + 30*B0, noise 4 + 30*2 (B0 = 256)
    L_sum = gf2.bucket(gf2.limbs_for(8192))
    check(cs.bound == 8192 and cs.noise == 64 and tuple(cs.limbs.shape) == (n, 32, L_sum),
          f"sum metadata: bound {cs.bound}, noise {cs.noise}, shape {tuple(cs.limbs.shape)}")

    # the card's sums against the CPU's plain path on the same ciphertexts
    rows = slice(0, 4)
    ref = HomomorphicAddition.unsafe_apply(
        ht.Ciphered(ca.limbs[rows].cpu(), ca.bound, ht.U32),
        ht.Ciphered(cb.limbs[rows].cpu(), cb.bound, ht.U32),
    )
    check(ref.limbs.shape == cs.limbs[rows].shape and
          bool((ref.limbs == cs.limbs[rows].cpu()).all()),
          "u32 add: card limbs differ from the CPU plain path")
    log(f"[main] Parameters(128, 128, 1, 128), {n} u32 pairs: keygen {t_keygen*1e3:.3f} ms, "
        f"encrypt {t_enc*1e3:.3f} ms, checked add {t_add*1e3:.3f} ms, "
        f"decrypt {t_dec*1e3:.3f} ms; sums right, card == CPU on 4 rows")

    a8 = rng.integers(0, 256, size=n)
    b8 = rng.integers(0, 256, size=n)
    e8a = c.encrypt(a8.tolist(), ht.U8, batch=True)
    e8b = c.encrypt(b8.tolist(), ht.U8, batch=True)
    for op, fn in ((HomomorphicAndGate, np.bitwise_and), (HomomorphicOrGate, np.bitwise_or),
                   (HomomorphicXorGate, np.bitwise_xor)):
        out = np.array(c.decrypt(c.apply2(op, e8a, e8b)).tolist())
        check(np.array_equal(out, fn(a8, b8)), f"U8 {op.__name__} wrong")
    out = np.array(c.decrypt(c.apply1(HomomorphicNotGate, e8a)).tolist())
    check(np.array_equal(out, 255 - a8), "U8 NOT wrong")
    log(f"[main] U8 AND/OR/XOR/NOT on {n} pairs right")
    ctx["add_inputs"] = (c, ca, cb)
    ctx["add_values"] = (xs, ys)
    return dict(keygen_ms=t_keygen * 1e3, encrypt_ms=t_enc * 1e3, add_ms=t_add * 1e3,
                decrypt_ms=t_dec * 1e3, pairs=n)


def phase_bulk(ctx):
    import numpy as np

    import homomorph_tpu_torch as ht

    torch, dev, seed = ctx["torch"], ctx["dev"], ctx["seed"]
    rng = np.random.default_rng(seed + 10)
    out = []
    for params, n_bits in ((ht.Parameters(128, 128, 64, 128), 1 << 21),
                           (ht.Parameters(1024, 1024, 64, 256), 1 << 20)):
        c = seeded_context(ht, params, seed + 20, dev)
        vals = rng.integers(0, 2**32, size=n_bits // 32, dtype=np.uint64)
        t0 = time.perf_counter()
        ct = c.encrypt(vals.tolist(), ht.U32, batch=True)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = np.array(c.decrypt(ct).tolist(), dtype=np.uint64)
        t_dec = time.perf_counter() - t0
        check(np.array_equal(back, vals), f"bulk {params}: round trip wrong")
        L = ct.limbs.shape[-1]
        log(f"[bulk] {params}: {n_bits} bits, L={L}, ciphertext {ct.limbs.numel() * 4 / 1e6:.1f} MB; "
            f"encrypt {t_enc*1e3:.3f} ms ({n_bits / t_enc:,.0f} bits/s), "
            f"decrypt {t_dec*1e3:.3f} ms ({n_bits / t_dec:,.0f} bits/s); round trip right")
        out.append(dict(params=[params.d, params.dp, params.delta, params.tau], bits=n_bits,
                        limbs=L, encrypt_ms=t_enc * 1e3, decrypt_ms=t_dec * 1e3))
        ctx.setdefault("bulk_inputs", (c, vals, ct))
        del ct
    return out


def phase_mulcmp(ctx):
    """Phase 5b: checked u8 multiplication and u32 comparison, encrypt
    through K3 (the caller selects it)."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import (
        HomomorphicEquality, HomomorphicLessThan, HomomorphicMaximum,
        HomomorphicMultiplication, HomomorphicSubtraction,
    )

    torch, dev, seed = ctx["torch"], ctx["dev"], ctx["seed"] + 30
    rng = np.random.default_rng(seed)
    n8, n32 = 1024, 2048
    a8, b8 = rng.integers(0, 256, size=n8), rng.integers(0, 256, size=n8)
    b8[::8] = a8[::8]  # some equal pairs for eq
    x32 = rng.integers(0, 2**32, size=n32, dtype=np.uint64)
    y32 = rng.integers(0, 2**32, size=n32, dtype=np.uint64)
    y32[::16] = x32[::16]

    params = ht.Parameters(128, 128, 1, 128)
    c, keygen_ms = stage(torch, lambda: seeded_context(ht, params, seed, dev))
    (e8a, e8b, e32a, e32b), enc_ms = stage(torch, lambda: (
        c.encrypt(a8.tolist(), ht.U8, batch=True), c.encrypt(b8.tolist(), ht.U8, batch=True),
        c.encrypt(x32.tolist(), ht.U32, batch=True), c.encrypt(y32.tolist(), ht.U32, batch=True)))

    # the multiplication's and lt's K1 launches as [B, La] x [B, Lb], for phase 3b
    def recorded(fn):
        return recorded_products(lambda: stage(torch, fn))

    (prod, mul_ms), shapes = recorded(lambda: c.apply2(HomomorphicMultiplication, e8a, e8b))
    ctx["mul_shapes"] = shapes
    (lt, lt_ms), ctx["lt_shapes"] = recorded(lambda: c.apply2(HomomorphicLessThan, e32a, e32b))
    mx, max_ms = stage(torch, lambda: c.apply2(HomomorphicMaximum, e8a, e8b))
    eq, eq_ms = stage(torch, lambda: c.apply2(HomomorphicEquality, e8a, e8b))
    sb, sub_ms = stage(torch, lambda: c.apply2(HomomorphicSubtraction, e8a, e8b))

    t0 = time.perf_counter()
    got = np.array(c.decrypt(prod).tolist())
    dec_ms = (time.perf_counter() - t0) * 1e3
    want = (a8 * b8) % 256
    check(np.array_equal(got, want), f"u8 mul: {int((got != want).sum())} of {n8} products wrong")
    got = np.array(c.decrypt(lt).tolist(), dtype=bool)
    check(np.array_equal(got, x32 < y32), f"u32 lt: {int((got != (x32 < y32)).sum())} wrong")
    for name, cph, want in (("max", mx, np.maximum(a8, b8)), ("eq", eq, a8 == b8),
                            ("sub", sb, (a8 - b8) % 256)):
        got = np.array(c.decrypt(cph).tolist()).astype(want.dtype)
        check(np.array_equal(got, want), f"u8 {name}: {int((got != want).sum())} wrong")

    # the card's product and comparison against the CPU's plain path
    def rows4(cph):
        return ht.Ciphered(cph.limbs[:4].cpu(), cph.bound, cph.desc,
                           zero_lanes=cph.zero_lanes, noise=cph.noise)

    for name, op, card, a, b in (("mul", HomomorphicMultiplication, prod, e8a, e8b),
                                 ("lt", HomomorphicLessThan, lt, e32a, e32b)):
        ref = op.unsafe_apply(rows4(a), rows4(b))
        check(ref.limbs.shape == card.limbs[:4].shape
              and bool((ref.limbs == card.limbs[:4].cpu()).all())
              and (ref.bound, ref.noise, ref.zero_lanes) == (card.bound, card.noise, card.zero_lanes),
              f"{name}: card limbs, bound or noise differ from the CPU plain path")
    log(f"[mulcmp] Parameters(128, 128, 1, 128), encrypt through K3: keygen {keygen_ms:.3f} ms, "
        f"encrypt {n8}+{n8} u8 and {n32}+{n32} u32 {enc_ms:.3f} ms; checked u8 mul "
        f"{mul_ms:.3f} ms ({len(shapes)} clmul launches; product bound {prod.bound}, noise "
        f"{prod.noise}, L={prod.num_limbs}), u32 lt {lt_ms:.3f} ms, u8 max {max_ms:.3f} ms, "
        f"eq {eq_ms:.3f} ms, sub {sub_ms:.3f} ms; decrypt product {dec_ms:.3f} ms; all right, "
        f"card == CPU on 4 rows of mul and lt")
    ctx["mulcmp_inputs"] = (c, e8a, e8b, e32a, e32b)
    return dict(keygen_ms=keygen_ms, encrypt_ms=enc_ms, mul_ms=mul_ms, lt_ms=lt_ms,
                max_ms=max_ms, eq_ms=eq_ms, sub_ms=sub_ms, decrypt_mul_ms=dec_ms,
                mul_clmul_launches=len(shapes), lt_clmul_launches=len(ctx["lt_shapes"]),
                u8_pairs=n8, u32_pairs=n32)


# Phase 3c: balanced widths of the sweep, and the smaller widths of the chunk
# route's Ls x 4Ls products; rows chosen so that every shape has about
# ROUTE_PAIRS (limb, limb) pairs
ROUTE_SWEEP_LS = (32, 48, 64, 96, 128, 192, 256, 384, 512, 1024, 2048, 4096)
ROUTE_CHUNK_LS = (64, 128, 256, 512, 1024)
ROUTE_PAIRS = 1 << 27


def route_case(ctx, Ls, Lg):
    """One Karatsuba level (or the chunk route and one level under it) of
    [B, Ls] x [B, Lg] against one direct K1 launch: device time of all
    records (K1, R1 and R2), each one's share, and the time per call."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    B = -(-ROUTE_PAIRS // (Ls * (Lg + 1)))
    a, b = random_words(ctx, (B, Ls)), random_words(ctx, (B, Lg))

    def direct():
        return k.clmul_flat(a, b)

    def routed():  # the threshold at Ls: exactly one split below the chunks
        return with_env(k.KARATSUBA_MIN_ENV, Ls, lambda: k.clmul_rows(a, b))

    got, want = routed(), direct()
    torch.cuda.synchronize()
    bad, _ = compare(torch, got, want)
    check(bad == 0, f"route {Ls}x{Lg} at B={B}: {bad} limbs differ from the direct launch")
    del got, want
    iters = 5
    rec_d, rec_r = profiled(direct, iters), profiled(routed, iters)
    k1, r1, r2 = (None, None, None) if rec_r is None else (
        by_name(rec_r, key) / iters for key in ("clmul", "route_split", "route_join"))
    row = dict(Ls=Ls, Lg=Lg, B=B, pairs=B * Ls * (Lg + 1),
               steps=[s[0] for s in k.route_plan(Ls, Lg, Ls)],
               direct_ms=None if rec_d is None else sum(rec_d.values()) / iters,
               routed_ms=None if rec_r is None else sum(rec_r.values()) / iters,
               routed_k1_ms=k1, routed_r1_ms=r1, routed_r2_ms=r2,
               direct_call_ms=call_ms(torch, direct, 10),
               routed_call_ms=call_ms(torch, routed, 10))
    row["routed_glue_ms"] = None if rec_r is None else row["routed_ms"] - k1
    log(f"[route] {Ls}x{Lg} B={B} {'+'.join(row['steps'])}: direct {ms_text(row['direct_ms'])} "
        f"ms, routed {ms_text(row['routed_ms'])} ms (K1 {ms_text(k1)} + glue "
        f"{ms_text(row['routed_glue_ms'])}: R1 {ms_text(r1)}, R2 {ms_text(r2)}); per call {row['direct_call_ms']:.5f} / "
        f"{row['routed_call_ms']:.5f} ms; equal")
    return row


def by_name(records, key):
    """Device ms of the records whose name holds ``key``: "clmul" (K1),
    "route_split" (R1), "route_join" (R2), "csa_level_in" (C1),
    "csa_level_out" (C2), "ripple_step" (C3)."""
    return sum(v for name, v in records.items() if key in name)


def crossover(rows):
    """The smallest Ls from which the routed product wins at every larger
    width of the sweep (None if it never does), over the rows whose device
    times were measured."""
    best = None
    measured = [r for r in rows if r["direct_ms"] is not None and r["routed_ms"] is not None]
    for r in sorted(measured, key=lambda r: -r["Ls"]):
        if r["routed_ms"] >= r["direct_ms"]:
            break
        best = r["Ls"]
    return best


def phase_route_sweep(ctx):
    """Phase 3c: where one Karatsuba level starts to beat a direct launch."""
    from homomorph_tpu_torch.gf2 import kernels as k

    balanced = [route_case(ctx, Ls, Ls) for Ls in ROUTE_SWEEP_LS]
    chunked = [route_case(ctx, Ls, 4 * Ls) for Ls in ROUTE_CHUNK_LS]
    out = dict(balanced=balanced, chunked=chunked, crossover=crossover(balanced),
               chunk_crossover=crossover(chunked), threshold=k._KARATSUBA_MIN)
    log(f"[route] measured crossover {out['crossover']} limbs (chunk route "
        f"{out['chunk_crossover']}); _KARATSUBA_MIN in the code {k._KARATSUBA_MIN}")
    return out


def wide_mul(ctx, ht, name, params, n, desc, bits, direct_rows, seed):
    """Checked multiplication of ``n`` random pairs at ``params``, decrypted
    and asserted; ``direct_rows`` rows again with the route off (every
    product one direct K1 launch), equal limb for limb."""
    import numpy as np

    torch, dev = ctx["torch"], ctx["dev"]
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.models import HomomorphicMultiplication as Mul

    rng = np.random.default_rng(seed)
    c, keygen_ms = stage(torch, lambda: seeded_context(ht, params, seed, dev))
    xs = rng.integers(0, 2**bits, size=n, dtype=np.uint64)
    ys = rng.integers(0, 2**bits, size=n, dtype=np.uint64)
    (ea, eb), enc_ms = stage(torch, lambda: (c.encrypt(xs.tolist(), desc, batch=True),
                                             c.encrypt(ys.tolist(), desc, batch=True)))
    req = Mul.requirement_for(ea, eb)
    check(req * params.delta <= params.d, f"{name}: requirement {req} above d/delta")
    torch.cuda.reset_peak_memory_stats()
    before = counters["K1"]
    (prod, mul_ms), shapes = recorded_products(lambda: stage(torch, lambda: c.apply2(Mul, ea, eb)))
    launches = counters["K1"] - before
    peak = torch.cuda.max_memory_allocated() / 1e9
    sk = c.get_secret_key()
    _, mask_ms = stage(torch, lambda: sk.decrypt_mask(prod.num_limbs))
    mask_dev_ms = profiled_ms(lambda: gf2.decrypt_mask(sk.limbs, sk.degree, prod.num_limbs), 1)
    got, dec_ms = stage(torch, lambda: np.array(c.decrypt(prod).tolist(), dtype=np.uint64))
    want = (xs * ys) % (1 << bits)
    check(np.array_equal(got, want), f"{name}: {int((got != want).sum())} of {n} products wrong")

    r = direct_rows
    da = ht.Ciphered(ea.limbs[:r], ea.bound, desc, noise=ea.noise)
    db = ht.Ciphered(eb.limbs[:r], eb.bound, desc, noise=eb.noise)
    before = counters["K1"]
    direct, direct_ms = with_env(k.KARATSUBA_MIN_ENV, 1 << 30,
                                 lambda: stage(torch, lambda: c.apply2(Mul, da, db)))
    direct_launches = counters["K1"] - before
    check(direct.limbs.shape == prod.limbs[:r].shape
          and bool((direct.limbs == prod.limbs[:r]).all())
          and (direct.bound, direct.noise) == (prod.bound, prod.noise),
          f"{name}: direct K1 product differs from the routed one on {r} rows")
    kmin = k.karatsuba_min()
    leaves = [leaf_shape(*s, kmin) for s in shapes]
    stats = dict(params=[params.d, params.dp, params.delta, params.tau], pairs=n,
                 requirement=req, keygen_ms=keygen_ms, encrypt_ms=enc_ms, mul_ms=mul_ms,
                 mask_ms=mask_ms, mask_device_ms=mask_dev_ms, decrypt_ms=dec_ms,
                 product_limbs=list(prod.limbs.shape),
                 bound=prod.bound, noise=prod.noise, peak_gb=peak, k1_launches=launches,
                 products=len(shapes),
                 route_levels=sum(len(k.route_plan(min(s[1:]), max(s[1:]), kmin)) for s in shapes),
                 direct_rows=r, direct_ms=direct_ms, direct_k1_launches=direct_launches,
                 widest_product=list(max(shapes, key=lambda s: s[1] + s[2])),
                 busiest_product=list(max(shapes, key=lambda s: clmul_ops(*s))),
                 widest_leaf=list(max(leaves, key=lambda s: (s[1] + s[2], s[0]))),
                 busiest_leaf=list(max(leaves, key=lambda s: clmul_ops(*s))))
    log(f"[wide] {name} at {params}, {n} pairs (requirement {req}): keygen {keygen_ms:.3f} ms, "
        f"encrypt {enc_ms:.3f} ms, checked mul {mul_ms:.3f} ms ({len(shapes)} products, "
        f"{launches} K1 launches, {stats['route_levels']} route levels; product "
        f"{list(prod.limbs.shape)}, bound {prod.bound}, noise {prod.noise}; peak {peak:.3f} GB), "
        f"decrypt mask {mask_ms:.3f} ms wall, {ms_text(mask_dev_ms, 3)} ms device (on the card), "
        f"decrypt {dec_ms:.3f} ms; all right; {r} rows with "
        f"the route off {direct_ms:.3f} ms ({direct_launches} K1 launches), equal limb for limb")
    log(f"[wide] {name}: widest product {stats['widest_product']}, busiest "
        f"{stats['busiest_product']}; K1 launches: widest {stats['widest_leaf']}, busiest "
        f"{stats['busiest_leaf']}")
    return stats, (c, ea, eb, prod), shapes


# Phase 3b: thresholds at which the u16 product is timed end to end (the last
# one turns the route off)
U16_THRESHOLDS = (32, 48, 64, 96, 128, 256, 1 << 30)


def threshold_scan(ctx, c, ea, eb, prod):
    """The u16 product end to end at each of :data:`U16_THRESHOLDS`: wall
    time, device time (all records) and K1's share; the same limbs each
    time.  A measurement, not a gate on the timing."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.models import HomomorphicMultiplication as Mul

    out = []
    for kmin in U16_THRESHOLDS:
        def run():
            return with_env(k.KARATSUBA_MIN_ENV, kmin, lambda: c.apply2(Mul, ea, eb))

        got, _ = stage(torch, run)
        check(torch.equal(got.limbs, prod.limbs), f"u16 at threshold {kmin}: limbs differ")
        del got
        _, wall = stage(torch, run)
        rec = profiled(run)
        k1 = None if rec is None else sum(v for name, v in rec.items() if "clmul" in name)
        out.append(dict(kmin=kmin, wall_ms=wall, device_ms=None if rec is None else sum(rec.values()),
                        k1_ms=k1))
        log(f"[wide] u16 at threshold {kmin}: wall {wall:.3f} ms, device "
            f"{ms_text(out[-1]['device_ms'], 3)} ms (K1 {ms_text(k1, 3)} ms); same limbs")
    return out


def phase_wide(ctx):
    """Phase 5c: u16 and u32 multiplication, sum, popcount, clamp, shifts,
    rotates and ``abs_``."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicPopCount, HomomorphicSum, circuits

    torch, seed = ctx["torch"], ctx["seed"] + 40
    out = {}
    out["u16"], ctx["u16_inputs"], ctx["u16_shapes"] = wide_mul(
        ctx, ht, "u16", ht.Parameters(1024, 128, 1, 128), 512, ht.U16, 16, 2, seed)
    out["u32"], (c32, a32, b32, p32), ctx["u32_shapes"] = wide_mul(
        ctx, ht, "u32", ht.Parameters(2432, 128, 1, 128), 8, ht.U32, 32, 1, seed + 1)
    ctx["u32_inputs"] = (c32, a32, b32)
    del p32

    # the N-ary sum and the popcount, checked, at the u16 product's parameters
    rng = np.random.default_rng(seed + 2)
    n = 1024
    c = ctx["u16_inputs"][0]
    rows8 = rng.integers(0, 256, size=(8, n))
    v32 = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    ops8 = [c.encrypt(r.tolist(), ht.U8, batch=True) for r in rows8]
    e32 = c.encrypt(v32.tolist(), ht.U32, batch=True)
    (sm, sum_ms), (pc, pop_ms) = (stage(torch, lambda: c.apply_n(HomomorphicSum, ops8)),
                                  stage(torch, lambda: c.apply1(HomomorphicPopCount, e32)))
    lo, hi = (c.encrypt([v] * n, ht.U8, batch=True) for v in (40, 200))
    cl, clamp_ms = stage(torch, lambda: circuits.clamp(ops8[0], lo, hi))
    checks = (("sum of 8 u8", sm, rows8.sum(axis=0) % 256),
              ("u32 popcount", pc, np.array([bin(int(v)).count("1") for v in v32])),
              ("u8 clamp", cl, np.clip(rows8[0], 40, 200)))
    for label, cph, want in checks:
        got = np.array(c.decrypt(cph).tolist(), dtype=np.int64)
        check(np.array_equal(got, want), f"{label}: {int((got != want).sum())} of {n} wrong")
    out["sum_popcount_clamp"] = dict(
        params=[1024, 128, 1, 128], batch=n, sum_ms=sum_ms, popcount_ms=pop_ms,
        clamp_ms=clamp_ms, sum_requirement=HomomorphicSum.requirement_for(*ops8),
        popcount_requirement=HomomorphicPopCount.requirement_for(e32))
    log(f"[wide] Parameters(1024, 128, 1, 128), {n} rows: checked sum of 8 u8 {sum_ms:.3f} ms "
        f"(requirement {out['sum_popcount_clamp']['sum_requirement']}), checked u32 popcount "
        f"{pop_ms:.3f} ms (requirement {out['sum_popcount_clamp']['popcount_requirement']}), "
        f"u8 clamp {clamp_ms:.3f} ms; all right")
    del ops8, e32, sm, pc, cl, lo, hi

    # the plaintext-amount remaps and abs_ on i8, at the add path's parameters
    c = ctx["add_inputs"][0]
    i8 = rng.integers(-128, 128, size=n)
    i8[:2] = (-128, 127)
    e8 = c.encrypt(i8.tolist(), ht.I8, batch=True)
    u8 = (i8 % 256).astype(np.int64)

    def wrap(v):
        return ((v + 128) % 256) - 128

    remaps = {
        "shl": (lambda: circuits.shl(e8, 3), wrap((u8 << 3) % 256)),
        "shr": (lambda: circuits.shr(e8, 3), i8 >> 3),  # arithmetic for i8
        "rotl": (lambda: circuits.rotl(e8, 3), wrap(((u8 << 3) | (u8 >> 5)) % 256)),
        "rotr": (lambda: circuits.rotr(e8, 3), wrap(((u8 >> 3) | (u8 << 5)) % 256)),
        "abs_": (lambda: circuits.abs_(e8), wrap(np.abs(i8))),
    }
    remap_ms = {}
    for label, (fn, want) in remaps.items():
        cph, remap_ms[label] = stage(torch, fn)
        got = np.array(c.decrypt(cph).tolist(), dtype=np.int64)
        check(np.array_equal(got, want), f"i8 {label}: {int((got != want).sum())} of {n} wrong")
    out["remaps"] = dict(params=[128, 128, 1, 128], batch=n, ms=remap_ms)
    log(f"[wide] Parameters(128, 128, 1, 128), {n} i8: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in remap_ms.items()) + "; all right")

    return out


def phase_exp_enc(ctx):
    """Phase 6b: the encrypt experiment's entry at its full size."""
    from homomorph_tpu_torch.experiments import exp_enc

    out = exp_enc.run(bits=1 << 21, device=ctx["dev"])
    for name, r in out["rows"].items():
        check(r["mismatches"] == 0, f"exp_enc {name}: {r['mismatches']} limbs differ from K2")
        log(f"[exp_enc] {name}: {r['ms']:.4f} ms per step (draw + encrypt), "
            f"{r['bits_per_s']:,.0f} bits/s; equal to pallas_v2")
    return out


def mul_shape_rows(ctx):
    """Phase 3b: K1 at the busiest shapes of the u8 multiplication: its
    first launch (the broadcast partial products), and the launch with the
    most work among stacked groups (more rows than the batch: CSA levels,
    the ripple's g products) and among single products (the ripple chain);
    and at the busiest launch of the u32 ``lt``, after timing each distinct
    ``lt`` launch shape alone (which of them make ``lt`` device-bound)."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    shapes = ctx["mul_shapes"]
    n = ctx["mulcmp_inputs"][1].limbs.shape[0]
    groups = [s for s in shapes[1:] if s[0] > n]
    singles = [s for s in shapes[1:] if s[0] == n]
    check(groups and singles, f"unexpected multiplication launches {shapes}")
    lt_shapes = ctx["lt_shapes"]
    check(lt_shapes, "lt launched no clmul")
    lt_times = []
    for shape in sorted(set(lt_shapes), key=lambda s: -clmul_ops(*s)):
        B, La, Lb = shape
        a, b = random_words(ctx, (B, La)), random_words(ctx, (B, Lb))
        ms = profiled_ms(lambda: k.clmul_flat(a, b), 5)
        lt_times.append(dict(shape=list(shape), launches=lt_shapes.count(shape), ms=ms))
        del a, b
    ctx["lt_launch_times"] = lt_times
    log(f"[kernels] lt's {len(lt_shapes)} clmul launches by shape (B, La, Lb), count, kernel "
        "ms: " + "; ".join(f"{tuple(t['shape'])} x{t['launches']} {ms_text(t['ms'])}"
                           for t in lt_times))
    rows = clmul_rows(ctx, (("mul-pp", *shapes[0]),
                            ("mul-group", *max(groups, key=lambda s: clmul_ops(*s))),
                            ("mul-chain", *max(singles, key=lambda s: clmul_ops(*s))),
                            ("lt-busiest", *max(lt_shapes, key=lambda s: clmul_ops(*s)))))
    kmin = k.karatsuba_min()
    u16 = [leaf_shape(*s, kmin) for s in ctx["u16_shapes"]]
    u32 = [leaf_shape(*s, kmin) for s in ctx["u32_shapes"]]
    picks = (("u16-busiest", u16, max(u16, key=lambda s: clmul_ops(*s))),
             ("u32-widest", u32, max(u32, key=lambda s: (s[1] + s[2], s[0]))))
    new = clmul_rows(ctx, [(label, *shape) for label, _, shape in picks], plain_events=True)
    for row, (_, leaves, shape) in zip(new, picks):
        row["launches_per_product"] = leaves.count(shape)  # of one checked multiplication
    return rows + new


def widest_product(ctx):
    """The u32 product's widest operands at their real row count: one
    direct K1 launch against the route, device time of each, equal."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    B, La, Lb = max(ctx["u32_shapes"], key=lambda s: (s[1] + s[2], s[0]))
    a, b = random_words(ctx, (B, La)), random_words(ctx, (B, Lb))
    got, want = k.clmul_rows(a, b), k.clmul_flat(a, b)
    torch.cuda.synchronize()
    bad, _ = compare(torch, got, want)
    check(bad == 0, f"u32 widest product {B}x{La}x{Lb}: {bad} limbs differ, route against K1")
    out = dict(shape=[B, La, Lb], direct_ms=profiled_ms(lambda: k.clmul_flat(a, b), 2),
               routed_ms=profiled_ms(lambda: k.clmul_rows(a, b), 2),
               leaf=list(leaf_shape(B, La, Lb, k.karatsuba_min())))
    log(f"[kernels] u32 widest product B={B} {La}x{Lb}: one direct K1 launch "
        f"{ms_text(out['direct_ms'])} ms, routed (launch {out['leaf']}) "
        f"{ms_text(out['routed_ms'])} ms; equal")
    return out


def route_bytes(B, Ls, Lg, steps):
    """HBM bytes of R1 and of R2 as functions (``exp_route.function_bytes``)
    and of R2's launches (``join_launches``: the ascent reads the leaves'
    products and writes its nodes' products, a level alone and the chunk
    step each read their input and write their output)."""
    from homomorph_tpu_torch.experiments.exp_route import function_bytes
    from homomorph_tpu_torch.gf2 import kernels as k

    rows, w = k.leaf_rows(B, steps)
    n, h, lo = k._levels(steps)
    rows0 = B * max(n, 1)
    launches = 0
    for top, tile, _ in k.join_launches(B, steps):
        if top < 0:
            launches += 4 * (rows0 * 2 * Ls + B * (Ls + Lg))
        else:
            read = rows * 2 * w if tile else rows0 * 3 ** (top + 1) * 2 * h[top]
            launches += 4 * (read + rows0 * 3 ** top * lo[top])
    return (*function_bytes(B, Ls, Lg, steps), launches)


def route_kernel_rows(ctx):
    """Phase 3b: R1 and R2 against their plain versions (the level-by-level
    torch glue, on the card) at the u16 product's busiest route and the u32
    product's widest, as phase 5c recorded them, and at the widest of the
    d = 5888 u32 product and of the u64 product (``exp_route.ROUTES``, held
    to the shapes phases 10e and 10c record), each checked, timed and
    bounded by ``exp_route.route_kernels`` (R2: its whole launch plan), with
    R1's plan and R2's launches and their bytes beside."""
    from homomorph_tpu_torch.experiments.exp_route import ROUTES, route_kernels
    from homomorph_tpu_torch.gf2 import kernels as k

    u16 = max(ctx["u16_shapes"], key=lambda s: clmul_ops(*s))
    u32 = max(ctx["u32_shapes"], key=lambda s: (s[1] + s[2], s[0]))
    picks = [("u16-busiest", u16), ("u32-widest", u32)] + [
        (label, (B, Ls, Lg)) for label, B, Ls, Lg in ROUTES if label in WIDEST_ROUTES]
    rows = []
    for label, (B, La, Lb) in picks:
        Ls, Lg = min(La, Lb), max(La, Lb)
        steps = k.route_plan(Ls, Lg, k.karatsuba_min())
        check(steps, f"the {label} product {B}x{La}x{Lb} takes no route level")
        got = route_kernels(label, B, Ls, Lg, ctx["peaks"]["hbm_bw"])
        check(got["R1"]["mismatches"] + got["R2"]["mismatches"] == 0,
              f"route kernels at {label} {B}x{Ls}x{Lg}: R1 {got['R1']['mismatches']}, "
              f"R2 {got['R2']['mismatches']} mismatches")
        launch_bytes = route_bytes(B, Ls, Lg, steps)[2]
        leaf = got["leaves"]
        shape = f"B={B} Ls={Ls} Lg={Lg} -> leaves [{leaf[0]}, {leaf[1]}] x2"
        plan = k.join_launches(B, steps)
        for name, kernel, extra in (
                ("R1", "route_split", dict(shape=shape, split_plan=list(k.split_plan(B, steps)))),
                ("R2", "route_join", dict(
                    shape=shape.replace("leaves", "products of"),
                    launches_per_product=got["R2"]["launches"], launch_plan=plan,
                    launch_bytes=launch_bytes,
                    launch_bound_ms=launch_bytes / ctx["peaks"]["hbm_bw"] * 1e3))):
            m = got[name]
            rows.append(dict(
                kernel=kernel, label=label, mismatches=m["mismatches"],
                max_abs_err=m["max_abs_err"], steps=got["steps"],
                **{key: m[key] for key in ("ms", "ms_by", "call_ms", "plain_ms", "plain_by")},
                work=[], old_ops=0, old_rate="int32_ops", bytes=m["bytes"], **extra))
        for r in rows[-2:]:
            log(f"[kernels] {r['kernel']} {label} {r['shape']}: mismatches {r['mismatches']}, "
                f"kernel {r['ms']} ms by {r['ms_by']} (call {r['call_ms']} ms), plain "
                f"{r['plain_ms']} ms by {r['plain_by']}" + (
                    f"; {r['launches_per_product']} launches {plan}, their own bytes' bound "
                    f"{r['launch_bound_ms']:.5f} ms" if r["kernel"] == "route_join"
                    else f"; depth and group {r['split_plan']}"))
    return set_bounds(ctx, rows)


#: the labels of ``exp_route.ROUTES`` phase 3b adds to the recorded routes,
#: and the path whose widest product each is
WIDEST_ROUTES = {"d5888-widest": "bench", "u64-widest": "u64"}


def widest_route_checked(label, shapes):
    """Hold a path's widest recorded product to its ``exp_route.ROUTES``
    entry (phase 3b timed R1 and R2 there)."""
    from homomorph_tpu_torch.experiments.exp_route import ROUTES

    B, La, Lb = max(shapes, key=lambda s: (s[1] + s[2], s[0]))
    want = [r[1:] for r in ROUTES if r[0] == label][0]
    check((B, min(La, Lb), max(La, Lb)) == want,
          f"{label}: the path's widest product is {B}x{La}x{Lb}, not {want} as phase 3b took it")
    return [B, La, Lb]


def torch_glue_rows(af, bf):
    """The clmul dispatcher as the port ran it before R1 and R2: the same
    route, with the level-by-level torch glue on the card around K1 (the
    "before" of phase 7's product stages)."""
    from homomorph_tpu_torch.gf2 import kernels as k

    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    steps = k.route_plan(small.shape[1], big.shape[1], k.karatsuba_min())
    if not steps or af.shape[0] == 0:
        return k.clmul_flat(af, bf)
    leaf_s, leaf_g = k._split_levels(small, big, steps)
    return k._join_levels(k.clmul_flat(leaf_s, leaf_g), small.shape[0], steps)


def with_torch_glue(fn):
    """``fn()`` with the dispatcher's route glue as torch ops (:func:`torch_glue_rows`)."""
    from homomorph_tpu_torch.gf2 import kernels as k

    rows = k.clmul_rows
    k.clmul_rows = torch_glue_rows
    try:
        return fn()
    finally:
        k.clmul_rows = rows


def with_per_op_glue(fn):
    """``fn()`` with the circuits' glue one torch op a bit, as the port ran it
    before C1-C3 (``circuits._csa_accumulate_per_op``, ``add_per_op``): the
    "before" of phase 7's stages and phase 10f's reference."""
    from homomorph_tpu_torch.models import circuits

    saved = circuits._csa_accumulate, circuits.add
    circuits._csa_accumulate, circuits.add = circuits._csa_accumulate_per_op, circuits.add_per_op
    try:
        return fn()
    finally:
        circuits._csa_accumulate, circuits.add = saved


def same_as_per_op(ctx, label, fn):
    """Hold ``fn()`` (a circuit from its plan) to the per-op glue's output:
    limbs, bound and noise."""
    torch = ctx["torch"]
    got = fn()
    want = with_per_op_glue(fn)
    check(got.limbs.shape == want.limbs.shape and torch.equal(got.limbs, want.limbs)
          and (got.bound, got.noise) == (want.bound, want.noise),
          f"{label}: the plan's output differs from the per-op glue's")
    log(f"[glue] {label}: {list(got.limbs.shape)}, bound {got.bound}, noise {got.noise}: "
        "equal to the per-op glue's limb for limb")
    return got


#: device records of phase 7's product stages by kernel: K1, R1, R2, C1-C3
#: (csrc/circuit.cu) and the rest
STAGE_KERNELS = ("clmul", "route_split", "route_join", "csa_level_in", "csa_level_out",
                 "ripple_step")


def circuit_kernel_rows(ctx):
    """Phase 3b: C1, C2 and C3 (``csrc/circuit.cu``) against their plain
    version (``circuit_kernels.xor_rows_plain``, on the card) on random limbs
    at the programs the paths give them (``experiments/exp_circuit.py``:
    recorded on the meta device): the u16 product's busiest level and step,
    the u32 product's (d = 2432) widest, the u64 product's busiest and its
    first level (692 ops: three launches of C1), and C1's stack of each
    product's lanes; each timed as in phase 3, bounded by its bytes."""
    from homomorph_tpu_torch.experiments import exp_circuit

    torch = ctx["torch"]
    kernels = {"C1": "csa_level_in", "C2": "csa_level_out", "C3": "ripple_step",
               "C1 stack": "csa_level_in"}
    cases = []
    for path, widest, label in (("u16", False, "u16-busiest"), ("u32", True, "u32-widest"),
                                ("u64", False, "u64-busiest")):
        for name, rec in exp_circuit.picks(path, widest).items():
            cases.append((label + (" stack" if "stack" in name else ""), kernels[name], rec))
    first = exp_circuit.described(next(r for r in exp_circuit.recorded_programs("u64")
                                       if r["kernel"] == "csa_level_in"))
    check(first["launches"] == 3, f"the u64 product's first level takes {first['launches']} "
          "launches of C1, not 3")
    cases.append(("u64-first-level", "csa_level_in", first))
    rows = []
    for seed, (label, kernel, rec) in enumerate(cases):
        bad, err, run_kernel, run_plain = exp_circuit.kernel_case(rec, ctx["dev"], seed)
        check(bad == 0, f"{kernel} {label}: {bad} limbs differ from the plain version")
        shape = (f"{rec['prog'].shape[0]} ops x {rec['rows']} rows, widest {rec['width']} limbs, "
                 f"{rec['launches']} launch(es)")
        rows.append(dict(kernel=kernel, label=label, shape=shape, mismatches=bad,
                         max_abs_err=err, **timed(torch, run_kernel, run_plain, plain_events=True),
                         work=[], old_ops=0, old_rate="int32_ops", bytes=rec["bytes"],
                         launches_per_call=rec["launches"]))
        r = rows[-1]
        log(f"[kernels] {kernel} {label} {shape}: mismatches {bad}, kernel {r['ms']} ms by "
            f"{r['ms_by']} (call {r['call_ms']} ms), plain {r['plain_ms']} ms by {r['plain_by']}, "
            f"{rec['bytes']} bytes")
        del run_kernel, run_plain
    torch.cuda.empty_cache()
    return set_bounds(ctx, rows)


def phase_glue(ctx):
    """Phase 10f: the bench's u32 product (d = 5888, 8 pairs) and the u64
    product (d = 13440, one pair) from their plans against the per-op glue
    (limbs, bound, noise), each decrypted under a key with ``S(0) = 1``."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models import circuits

    out = {}
    for label, params, desc, bits, n in (("d5888", (5888, 128, 1, 128), ht.U32, 32, 8),
                                         ("u64", (13440, 128, 1, 128), ht.U64, 64, 1)):
        c = context(params, CHECK_SEED, ctx["dev"])
        rng = np.random.default_rng(ctx["seed"] + bits)
        xs = [int(v) for v in rng.integers(0, 2**bits, size=n, dtype=np.uint64)]
        ys = [int(v) for v in rng.integers(0, 2**bits, size=n, dtype=np.uint64)]
        a, b = (c.encrypt(v, desc, batch=True) for v in (xs, ys))
        prod = same_as_per_op(ctx, f"{label} product", lambda: circuits.mul_unsigned(a, b))
        got = [int(v) for v in c.decrypt(prod)]
        check(got == [x * y % 2**bits for x, y in zip(xs, ys)], f"{label} product decrypts wrong")
        out[label] = dict(shape=list(prod.limbs.shape), bound=prod.bound, noise=prod.noise)
        del prod, a, b, c
        ctx["torch"].cuda.empty_cache()
    return out


def phase_profile(ctx, main_stats, bulk_stats, mul_stats, wide_stats):
    """Warm wall time, device time by kernel and the device's busy share of
    the checked add, the first bulk round trip, the u8 multiplication, the
    u32 comparison and the u16 and u32 multiplications.  Each stage runs once more
    unprofiled for its warm wall time (phases 5-6, 5b and 5c ran it cold),
    then under
    ``torch.profiler`` (:func:`profiled`); the busy share is the profiled
    device time over the warm wall time, null with the device time when the
    profiler traced nothing."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import (
        HomomorphicAddition, HomomorphicLessThan, HomomorphicMultiplication,
    )

    torch = ctx["torch"]
    c, ca, cb = ctx["add_inputs"]
    bc, vals, bct = ctx["bulk_inputs"]
    mc, e8a, e8b, e32a, e32b = ctx["mulcmp_inputs"]
    wc, w16a, w16b, _ = ctx["u16_inputs"]
    xc, w32a, w32b = ctx["u32_inputs"]
    for label, fn in (("u16 product", lambda: wc.apply2(HomomorphicMultiplication, w16a, w16b)),
                      ("u32 product", lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b)),
                      ("u32 add", lambda: c.apply2(HomomorphicAddition, ca, cb))):
        same_as_per_op(ctx, label, fn)
    stages = {
        "mul_u16": (lambda: wc.apply2(HomomorphicMultiplication, w16a, w16b),
                    wide_stats["u16"]["mul_ms"]),
        "mul_u16_per_op": (lambda: with_per_op_glue(
            lambda: wc.apply2(HomomorphicMultiplication, w16a, w16b)), None),
        "mul_u16_torch_glue": (lambda: with_torch_glue(
            lambda: wc.apply2(HomomorphicMultiplication, w16a, w16b)), None),
        "mul_u32": (lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b),
                    wide_stats["u32"]["mul_ms"]),
        "mul_u32_torch_glue": (lambda: with_torch_glue(
            lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b)), None),
        "mul_u32_per_op": (lambda: with_per_op_glue(
            lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b)), None),
        "mul_u8": (lambda: mc.apply2(HomomorphicMultiplication, e8a, e8b), mul_stats["mul_ms"]),
        "lt_u32": (lambda: mc.apply2(HomomorphicLessThan, e32a, e32b), mul_stats["lt_ms"]),
        "add": (lambda: c.apply2(HomomorphicAddition, ca, cb), main_stats["add_ms"]),
        "add_per_op": (lambda: with_per_op_glue(
            lambda: c.apply2(HomomorphicAddition, ca, cb)), None),
        "bulk_encrypt": (lambda: bc.encrypt(vals.tolist(), ht.U32, batch=True),
                         bulk_stats[0]["encrypt_ms"]),
        "bulk_decrypt": (lambda: bc.decrypt(bct), bulk_stats[0]["decrypt_ms"]),
    }
    out = {}
    for name, (fn, cold_ms) in stages.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        per_kernel = profiled(fn) or {}
        dev_ms = sum(per_kernel.values()) if per_kernel else None
        busy = None if dev_ms is None else dev_ms / warm_ms
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[name] = dict(cold_ms=cold_ms, warm_ms=warm_ms, device_ms=dev_ms,
                         busy_share=busy, top=top)
        if name.startswith(("mul_u16", "mul_u32", "add")):
            # the product and add stages' device time by kernel: K1, R1, R2,
            # C1-C3 and the rest (the circuit's own torch ops, and the torch
            # glue where it runs)
            split = {key: by_name(per_kernel, key) for key in STAGE_KERNELS}
            split["other"] = (dev_ms or 0.0) - sum(split.values())
            out[name].update(device_by_kernel=split if per_kernel else None,
                             device_records=device_launches(fn))
            log(f"[profile] {name}: device by kernel " + ", ".join(
                f"{ms_text(dev_ms and split[key], 3)} {key}" for key in split)
                + f" ms; {out[name]['device_records']} device records a call")
        log(f"[profile] {name}: cold {ms_text(cold_ms, 3)} ms, warm {warm_ms:.3f} ms wall, device "
            f"{ms_text(dev_ms, 3)} ms (busy {'not measured' if busy is None else f'{busy:.1%}'}); "
            "top: " + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
    return out


def phase_verify(ctx):
    """The verify gate (``run_verification``) in full, scaled round trip
    included, on the card; each check's line logged."""
    import homomorph_tpu_torch as ht

    lines = []

    def gate_log(*parts):
        lines.append(" ".join(str(p) for p in parts))
        log(f"[verify] {lines[-1]}")

    _, ms = stage(ctx["torch"], lambda: ht.run_verification(log=gate_log))
    log(f"[verify] run_verification(quick=False, scaled=True) passed in {ms:.3f} ms")
    return dict(ms=ms, lines=lines)


# (label, key, limbs): the decrypt-mask classes of the paths, up to the
# bench's u32 product (d = 5888) and the u64 product (d = 13440); a key is
# the name of a context in ctx, or a degree whose key comes from CHECK_SEED
MASK_CLASSES = (("d128-L9", "add_inputs", 9), ("d1024-L65", "u16_inputs", 65),
                ("d1024-L8192", "u16_inputs", 8192), ("d2432-L98304", "u32_inputs", 98304),
                ("d5888-L262144", 5888, 262144), ("d13440-L3145728", 13440, 3145728))
#: the widest class whose native mask is also held against the Python-int
#: recurrence (3.1M big-int steps; the wider classes would take minutes)
PYTHON_MASK_LIMBS = 98304
#: bit positions at the end of the widest class held against ``X^i mod S``
#: by square-and-multiply on Python integers
MASK_TAIL_BITS = 64


def x_pow_mod(e, s_int, d):
    """``X^e mod S`` on Python integers (``S`` of exact degree ``d``): a
    square in GF(2)[X] spreads the bits (bit ``j`` to bit ``2j``), then
    the reduction XORs ``S`` under each bit from ``2d`` down to ``d``."""
    def reduce(p):
        while p.bit_length() > d:
            p ^= s_int << (p.bit_length() - 1 - d)
        return p

    r = 1
    for bit in bin(e)[2:]:
        r = reduce(int("0".join(bin(r)[2:]), 2))
        if bit == "1":
            r = reduce(r << 1)
    return r


def mask_tail(sk, n_limbs, bits):
    """The last ``bits`` mask bits of the class, ``(X^i mod S)(0)`` for the
    last ``bits`` positions ``i``, from :func:`x_pow_mod` and the monic
    recurrence after it, packed as ``bits / 32`` limbs."""
    import numpy as np

    from homomorph_tpu_torch.gf2 import poly as gf2

    s_int = int.from_bytes(gf2.limbs_to_bytes(sk.limbs), "little")
    d = sk.degree
    r = x_pow_mod(32 * n_limbs - bits, s_int, d)
    out = 0
    for i in range(bits):
        out |= (r & 1) << i
        r <<= 1
        if r >> d & 1:
            r ^= s_int
    return np.frombuffer(out.to_bytes(bits // 8, "little"), dtype="<u4").astype(np.uint32)


def device_launches(fn, traces=3):
    """Device records (kernels, copies, fills) one call of ``fn`` makes, from
    ``torch.profiler``: the most any of ``traces`` traces holds (a trace can
    lose records), after one warm-up call; None when no trace held any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
        most = max(most, sum(ev.device_type == DeviceType.CUDA for ev in prof.events()))
    return most or None


def plan_bound_ms(plan, Ls, shapes, peaks):
    """The least ms of a plan's steps: for an M3 or M2 step the product's
    work under the best design in the repo for it (``newton_step_work``:
    M2's comb pairs or the Karatsuba route's leaf pairs, whichever are
    fewer; over the whole card) against the fused step's HBM bytes, and
    the route steps' products at their leaf shapes (``products_sol`` of
    ``shapes``) plus M1's bytes."""
    secs, prev = products_sol(shapes, peaks), 1
    for kind, k in plan:
        Lo = -(-k // 32)
        Li = -(-prev // 32)
        if kind == "route":
            secs += square_bytes(1, Li, Lo) / peaks["hbm_bw"]
        else:
            smem, ops = newton_step_work(Lo, Ls)
            secs += bound((Li + Lo + (Ls if kind == "M2" else 0)) * 4,
                          [(smem, "smem_bw"), (ops, "int32_ops")], peaks)[0]
        prev = k
    return secs * 1e3


def mask_class_route(ctx, sk, n_limbs, sstar, plan):
    """One route of a class's mask (``mask_kernel.series_mask`` by ``plan``
    from the cached ``S*``): its first call's wall (cold), the kernels'
    launch counters of that call, the products it sent to the clmul
    dispatcher, and its bound."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    torch = ctx["torch"]

    def run():
        return mk.series_mask(sstar, sk.degree, n_limbs, plan)

    before = mk.launch_counts()
    (w, cold_ms), shapes = recorded_products(lambda: stage(torch, run))
    counts = {name: n - before[name] for name, n in mk.launch_counts().items()}
    kinds = {kind: sum(1 for kd, _ in plan if kd == kind) for kind in ("M3", "M2", "route")}
    return dict(run=run, w=w, cold_ms=cold_ms, counters=counts, steps=kinds,
                products=len(shapes),
                leaf_limb_pairs=sum(B * Ls * (Lg + 1) for B, Ls, Lg in
                                    (leaf_shape(*sh) for sh in shapes)),
                bound_ms=plan_bound_ms(plan, sstar.shape[0], shapes, ctx["peaks"]))


def phase_masks(ctx):
    """Phase 10, a path of its own: the decrypt masks of the paths' classes
    on the card, up to the u64 product's 3,145,728 limbs, through the plan
    (``mask_kernel.mask_plan``: M3, then M2 or the route) and through PR
    10's route forced (every step M1 and K1), each from the cached ``S*``:
    both against the native host engine word for word at every class, the
    native engine against the Python-int recurrence up to
    :data:`PYTHON_MASK_LIMBS`, and the widest class's last
    :data:`MASK_TAIL_BITS` bits against ``X^i mod S`` by square-and-multiply.
    For each route: synchronised wall cold (its first call at the class)
    and warm (median of 3, the routes in turns), device time, device
    records a call (:func:`device_launches`), the kernels' counters, and
    the bound (:func:`plan_bound_ms`); the native engine's host time.
    Returns (stats, each class's ``(label, key, limbs)``)."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import native
    from homomorph_tpu_torch.experiments.common import CHECK_SEED
    from homomorph_tpu_torch.gf2 import mask_kernel as mk
    from homomorph_tpu_torch.gf2 import poly as gf2

    torch = ctx["torch"]
    native.library()  # built and loaded before the clock starts

    def median_ms(fn, reps):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return res, sorted(walls)[reps // 2]

    out, keys = [], []
    for label, source, n_limbs in MASK_CLASSES:
        if isinstance(source, str):
            sk = ctx[source][0].get_secret_key()
        else:
            sk = ht.SecretKey.random(source, ht.ThreefrySource(CHECK_SEED), device=ctx["dev"])
            check(int(sk.limbs[0].item()) & 1, f"mask {label}: the key has S(0) = 0")
        host = gf2.to_numpy(sk.limbs)
        d, s0 = sk.degree, int(host[0]) & 1
        sstar = mk.reversed_key(sk.limbs, d)
        plan = mk.mask_plan(d, n_limbs)
        routes = {"plan": mask_class_route(ctx, sk, n_limbs, sstar, plan),
                  "route": mask_class_route(ctx, sk, n_limbs, sstar,
                                            [("route", k) for _, k in plan])}
        warm = {name: [] for name in routes}
        for _ in range(3):
            for name, r in routes.items():
                warm[name].append(stage(torch, r["run"])[1])
        for name, r in routes.items():
            r["warm_ms"] = sorted(warm[name])[1]
            r["device_ms"] = profiled_ms(r["run"], 1)
            r["device_launches"] = device_launches(r["run"])
        check(torch.equal(sk.decrypt_mask(n_limbs), routes["plan"]["w"]),
              f"mask {label}: the key's cached mask differs from the plan's")
        got = gf2.to_numpy(routes["plan"]["w"])
        check(np.array_equal(got, gf2.to_numpy(routes["route"]["w"])),
              f"mask {label}: the plan's mask differs from the route's")
        small = n_limbs <= 1024  # a single call is too short for the host clock
        reps = 21 if small else 3 if n_limbs <= 262144 else 1
        fast, native_ms = median_ms(lambda: native.decrypt_mask(host, d, n_limbs), reps)
        check(np.array_equal(got, fast), f"mask {label}: the device route differs from native "
              f"at {int((got != fast).sum())} of {n_limbs} limbs")
        row = dict(label=label, degree=d, s0=s0, limbs=n_limbs, native_ms=native_ms,
                   native_reps=reps, kinds=[kind for kind, _ in plan],
                   **{name: {key: v for key, v in r.items() if key not in ("run", "w")}
                      for name, r in routes.items()})
        if n_limbs <= PYTHON_MASK_LIMBS:
            plain, python_ms = median_ms(lambda: gf2.decrypt_mask_words(host, d, n_limbs),
                                         21 if small else 1)
            check(np.array_equal(fast, plain),
                  f"mask {label}: native differs from the Python-int recurrence")
            row["python_ms"] = python_ms
        else:
            tail = mask_tail(sk, n_limbs, MASK_TAIL_BITS)
            check(np.array_equal(got[-MASK_TAIL_BITS // 32:], tail),
                  f"mask {label}: the last {MASK_TAIL_BITS} bits differ from X^i mod S")
        for name, r in routes.items():
            log(f"[masks] {label} (S(0) = {s0}) {name}: steps {r['steps']}, cold "
                f"{r['cold_ms']:.4f} ms, warm {r['warm_ms']:.4f} ms, device "
                f"{ms_text(r['device_ms'], 4)} ms, {r['device_launches']} device records a call, "
                f"counters {r['counters']}, {r['leaf_limb_pairs']:,} leaf limb pairs, bound "
                f"{r['bound_ms']:.4f} ms")
        log(f"[masks] {label}: native {native_ms:.4f} ms (median of {reps}), "
            f"{native_ms / routes['plan']['warm_ms']:.1f}x the plan's warm wall, "
            f"{native_ms / routes['route']['warm_ms']:.1f}x the route's; equal word for word"
            + (f"; Python ints {row['python_ms']:.4f} ms, equal to native" if "python_ms" in row
               else f"; the last {MASK_TAIL_BITS} bits equal X^i mod S"))
        out.append(row)
        keys.append((label, sk, n_limbs))
        del routes, got, fast
    return out, keys


def mask_kernel_rows(ctx, keys):
    """M1, M2 and M3 against their plain versions on the card (launches
    that do not count on any path).  M1 at the route's last squaring of
    the same classes (timed as in phase 3) and at edge shapes (one limb, odd
    tails, rows whose addresses are not 16-byte aligned, a whole square),
    checked only.  M2 at the last step of each class of a generated key
    (d = 5888, 13440) on a random
    series of the step's input width: equal to ``newton_step_plain``, and
    at the u64 class on its first and last :data:`SPOT_ROWS` limbs (the
    plain version of the whole step would materialize 10 GB).  M3 at the
    9- and 65-limb classes (the whole mask) and at the cap of the u64 key."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.gf2 import mask_kernel as mk
    from homomorph_tpu_torch.gf2 import poly as gf2

    for B, L, n_bits, offset in ((1, 1, 1, 0), (3, 7, 200, 0), (5, 33, None, 0),
                                 (2, 9, 288, 0), (1, 1000, 1500, 1), (1, 4096, 262143, 1)):
        x = random_words(ctx, (B, L + offset))[:, offset:]
        x = x if B == 1 else x.contiguous()
        got = mk.square(x, n_bits)
        torch.cuda.synchronize()
        bad, _ = compare(torch, got, mk.square_plain(x, n_bits))
        check(bad == 0, f"square [{B}, {L}] to {n_bits} bits (offset {offset}): {bad} mismatches")
    log("[masks] M1 equals square_plain at the edge shapes (one limb, odd tails, unaligned rows)")
    rows, small_cases = [], []
    generated = {label for label, source, _ in MASK_CLASSES if not isinstance(source, str)}
    for label, sk, n_limbs in keys:
        if label not in generated:
            continue
        d = sk.degree
        m = 32 * n_limbs - d
        k_prev, k_last = mk.precisions(m)[-2:]
        L, Lo = -(-k_prev // 32), -(-k_last // 32)
        Ls = gf2.limbs_for(d)
        x = random_words(ctx, (1, L))
        got = mk.square(x, m)
        torch.cuda.synchronize()
        bad, err = compare(torch, got, mk.square_plain(x, m))
        check(bad == 0, f"square {label} [1, {L}] -> [1, {Lo}]: {bad} mismatches")
        rows.append(dict(
            kernel="square", label=label, shape=f"B=1 L={L} Lo={Lo} bits={m}",
            mismatches=bad, max_abs_err=err,
            **timed(torch, lambda: mk.square(x, m), lambda: mk.square_plain(x, m)),
            work=[(Lo * SQUARE_OPS_PER_LIMB, "int32_ops")], old_ops=Lo * SQUARE_OPS_PER_LIMB,
            old_rate="int32_ops", bytes=square_bytes(1, L, Lo),
        ))
        sstar = mk.reversed_key(sk.limbs, d)
        inv = x.view(-1)
        got = mk.newton_step(inv, sstar, m)
        torch.cuda.synchronize()
        if Lo * Ls <= 1 << 28:
            bad, err = compare(torch, got, mk.newton_step_plain(inv, sstar, m))
            times = timed(torch, lambda: mk.newton_step(inv, sstar, m),
                          lambda: mk.newton_step_plain(inv, sstar, m))
        else:
            n = SPOT_ROWS
            j0 = Lo - n - Ls - 1  # output limb j reads the square from limb j - Ls - 1 up
            sq = mk.square_plain(inv.view(1, -1), m)[:, j0:]
            tail = k.clmul_plain(sstar.view(1, -1), sq)[0, Lo - n - j0 : Lo - j0]
            check(m % 32 == 0, f"{label}: the spot check takes a last step of whole limbs")
            bad0, err0 = compare(torch, got[:n], mk.newton_step_plain(inv[: n // 2], sstar, 32 * n))
            bad1, err1 = compare(torch, got[-n:], tail)
            bad, err = bad0 + bad1, max(err0, err1)
            traced = profiled_ms(lambda: mk.newton_step(inv, sstar, m), 20)
            calls = call_ms(torch, lambda: mk.newton_step(inv, sstar, m))
            times = dict(ms=calls if traced is None else traced,
                         ms_by="events" if traced is None else "profiler", call_ms=calls,
                         plain_ms=None, plain_by="not measured")
        check(bad == 0, f"newton_step {label} [{L}] -> [{Lo}] by S* [{Ls}]: {bad} mismatches")
        smem, ops = newton_step_work(Lo, Ls)
        rows.append(dict(
            kernel="newton_step", label=label, shape=f"Li={L} Ls={Ls} Lo={Lo} bits={m}",
            mismatches=bad, max_abs_err=err, checked="all" if Lo * Ls <= 1 << 28 else
            f"first and last {SPOT_ROWS} limbs", **times,
            work=[(smem, "smem_bw"), (ops, "int32_ops")], old_ops=comb_pairs(Lo, Ls) * 64,
            old_rate="int32_ops", bytes=(L + Ls + Lo) * 4,
        ))
        if label == "d13440-L3145728":
            small_cases.append((f"{label}-cap", sstar, 32 * mk.SMALL_CAP, None))
        del x, got, inv
    for label, sk, n_limbs in keys[:2]:
        small_cases.append((label, mk.reversed_key(sk.limbs, sk.degree),
                            32 * n_limbs - sk.degree, (sk.degree, n_limbs)))
    for label, sstar, n_bits, assemble in small_cases:
        got = mk.series_small(sstar, n_bits, assemble)
        torch.cuda.synchronize()
        bad, err = compare(torch, got, mk.series_small_plain(sstar, n_bits, assemble))
        check(bad == 0, f"series_small {label}: {bad} mismatches")
        Ls = sstar.shape[0]
        work = [newton_step_work(-(-kk // 32), Ls) for kk in mk.precisions(n_bits)]
        pairs = sum(comb_pairs(-(-kk // 32), Ls) for kk in mk.precisions(n_bits))
        rows.append(dict(
            kernel="series_small", label=label,
            shape=f"Ls={Ls} bits={n_bits} steps={len(mk.precisions(n_bits))} "
                  f"out={got.shape[0]}" + (" (mask)" if assemble else ""),
            mismatches=bad, max_abs_err=err,
            **timed(torch, lambda: mk.series_small(sstar, n_bits, assemble),
                    lambda: mk.series_small_plain(sstar, n_bits, assemble)),
            work=[(sum(w[0] for w in work), "smem_bw"), (sum(w[1] for w in work), "int32_ops")],
            old_ops=pairs * 64, old_rate="int32_ops", bytes=(Ls + got.shape[0]) * 4,
        ))
    for r in rows:
        log(f"[kernels] {r['kernel']} {r['label']} {r['shape']}: mismatches {r['mismatches']}, "
            f"kernel {r['ms']} ms by {r['ms_by']} (call {r['call_ms']} ms), plain "
            f"{ms_text(r['plain_ms'])} ms by {r['plain_by']}")
    return set_bounds(ctx, rows)


#: K1's launches on the paths before the mesh phase, as counted before the
#: limb-mesh hook existed in the clmul dispatcher (PERF.md section 6), and
#: before the decrypt masks moved to the card: the mask route's own K1
#: launches (the counter ``mask.K1``, the ``mask_clmul`` count of each
#: path) are taken off each path's K1 count before the check
K1_EARLIER_PATHS = {"add": 36, "mul_cmp": 47, "exp_enc": 1, "wide": 302, "verify": 39,
                    "compiled": 356}

# Phase 10b: the meshes of the bulk encrypt (four places on the one card)
MESH_BULK = (((128, 128, 64, 128), 1 << 21, ((4, 1), (2, 2), (1, 4))),
             ((1024, 1024, 64, 256), 1 << 20, ((1, 2),)))


def mesh_partials(ctx, sel, pk_limbs, shape, L):
    """X1 at one grid's partial shapes against its plain version, bit for
    bit: the first data block's rows of the first and the last tau shard,
    each on the planes of its shard's key rows and a zero plaintext, as
    ``sharded_encrypt_bits`` launches them.  Held one by one, so that a
    fault that is the same in every shard cannot cancel in the XOR of the
    partials.  The launches made here are taken back off the counters.
    Returns the mismatches over both shards."""
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import poly as gf2

    torch = ctx["torch"]
    (n_data, n_tau), (B, n, tau) = shape, sel.shape
    blk, ts = B // n_data, tau // n_tau
    zero = torch.zeros(blk * n, dtype=gf2.LIMB_DTYPE, device=sel.device)
    total = 0
    with counters.aside():
        for j in sorted({0, n_tau - 1}):
            rows = sel[:blk, :, j * ts:(j + 1) * ts].reshape(blk * n, ts).contiguous()
            planes = enc.pk_planes(enc.pk_columns(pk_limbs[j * ts:(j + 1) * ts].contiguous()))
            bad, err = compare(torch, enc.encrypt_sel_mma(rows, planes, zero, L),
                               enc.encrypt_sel_plain(rows, planes, zero, L))
            check(bad == 0, f"mesh {shape}: X1's partial of tau shard {j} ({blk * n} rows, "
                            f"{ts} key rows): {bad} limbs differ from its plain version")
            total += bad
            if j == 0:  # every shard's partial has this shape: time it once
                mesh_x1_row(ctx, shape, rows, planes, zero, L, bad, err)
            del rows, planes
    return total


def mesh_x1_row(ctx, shape, rows, planes, zero, L, bad, err):
    """X1 at a grid's partial shape: device time, call time, its plain
    version's time, its bound and ``torch._int_mm``'s time for the bare
    count product, as phase 3's X1 rows; kept in ``ctx["mesh_x1_rows"]``."""
    import torch.nn.functional as F

    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc

    torch = ctx["torch"]
    B, ts = rows.shape
    D, Kp = planes.shape
    row = dict(
        kernel="encrypt_v3", label=f"mesh{shape[0]}x{shape[1]}",
        shape=f"B={B} tau={ts} D={D} L={L} (mesh {shape[0]}x{shape[1]} partial)",
        mismatches=bad, max_abs_err=err,
        **timed(torch, lambda: enc.encrypt_sel_mma(rows, planes, zero, L),
                lambda: enc.encrypt_sel_plain(rows, planes, zero, L)),
        work=[(encrypt_lookup_bytes(B, ts, L), "smem_bw")], old_ops=2 * B * ts * D,
        old_rate="int8_tc_ops", bytes=B * ts + D * Kp + (B + B * L) * 4,
        int_mm_ms=int_mm_ms(ctx, F.pad(rows, (0, Kp - ts)), planes),
    )
    set_bounds(ctx, [row])
    ctx.setdefault("mesh_x1_rows", []).append(row)
    log(f"[mesh] X1 at the partial of mesh {shape}, {row['shape']}: kernel {row['ms']:.5f} ms "
        f"by {row['ms_by']} (call {row['call_ms']:.5f} ms), plain {row['plain_ms']:.3f} ms by "
        f"{row['plain_by']}, bound {row['bound_ms']:.5f} ms ({row['bound_by']}, "
        f"{row['bound_ms'] / row['ms']:.1%} of it), old count's bound {row['old_bound_ms']:.5f} "
        f"ms; torch._int_mm of the count product {ms_text(row['int_mm_ms'])} ms")


def mesh_bulk(ctx, params, n_bits, shapes, seed):
    """``sharded_encrypt_bits`` on each grid of places against K2's dense
    output on the same selections, bit for bit, and decrypted through
    ``sharded_decrypt_bits``; K2's dense output against its plain version
    and X1 at each grid's partial shapes against its own
    (:func:`mesh_partials`); device time (X1's share), X1 launches and the
    exchange primitive's bytes per grid."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.parallel import bulk, make_mesh, ppermute

    torch, dev = ctx["torch"], ctx["dev"]
    c = seeded_context(ht, params, seed, dev)
    pk, sk = c.get_public_key(), c.get_secret_key()
    tau, L, n = params.tau, gf2.limbs_for(pk.max_degree), 32
    selw = random_words(ctx, (n_bits, -(-tau // 32)))
    sel = gf2.unpack_bits(selw, tau, dtype=torch.int8).view(n_bits // n, n, tau)
    plain = torch.randint(0, 2, (n_bits // n, n), dtype=torch.int32, device=dev,
                          generator=ctx["gen"])
    dense = enc.encrypt_words_table(selw, pk.limbs, plain.view(-1), L)
    bad, _ = compare(torch, dense, enc.encrypt_plain(selw, enc.pk_planes(enc.pk_columns(pk.limbs)),
                                                     plain.view(-1), L))
    check(bad == 0, f"mesh {params}: K2's dense output has {bad} limbs that differ from its plain "
                    "version")
    dense_ms = profiled_ms(lambda: enc.encrypt_words_table(selw, pk.limbs, plain.view(-1), L), 3)
    w = sk.decrypt_mask(L)
    rows = []
    for shape in shapes:
        cfg = make_mesh(*shape, [dev] * (shape[0] * shape[1]))
        partial_bad = mesh_partials(ctx, sel, pk.limbs, shape, L)

        def run():
            return bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, plain, L)

        x1 = counters["X1"]
        ppermute.local_bytes = ppermute.cross_bytes = 0
        out, wall = stage(torch, run)
        x1 = counters["X1"] - x1
        moved = (ppermute.local_bytes, ppermute.cross_bytes)
        bad, _ = compare(torch, out.view(-1, L), dense)
        check(bad == 0, f"mesh {shape} {params}: {bad} limbs differ from K2's dense output")
        back = bulk.sharded_decrypt_bits(cfg, out, w)
        check(torch.equal(back, plain), f"mesh {shape} {params}: decrypts wrong")
        del out, back
        rec = profiled(run) or {}
        dev_ms = sum(rec.values()) if rec else None
        x1_ms = sum(v for k, v in rec.items() if "encrypt_wgmma" in k) if rec else None
        top = sorted(rec.items(), key=lambda kv: -kv[1])[:5]
        rows.append(dict(params=[params.d, params.dp, params.delta, params.tau], bits=n_bits,
                         mesh=list(shape), tau_slice=tau // shape[1], limbs=L, x1_launches=x1,
                         local_bytes=moved[0], cross_bytes=moved[1], mismatches=bad,
                         partial_mismatches=partial_bad,
                         wall_ms=wall, device_ms=dev_ms, x1_ms=x1_ms, dense_k2_ms=dense_ms,
                         top=top))
        log(f"[mesh] {params} {n_bits} bits, mesh {shape} (tau slice {tau // shape[1]}): "
            f"0 mismatches against K2, decrypts right, X1's first and last tau shard's partials "
            f"equal its plain version; {x1} X1 launches "
            f"({ms_text(x1_ms)} ms of X1 device time, {ms_text(None if x1_ms is None else x1_ms / x1)} "
            f"ms a launch), device {ms_text(dev_ms)} ms, wall {wall:.3f} ms; exchanged "
            f"{moved[0]} bytes within the process, {moved[1]} across; dense K2 "
            f"{ms_text(dense_ms)} ms; top: " + "; ".join(f"{k[:40]} {v:.4f} ms" for k, v in top))
    del sel, selw, dense
    return rows


def phase_mesh(ctx):
    """Phase 10b: the sharded pipelines on grids of places on the one card:
    the bulk meshes (:data:`MESH_BULK`), a sharded context's checked u32 add
    against an unsharded one under the same seed, and the checked u32
    product under a limb mesh of four places against the dense product."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicMultiplication
    from homomorph_tpu_torch.parallel import Mesh, limbmul, make_mesh, ppermute

    torch, dev, seed = ctx["torch"], ctx["dev"], ctx["seed"]
    out = dict(bulk=[])
    for params, n_bits, shapes in MESH_BULK:
        out["bulk"] += mesh_bulk(ctx, ht.Parameters(*params), n_bits, shapes, seed + 30)
        torch.cuda.synchronize()

    # (c) Context(sharding=make_mesh(2, 2)): u32 add, bytes against one place
    c, _, _ = ctx["add_inputs"]
    xs, ys = ctx["add_values"]
    sh = ht.Context(c.parameters, encrypt_seed=seed + 40, sharding=make_mesh(2, 2, [dev] * 4),
                    device=dev)
    one = ht.Context(c.parameters, encrypt_seed=seed + 40, device=dev)
    for cc in (sh, one):
        cc.set_secret_key(c.get_secret_key())
        cc.set_public_key(c.get_public_key())
    def pair(cc):
        return cc.encrypt(xs.tolist(), ht.U32, batch=True), cc.encrypt(ys.tolist(), ht.U32,
                                                                         batch=True)

    x1 = counters["X1"]
    (sa, sb), enc_cold = stage(torch, lambda: pair(sh))
    x1 = counters["X1"] - x1
    (oa, ob), one_cold = stage(torch, lambda: pair(one))
    check(torch.equal(sa.limbs, oa.limbs) and torch.equal(sb.limbs, ob.limbs)
          and sa.to_bytes() == oa.to_bytes(),
          "sharded context: ciphertext bytes differ from the unsharded context's")
    # warm, in turns (the contexts' key chains move on: these are new pairs)
    walls = {"sharded": [], "one": []}
    for name in ("one", "sharded", "sharded", "one", "one", "sharded"):
        walls[name].append(stage(torch, lambda: pair(sh if name == "sharded" else one))[1])
    enc_ms, one_ms = sorted(walls["sharded"])[1], sorted(walls["one"])[1]
    s, add_ms = stage(torch, lambda: sh.apply2(HomomorphicAddition, sa, sb))
    got = np.array(sh.decrypt(s).tolist(), dtype=np.uint64)
    check(s.sharding == sa.sharding and np.array_equal(got, (xs + ys) % (1 << 32)),
          "sharded context: u32 add decrypts wrong or lost its sharding")
    out["context_add"] = dict(pairs=len(xs), x1_launches=x1, encrypt_cold_ms=enc_cold,
                              dense_encrypt_cold_ms=one_cold, encrypt_ms=enc_ms,
                              dense_encrypt_ms=one_ms, walls=walls, add_ms=add_ms)
    log(f"[mesh] Context(sharding=make_mesh(2, 2)) at {c.parameters}, {len(xs)} u32 pairs: "
        f"ciphertext bytes equal the unsharded context's, sums right; encrypting both operands "
        f"{enc_cold:.3f} ms cold ({x1} X1 launches), warm median {enc_ms:.3f} ms; unsharded "
        f"{one_cold:.3f} cold, {one_ms:.3f} ms warm; checked add {add_ms:.3f} ms")
    del sa, sb, oa, ob, s

    # (d) the checked u32 product under a limb mesh of four places
    xc, w32a, w32b = ctx["u32_inputs"]
    dense, dense_ms = stage(torch, lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b))
    hook = limbmul.maybe_sharded_clmul
    lmesh = Mesh([dev] * 4, (limbmul.LIMB_AXIS,))
    k1 = counters["K1"]
    ppermute.local_bytes = ppermute.cross_bytes = hook.taken = hook.planned_bytes = 0
    with limbmul.use_limb_mesh(lmesh):
        prod, mesh_ms = stage(torch, lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b))
    k1 = counters["K1"] - k1
    moved = ppermute.local_bytes, ppermute.cross_bytes
    taken, expect = hook.taken, hook.planned_bytes
    check(taken > 0, "no product of the u32 multiplication took the limb mesh")
    check(torch.equal(prod.limbs, dense.limbs) and (prod.bound, prod.noise) == (
        dense.bound, dense.noise), "limb mesh: the u32 product differs from the dense product")
    check(moved == (expect, 0),
          f"limb mesh: the primitive moved {moved} bytes, comm_bytes_per_call says {expect}")
    xa = np.array(xc.decrypt(w32a).tolist(), dtype=np.uint64)
    xb = np.array(xc.decrypt(w32b).tolist(), dtype=np.uint64)
    got = np.array(xc.decrypt(prod).tolist(), dtype=np.uint64)
    check(np.array_equal(got, (xa * xb) % (1 << len(prod))),
          "limb mesh: the u32 product decrypts wrong")
    del prod, dense
    with limbmul.use_limb_mesh(lmesh):
        mesh_dev = profiled_ms(lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b), 1)
    dense_dev = profiled_ms(lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b), 1)
    out["limb_mul_u32"] = dict(pairs=len(got), products_sharded=taken, k1_launches=k1,
                               primitive_bytes=moved[0], comm_bytes_per_call=expect,
                               mesh_ms=mesh_ms, dense_ms=dense_ms, mesh_device_ms=mesh_dev,
                               dense_device_ms=dense_dev)
    log(f"[mesh] u32 product at {xc.parameters}, {len(got)} pairs, limb mesh of 4 places: "
        f"equal to the dense product limb for limb, decrypts right; {taken} products "
        f"took the mesh, {k1} K1 launches; the primitive moved {moved[0]} bytes, "
        f"comm_bytes_per_call sums to {expect}; wall {mesh_ms:.3f} ms (dense {dense_ms:.3f} ms), "
        f"device {ms_text(mesh_dev, 3)} ms (dense {ms_text(dense_dev, 3)} ms)")
    return out


#: rows at each end of a K1 launch that :func:`k1_spot_checked` holds
#: against the plain version
SPOT_ROWS = 256


def k1_spot_checked(ctx, label, fn):
    """``(fn(), checks)``: K1's launch with the most rows in ``fn`` and its
    widest (most limbs) are held against ``clmul_plain`` on their first and
    last :data:`SPOT_ROWS` rows.  The rows are copied right after each
    launch, before the route joins and frees its output; launches under
    CUDA graph capture are not copied.  While ``fn`` runs, the kernels
    module's ``clmul_flat`` is a wrapper that calls the real one, which
    counts each launch."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    real = k.clmul_flat
    kept = {}

    def spy(af, bf):
        out = real(af, bf)
        if out.is_cuda and out.shape[0] and not torch.cuda.is_current_stream_capturing():
            B, width = af.shape[0], out.shape[1]
            for key, size in (("most rows", (B, width)), ("widest", (width, B))):
                if key not in kept or size > kept[key]["size"]:
                    ends = (slice(0, min(B, SPOT_ROWS)), slice(max(0, B - SPOT_ROWS), B))
                    kept[key] = dict(size=size, shape=[B, af.shape[1], bf.shape[1]],
                                     blocks=[(af[e].clone(), bf[e].clone(), out[e].clone())
                                             for e in ends])
        return out

    k.clmul_flat = spy
    try:
        result = fn()
    finally:
        k.clmul_flat = real
    torch.cuda.synchronize()
    check(kept, f"{label}: no K1 launch to check")
    checks = []
    for key, rec in kept.items():
        bad = sum(compare(torch, got, k.clmul_plain(a, b))[0] for a, b, got in rec["blocks"])
        rows = sum(a.shape[0] for a, _, _ in rec["blocks"])
        check(bad == 0, f"{label}: K1's {key} launch {rec['shape']}: {bad} limbs differ from "
              "the plain version")
        checks.append(dict(launch=key, shape=rec["shape"], rows_checked=rows, mismatches=0))
        log(f"[{label}] K1's {key} launch [rows, La, Lb] = {rec['shape']}: first and last "
            f"{SPOT_ROWS} rows equal to the plain version")
    return result, checks


def phase_u64(ctx):
    """Phase 10c: the u64 product at ``Parameters(13440, 128, 1, 128)``
    (``homomorph_tpu_torch.experiments.exp_mul64``): keygen, the eager tree,
    its K1 launches and peak memory, the decrypt mask's wall and device time, the
    decrypt against ``x * y mod 2^64`` under a key with ``S(0) = 1`` (inside
    the envelope, so every coefficient of the product counts), and a warm
    call's wall and device time, also by kernel.  K1's largest and widest
    launches are held against the plain version (:func:`k1_spot_checked`),
    and the widest product to the route phase 3b timed."""
    from homomorph_tpu_torch.experiments import exp_mul64

    torch = ctx["torch"]
    torch.cuda.empty_cache()
    (out, spots), shapes = recorded_products(lambda: k1_spot_checked(ctx, "u64", lambda: exp_mul64.run(
        device=ctx["dev"], log=lambda m: log(f"[u64] {m.strip()}"))))
    check(out["correct"], "the u64 product decrypts wrong")
    check(out["s0"] == 1, "the u64 key has S(0) = 0: its decrypt reads only the constant term")
    split = out["tree_device_by_kernel"]
    log(f"[u64] eager device time by kernel: K1 {split['K1']:.3f}, R1 {split['R1']:.3f}, "
        f"R2 {split['R2']:.3f}, other {split['other']:.3f} ms")
    torch.cuda.empty_cache()
    return dict(out, k1_spot_checks=spots, widest_product=widest_route_checked("u64-widest", shapes))


def phase_entry(ctx):
    """Phase 10d: the entry points (``homomorph_tpu_torch.entry``):
    ``entry()``'s step on the card (checked by decrypt inside, and again
    here), and ``dryrun_multichip(4)`` on four places on the card."""
    import numpy as np

    from homomorph_tpu_torch import entry

    fn, args = entry.entry(ctx["dev"])
    out_x, out_m = fn(*args)
    a, b = (x.cpu().numpy() for x in args[2:])
    check(np.array_equal(out_x.cpu().numpy(), a ^ b) and np.array_equal(out_m.cpu().numpy(), a & b),
          "entry(): the gate layer decrypts wrong")
    dry = entry.dryrun_multichip(4, ctx["dev"])
    log(f"[entry] entry(): XOR and AND of 256x32 bits decrypt right; dryrun_multichip(4): {dry}")
    return dict(entry_shapes=[list(out_x.shape), list(out_m.shape)], dryrun=dry)


def phase_bench(ctx):
    """Phase 10e: the port's bench (``homomorph_tpu_torch.bench``) at full
    size with ``--with-mul32``: the verify gate, then every section; its
    JSON line is printed here.  The u16 and u32 products must decrypt right
    under keys with ``S(0) = 1`` (the bench exits 1 otherwise), K1's largest
    and widest launches must equal the plain version
    (:func:`k1_spot_checked`), and every device-busy field must be a
    number."""
    from homomorph_tpu_torch import bench

    def bench_log(*a):
        log("[bench] " + " ".join(str(x) for x in a))

    try:
        (result, spots), shapes = recorded_products(lambda: k1_spot_checked(
            ctx, "bench", lambda: bench.run(bench.parse_args(["--with-mul32"]), bench_log)))
    except SystemExit as err:
        raise SmokeFailure(f"the bench exited with {err.code}") from err
    widest = widest_route_checked("d5888-widest", shapes)
    print(json.dumps(result), flush=True)
    busy = {k: v for part in (result["extras"], result["headline"]) for k, v in part.items()
            if "device_busy" in k or k == "decrypt_u32_device_latency_us"}
    check(all(v is not None for v in busy.values()), f"bench: device fields not measured: {busy}")
    check("mul_u32_per_s_batched" in result["extras"] and "mul_u16_per_s_batched"
          in result["extras"], "bench: the u16 or u32 product did not run")
    with open(result["extras"]["windows_file"]) as f:
        windows = json.load(f)
    for label, w in windows.items():
        log(f"[bench] window {label}: p50 {w['p50_s_per_step']:.9f} s, p95 "
            f"{w['p95_s_per_step']:.9f} s, min {w['min_s_per_step']:.9f} s a step "
            f"({w['windows']} x {w['steps_per_window']})")
    return dict(result, windows=windows, k1_spot_checks=spots, widest_product=widest)


def launch_counts(ctx):
    return {name: counters[key] for name, key in ctx["wrappers"].items()}


def compiled_case(ctx, name, graphed, call, eager_fn, meta_fn, replays=5):
    """Eager's warm wall time (median of 3, before any capture: a capture
    empties the allocator's cache, which the next eager calls refill), the
    output metadata's derivation on the meta device alone (the circuit's
    Python without device work), a compiled callable's first call (meta,
    warm-up, capture, replay), the median wall time of ``replays`` more and
    one replay's device time.  The launch counters move at the first call
    (the warm-up, and the capture's manifest at its replay) and by the
    manifest at each replay after it.  Returns (stats, first output, last
    output, eager output)."""
    torch = ctx["torch"]
    eager_walls = []
    for _ in range(3):
        eager, ms = stage(torch, eager_fn)
        eager_walls.append(ms)
    _, meta_ms = stage(torch, meta_fn)
    before = launch_counts(ctx)
    first, capture_ms = stage(torch, call)
    mid = launch_counts(ctx)
    walls = []
    for _ in range(replays):
        out, ms = stage(torch, call)
        walls.append(ms)
    (manifest,) = graphed.manifests
    want = {k: n + replays * manifest.get(ctx["wrappers"][k], 0) for k, n in mid.items()}
    check(launch_counts(ctx) == want, f"compiled {name}: {replays} replays counted "
          f"{launch_counts(ctx)} from {mid}, not their manifest's {manifest}")
    stats = dict(eager_ms=sorted(eager_walls)[1], eager_walls_ms=eager_walls, meta_ms=meta_ms,
                 capture_ms=capture_ms, replay_ms=sorted(walls)[len(walls) // 2],
                 replays_ms=walls, replay_device_ms=profiled_ms(call, 1), graphs=graphed.graphs,
                 captured_launches={k: mid[k] - before[k] for k in mid})
    log(f"[compiled] {name}: eager median {stats['eager_ms']:.3f} ms of "
        f"{[round(w, 3) for w in eager_walls]}, metadata on the meta device {meta_ms:.3f} ms, "
        f"first call (meta, warm-up, capture, replay) {capture_ms:.3f} ms, replay median "
        f"{stats['replay_ms']:.3f} ms of {[round(w, 3) for w in walls]}, one replay's device "
        f"time {ms_text(stats['replay_device_ms'], 3)} ms; launches at warm-up and capture "
        f"{stats['captured_launches']}")
    return stats, first, out, eager


def profiler_after_graphs(ctx):
    """Whether ``torch.profiler`` still records device time after the CUDA
    graphs (not a gate): the u32 product's widest direct K1 launch and a
    small one, each traced once."""
    torch = ctx["torch"]
    from homomorph_tpu_torch.gf2 import kernels as k

    out = {}
    for label, (B, La, Lb) in (("u32-widest", max(ctx["u32_shapes"], key=lambda s: s[1] + s[2])),
                               ("add-chain", (2048, 9, 256))):
        a, b = random_words(ctx, (B, La)), random_words(ctx, (B, Lb))
        out[label] = profiled_ms(lambda: k.clmul_flat(a, b), 2)
        log(f"[profiler] after the graphs, direct K1 {label} {B}x{La}x{Lb}: "
            f"{ms_text(out[label])} ms")
        del a, b
        torch.cuda.synchronize()
    return out


def phase_compiled(ctx):
    """Compiled pipelines on the card: the u32 add (2,048 pairs) and the u32
    product (8 pairs) as CUDA graphs against eager, limb for limb and
    decrypted, and the u32 add's encrypt -> add -> decrypt round trip under
    a new key at every call."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicMultiplication
    from homomorph_tpu_torch.models.compiled import _derive_meta, compile_op2, compile_roundtrip

    torch = ctx["torch"]
    out = {}
    c, ca, cb = ctx["add_inputs"]
    xs, ys = ctx["add_values"]
    xc, w32a, w32b = ctx["u32_inputs"]
    cases = (("add_u32", c, HomomorphicAddition, ca, cb, lambda x, y: (x + y) % (1 << 32)),
             ("mul_u32", xc, HomomorphicMultiplication, w32a, w32b,
              lambda x, y: (x * y) % (1 << 32)))
    for name, cc, op, a, b, plain_fn in cases:
        bound = cc.parameters.pk_degree
        fn = compile_op2(op, ht.U32, bound)
        stats, first, last, eager = compiled_case(
            ctx, name, fn.graphed, lambda: fn(a, b), lambda: cc.apply2(op, a, b),
            lambda: _derive_meta(op.unsafe_apply, bound, ht.U32, a.limbs.shape, b.limbs.shape))
        for got in (first, last):
            check(torch.equal(got.limbs, eager.limbs)
                  and (got.bound, got.noise, got.zero_lanes) == (eager.bound, eager.noise,
                                                                 eager.zero_lanes),
                  f"compiled {name}: limbs or metadata differ from eager")
        xa = np.array(cc.decrypt(a).tolist(), dtype=np.uint64)
        xb = np.array(cc.decrypt(b).tolist(), dtype=np.uint64)
        got = np.array(cc.decrypt(last).tolist(), dtype=np.uint64)
        check(np.array_equal(got, plain_fn(xa, xb)), f"compiled {name}: decrypts wrong")
        stats["pairs"] = len(got)
        out[name] = stats
        del fn, first, last, eager

    # the round trip: T1 (device key) -> K2 -> add -> decrypt in one graph
    fn = compile_roundtrip(c, HomomorphicAddition, ht.U32)

    def u32_bits(v):
        return np.unpackbits(v.astype("<u4").view(np.uint8).reshape(-1, 4), axis=1,
                             bitorder="little")

    bits_a, bits_b = u32_bits(xs), u32_bits(ys)
    key = [hrng.threefry_key(ctx["seed"])]
    outs = []

    def roundtrip():
        key[0] = hrng.threefry_split(key[0])[0]  # a new key every call
        outs.append(fn(key[0], bits_a, bits_b))
        return outs[-1]

    def eager():
        ea = c.encrypt(xs.tolist(), ht.U32, batch=True)
        eb = c.encrypt(ys.tolist(), ht.U32, batch=True)
        return c.apply2(HomomorphicAddition, ea, eb).decipher_bits(c.get_secret_key())

    L = gf2.limbs_for(c.get_public_key().max_degree)
    stats, _, _, _ = compiled_case(
        ctx, "roundtrip_add_u32", fn.graphed, roundtrip, eager,
        lambda: _derive_meta(HomomorphicAddition.unsafe_apply, c.get_public_key().max_degree,
                             ht.U32, bits_a.shape + (L,), bits_b.shape + (L,)))
    # the same replays with the plaintext bits already on the card: what the
    # two host-to-device copies of numpy bits cost a call
    dev_a, dev_b = (torch.from_numpy(b.astype(np.int32)).to(ctx["dev"]) for b in (bits_a, bits_b))
    walls = []
    for _ in range(5):
        key[0] = hrng.threefry_split(key[0])[0]
        o, ms = stage(torch, lambda: fn(key[0], dev_a, dev_b))
        outs.append(o)
        walls.append(ms)
    stats["replay_device_bits_ms"] = sorted(walls)[2]
    want = (xs + ys) % (1 << 32)
    for o in outs:
        packed = np.packbits(o.cpu().numpy().astype(np.uint8), axis=1, bitorder="little")
        check(np.array_equal(packed.view("<u4").reshape(-1), want),
              "compiled u32 add round trip: decrypts wrong")
    stats["pairs"] = len(xs)
    out["roundtrip_add_u32"] = stats
    log(f"[compiled] roundtrip_add_u32: replay median {stats['replay_device_bits_ms']:.3f} ms with "
        f"the bits on the card; {len(outs)} calls under {len(outs)} keys decrypt to the "
        f"{len(xs)} sums")

    out["roundtrip_add_u32_k3"] = with_env(
        enc.ENC_IMPL_ENV, "pallas_v1", lambda: roundtrip_k3(ctx, bits_a, bits_b, want))
    return out


def roundtrip_k3(ctx, bits_a, bits_b, want):
    """The u32 add's round trip captured under ``pallas_v1``: K3 encrypts
    (counted at warm-up and capture, K2 never); each replay, under a new
    key, equals the same function run eagerly on the same keys and
    decrypts to the sums."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import prng
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.models import HomomorphicAddition
    from homomorph_tpu_torch.models.compiled import compile_roundtrip

    torch = ctx["torch"]
    c = ctx["add_inputs"][0]
    fn = compile_roundtrip(c, HomomorphicAddition, ht.U32)
    dev_a, dev_b = (torch.from_numpy(b.astype(np.int32)).to(ctx["dev"]) for b in (bits_a, bits_b))
    key = hrng.threefry_key(ctx["seed"] + 1)
    before = launch_counts(ctx)
    walls = []
    for i in range(6):
        key = hrng.threefry_split(key)[0]
        out, ms = stage(torch, lambda: fn(key, dev_a, dev_b))
        if i:
            walls.append(ms)
        else:
            captured = {k: v - before[k] for k, v in launch_counts(ctx).items()}
        ka, kb = hrng.threefry_split(key)
        keys = torch.stack([prng.key_words(ka), prng.key_words(kb)]).to(ctx["dev"])
        check(torch.equal(out, fn.graphed._fn(keys, dev_a, dev_b)),
              "compiled round trip through K3: a replay differs from eager")
        packed = np.packbits(out.cpu().numpy().astype(np.uint8), axis=1, bitorder="little")
        check(np.array_equal(packed.view("<u4").reshape(-1), want),
              "compiled round trip through K3: decrypts wrong")
    check(captured["encrypt_v1"] > 0 and captured["encrypt"] == 0,
          f"compiled round trip under pallas_v1 captured {captured}")
    stats = dict(replay_ms=sorted(walls)[len(walls) // 2], replays_ms=walls,
                 replay_device_ms=profiled_ms(lambda: fn(key, dev_a, dev_b), 1),
                 captured_launches=captured, graphs=fn.graphed.graphs, pairs=len(want))
    log(f"[compiled] roundtrip_add_u32_k3 ({enc.ENC_IMPL_ENV}=pallas_v1): replay median "
        f"{stats['replay_ms']:.3f} ms with the bits on the card, one replay's device time "
        f"{ms_text(stats['replay_device_ms'], 3)} ms; 6 replays under 6 keys equal eager and decrypt "
        f"to the sums; launches at warm-up and capture {captured}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2
    from homomorph_tpu_torch.gf2 import cuda_build
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc

    dev = torch.device("cuda")
    ctx = dict(torch=torch, dev=dev, seed=SEED,
               gen=torch.Generator(device=dev).manual_seed(SEED))
    t_start = time.perf_counter()

    # 1. device line
    card = nvidia_smi("name,power.limit")
    log(card)
    ctx["peaks"] = peaks = chip_peaks()
    log(f"[device] {torch.cuda.get_device_name(0)}: {peaks['sms']} SMs, max SM clock "
        f"{peaks['mhz']:.0f} MHz -> INT32 {peaks['int32_ops'] / 1e12:.2f} Tops/s, shared memory "
        f"{peaks['smem_bw'] / 1e12:.2f} TB/s; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # 2. build
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] {', '.join(cuda_build.SOURCES)} built in {time.perf_counter() - t0:.3f} s")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma", "Performance")):
                log(f"[build] {name}: {line.strip()}")

    # 3-4. kernels against plain versions, fixture replay; the SM clock and
    # power beside the kernel times (a card below its clock runs them slower)
    clock_query = "clocks.sm,power.draw,temperature.gpu"
    clocks = {"before phase 3": nvidia_smi(clock_query)}
    t0 = time.perf_counter()
    rows = phase_kernels(ctx)
    square = phase_square_sweep(ctx)
    clocks["after phase 3"] = nvidia_smi(clock_query)
    log(f"[kernels] phase done in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sweep = phase_route_sweep(ctx)
    log(f"[route] phase done in {time.perf_counter() - t0:.3f} s")
    phase_fixtures(ctx)

    # 5-6, 5b, 6b. the paths, each with its launch counts from 0
    # each wrapper's name in the logs, and its counter
    ctx["wrappers"] = wrappers = {
        "clmul": "K1", "encrypt": "K2", "encrypt_v1": "K3", "encrypt_v3": "X1",
        "threefry": "T1", "threefry_dkey": "T1.dkey", "square": "M1", "newton_step": "M2",
        "series_small": "M3", "mask_clmul": "mask.K1", "route_split": "R1", "route_join": "R2",
        "csa_level_in": "C1", "csa_level_out": "C2", "ripple_step": "C3",
        "clmul_square": "K1.square", "clmul_square_tiled": "K1.square.tiled", "decipher": "D1"}

    def run_path(fn):
        before = launch_counts(ctx)
        t0 = time.perf_counter()
        out = fn()
        log(f"[paths] path done in {time.perf_counter() - t0:.3f} s")
        return out, {name: n - before[name] for name, n in launch_counts(ctx).items()}

    paths = {}
    torch.cuda.reset_peak_memory_stats()
    (main_stats, bulk_stats), paths["add"] = run_path(lambda: (phase_main(ctx), phase_bulk(ctx)))
    saved_impl = os.environ.get(enc.ENC_IMPL_ENV)
    os.environ[enc.ENC_IMPL_ENV] = "pallas_v1"  # this phase only: encrypt through K3
    mul_stats, paths["mul_cmp"] = run_path(lambda: phase_mulcmp(ctx))
    if saved_impl is None:
        del os.environ[enc.ENC_IMPL_ENV]
    else:
        os.environ[enc.ENC_IMPL_ENV] = saved_impl
    exp_stats, paths["exp_enc"] = run_path(lambda: phase_exp_enc(ctx))
    peak = torch.cuda.max_memory_allocated() / 1e9
    wide_stats, paths["wide"] = run_path(lambda: phase_wide(ctx))
    log(f"[paths] peak device memory over the first three paths {peak:.3f} GB")

    # 3b. K1 at the multiplications' and lt's busiest shapes
    t0 = time.perf_counter()
    rows += mul_shape_rows(ctx)
    rows += route_kernel_rows(ctx)
    rows += circuit_kernel_rows(ctx)
    widest = widest_product(ctx)
    wide_stats["u16_thresholds"] = threshold_scan(ctx, *ctx["u16_inputs"])
    log(f"[kernels] phase 3b done in {time.perf_counter() - t0:.3f} s")
    clocks["after phase 3b"] = nvidia_smi(clock_query)
    log(f"[device] {clock_query}: " + "; ".join(f"{k} {v}" for k, v in clocks.items()))
    for r in rows:
        log(f"[bounds] {r['kernel']} {r['label']} {r['shape']}: kernel {r['ms']:.5f} ms by "
            f"{r['ms_by']}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it), "
            f"old count's bound {r['old_bound_ms']:.5f} ms ({r['old_bound_ms'] / r['ms']:.1%} "
            f"of it)" + (f"; torch._int_mm of the count product {ms_text(r['int_mm_ms'])} ms"
                         if "int_mm_ms" in r else ""))
    # 7. where the time of each path goes
    t0 = time.perf_counter()
    profile_stats = phase_profile(ctx, main_stats, bulk_stats, mul_stats, wide_stats)
    log(f"[profile] phase done in {time.perf_counter() - t0:.3f} s")

    # 9-11. the verify gate, the decrypt masks and the compiled pipelines (the
    # CUDA graphs last: in one run, a phase 3b trace that ran after them came
    # back with no device records; profiler_after_graphs checks the profiler
    # after them and records what it finds)
    verify_stats, paths["verify"] = run_path(lambda: phase_verify(ctx))
    t0 = time.perf_counter()
    (mask_stats, mask_keys), paths["masks"] = run_path(lambda: phase_masks(ctx))
    rows += mask_kernel_rows(ctx, mask_keys)
    del mask_keys
    log(f"[masks] phase done in {time.perf_counter() - t0:.3f} s")
    # 10b. the grids of places, before the graphs
    mesh_stats, paths["mesh"] = run_path(lambda: phase_mesh(ctx))
    rows += ctx.get("mesh_x1_rows", [])
    # 10c-10e. the u64 product, the entry points and the bench, before the
    # compiled pipelines (the bench captures graphs of its own last)
    u64_stats, paths["u64"] = run_path(lambda: phase_u64(ctx))
    entry_stats, paths["entry"] = run_path(lambda: phase_entry(ctx))
    bench_stats, paths["bench"] = run_path(lambda: phase_bench(ctx))
    t0 = time.perf_counter()
    glue_stats = phase_glue(ctx)
    log(f"[glue] phase done in {time.perf_counter() - t0:.3f} s")
    compiled_stats, _ = run_path(lambda: phase_compiled(ctx))
    # the compiled path's launches are those of its warm-ups and first
    # replays (each replay after them counts its manifest again)
    paths["compiled"] = {name: sum(st["captured_launches"][name] for st in compiled_stats.values())
                         for name in wrappers}
    profiler_probe = profiler_after_graphs(ctx)
    for path, counts in paths.items():
        log(f"[paths] launches in {path}: {counts}")
    # which kernels each path must have run, and K2 must not run under pallas_v1
    # (every new mask starts with M3; the wider classes go on with M2, and
    # phase 10 also runs the route, M1 and K1, at every class)
    circuit = ("csa_level_in", "csa_level_out", "ripple_step")
    needs = {"add": ("clmul", "encrypt", "threefry", "series_small", "csa_level_in",
                     "ripple_step", "decipher"),
             "mul_cmp": ("clmul", "encrypt_v1", "threefry", "series_small", "decipher") + circuit,
             "exp_enc": ("encrypt", "encrypt_v1", "encrypt_v3", "threefry"),
             "wide": ("clmul", "encrypt", "threefry", "series_small", "newton_step",
                      "route_split", "route_join", "decipher") + circuit,
             "verify": ("clmul", "encrypt", "threefry", "series_small", "decipher") + circuit,
             "masks": ("clmul", "square", "newton_step", "series_small", "mask_clmul"),
             "mesh": ("clmul", "encrypt", "encrypt_v3", "threefry", "series_small",
                      "decipher") + circuit,
             "u64": ("clmul", "encrypt", "series_small", "newton_step", "route_split",
                     "route_join", "decipher") + circuit,
             "entry": ("clmul", "encrypt", "encrypt_v3", "threefry", "series_small", "decipher"),
             "bench": ("clmul", "encrypt", "threefry", "series_small", "newton_step",
                       "route_split", "route_join", "decipher") + circuit,
             "compiled": ("clmul", "encrypt", "encrypt_v1", "threefry_dkey", "route_split",
                          "route_join", "decipher") + circuit}
    for path, names in needs.items():
        for name in names:
            check(paths[path][name] > 0, f"{name} was not launched on the {path} path")
    check(paths["mul_cmp"]["encrypt"] == 0, "K2 ran while pallas_v1 selected K3")
    for path in ("wide", "u64", "compiled"):  # their routed products' leaves are square
        check(0 < paths[path]["clmul_square"] <= paths[path]["clmul"],
              f"K1's square path launched {paths[path]['clmul_square']} of {paths[path]['clmul']} "
              f"times on the {path} path")
        # the leaves are 32-63 limbs, where SQUARE_COLUMNS gives k > 1
        check(0 < paths[path]["clmul_square_tiled"] <= paths[path]["clmul_square"],
              f"K1's square path took k > 1 in {paths[path]['clmul_square_tiled']} of "
              f"{paths[path]['clmul_square']} launches on the {path} path")
    # the limb-mesh hook is inert without a mesh: K1's launches on the
    # earlier paths, less the mask route's, are those of the runs before
    # either existed
    for path, want in K1_EARLIER_PATHS.items():
        got = paths[path]["clmul"] - paths[path]["mask_clmul"]
        check(got == want, f"K1 launched {got} times on the {path} path besides the "
              f"{paths[path]['mask_clmul']} of its decrypt masks, not {want}")

    # 8. kernels line: each kernel at its busiest path shape
    meta = {
        "clmul": ("homomorph_tpu_torch/csrc/clmul.cu", "homomorph_tpu/gf2/kernels.py:56",
                  "add-chain"),
        "encrypt": ("homomorph_tpu_torch/csrc/encrypt.cu",
                    "homomorph_tpu/gf2/encrypt_kernel.py:37", "tau128"),
        "encrypt_v1": ("homomorph_tpu_torch/csrc/encrypt_mma.cu",
                       "homomorph_tpu/gf2/encrypt_kernel.py:93", "tau128"),
        "encrypt_v3": ("homomorph_tpu_torch/csrc/encrypt_mma.cu",
                       "experiments/exp_enc.py:65", "tau128"),
        # not a Pallas kernel: the threefry stream XLA generates there
        "threefry": ("homomorph_tpu_torch/csrc/threefry.cu", "homomorph_tpu/cipher.py:360",
                     "words"),
        # T1's device-key entry (hm_threefry_bits_dkey): the same stream
        "threefry_dkey": ("homomorph_tpu_torch/csrc/threefry.cu",
                          "homomorph_tpu/cipher.py:360", "words"),
        # not Pallas kernels: the lax.scan of the decrypt mask's recurrence
        # there; M1 squares the series that replaces it on the route's
        # steps (K1 multiplies), M2 fuses a step, M3 runs the small ones
        "square": ("homomorph_tpu_torch/csrc/mask.cu", "homomorph_tpu/gf2/poly.py:352",
                   "d13440-L3145728"),
        "newton_step": ("homomorph_tpu_torch/csrc/mask.cu", "homomorph_tpu/gf2/poly.py:352",
                        "d5888-L262144"),
        "series_small": ("homomorph_tpu_torch/csrc/mask.cu", "homomorph_tpu/gf2/poly.py:352",
                         "d1024-L65"),
        # not Pallas kernels: the XLA pads, slices and XORs of the route's
        # levels there (_karatsuba_flat, and _clmul_flat's chunk branch)
        "route_split": ("homomorph_tpu_torch/csrc/route.cu", "homomorph_tpu/gf2/kernels.py:356",
                        "u16-busiest"),
        "route_join": ("homomorph_tpu_torch/csrc/route.cu", "homomorph_tpu/gf2/kernels.py:356",
                       "u16-busiest"),
        # not Pallas kernels: the XLA XORs, pads, stacks and fits of the
        # carry-save tree (_csa_accumulate, with _batched_clmul_pairs and
        # _fit_bit) and of the ripples (_ripple_add_rows, add's chain)
        "csa_level_in": ("homomorph_tpu_torch/csrc/circuit.cu",
                         "homomorph_tpu/models/circuits.py:765", "u16-busiest"),
        "csa_level_out": ("homomorph_tpu_torch/csrc/circuit.cu",
                          "homomorph_tpu/models/circuits.py:765", "u16-busiest"),
        "ripple_step": ("homomorph_tpu_torch/csrc/circuit.cu",
                        "homomorph_tpu/models/circuits.py:844", "u16-busiest"),
        # not a Pallas kernel: XLA's fusion of c & w, the XOR fold and the parity
        "decipher": ("homomorph_tpu_torch/csrc/decrypt.cu", "homomorph_tpu/gf2/poly.py:383",
                     "sum"),
    }
    kernels = []
    for name, (source, replaces, label) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = [r for r in mine if r["label"] == label][-1]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(counts[name] for counts in paths.values()),
            launches_by_path={path: counts[name] for path, counts in paths.items()},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            mismatches=sum(r["mismatches"] for r in mine),
            shape=rep["shape"], ms=rep["ms"], ms_by=rep["ms_by"], plain_ms=rep["plain_ms"],
            plain_by=rep["plain_by"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=None,
            old_bound_ms=rep["old_bound_ms"],
            # torch._int_mm of the bare count product: a yardstick, not the function
            int_mm_ms=rep.get("int_mm_ms"),
        ))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=rows, main=main_stats, bulk=bulk_stats,
                           mulcmp=mul_stats, exp_enc=exp_stats, launches=paths,
                           route_sweep=sweep, square_sweep=square, wide=wide_stats,
                           u32_widest=widest,
                           verify=verify_stats, masks=mask_stats,
                           mesh=mesh_stats,
                           u64=u64_stats, entry=entry_stats, bench=bench_stats,
                           glue=glue_stats,
                           compiled=compiled_stats,
                           profiler_after_graphs=profiler_probe,
                           lt_launch_times=ctx["lt_launch_times"],
                           k2_vs_k3=ctx["k2_vs_k3"],
                           clocks=clocks,
                           peak_gb=peak, kernels=kernels, profile=profile_stats,
                           seconds=time.perf_counter() - t_start), f, indent=1)
    for kern in kernels:
        check(kern["launches"] > 0 and kern["mismatches"] == 0,
              f"{kern['name']}: {kern['launches']} launches, {kern['mismatches']} mismatches")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
