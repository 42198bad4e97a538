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
   graph replayed after each rewrite of its key buffer;
   K2 also at tau 1 and 300, at L above the key's limbs and at keys whose
   tables the launcher tiles (checked only); beside each K3 and X1 row, its
   share of the bound and of the tensor-core count, and the device time of
   ``torch._int_mm`` on the bare count product (a yardstick the port never
   calls);
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
   (split, the leaf launch, unwind) against one direct K1 launch on
   balanced operands of 32-4,096 limbs, and the chunk route at ``Lg = 4 Ls``,
   by device time; every routed product equal to the direct one, limb for
   limb; the crossover it measures printed beside the threshold in the code;
5c. the wide path (:func:`phase_wide`): checked u16 multiplication of 512
   pairs at ``Parameters(1024, 128, 1, 128)`` and u32 of 8 pairs at
   ``(2432, 128, 1, 128)``, decrypted and asserted, 2 and 1 of their rows
   again with the route off (direct K1) and equal limb for limb; the u32
   product once more with ``HOMOMORPH_TPU_TORCH_EAGER_SYNC=1``; the sum of
   8 u8 operands, the u32 popcount, the u8 clamp, the i8 shifts, rotates
   and ``abs_``, and the u32 add through the carry scan, each decrypted and
   asserted;
3b. K1 at the busiest shapes phase 5b's multiplication and ``lt`` launched
   it with, every distinct ``lt`` launch shape timed, and at the busiest
   launch of the u16 product and the widest of the u32 product (phase 5c),
   with the u32 product's widest operands timed direct and routed, and the
   u16 product end to end at thresholds from 48 limbs to the route off;
7. ``torch.profiler`` traces of the checked add, the first bulk round trip,
   the u8 multiplication, the u32 ``lt`` and the u16 and u32
   multiplications: warm wall time, device time by kernel, busy share;
9. the verify gate (``run_verification()`` in full, scaled round trip
   included), a path of its own;
10. the native decrypt masks at the 9-, 65-, 8,192- and 98,304-limb classes
   against the Python-int recurrence, word for word, both timed (host);
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
   tree's wall, device time, K1 launches and peak memory, the decrypt
   mask's host time; K1's launch with the most rows and its widest held
   against the plain version on their first and last 256 rows
   (:func:`k1_spot_checked`);
10d. the entry points (``homomorph_tpu_torch.entry``): ``entry()``'s
   gate step and ``dryrun_multichip(4)`` on four places on the card, each
   checked by decrypt;
10e. the port's bench (``homomorph_tpu_torch.bench --with-mul32``) at full
   size, its JSON printed on a line of its own: the verify gate, then every
   section, the u16 and the d = 5888 u32 products decrypted on the card
   under keys with ``S(0) = 1``, K1's largest and widest launches held
   against the plain version as in 10c, every device-busy field a number;
11. the compiled pipelines as CUDA graphs (:func:`phase_compiled`): the u32
   add (2,048 pairs) and the u32 product (8 pairs) against eager limb for
   limb and decrypted, and the u32 add's encrypt -> add -> decrypt round
   trip under a new key each call: first call, replays, eager and one
   replay's device time; the u32 add through the carry scan
   (``HOMOMORPH_TPU_TORCH_CARRY_SCAN=1``) against eager, and the round trip
   through K3 (``HOMOMORPH_TPU_TORCH_ENC_IMPL=pallas_v1``), each replay
   against the same function run eagerly on its keys; their launches are
   those counted at warm-up and capture (a replay must count none);
8. one JSON line of kernels (launches counted over the paths: phases 5-6,
   5b, 6b, 5c, 9, 10b-10e and 11, each counted from 0; each bound the larger of the
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
from homomorph_tpu_torch.experiments.common import leaf_shape, recorded_products  # noqa: E402
from homomorph_tpu_torch.utils.profiling import (  # noqa: E402
    THREEFRY_ALU_OPS_PER_WORD,
    bound,
    chip_peaks,
    clmul_bytes,
    clmul_comb_work,
    clmul_ops,
    device_records,
    encrypt_lookup_bytes,
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
    records (K1 and the torch glue), K1's share, and the time per call."""
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
    k1 = None if rec_r is None else sum(v for name, v in rec_r.items() if "clmul" in name) / iters
    row = dict(Ls=Ls, Lg=Lg, B=B, pairs=B * Ls * (Lg + 1),
               steps=[s[0] for s in k.route_plan(Ls, Lg, Ls)],
               direct_ms=None if rec_d is None else sum(rec_d.values()) / iters,
               routed_ms=None if rec_r is None else sum(rec_r.values()) / iters,
               routed_k1_ms=k1, direct_call_ms=call_ms(torch, direct, 10),
               routed_call_ms=call_ms(torch, routed, 10))
    row["routed_glue_ms"] = None if rec_r is None else row["routed_ms"] - k1
    log(f"[route] {Ls}x{Lg} B={B} {'+'.join(row['steps'])}: direct {ms_text(row['direct_ms'])} "
        f"ms, routed {ms_text(row['routed_ms'])} ms (K1 {ms_text(k1)} + glue "
        f"{ms_text(row['routed_glue_ms'])}); per call {row['direct_call_ms']:.5f} / "
        f"{row['routed_call_ms']:.5f} ms; equal")
    return row


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
    before = k.clmul_flat.launches
    (prod, mul_ms), shapes = recorded_products(lambda: stage(torch, lambda: c.apply2(Mul, ea, eb)))
    launches = k.clmul_flat.launches - before
    peak = torch.cuda.max_memory_allocated() / 1e9
    sk = c.get_secret_key()
    _, mask_ms = stage(torch, lambda: sk.decrypt_mask(prod.num_limbs))
    got, dec_ms = stage(torch, lambda: np.array(c.decrypt(prod).tolist(), dtype=np.uint64))
    want = (xs * ys) % (1 << bits)
    check(np.array_equal(got, want), f"{name}: {int((got != want).sum())} of {n} products wrong")

    r = direct_rows
    da = ht.Ciphered(ea.limbs[:r], ea.bound, desc, noise=ea.noise)
    db = ht.Ciphered(eb.limbs[:r], eb.bound, desc, noise=eb.noise)
    before = k.clmul_flat.launches
    direct, direct_ms = with_env(k.KARATSUBA_MIN_ENV, 1 << 30,
                                 lambda: stage(torch, lambda: c.apply2(Mul, da, db)))
    direct_launches = k.clmul_flat.launches - before
    check(direct.limbs.shape == prod.limbs[:r].shape
          and bool((direct.limbs == prod.limbs[:r]).all())
          and (direct.bound, direct.noise) == (prod.bound, prod.noise),
          f"{name}: direct K1 product differs from the routed one on {r} rows")
    kmin = k.karatsuba_min()
    leaves = [leaf_shape(*s, kmin) for s in shapes]
    stats = dict(params=[params.d, params.dp, params.delta, params.tau], pairs=n,
                 requirement=req, keygen_ms=keygen_ms, encrypt_ms=enc_ms, mul_ms=mul_ms,
                 mask_ms=mask_ms, decrypt_ms=dec_ms, product_limbs=list(prod.limbs.shape),
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
        f"decrypt mask {mask_ms:.3f} ms host, decrypt {dec_ms:.3f} ms; all right; {r} rows with "
        f"the route off {direct_ms:.3f} ms ({direct_launches} K1 launches), equal limb for limb")
    log(f"[wide] {name}: widest product {stats['widest_product']}, busiest "
        f"{stats['busiest_product']}; K1 launches: widest {stats['widest_leaf']}, busiest "
        f"{stats['busiest_leaf']}")
    return stats, (c, ea, eb, prod), shapes


# Phase 5c: thresholds at which the u16 product is timed end to end (the last
# one turns the route off)
U16_THRESHOLDS = (48, 64, 96, 128, 256, 1 << 30)


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
    rotates, ``abs_`` and the scanned add."""
    import numpy as np

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.models import (
        HomomorphicAddition, HomomorphicMultiplication, HomomorphicPopCount, HomomorphicSum,
        circuits,
    )

    torch, dev, seed = ctx["torch"], ctx["dev"], ctx["seed"] + 40
    out = {}
    out["u16"], ctx["u16_inputs"], ctx["u16_shapes"] = wide_mul(
        ctx, ht, "u16", ht.Parameters(1024, 128, 1, 128), 512, ht.U16, 16, 2, seed)
    out["u32"], (c32, a32, b32, p32), ctx["u32_shapes"] = wide_mul(
        ctx, ht, "u32", ht.Parameters(2432, 128, 1, 128), 8, ht.U32, 32, 1, seed + 1)
    torch.cuda.reset_peak_memory_stats()
    synced, sync_ms = with_env(circuits.EAGER_SYNC_ENV, "1", lambda: stage(
        torch, lambda: c32.apply2(HomomorphicMultiplication, a32, b32)))
    sync_peak = torch.cuda.max_memory_allocated() / 1e9
    check(torch.equal(synced.limbs, p32.limbs), "u32 with EAGER_SYNC differs")
    out["u32_eager_sync"] = dict(mul_ms=sync_ms, peak_gb=sync_peak)
    log(f"[wide] u32 with HOMOMORPH_TPU_TORCH_EAGER_SYNC=1: {sync_ms:.3f} ms, peak "
        f"{sync_peak:.3f} GB (without: {out['u32']['mul_ms']:.3f} ms, "
        f"{out['u32']['peak_gb']:.3f} GB); same limbs")
    ctx["u32_inputs"] = (c32, a32, b32)
    del synced, p32

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
    c, ca, cb = ctx["add_inputs"]
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

    # the u32 add through the carry scan, against the ripple's polynomials
    xs = np.array(c.decrypt(ca).tolist(), dtype=np.uint64)
    ys = np.array(c.decrypt(cb).tolist(), dtype=np.uint64)
    before = k.clmul_flat.launches
    scan, scan_ms = with_env(circuits.CARRY_SCAN_ENV, "1", lambda: stage(
        torch, lambda: c.apply2(HomomorphicAddition, ca, cb)))
    scan_launches = k.clmul_flat.launches - before
    ripple, ripple_ms = stage(torch, lambda: c.apply2(HomomorphicAddition, ca, cb))
    got = np.array(c.decrypt(scan).tolist(), dtype=np.uint64)
    check(np.array_equal(got, (xs + ys) % (1 << 32)), "scanned u32 add wrong")
    from homomorph_tpu_torch.gf2 import poly as gf2

    L = max(scan.num_limbs, ripple.num_limbs)
    check(torch.equal(gf2.pad_limbs(scan.limbs[:4], L), gf2.pad_limbs(ripple.limbs[:4], L)),
          "scanned add: polynomials differ from the ripple's on 4 rows")
    out["scan_add"] = dict(pairs=len(xs), scan_ms=scan_ms, ripple_ms=ripple_ms,
                           scan_k1_launches=scan_launches, scan_limbs=scan.num_limbs,
                           ripple_limbs=ripple.num_limbs)
    log(f"[wide] u32 add through the carry scan, {len(xs)} pairs: {scan_ms:.3f} ms "
        f"({scan_launches} K1 launches, L={scan.num_limbs}) against the ripple's "
        f"{ripple_ms:.3f} ms (L={ripple.num_limbs}); right, same polynomials on 4 rows")
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
    stages = {
        "mul_u16": (lambda: wc.apply2(HomomorphicMultiplication, w16a, w16b),
                    wide_stats["u16"]["mul_ms"]),
        "mul_u32": (lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b),
                    wide_stats["u32"]["mul_ms"]),
        "mul_u8": (lambda: mc.apply2(HomomorphicMultiplication, e8a, e8b), mul_stats["mul_ms"]),
        "lt_u32": (lambda: mc.apply2(HomomorphicLessThan, e32a, e32b), mul_stats["lt_ms"]),
        "add": (lambda: c.apply2(HomomorphicAddition, ca, cb), main_stats["add_ms"]),
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
        log(f"[profile] {name}: cold {cold_ms:.3f} ms, warm {warm_ms:.3f} ms wall, device "
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


# (label, key's context in ctx, limbs): the decrypt-mask classes of the paths
MASK_CLASSES = (("d128-L9", "add_inputs", 9), ("d1024-L65", "u16_inputs", 65),
                ("d1024-L8192", "u16_inputs", 8192), ("d2432-L98304", "u32_inputs", 98304))


def phase_masks(ctx):
    """The native decrypt mask against the Python-int recurrence at the
    paths' degree classes, word for word, both timed on the host."""
    import numpy as np

    from homomorph_tpu_torch import native
    from homomorph_tpu_torch.gf2 import poly as gf2

    native.library()  # built and loaded before the clock starts
    out = []
    def median_ms(fn, reps):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return res, sorted(walls)[reps // 2]

    for label, source, n_limbs in MASK_CLASSES:
        sk = ctx[source][0].get_secret_key()
        host = gf2.to_numpy(sk.limbs)
        small = n_limbs <= 1024  # a single call is too short for the host clock
        fast, native_ms = median_ms(lambda: native.decrypt_mask(host, sk.degree, n_limbs),
                                    21 if small else 3)
        plain, python_ms = median_ms(lambda: gf2.decrypt_mask_words(host, sk.degree, n_limbs),
                                     21 if small else 1)
        check(np.array_equal(fast, plain), f"mask {label}: native differs from the Python-int recurrence")
        out.append(dict(label=label, degree=sk.degree, limbs=n_limbs, native_ms=native_ms,
                        python_ms=python_ms))
        log(f"[masks] {label} (median of {21 if small else 3} and {21 if small else 1} calls): "
            f"native {native_ms:.4f} ms, Python ints {python_ms:.4f} ms "
            f"({python_ms / native_ms:.1f}x); equal word for word")
    return out


#: K1's launches on the paths before the mesh phase, as counted before the
#: limb-mesh hook existed in the clmul dispatcher (PERF.md section 6)
K1_EARLIER_PATHS = {"add": 36, "mul_cmp": 47, "exp_enc": 1, "wide": 429, "verify": 39,
                    "compiled": 378}

# Phase 10b: the meshes of the bulk encrypt (four places on the one card)
MESH_BULK = (((128, 128, 64, 128), 1 << 21, ((4, 1), (2, 2), (1, 4))),
             ((1024, 1024, 64, 256), 1 << 20, ((1, 2),)))


def mesh_partials(ctx, sel, pk_limbs, shape, L):
    """X1 at one grid's partial shapes against its plain version, bit for
    bit: the first data block's rows of the first and the last tau shard,
    each on the planes of its shard's key rows and a zero plaintext, as
    ``sharded_encrypt_bits`` launches them.  Held one by one, so that a
    fault that is the same in every shard cannot cancel in the XOR of the
    partials.  The launches made here are taken back off X1's count.
    Returns the mismatches over both shards."""
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import poly as gf2

    torch = ctx["torch"]
    (n_data, n_tau), (B, n, tau) = shape, sel.shape
    blk, ts = B // n_data, tau // n_tau
    launches = enc.encrypt_sel_mma.launches
    zero = torch.zeros(blk * n, dtype=gf2.LIMB_DTYPE, device=sel.device)
    total = 0
    for j in sorted({0, n_tau - 1}):
        rows = sel[:blk, :, j * ts:(j + 1) * ts].reshape(blk * n, ts).contiguous()
        planes = enc.pk_planes(enc.pk_columns(pk_limbs[j * ts:(j + 1) * ts].contiguous()))
        bad, err = compare(torch, enc.encrypt_sel_mma(rows, planes, zero, L),
                           enc.encrypt_sel_plain(rows, planes, zero, L))
        check(bad == 0, f"mesh {shape}: X1's partial of tau shard {j} ({blk * n} rows, {ts} key "
                        f"rows): {bad} limbs differ from its plain version")
        total += bad
        if j == 0:  # every shard's partial has this shape: time it once
            mesh_x1_row(ctx, shape, rows, planes, zero, L, bad, err)
        del rows, planes
    enc.encrypt_sel_mma.launches = launches
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

        x1 = enc.encrypt_sel_mma.launches
        ppermute.local_bytes = ppermute.cross_bytes = 0
        out, wall = stage(torch, run)
        x1 = enc.encrypt_sel_mma.launches - x1
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

    x1 = enc.encrypt_sel_mma.launches
    (sa, sb), enc_cold = stage(torch, lambda: pair(sh))
    x1 = enc.encrypt_sel_mma.launches - x1
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
    k1 = k.clmul_flat.launches
    ppermute.local_bytes = ppermute.cross_bytes = hook.taken = hook.planned_bytes = 0
    with limbmul.use_limb_mesh(lmesh):
        prod, mesh_ms = stage(torch, lambda: xc.apply2(HomomorphicMultiplication, w32a, w32b))
    k1 = k.clmul_flat.launches - k1
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
    module's ``clmul_flat`` is a wrapper that calls the real one, so every
    launch is counted once, on the wrapper, and the count is handed back."""
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

    spy.launches = real.launches
    k.clmul_flat = spy
    try:
        result = fn()
    finally:
        k.clmul_flat = real
        real.launches = spy.launches
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
    its K1 launches and peak memory, the decrypt mask on the host, the
    decrypt against ``x * y mod 2^64`` under a key with ``S(0) = 1`` (inside
    the envelope, so every coefficient of the product counts), and a warm
    call's wall and device time.  K1's largest and widest launches are held
    against the plain version (:func:`k1_spot_checked`)."""
    from homomorph_tpu_torch.experiments import exp_mul64

    torch = ctx["torch"]
    torch.cuda.empty_cache()
    out, spots = k1_spot_checked(ctx, "u64", lambda: exp_mul64.run(
        device=ctx["dev"], log=lambda m: log(f"[u64] {m.strip()}")))
    check(out["correct"], "the u64 product decrypts wrong")
    check(out["s0"] == 1, "the u64 key has S(0) = 0: its decrypt reads only the constant term")
    torch.cuda.empty_cache()
    return dict(out, k1_spot_checks=spots)


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
        result, spots = k1_spot_checked(ctx, "bench", lambda: bench.run(
            bench.parse_args(["--with-mul32"]), bench_log))
    except SystemExit as err:
        raise SmokeFailure(f"the bench exited with {err.code}") from err
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
    return dict(result, windows=windows, k1_spot_checks=spots)


def launch_counts(ctx):
    return {name: w.launches for name, w in ctx["wrappers"].items()}


def compiled_case(ctx, name, graphed, call, eager_fn, meta_fn, replays=5):
    """Eager's warm wall time (median of 3, before any capture: a capture
    empties the allocator's cache, which the next eager calls refill), the
    output metadata's derivation on the meta device alone (the circuit's
    Python without device work), a compiled callable's first call (meta,
    warm-up, capture, replay), the median wall time of ``replays`` more and
    one replay's device time.  The launch counters move at the first call
    (warm-up and capture) and must not move at a replay.  Returns (stats,
    first output, last output, eager output)."""
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
    check(launch_counts(ctx) == mid, f"compiled {name}: a replay counted a launch")
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

    # the u32 add through the carry scan: capturable since the scan takes its
    # positions as views (no host-to-device index copy)
    from homomorph_tpu_torch.models import circuits

    def scan_case():
        fn = compile_op2(HomomorphicAddition, ht.U32, c.parameters.pk_degree)
        stats, first, last, eager = compiled_case(
            ctx, "add_u32_scan", fn.graphed, lambda: fn(ca, cb),
            lambda: c.apply2(HomomorphicAddition, ca, cb),
            lambda: _derive_meta(HomomorphicAddition.unsafe_apply, c.parameters.pk_degree, ht.U32,
                                 ca.limbs.shape, cb.limbs.shape))
        for got in (first, last):
            check(torch.equal(got.limbs, eager.limbs) and (got.bound, got.noise) == (
                eager.bound, eager.noise), "compiled add_u32_scan: limbs or metadata differ")
        got = np.array(c.decrypt(last).tolist(), dtype=np.uint64)
        check(np.array_equal(got, (xs + ys) % (1 << 32)), "compiled add_u32_scan: decrypts wrong")
        stats["pairs"] = len(got)
        return stats

    out["add_u32_scan"] = with_env(circuits.CARRY_SCAN_ENV, "1", scan_case)
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
    from homomorph_tpu_torch import prng
    from homomorph_tpu_torch.gf2 import cuda_build
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import kernels as k

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
    clocks["after phase 3"] = nvidia_smi(clock_query)
    log(f"[kernels] phase done in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sweep = phase_route_sweep(ctx)
    log(f"[route] phase done in {time.perf_counter() - t0:.3f} s")
    phase_fixtures(ctx)

    # 5-6, 5b, 6b. the paths, each with its launch counts from 0
    ctx["wrappers"] = wrappers = {
        "clmul": k.clmul_flat, "encrypt": enc.encrypt_words_table,
        "encrypt_v1": enc.encrypt_words_mma, "encrypt_v3": enc.encrypt_sel_mma,
        "threefry": prng.random_bits, "threefry_dkey": prng.random_bits_device_key}

    def run_path(fn):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        log(f"[paths] path done in {time.perf_counter() - t0:.3f} s")
        return out, {name: w.launches for name, w in wrappers.items()}

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

    # 9-11. the verify gate, the native masks and the compiled pipelines (the
    # CUDA graphs last: in one run, a phase 3b trace that ran after them came
    # back with no device records; profiler_after_graphs checks the profiler
    # after them and records what it finds)
    verify_stats, paths["verify"] = run_path(lambda: phase_verify(ctx))
    t0 = time.perf_counter()
    mask_stats = phase_masks(ctx)
    log(f"[masks] phase done in {time.perf_counter() - t0:.3f} s")
    # 10b. the grids of places, before the graphs
    mesh_stats, paths["mesh"] = run_path(lambda: phase_mesh(ctx))
    rows += ctx.get("mesh_x1_rows", [])
    # 10c-10e. the u64 product, the entry points and the bench, before the
    # compiled pipelines (the bench captures graphs of its own last)
    u64_stats, paths["u64"] = run_path(lambda: phase_u64(ctx))
    entry_stats, paths["entry"] = run_path(lambda: phase_entry(ctx))
    bench_stats, paths["bench"] = run_path(lambda: phase_bench(ctx))
    compiled_stats, _ = run_path(lambda: phase_compiled(ctx))
    # the compiled path's launches are those of its warm-ups and captures
    # (the counters do not move at a replay)
    paths["compiled"] = {name: sum(st["captured_launches"][name] for st in compiled_stats.values())
                         for name in wrappers}
    profiler_probe = profiler_after_graphs(ctx)
    for path, counts in paths.items():
        log(f"[paths] launches in {path}: {counts}")
    # which kernels each path must have run, and K2 must not run under pallas_v1
    needs = {"add": ("clmul", "encrypt", "threefry"),
             "mul_cmp": ("clmul", "encrypt_v1", "threefry"),
             "exp_enc": ("encrypt", "encrypt_v1", "encrypt_v3", "threefry"),
             "wide": ("clmul", "encrypt", "threefry"),
             "verify": ("clmul", "encrypt", "threefry"),
             "mesh": ("clmul", "encrypt", "encrypt_v3", "threefry"),
             "u64": ("clmul", "encrypt"),
             "entry": ("clmul", "encrypt", "encrypt_v3", "threefry"),
             "bench": ("clmul", "encrypt", "threefry"),
             "compiled": ("clmul", "encrypt", "encrypt_v1", "threefry_dkey")}
    for path, names in needs.items():
        for name in names:
            check(paths[path][name] > 0, f"{name} was not launched on the {path} path")
    check(paths["mul_cmp"]["encrypt"] == 0, "K2 ran while pallas_v1 selected K3")
    # the limb-mesh hook is inert without a mesh: K1's launches on the
    # earlier paths are those of the runs before it existed
    for path, want in K1_EARLIER_PATHS.items():
        check(paths[path]["clmul"] == want,
              f"K1 launched {paths[path]['clmul']} times on the {path} path, not {want}")

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
                           route_sweep=sweep, wide=wide_stats, u32_widest=widest,
                           verify=verify_stats, masks=mask_stats, mesh=mesh_stats,
                           u64=u64_stats, entry=entry_stats, bench=bench_stats,
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
