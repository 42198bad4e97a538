#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, in order; any failure exits non-zero before the result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``homomorph_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (0 mismatches required); each timed by its device
   time from ``torch.profiler`` (see :func:`device_records`);
4. replay of the interop fixtures (``tests/fixtures/interop_v1.json``):
   keygen and recorded-stream encryption on the card must give the
   fixture's bytes;
5. the main path at ``Parameters(128, 128, 1, 128)``: seeded keygen,
   encrypt 2,048 u32 pairs, checked ``HomomorphicAddition``, decrypt,
   assert ``(x + y) mod 2^32``; the card's sums against the CPU's plain path
   on a few rows; a U8 AND/OR/XOR/NOT gate check;
6. bulk round-trips: 2^21 bits at ``(128, 128, 64, 128)`` and 2^20 bits at
   ``(1024, 1024, 64, 256)``;
7. a ``torch.profiler`` trace of the checked add and of the first bulk
   round trip: warm wall time, device time by kernel, busy share;
8. one JSON line of kernels (launches counted over phases 5-6 only);
9. last line ``{"ok": true, "device": {...}}``.

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

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and dense int8
# tensor-core rate.  The INT32 rate is derived on the card (see int32_rate).
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_OPS_PER_SM_PER_CLOCK = 64  # CUDA C guide, arithmetic throughput, cc 9.0


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


def int32_rate(torch):
    """INT32 operations per second: SMs x 64 per SM per clock x max SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_OPS_PER_SM_PER_CLOCK * mhz * 1e6, sms, mhz


def device_records(torch, fn, iters=1):
    """Device time in ms by record name (kernels and copies) over ``iters``
    calls of ``fn``, from ``torch.profiler``, after one warm-up call.

    This is the card's own time: it leaves out the host's time to issue a
    call (checks, allocation, the ctypes launch), which for a short kernel
    is longer than the kernel itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = per_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return per_name


def device_ms(torch, fn, iters):
    """Device time of one call of ``fn``, averaged over ``iters`` calls."""
    return sum(device_records(torch, fn, iters).values()) / iters


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


def clmul_ops(B, La, Lb):
    """K1's work on [B, La] x [B, Lb]: per row, Ls*(Lg+1) pairs of a limb of
    the smaller operand and an output limb (``csrc/clmul.cu``'s loops), each
    32 mask-and-XOR steps, counted at 2 ops a step as
    ``homomorph_tpu/utils/profiling.py::clmul_sol`` counts them."""
    Ls, Lg = min(La, Lb), max(La, Lb)
    return B * 32 * Ls * (Lg + 1) * 2


def phase_kernels(ctx):
    """K1 and K2 against their plain versions at the main path's shapes."""
    torch, dev, rng = ctx["torch"], ctx["dev"], ctx["gen"]
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import kernels as k

    def words(shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev, generator=rng)

    def timed(kernel_fn, plain_fn):
        return dict(ms=device_ms(torch, kernel_fn, 20), call_ms=call_ms(torch, kernel_fn),
                    plain_ms=device_ms(torch, plain_fn, 3))

    rows = []
    # (label, B, La, Lb): keygen S*Q_i, the adder's whole-tensor AND, its last
    # chain step, and small-batch wide operands
    for label, B, La, Lb in (("keygen", 128, 5, 5), ("add-and", 65536, 9, 9),
                             ("add-chain", 2048, 9, 256), ("wide48", 7, 9, 48),
                             ("wide96", 7, 9, 96)):
        a, b = words((B, La)), words((B, Lb))
        got = k.clmul_flat(a, b)
        torch.cuda.synchronize()
        want = k.clmul_plain(a, b)
        bad, err = compare(torch, got, want)
        check(bad == 0, f"clmul {label} ({B}, {La}x{Lb}): {bad} mismatches")
        ops = clmul_ops(B, La, Lb)
        nbytes = B * (La + Lb) * 4 * 2
        rows.append(dict(
            kernel="clmul", label=label, shape=f"B={B} La={La} Lb={Lb}",
            mismatches=bad, max_abs_err=err,
            **timed(lambda: k.clmul_flat(a, b), lambda: k.clmul_plain(a, b)),
            ops=ops, ops_rate=ctx["int32_rate"], bytes=nbytes,
        ))
        log(f"[kernels] clmul {label:9s} B={B} {La}x{Lb}: mismatches {bad}, "
            f"kernel {rows[-1]['ms']} ms (call {rows[-1]['call_ms']} ms), "
            f"plain {rows[-1]['plain_ms']} ms")

    # (tau, Lpk): the slice's and the first bulk's key, the scaled key, an
    # unaligned tau
    for tau, Lpk in ((128, 9), (256, 65), (33, 9)):
        for B in (65536, 1 << 21):
            W, D, L = -(-tau // 32), 32 * Lpk, Lpk
            pk = words((tau, Lpk))
            pkcol = enc.pk_columns(pk)
            selw = words((B, W))
            plain = (words((B,)) & 1).contiguous()
            got = enc.encrypt_bits_fused(selw, pkcol, plain, L)
            torch.cuda.synchronize()
            want = enc.encrypt_plain(selw, pkcol, plain, L)
            bad, err = compare(torch, got, want)
            check(bad == 0, f"encrypt tau={tau} B={B}: {bad} mismatches")
            nbytes = (B * W + B + B * L + D * W) * 4
            rows.append(dict(
                kernel="encrypt", label=f"tau{tau}", shape=f"B={B} tau={tau} D={D} L={L}",
                mismatches=bad, max_abs_err=err,
                **timed(lambda: enc.encrypt_bits_fused(selw, pkcol, plain, L),
                        lambda: enc.encrypt_plain(selw, pkcol, plain, L)),
                ops=2 * B * tau * D, ops_rate=INT8_TC_OPS_PER_S, bytes=nbytes,
            ))
            log(f"[kernels] encrypt tau={tau} B={B}: mismatches {bad}, "
                f"kernel {rows[-1]['ms']} ms (call {rows[-1]['call_ms']} ms), "
                f"plain {rows[-1]['plain_ms']} ms")
            del got, want, selw, plain
    for r in rows:
        t_ops = r["ops"] / r["ops_rate"] * 1e3
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return rows


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


def phase_profile(ctx, main_stats, bulk_stats):
    """Warm wall time, device time by kernel and the device's busy share of
    the checked add and of the first bulk round trip.  Each stage runs once
    more unprofiled for its warm wall time (phases 5-6 ran it cold), then
    under ``torch.profiler`` (:func:`device_records`); the busy share is the
    profiled device time over the warm wall time."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicAddition

    torch = ctx["torch"]
    c, ca, cb = ctx["add_inputs"]
    bc, vals, bct = ctx["bulk_inputs"]
    stages = {
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
        per_kernel = device_records(torch, fn)
        dev_ms = sum(per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        out[name] = dict(cold_ms=cold_ms, warm_ms=warm_ms, device_ms=dev_ms,
                         busy_share=dev_ms / warm_ms, top=top)
        log(f"[profile] {name}: cold {cold_ms:.3f} ms, warm {warm_ms:.3f} ms wall, device "
            f"{dev_ms:.3f} ms (busy {dev_ms / warm_ms:.1%}); top: "
            + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import homomorph_tpu_torch  # noqa: F401  (fails outside a checkout)
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
    ctx["int32_rate"], sms, mhz = int32_rate(torch)
    log(f"[device] {torch.cuda.get_device_name(0)}: {sms} SMs, max SM clock {mhz:.0f} MHz "
        f"-> INT32 {ctx['int32_rate'] / 1e12:.2f} Tops/s; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # 2. build
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] {', '.join(cuda_build.SOURCES)} built in {time.perf_counter() - t0:.3f} s")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3-4. kernels against plain versions, fixture replay
    rows = phase_kernels(ctx)
    phase_fixtures(ctx)

    # 5-6. the main path, with launch counts
    k.clmul_flat.launches = 0
    enc.encrypt_bits_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    main_stats = phase_main(ctx)
    bulk_stats = phase_bulk(ctx)
    launches = {"clmul": k.clmul_flat.launches, "encrypt": enc.encrypt_bits_fused.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main] launches in phases 5-6: {launches}; peak device memory {peak:.3f} GB")
    # 7. where the time of the add and the bulk round trip goes
    profile_stats = phase_profile(ctx, main_stats, bulk_stats)

    # 8. kernels line: each kernel at its busiest main-path shape
    meta = {
        "clmul": ("homomorph_tpu_torch/csrc/clmul.cu", "homomorph_tpu/gf2/kernels.py:56", "add-chain"),
        "encrypt": ("homomorph_tpu_torch/csrc/encrypt.cu",
                    "homomorph_tpu/gf2/encrypt_kernel.py:37", "tau128"),
    }
    kernels = []
    for name, (source, replaces, label) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        rep = [r for r in mine if r["label"] == label][-1]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            mismatches=sum(r["mismatches"] for r in mine),
            shape=rep["shape"], ms=rep["ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=None,
        ))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=rows, main=main_stats, bulk=bulk_stats,
                           launches=launches, peak_gb=peak, kernels=kernels,
                           profile=profile_stats,
                           seconds=time.perf_counter() - t_start), f, indent=1)
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was not launched on the main path")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
