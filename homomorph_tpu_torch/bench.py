"""The port's bench: the system's metrics on the card, as one JSON line.

Counterpart of the repo's ``bench.py`` (the JAX package's bench), section for
section and at its sizes:

* the verify gate (:func:`homomorph_tpu_torch.verify.run_verification`)
  first: no number is printed unless the kernels return the right bits on
  the card about to be timed (``HOMOMORPH_TPU_TORCH_SKIP_VERIFY=1`` skips it
  and prints a warning);
* bulk encrypt at ``Parameters(128, 128, 64, 128)``, 2^21 bits: T1 draws the
  selection words under keys of ``split(key(1), n + 4)`` and the encrypt
  kernel encrypts them (K2, or K3 under ``HOMOMORPH_TPU_TORCH_ENC_IMPL=
  pallas_v1``), so a step's ciphertext is the JAX step's bytes;
* bulk decrypt, and the sync latency of one u32 decrypt;
* the device latency of one u32 decrypt from chains of 8,192 and 40,960
  dependent decrypts (each step folds its bits back through a runtime zero):
  one chain of 8,192 steps is captured as a CUDA graph and the delta between
  one and five back-to-back replays is divided by the 32,768 steps between
  them (a 40,960-step graph of ~20 kernels a step is not captured);
* checked-circuit throughput: u32 add and ``lt`` (2,048 pairs), u8 product
  (1,024 pairs), u16 product at ``Parameters(1024, 128, 1, 128)`` (512 pairs,
  decrypted and compared on the card under a key with ``S(0) = 1``,
  :func:`wide_context`), each a compiled callable (one CUDA
  graph replay a call, :func:`~homomorph_tpu_torch.models.compiled.
  compile_op2`), and the decrypt after the add and after the u8 product;
* with ``--with-mul32``, the u32 product at ``Parameters(5888, 128, 1, 128)``,
  8 pairs, eager as the JAX bench runs it: decrypted and compared under the
  same kind of key, with its
  peak device memory, its K1 launches and the wall and device time of its
  decrypt mask (computed on the card);
* the scaled configuration ``Parameters(1024, 1024, 64, 256)`` at 100,352
  and 2^20 bits.

Throughput is the median of three windows of back-to-back steps, each
window ended by a synchronisation; latency is the median of synchronised
single calls (:class:`~homomorph_tpu_torch.experiments.common.Timer`);
device-busy rates come from ``torch.profiler``'s device records
(:func:`~homomorph_tpu_torch.utils.profiling.device_busy`: three traces,
a record one lost counted from the others) and are ``null`` off the
card.  On the card, traces with no device records fail the run.  The spread of every window goes to
``bench_windows.json`` in the build directory (``homomorph_tpu_torch/_build/``
unless ``HOMOMORPH_TPU_TORCH_CACHE_DIR`` names another).

    python -m homomorph_tpu_torch.bench [--quick] [--json-only] [--batch-bits N]
        [--skip-scaled] [--with-mul32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import homomorph_tpu_torch as ht
from homomorph_tpu_torch import prng
from homomorph_tpu_torch import rng as hrng
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.experiments.common import (
    CHECK_SEED,
    Timer,
    context,
    key_s0,
    mask_device_s,
    mask_wall_s,
)
from homomorph_tpu_torch.gf2.encrypt_kernel import encrypt_bits_fused
from homomorph_tpu_torch.models import (
    HomomorphicAddition,
    HomomorphicLessThan,
    HomomorphicMultiplication,
    circuits,
)
from homomorph_tpu_torch.models.compiled import Graphed, compile_op2
from homomorph_tpu_torch.utils.cache import build_dir
from homomorph_tpu_torch.utils.profiling import counters

# the reference crate's u32 encrypt on one Ryzen 7800X3D core (its README:
# 76 us per u32), the bench's baseline
REFERENCE_BIT_ENC_PER_S = 32 / 76.0e-6
SKIP_VERIFY_ENV = "HOMOMORPH_TPU_TORCH_SKIP_VERIFY"
PARAMS = (128, 128, 64, 128)
SCALED_PARAMS = (1024, 1024, 64, 256)
MUL16_PARAMS = (1024, 128, 1, 128)
MUL32_PARAMS = (5888, 128, 1, 128)
# dependent decrypts per chain: (quick, full)
CHAINS = ((256, 2304), (8192, 40960))


# --------------------------------------------------------------------------
# The bench's steps (held against the JAX bench's by tests/test_torch_bench.py)
# --------------------------------------------------------------------------


def bench_keys(n: int) -> "tuple[tuple[int, int], ...]":
    """The JAX bench's ``jax.random.split(jax.random.key(1), n)``."""
    return hrng.threefry_split(hrng.threefry_key(1), n)


def encrypt_step(pk: ht.PublicKey, L: int, B: int, device):
    """``step(key) -> [B, L]``: T1 draws ``[B, ceil(tau/32)]`` selection
    words under ``key`` and the encrypt kernel encrypts ``B`` zero bits
    (``bench.py:157-160``)."""
    W = -(-pk.tau // 32)
    plain = torch.zeros(B, dtype=gf2.LIMB_DTYPE, device=device)

    def step(key):
        selw = prng.random_bits(key, (B, W), device)
        return encrypt_bits_fused(selw, pk.limbs, plain, L, planes=pk.planes)

    return step


def decrypt_chain(w: torch.Tensor, K: int):
    """``chain(c, z) -> [K, ...]``: ``K`` dependent decrypts of ``c`` under
    the mask ``w``; step ``k`` folds its bits back into the ciphertext
    through ``z``, a zero the card reads at run time, so no step can start
    before the one before it ends (``bench.py:206-213``)."""

    def chain(c, z):
        outs = []
        for _ in range(K):
            bits = gf2.decipher_bits(c, w)
            c = c ^ (bits * z)[..., None]
            outs.append(bits)
        return torch.stack(outs)

    return chain


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    device's name off the card."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


# --------------------------------------------------------------------------
# The result
# --------------------------------------------------------------------------


def assemble(m: dict, windows_file: str) -> dict:
    """The JSON result from the measurements ``m`` (rates in items a
    second; sections that did not run are absent): the JAX bench's keys,
    and the port's own beside them."""
    enc = m["bit_enc_per_s"]
    extras = {
        "params": "d=128 dp=128 delta=64 tau=128",
        "batch_bits": m["batch_bits"],
        "decrypt_bits_per_s": m["dec_per_s"],
        "decrypt_u32_sync_latency_us": m["dec_sync_s"] * 1e6,
        "decrypt_u32_device_latency_us": (None if m["dec_device_s"] is None
                                          else m["dec_device_s"] * 1e6),
        "decrypt_u32_device_latency_method": m["chain_method"],
        "encrypt_device_busy_bits_per_s": m["dev_enc_per_s"],
        "decrypt_device_busy_bits_per_s": m["dev_dec_per_s"],
        "add_u32_per_s_batched": m["add_per_s"],
        "add_u32_device_busy_per_s": m["dev_add_per_s"],
        "decipher_after_add_u32_per_s": m["dab_per_s"],
        "lt_u32_per_s_batched": m["lt_per_s"],
        "lt_u32_device_busy_per_s": m["dev_lt_per_s"],
        "device": m["device"],
        "platform": m["platform"],
        "device_count": m["device_count"],
    }
    if "mul_per_s" in m:
        extras["mul_u8_per_s_batched"] = m["mul_per_s"]
        extras["mul_u8_device_busy_per_s"] = m["dev_mul_per_s"]
        extras["decipher_after_mul_u8_per_s"] = m["dm_per_s"]
    if "mul16_per_s" in m:
        extras["mul_u16_per_s_batched"] = m["mul16_per_s"]
        extras["mul_u16_device_busy_per_s"] = m["dev_mul16_per_s"]
    if "mul32_per_s" in m:
        extras["mul_u32_per_s_batched"] = m["mul32_per_s"]
        extras["mul_u32_first_eval_s"] = m["mul32_first_s"]
        extras["mul_u32_product_limbs"] = m["mul32_limbs"]
        extras["mul_u32_k1_launches"] = m["mul32_k1"]
        extras["mul_u32_peak_gb"] = m["mul32_peak_gb"]
        extras["mul_u32_mask_s"] = m["mul32_mask_s"]
        extras["mul_u32_mask_launches"] = m["mul32_mask_launches"]
        extras["mul_u32_mask_device_s"] = m["mul32_mask_device_s"]
    if "s_enc_per_s" in m:
        extras["scaled_1024_encrypt_bits_per_s"] = m["s_enc_per_s"]
        extras["scaled_1024_decrypt_bits_per_s"] = m["s_dec_per_s"]
        extras["scaled_1024_encrypt_bits_per_s_2e20"] = m["l_enc_per_s"]
        extras["scaled_1024_decrypt_bits_per_s_2e20"] = m["l_dec_per_s"]
        extras["scaled_1024_encrypt_device_busy_bits_per_s"] = m["dev_senc_per_s"]
        extras["scaled_1024_decrypt_device_busy_bits_per_s"] = m["dev_sdec_per_s"]
    extras["windows_file"] = windows_file
    return {
        "metric": "bit_encryptions_per_s_per_chip",
        "value": enc,
        "unit": "bits/s",
        "vs_baseline": enc / REFERENCE_BIT_ENC_PER_S,
        "extras": extras,
        # the headline again, last, where a reader of the output's tail finds it
        "headline": {
            "bit_encryptions_per_s": enc,
            "encrypt_device_busy_bits_per_s": m["dev_enc_per_s"],
            "decrypt_bits_per_s": m["dec_per_s"],
            "decrypt_device_busy_bits_per_s": m["dev_dec_per_s"],
            "mul_u16_per_s_batched": m.get("mul16_per_s"),
            "vs_baseline": enc / REFERENCE_BIT_ENC_PER_S,
        },
    }


# --------------------------------------------------------------------------
# Sections
# --------------------------------------------------------------------------


def _bulk(t: Timer, m: dict, args, log, dev) -> dict:
    """Bulk encrypt, decrypt, the two decrypt latencies; returns what the
    later sections reuse."""
    ctx = context(PARAMS, 0, dev)
    pk, sk = ctx.get_public_key(), ctx.get_secret_key()
    L = gf2.limbs_for(ctx.parameters.pk_degree)
    n_steps = 4 if args.quick else 16
    B = args.batch_bits or (1 << 14 if args.quick else 1 << 21)
    m["batch_bits"] = B

    enc_step = encrypt_step(pk, L, B, dev)
    keys = list(bench_keys(n_steps + 4))
    it = iter(keys * 50)
    te = t.throughput(lambda: enc_step(next(it)), n_steps, label="encrypt")
    m["bit_enc_per_s"] = B / te
    log(f"encrypt: {B} bits in {te * 1e3:.3f} ms -> {B / te:,.0f} bit-enc/s")
    m["dev_enc_per_s"] = t.device_rate(lambda: enc_step(next(it)), B)
    if m["dev_enc_per_s"]:
        log(f"encrypt device-busy: {m['dev_enc_per_s']:,.0f} bit-enc/s")
    ct = enc_step(keys[0])

    w = sk.decrypt_mask(L)
    td = t.throughput(lambda: gf2.decipher_bits(ct, w), n_steps, label="decrypt")
    m["dec_per_s"] = B / td
    m["dev_dec_per_s"] = t.device_rate(lambda: gf2.decipher_bits(ct, w), B)
    log(f"decrypt: {B / td:,.0f} bit-dec/s (batch), device-busy {m['dev_dec_per_s']}")

    ct32 = ct[:32].contiguous()
    m["dec_sync_s"] = t.latency(lambda: gf2.decipher_bits(ct32, w), n_steps,
                                label="decrypt_u32_sync")
    log(f"decrypt u32 sync latency: {m['dec_sync_s'] * 1e6:.1f} us (host launch time included)")

    K1, K2 = CHAINS[0] if args.quick else CHAINS[1]
    chain = Graphed(decrypt_chain(w, K1), f"chain of {K1} decrypts")
    z0 = torch.zeros((), dtype=gf2.LIMB_DTYPE, device=dev)
    reps = max(3, n_steps // 4)
    t1 = t.latency(lambda: chain(ct32, z0), reps, label="decrypt_chain_short")
    t2 = t.latency(lambda: [chain(ct32, z0) for _ in range(K2 // K1)], reps,
                   label="decrypt_chain_long")
    # off the card the chain runs eagerly and its delta is no device time
    m["dec_device_s"] = max(0.0, (t2 - t1) / (K2 - K1)) if dev.type == "cuda" else None
    m["chain_method"] = (f"one {K1}-step chain as a CUDA graph, 1 and {K2 // K1} replays"
                         if dev.type == "cuda" else "not measured off the card")
    log(f"decrypt u32 device latency: {m['dec_device_s']} s a step "
        f"({K2} - {K1} dependent decrypts; {m['chain_method']})")
    return dict(ctx=ctx, ct=ct, L=L, it=it, keys=keys, n_steps=n_steps)


def _circuits(t: Timer, m: dict, b: dict, log, dev, quick: bool) -> None:
    """Checked u32 add and lt, the decrypt after the add."""
    ctx, ct, L, n_steps = b["ctx"], b["ct"], b["L"], b["n_steps"]
    bound = ctx.parameters.pk_degree
    n_add = 64 if quick else 2048
    ca = ht.Ciphered(ct[: n_add * 32].reshape(n_add, 32, L), bound, ht.U32)
    cb = ht.Ciphered(ct[n_add * 32: 2 * n_add * 32].reshape(n_add, 32, L), bound, ht.U32)

    add_step = compile_op2(HomomorphicAddition, ht.U32, bound)
    ta = t.throughput(lambda: add_step(ca, cb), max(8, n_steps // 2), warmup=1, label="add_u32")
    m["add_per_s"] = n_add / ta
    m["dev_add_per_s"] = t.device_rate(lambda: add_step(ca, cb), n_add, reps=2)
    log(f"hom. add u32: {n_add / ta:,.1f} adds/s batched, device-busy {m['dev_add_per_s']}")
    sum_limbs = add_step(ca, cb).limbs

    lt_step = compile_op2(HomomorphicLessThan, ht.U32, bound)
    tl = t.throughput(lambda: lt_step(ca, cb), max(8, n_steps // 2), warmup=1, label="lt_u32")
    m["lt_per_s"] = n_add / tl
    m["dev_lt_per_s"] = t.device_rate(lambda: lt_step(ca, cb), n_add, reps=2)
    log(f"hom. lt u32: {n_add / tl:,.1f} compares/s batched, device-busy {m['dev_lt_per_s']}")

    w_big = ctx.get_secret_key().decrypt_mask(sum_limbs.shape[-1])
    tdab = t.throughput(lambda: gf2.decipher_bits(sum_limbs, w_big), n_steps,
                        label="decipher_after_add")
    m["dab_per_s"] = n_add / tdab
    log(f"decipher-after-add u32: {n_add / tdab:,.1f}/s batched")


def _mul8(t: Timer, m: dict, log, dev) -> None:
    """Checked u8 product of 1,024 pairs (delta = 1), and its decrypt."""
    n_mul = 1024
    mctx = context((128, 128, 1, 128), 3, dev)
    ma = mctx.encrypt([6] * n_mul, ht.U8, batch=True)
    mb = mctx.encrypt([7] * n_mul, ht.U8, batch=True)
    mul_step = compile_op2(HomomorphicMultiplication, ht.U8, mctx.parameters.pk_degree)
    tm = t.throughput(lambda: mul_step(ma, mb), 6, warmup=1, label="mul_u8")
    m["mul_per_s"] = n_mul / tm
    m["dev_mul_per_s"] = t.device_rate(lambda: mul_step(ma, mb), n_mul, reps=2)
    log(f"hom. mul u8: {n_mul / tm:,.2f} muls/s batched, device-busy {m['dev_mul_per_s']}")
    prod = mul_step(ma, mb).limbs
    w_mul = mctx.get_secret_key().decrypt_mask(prod.shape[-1])
    tdm = t.throughput(lambda: gf2.decipher_bits(prod, w_mul), 6, label="decipher_after_mul")
    m["dm_per_s"] = n_mul / tdm
    log(f"decipher-after-mul u8: {n_mul / tdm:,.1f}/s batched")


def _fatal(msg: str) -> None:
    print(f"FATAL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def wide_context(params, dev):
    """The u16 and u32 products' context: keys from
    :data:`~homomorph_tpu_torch.experiments.common.CHECK_SEED`, whose ``S(0)
    = 1`` makes the decrypt check read every coefficient of the product (the
    JAX bench's seed 11 gives ``S(0) = 0``, with which a decrypt reads only
    the constant term).  Refuses a key with ``S(0) = 0``."""
    ctx = context(params, CHECK_SEED, dev)
    if key_s0(ctx) != 1:
        _fatal(f"ThreefrySource({CHECK_SEED}) gave a key with S(0) = 0: the decrypt "
               "would check only the product's constant term")
    return ctx


def _mul16(t: Timer, m: dict, log, dev) -> None:
    """Checked u16 product of 512 random pairs, decrypted and compared."""
    n = 512
    wctx = wide_context(MUL16_PARAMS, dev)
    rng = np.random.default_rng(7)
    xs = [int(v) for v in rng.integers(0, 1 << 16, size=n)]
    ys = [int(v) for v in rng.integers(0, 1 << 16, size=n)]
    wa = wctx.encrypt(xs, ht.U16, batch=True)
    wb = wctx.encrypt(ys, ht.U16, batch=True)
    step = compile_op2(HomomorphicMultiplication, ht.U16, wctx.parameters.pk_degree)
    got = [int(v) for v in wctx.decrypt(step(wa, wb))]
    if got != [(x * y) & 0xFFFF for x, y in zip(xs, ys)]:
        _fatal(f"the u16 product decrypted incorrectly on {dev}")
    log(f"u16 product decrypts correctly on {dev} (key with S(0) = 1)")
    tm = t.throughput(lambda: step(wa, wb), 2, warmup=0, label="mul_u16")
    m["mul16_per_s"] = n / tm
    m["dev_mul16_per_s"] = t.device_rate(lambda: step(wa, wb), n, reps=2)
    log(f"hom. mul u16: {n / tm:,.1f} muls/s batched, device-busy {m['dev_mul16_per_s']}")


def mul32_inputs(dev, params=MUL32_PARAMS, n: int = 8):
    """The u32 product's context and operands (``bench.py:389-397``, with
    :func:`wide_context`'s key): ``(ctx, a, b, xs, ys)``."""
    ctx = wide_context(params, dev)
    rng = np.random.default_rng(7)
    xs = [int(v) for v in rng.integers(0, 1 << 32, size=n)]
    ys = [int(v) for v in rng.integers(0, 1 << 32, size=n)]
    a = ctx.encrypt(xs, ht.U32, batch=True)
    b = ctx.encrypt(ys, ht.U32, batch=True)
    return ctx, a, b, xs, ys


def _mul32(t: Timer, m: dict, log, dev) -> None:
    """The u32 product of 8 pairs at d = 5888, eager, decrypted and
    compared; its first call's wall time, K1 launches and peak memory, and
    its decrypt mask's wall time before the windows and device time after
    them."""
    ctx, a, b, xs, ys = mul32_inputs(dev)
    p = ctx.parameters
    req = HomomorphicMultiplication.requirement_for(a, b)
    if p.d // p.delta < req:
        raise ValueError(f"d/delta = {p.d // p.delta} is below the u32 product's bound {req}")

    def step():
        return circuits.mul_unsigned(a, b).limbs

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k1 = counters["K1"]
    t.sync()
    t0 = time.perf_counter()
    prod = step()
    t.sync()
    m["mul32_first_s"] = time.perf_counter() - t0
    m["mul32_k1"] = counters["K1"] - k1
    m["mul32_peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else None)
    m["mul32_limbs"] = int(prod.shape[-1])
    m["mul32_mask_s"], m["mul32_mask_launches"] = mask_wall_s(t, ctx.get_secret_key(),
                                                              prod.shape[-1])
    got = [int(v) for v in ctx.decrypt(ht.Ciphered(prod, int(prod.shape[-1]) * 32 - 1, ht.U32))]
    if got != [(x * y) & 0xFFFFFFFF for x, y in zip(xs, ys)]:
        _fatal(f"the u32 product decrypted incorrectly on {dev}")
    log(f"u32 product decrypts correctly on {dev} (key with S(0) = 1; first eval {m['mul32_first_s']:.3f} s, "
        f"{m['mul32_k1']} K1 launches, peak {m['mul32_peak_gb']} GB, product "
        f"{m['mul32_limbs']} limbs a lane, mask {m['mul32_mask_s']:.6f} s wall, launches "
        f"{m['mul32_mask_launches']})")
    limbs = prod.shape[-1]
    del prod
    tm = t.throughput(step, 2, warmup=0, label="mul_u32")
    m["mul32_per_s"] = len(xs) / tm
    log(f"hom. mul u32: {len(xs) / tm:,.3f} muls/s batched")
    m["mul32_mask_device_s"] = mask_device_s(t, ctx.get_secret_key(), limbs)
    log(f"u32 product's decrypt mask: {m['mul32_mask_device_s']} s device")


def _scaled(t: Timer, m: dict, b: dict, log, dev) -> None:
    """Bulk encrypt and decrypt at d = dp = 1024, tau = 256: 100,352 and
    2^20 bits."""
    it, keys, n_steps = b["it"], b["keys"], b["n_steps"]
    sctx = context(SCALED_PARAMS, 2, dev)
    spk, ssk = sctx.get_public_key(), sctx.get_secret_key()
    sL = gf2.limbs_for(sctx.parameters.pk_degree)
    sw = ssk.decrypt_mask(sL)
    sB = 100_352
    senc = encrypt_step(spk, sL, sB, dev)
    ts = t.throughput(lambda: senc(next(it)), max(4, n_steps // 2), label="scaled_encrypt_1e5")
    sct = senc(keys[0])
    tsd = t.throughput(lambda: gf2.decipher_bits(sct, sw), max(4, n_steps // 2),
                       label="scaled_decrypt_1e5")
    m["s_enc_per_s"], m["s_dec_per_s"] = sB / ts, sB / tsd
    log(f"scaled d=dp=1024 tau=256: enc {sB / ts:,.0f} bits/s, dec {sB / tsd:,.0f} bits/s")
    del sct

    lB = 1 << 20
    lenc = encrypt_step(spk, sL, lB, dev)
    tl = t.throughput(lambda: lenc(next(it)), max(3, n_steps // 4), label="scaled_encrypt_2e20")
    lct = lenc(keys[1])
    tld = t.throughput(lambda: gf2.decipher_bits(lct, sw), max(3, n_steps // 4),
                       label="scaled_decrypt_2e20")
    m["l_enc_per_s"], m["l_dec_per_s"] = lB / tl, lB / tld
    k2 = keys[2]
    m["dev_senc_per_s"] = t.device_rate(lambda: lenc(k2), lB, reps=2)
    m["dev_sdec_per_s"] = t.device_rate(lambda: gf2.decipher_bits(lct, sw), lB, reps=2)
    log(f"scaled @2^20: enc {lB / tl:,.0f} bits/s, dec {lB / tld:,.0f} bits/s; device-busy "
        f"enc {m['dev_senc_per_s']}, dec {m['dev_sdec_per_s']}")


def run(args, log) -> dict:
    """Every section the flags ask for, after the verify gate; returns the
    result (:func:`assemble`)."""
    from homomorph_tpu_torch.device import resolve

    dev = resolve(args.device)
    ht.enable_compilation_cache()
    if dev.type == "cuda":
        from homomorph_tpu_torch.gf2 import cuda_build

        cuda_build.build()
    m = {"device": card_line(dev), "platform": "gpu" if dev.type == "cuda" else dev.type,
         "device_count": torch.cuda.device_count() if dev.type == "cuda" else 1}
    log(f"device: {m['device']}")

    if os.environ.get(SKIP_VERIFY_ENV, "0") == "1":
        print(f"WARNING: {SKIP_VERIFY_ENV}=1 - emitting UNVERIFIED numbers", file=sys.stderr)
    else:
        ht.run_verification(quick=args.quick, log=log, scaled=not args.skip_scaled, device=dev)

    t = Timer(dev)
    b = _bulk(t, m, args, log, dev)
    _circuits(t, m, b, log, dev, args.quick)
    if not args.quick:
        _mul8(t, m, log, dev)
        _mul16(t, m, log, dev)
        if args.with_mul32:
            _mul32(t, m, log, dev)
        if not args.skip_scaled:
            _scaled(t, m, b, log, dev)

    path = build_dir() / "bench_windows.json"
    with open(path, "w") as f:
        json.dump(t.stats, f, indent=1)
    return assemble(m, str(path))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small shapes / few steps")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--batch-bits", type=int, default=0, help="override bit batch")
    ap.add_argument("--skip-scaled", action="store_true")
    ap.add_argument("--with-mul32", action="store_true",
                    help="also run the u32 product at d = 5888")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    def log(*a):
        if not args.json_only:
            print(*a, file=sys.stderr, flush=True)

    print(json.dumps(run(args, log)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
