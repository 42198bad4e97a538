"""On-device correctness gate: run the port's kernels on the card and assert
bit-exact results before trusting any benchmark number.

Counterpart of :mod:`homomorph_tpu.verify`.  The CPU tests run every
wrapper's plain torch version, so the CUDA kernels are otherwise exercised
only by ``chip_smoke.py`` and the card tests; a benchmark of the port calls
:func:`run_verification` on the card it is about to time and refuses to
report when it raises.

The checks are the JAX package's five, through the port's paths: the clmul
dispatcher against a big-int oracle at shapes that take each of its routes
(one direct K1 launch, a Karatsuba split, the chunks of an unbalanced
product); the reference's golden vectors (src/polynomial.rs:522-591)
through K1, :func:`~homomorph_tpu_torch.gf2.poly.rem_iterative` and the
linear map (:func:`~homomorph_tpu_torch.gf2.poly.reduction_rows` +
:func:`~homomorph_tpu_torch.gf2.poly.rem_linear`); encrypt -> decrypt
round trips with NONZERO plaintexts from T1's words through K2; the typed
u32 round trip; and u8 add, ``lt`` and mul at exact noise bounds.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["VerificationError", "run_verification"]


class VerificationError(AssertionError):
    """A kernel of the port returned wrong bits on the device checked."""


# --------------------------------------------------------------------------
# Host oracle (Python big-int carry-less arithmetic - trivially correct)
# --------------------------------------------------------------------------


def _limbs_to_int(row: np.ndarray) -> int:
    return int.from_bytes(np.asarray(row, dtype="<u4").tobytes(), "little")


def _int_to_limbs(x: int, L: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(4 * L, "little"), dtype="<u4").astype(np.uint32)


def _int_clmul(x: int, y: int) -> int:
    r = 0
    while y:
        lsb = y & -y
        r ^= x << (lsb.bit_length() - 1)
        y ^= lsb
    return r


def _int_rem(c: int, s: int) -> int:
    ds = s.bit_length() - 1
    while c.bit_length() - 1 >= ds and c:
        c ^= s << (c.bit_length() - 1 - ds)
    return c


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------

#: (name, La, Lb, B): the JAX gate's three shapes and one unbalanced product
CLMUL_SHAPES = (
    ("small", 8, 8, 256),
    ("unbalanced", 72, 56, 128),
    ("karatsuba", 64, 64, 128),
    ("chunks", 64, 256, 128),
)


def _check_clmul_shapes(failures: list, log, dev: torch.device) -> None:
    """The clmul dispatcher against the big-int oracle at shapes that take
    each route the port has; the route :func:`~homomorph_tpu_torch.gf2.
    kernels.route_plan` gives each shape is logged.  On the card, every
    product must launch K1 once."""
    from .gf2 import kernels as gf2k
    from .gf2 import poly as gf2
    from .utils.profiling import counters

    rng = np.random.default_rng(0xC1A0)
    for name, La, Lb, B in CLMUL_SHAPES:
        a = rng.integers(0, 1 << 32, size=(B, La), dtype=np.uint32)
        b = rng.integers(0, 1 << 32, size=(B, Lb), dtype=np.uint32)
        before = counters["K1"]
        got = gf2.to_numpy(gf2k.clmul(gf2.from_numpy(a, dev), gf2.from_numpy(b, dev)))
        steps = gf2k.route_plan(min(La, Lb), max(La, Lb), gf2k.karatsuba_min())
        route = "+".join(s[0] for s in steps) if gf2k._routed(dev) and steps else "direct"
        if dev.type == "cuda" and counters["K1"] != before + 1:
            failures.append(
                f"clmul[{name}]: {counters['K1'] - before} K1 launches, expected 1"
            )
            continue
        # oracle-check a sample of rows (the kernel is batch-uniform)
        for i in range(0, B, max(1, B // 16)):
            want = _int_clmul(_limbs_to_int(a[i]), _limbs_to_int(b[i]))
            if _limbs_to_int(got[i]) != want:
                failures.append(f"clmul[{name}] row {i}: product != big-int oracle")
                break
        else:
            log(f"verify: clmul[{name}] ({La}x{Lb} limbs, B={B}, route {route}) ok")


def _check_golden_vectors(failures: list, log, dev: torch.device) -> None:
    """The reference's hand-computed vectors (src/polynomial.rs:522-591)
    through the clmul and remainder paths, broadcast over 128 rows."""
    from .gf2 import kernels as gf2k
    from .gf2 import poly as gf2

    B = 128

    def rows(*words):
        return gf2.from_numpy(np.tile(np.array(words, dtype=np.uint32), (B, 1)), dev)

    # (X^3 + 1)(X + 1) = X^4 + X^3 + X + 1  (polynomial.rs:538-547)
    got = gf2.to_numpy(gf2k.clmul(rows(0b1001), rows(0b11)))
    if not (got[:, 0] == 0b11011).all() or got[:, 1:].any():
        failures.append("golden mul vector (X^3+1)(X+1) wrong")
    else:
        log("verify: golden mul vector ok")

    # X^9+X^7+X^5+X^3+X^2+1 mod X^4+X^3+X+1 = X^3+X  (polynomial.rs:563-582)
    c = rows(0b1010101101, 0)
    s = gf2.from_numpy(np.array([0b11011], dtype=np.uint32), dev)
    want = _int_rem(0b1010101101, 0b11011)
    r = gf2.to_numpy(gf2.rem_iterative(c, s, 4))
    if not (r[:, 0] == want).all() or r[:, 1:].any():
        failures.append("golden rem vector wrong (rem_iterative)")
    else:
        log("verify: golden rem vector ok")

    # the linear map (reduction rows from the native engine) must agree
    table = gf2.reduction_rows(s, 4, gf2.bit_capacity(2))
    rl = gf2.to_numpy(gf2.rem_linear(c, table))
    if not (rl[:, 0] == want).all():
        failures.append("rem_linear disagrees with the golden rem vector")
    else:
        log("verify: linear-map reduction ok")


def _roundtrip(failures: list, log, dev, params, seed: int, key_seed: int, label: str):
    """Encrypt 4,096 random bits (T1 words under ``threefry_key(key_seed)``,
    K2) and decrypt them with the key's mask; returns the context."""
    from . import Context
    from . import prng
    from . import rng as _rng
    from .gf2 import encrypt_kernel as enc
    from .gf2 import poly as gf2

    ctx = Context(params, encrypt_seed=seed, device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    pk, sk = ctx.get_public_key(), ctx.get_secret_key()
    B = 4096
    plain = np.random.default_rng(key_seed).integers(0, 2, size=B, dtype=np.uint32)
    L = gf2.limbs_for(params.pk_degree)
    selw = prng.random_bits(_rng.threefry_key(key_seed), (B, -(-params.tau // 32)), dev)
    ct = enc.encrypt_words_table(selw, pk.limbs, gf2.from_numpy(plain, dev), L)
    bits = gf2.decipher_bits(ct, sk.decrypt_mask(L)).cpu().numpy()
    if not (bits == plain).all():
        failures.append(f"{label} round trip: {int((bits != plain).sum())}/{B} bits wrong")
    else:
        log(f"verify: {label} encrypt->decrypt round trip ok ({B} nonzero bits)")
    return ctx


def _check_roundtrip(failures: list, log, dev: torch.device) -> None:
    """Round trip at ``Parameters(128, 128, 64, 128)``, then the typed u32
    round trip of 32 values through ``Context.encrypt``."""
    from . import U32, Parameters

    ctx = _roundtrip(failures, log, dev, Parameters(128, 128, 64, 128), 0xF00D, 3,
                     "d=dp=128 tau=128")
    vals = [int(v) for v in np.random.default_rng(7).integers(0, 2**32, size=32, dtype=np.uint64)]
    got = [int(v) for v in ctx.decrypt(ctx.encrypt(vals, U32, batch=True))]
    if got != vals:
        failures.append("typed u32 encrypt->decrypt round trip wrong")
    else:
        log("verify: typed u32 round trip ok (32 values)")


def _check_roundtrip_scaled(failures: list, log, dev: torch.device) -> None:
    """Round trip at the scaled ``Parameters(1024, 1024, 64, 256)``."""
    from . import Parameters

    _roundtrip(failures, log, dev, Parameters(1024, 1024, 64, 256), 0x5CA1ED, 5,
               "scaled d=dp=1024 tau=256")


def _check_circuits(failures: list, log, dev: torch.device, with_mul: bool) -> None:
    """u8 add and ``lt`` (and mul), decrypted and compared, at parameters
    that meet the EXACT noise bounds (models/noise.py), so a mismatch can
    only be a kernel bug, never noise."""
    from . import U8, Context, Parameters
    from .models import circuits

    rng = np.random.default_rng(21)
    B = 128

    def context(params, seed):
        ctx = Context(params, encrypt_seed=seed, device=dev)
        ctx.generate_secret_key()
        ctx.generate_public_key()
        return ctx

    # add: u8 requirement 17 <= d/delta = 64; lt: 19 <= 64
    ctx = context(Parameters(64, 16, 1, 16), 11)
    xs = [int(v) for v in rng.integers(0, 256, size=B)]
    ys = [int(v) for v in rng.integers(0, 256, size=B)]
    a, b = ctx.encrypt(xs, U8, batch=True), ctx.encrypt(ys, U8, batch=True)
    got = [int(v) for v in ctx.decrypt(circuits.add(a, b))]
    if got != [(x + y) & 0xFF for x, y in zip(xs, ys)]:
        failures.append("u8 homomorphic add wrong")
    else:
        log(f"verify: u8 add ok ({B} random operand pairs)")
    lt = [bool(v) for v in ctx.decrypt(circuits.lt(a, b))]
    if lt != [x < y for x, y in zip(xs, ys)]:
        failures.append("u8 homomorphic lt wrong")
    else:
        log("verify: u8 lt ok")
    if not with_mul:
        return

    # mul: u8 exact requirement 65 <= d/delta = 160
    mctx = context(Parameters(160, 16, 1, 16), 13)
    xs = [int(v) for v in rng.integers(0, 256, size=B)]
    ys = [int(v) for v in rng.integers(0, 256, size=B)]
    a, b = mctx.encrypt(xs, U8, batch=True), mctx.encrypt(ys, U8, batch=True)
    got = [int(v) for v in mctx.decrypt(circuits.mul_unsigned(a, b))]
    if got != [(x * y) & 0xFF for x, y in zip(xs, ys)]:
        failures.append("u8 homomorphic mul wrong")
    else:
        log(f"verify: u8 mul ok ({B} random operand pairs)")


def run_verification(quick: bool = False, log=None, scaled: bool = True, device=None) -> None:
    """Run every correctness check on ``device`` (``None`` means the CUDA
    card; it raises without one) and raise :class:`VerificationError`
    listing all failures.

    ``quick=True`` skips the multiplier circuit and the scaled round trip;
    ``scaled=False`` skips only the scaled round trip (d=dp=1024,
    tau=256).  There is no soft-fail mode: a caller that wants to skip the
    gate must not call it.
    """
    from .device import resolve

    dev = resolve(device)
    if log is None:
        def log(*a):  # default stderr logger
            import sys

            print(*a, file=sys.stderr)

    failures: list[str] = []
    _check_clmul_shapes(failures, log, dev)
    _check_golden_vectors(failures, log, dev)
    _check_roundtrip(failures, log, dev)
    _check_circuits(failures, log, dev, with_mul=not quick)
    if scaled and not quick:
        _check_roundtrip_scaled(failures, log, dev)
    if failures:
        raise VerificationError(
            "on-device verification FAILED:\n  - " + "\n  - ".join(failures)
        )
