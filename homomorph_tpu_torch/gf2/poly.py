"""Batched GF(2) polynomial arithmetic on bit-packed limbs, in torch ops.

Counterpart of :mod:`homomorph_tpu.gf2.poly` (reference:
src/polynomial.rs).  Layout parity: coefficient of ``X^i`` is bit ``i % 32``
of limb ``i // 32`` (LSB-first within each limb), so the on-wire byte
format (LE bytes, src/polynomial.rs:98-122) is identical to the JAX
package's and to the reference's regardless of word size.

Limbs are stored as ``int32`` bit patterns: torch lacks ``<<``, ``>>`` and
comparisons on ``uint32``.  Left shifts wrap exactly as on ``uint32``; a
logical right shift is an arithmetic shift followed by a mask
(:func:`srl`).  Limbs convert to and from numpy ``uint32`` with ``.view``
(:func:`to_numpy`, :func:`from_numpy`).

Every function is shape-polymorphic over leading batch dimensions; limbs
live on the trailing axis.  A tensor of ``L`` limbs holds polynomials of
degree < ``32*L`` (the *degree class*); the exact degree is computed on
demand with :func:`compute_degree`.

The plain :func:`clmul` here is the 32-plane sweep of the JAX package; the
product that the rest of the port calls is
:func:`homomorph_tpu_torch.gf2.kernels.clmul`, which launches the CUDA
kernel for tensors on the card.

Remainders: reduction mod a fixed ``S`` is GF(2)-linear in the dividend,
so decryption uses a mask (:func:`decrypt_mask`) and the full remainder a
table of ``X^i mod S`` rows (:func:`reduction_rows`, :func:`rem_linear`).
The mask is a power series computed on the tensor's device
(:mod:`homomorph_tpu_torch.gf2.mask_kernel`); the table comes from the
native host engine (:mod:`homomorph_tpu_torch.native`), which runs the JAX
package's monic recurrence in C, and moves to the tensor's device.
:func:`rem_iterative`, the fixed-trip masked division, is kept for API
parity and as a cross-check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import native as _native
from ..device import resolve as _resolve

LIMB_BITS = 32
LIMB_DTYPE = torch.int32


def limbs_for(bound: int) -> int:
    """Number of limbs needed for polynomials of degree <= ``bound``."""
    return bound // LIMB_BITS + 1


def bit_capacity(num_limbs: int) -> int:
    return num_limbs * LIMB_BITS


def bucket(num_limbs: int) -> int:
    """Round a limb count up to a geometric bucket (1/8-octave steps).

    The same degree-class quantization as the JAX package, kept so that
    ciphertext shapes (and the wire header's ``L``) agree limb for limb.
    """
    if num_limbs <= 8:
        return num_limbs
    q = 1 << max(0, (num_limbs - 1).bit_length() - 2)
    return -(-num_limbs // q) * q


def pad_limbs(x: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """Zero-pad (or keep) the trailing limb axis to ``num_limbs``."""
    L = x.shape[-1]
    if L == num_limbs:
        return x
    if L > num_limbs:
        raise ValueError(f"cannot shrink limbs {L} -> {num_limbs}")
    return F.pad(x, (0, num_limbs - L))


def fit_limbs(x: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """Pad or trim the limb axis to ``num_limbs``.

    Trimming is only sound when the caller knows the dropped limbs are zero
    (i.e. the true degree bound fits in ``num_limbs``)."""
    if x.shape[-1] < num_limbs:
        return pad_limbs(x, num_limbs)
    return x[..., :num_limbs]


# --------------------------------------------------------------------------
# Construction and host conversion
# --------------------------------------------------------------------------


def to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> numpy ``uint32`` (same bits, host copy)."""
    return limbs.detach().to("cpu").contiguous().numpy().view(np.uint32)


def from_numpy(limbs: np.ndarray, device=None) -> torch.Tensor:
    """numpy ``uint32`` limbs -> int32 tensor on ``device`` (same bits)."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(_resolve(device))


def null(num_limbs: int = 1, batch: tuple[int, ...] = (), device=None) -> torch.Tensor:
    """The null polynomial (degree 0 by convention, src/polynomial.rs:124-137)."""
    return torch.zeros(batch + (num_limbs,), dtype=LIMB_DTYPE, device=_resolve(device))


def monomial(degree: int, num_limbs: int | None = None, device=None) -> torch.Tensor:
    """``X^degree`` (src/polynomial.rs:139-150)."""
    L = limbs_for(degree) if num_limbs is None else num_limbs
    out = np.zeros(L, dtype=np.uint32)
    out[degree // LIMB_BITS] = np.uint32(1 << (degree % LIMB_BITS))
    return from_numpy(out, device)


# --------------------------------------------------------------------------
# Bit helpers
# --------------------------------------------------------------------------


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a static ``k``."""
    if k == 0:
        return x
    if k >= LIMB_BITS:
        return torch.zeros_like(x)
    return (x >> k) & ((1 << (LIMB_BITS - k)) - 1)


def xor_fold(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """XOR-reduce ``dim`` (torch has no XOR reduction): a halving tree."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while n > 1:
        h = n // 2
        head = x[..., :h] ^ x[..., h : 2 * h]
        x = torch.cat([head, x[..., 2 * h :]], dim=-1) if n % 2 else head
        n = x.shape[-1]
    return x[..., 0]


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Parity of the 32 bits of each int32 (torch has no popcount).

    The arithmetic shifts drag sign bits into the high half, but each step
    only reads bits that are still exact, and bit 0 ends as the parity."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


# --------------------------------------------------------------------------
# Degree / evaluation
# --------------------------------------------------------------------------


def compute_degree(limbs: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit; 0 for the null polynomial (by convention).

    Torch has no ``clz``: the highest bit of each limb comes from a
    five-step binary search on the limb widened to a non-negative int64
    (a limb with bit 31 set is negative as int32)."""
    L = limbs.shape[-1]
    u = limbs.to(torch.int64) & 0xFFFFFFFF
    hb = torch.zeros_like(u)
    for s in (16, 8, 4, 2, 1):
        up = u >> s
        m = up != 0
        hb = hb + m * s
        u = torch.where(m, up, u)
    offsets = torch.arange(L, dtype=torch.int64, device=limbs.device) * LIMB_BITS
    cand = torch.where(limbs != 0, offsets + hb, torch.full_like(hb, -1))
    return cand.amax(dim=-1).clamp_min(0).to(torch.int32)


def is_null(limbs: torch.Tensor) -> torch.Tensor:
    return (limbs == 0).all(dim=-1)


def evaluate_at_zero(limbs: torch.Tensor) -> torch.Tensor:
    """``P(0)`` = constant-term bit (src/polynomial.rs:168-173)."""
    return limbs[..., 0] & 1


def evaluate_at_one(limbs: torch.Tensor) -> torch.Tensor:
    """``P(1)`` = parity of the total popcount (src/polynomial.rs:175-181)."""
    return parity32(xor_fold(limbs))


def evaluate(limbs: torch.Tensor, x: bool) -> torch.Tensor:
    return evaluate_at_one(limbs) if x else evaluate_at_zero(limbs)


# --------------------------------------------------------------------------
# Add (XOR) family
# --------------------------------------------------------------------------


def xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial addition over GF(2) (src/polynomial.rs:190-213)."""
    L = max(a.shape[-1], b.shape[-1])
    return pad_limbs(a, L) ^ pad_limbs(b, L)


def xor_const_bit(a: torch.Tensor, bit: "torch.Tensor | int") -> torch.Tensor:
    """Conditionally flip the constant term (src/polynomial.rs:237-243).

    A Python-int ``bit`` stays a scalar operand: no host-to-device copy,
    which a CUDA graph capture could not hold."""
    if not isinstance(bit, torch.Tensor):
        bit = int(bit) & 1
    else:
        bit = bit.to(a.dtype) & 1
    out = a.clone()
    out[..., 0] ^= bit
    return out


# --------------------------------------------------------------------------
# Shifts
# --------------------------------------------------------------------------


def _shift_limbs(x: torch.Tensor, ws: int) -> torch.Tensor:
    """Move limbs up by ``ws`` positions within the same width."""
    L = x.shape[-1]
    if ws >= L:
        return torch.zeros_like(x)
    return F.pad(x[..., : L - ws], (ws, 0))


def shift_left_static(x: torch.Tensor, k: int, out_limbs: int) -> torch.Tensor:
    """``x << k`` (multiply by X^k) with static shift, into ``out_limbs``."""
    ws, bs = divmod(k, LIMB_BITS)
    xp = pad_limbs(x, out_limbs)
    lo = _shift_limbs(xp, ws)
    if bs == 0:
        return lo
    return (lo << bs) | srl(_shift_limbs(xp, ws + 1), LIMB_BITS - bs)


def shift_left_dynamic(
    x: torch.Tensor, shift: "torch.Tensor | int", out_limbs: int
) -> torch.Tensor:
    """``x << shift`` with a runtime scalar shift, into ``out_limbs`` limbs.

    PyTorch runs eagerly, so the shift is read as a Python int and the
    static form computes the same bits."""
    return shift_left_static(x, int(shift), out_limbs)


# --------------------------------------------------------------------------
# Carry-less multiplication (plain sweep)
# --------------------------------------------------------------------------


def _skew_xor_reduce(mat: torch.Tensor, T: int) -> torch.Tensor:
    """XOR-reduce anti-diagonals: out[m] = XOR_{i+j=m} mat[..., i, j].

    Padding each of the R rows to T+1 entries and reading the flat buffer
    as rows of T entries shifts row r right by r positions, which aligns
    the anti-diagonals into columns.  Requires ``T >= R + C - 1``.
    """
    R, C = mat.shape[-2], mat.shape[-1]
    assert T >= R + C - 1
    lead = mat.shape[:-2]
    m = F.pad(mat, (0, T + 1 - C))
    flat = m.reshape(*lead, R * (T + 1))[..., : R * T]
    return xor_fold(flat.reshape(*lead, R, T), dim=-2)


def clmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less (GF(2)) polynomial product of bit-packed operands.

    ``a``: [..., La] limbs, ``b``: [..., Lb] limbs -> [..., La+Lb] limbs,
    broadcast over leading dims.  Branch-free 32-plane sweep over the bits
    of ``a`` (replacing the reference's per-set-bit loop,
    src/polynomial.rs:252-310), then an anti-diagonal XOR reduction.
    Materializes [..., La, Lb]; :func:`homomorph_tpu_torch.gf2.kernels.
    clmul_plain` chunks the batch to bound that.
    """
    La, Lb = a.shape[-1], b.shape[-1]
    a_e = a[..., :, None]
    b_e = b[..., None, :]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lo = torch.zeros(lead + (La, Lb), dtype=LIMB_DTYPE, device=a.device)
    hi = torch.zeros_like(lo)
    for k in range(LIMB_BITS):
        sel = -((a_e >> k) & 1)  # all-ones where bit k of a is set
        lo ^= (b_e << k) & sel
        if k:
            hi ^= srl(b_e, LIMB_BITS - k) & sel
    T = La + Lb - 1
    diag_lo = _skew_xor_reduce(lo, T)  # contributes to limb i+j
    diag_hi = _skew_xor_reduce(hi, T)  # contributes to limb i+j+1
    return F.pad(diag_lo, (0, 1)) ^ F.pad(diag_hi, (1, 0))


_CLMUL_ELEM_CAP = 1 << 22  # cap on La*Lb*batch elements materialized at once


def clmul_chunked(
    a: torch.Tensor, b: torch.Tensor, cap: "int | None" = None
) -> torch.Tensor:
    """:func:`clmul` in chunks of the flattened batch, so that the
    [chunk, La, Lb] planes stay under ``cap`` elements (default
    :data:`_CLMUL_ELEM_CAP`, the JAX package's).  Same result as
    :func:`clmul`, broadcast over leading dims."""
    La, Lb = a.shape[-1], b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    batch = math.prod(lead)
    cap = _CLMUL_ELEM_CAP if cap is None else cap
    if batch * La * Lb <= cap or not lead:
        return clmul(a, b)
    af = a.expand(*lead, La).reshape(batch, La)
    bf = b.expand(*lead, Lb).reshape(batch, Lb)
    chunk = max(1, cap // (La * Lb))
    out = torch.cat(
        [clmul(af[r : r + chunk], bf[r : r + chunk]) for r in range(0, batch, chunk)]
    )
    return out.reshape(*lead, La + Lb)


# --------------------------------------------------------------------------
# Remainder
# --------------------------------------------------------------------------


def rem_iterative(c: torch.Tensor, s: torch.Tensor, s_degree: int) -> torch.Tensor:
    """Fixed-trip masked long division: remainder of ``c`` mod ``s``.

    The JAX package's branch-free re-design of the reference's shift-XOR
    loop (src/polynomial.rs:316-365): exactly ``32*L - s_degree``
    iterations, from the top shift down, each XORing ``s << shift`` where
    bit ``s_degree + shift`` of the running remainder is set (as a mask, no
    branch on data).  ``s_degree`` is the exact degree of ``s``.  Batched
    over leading dims of ``c``; ``s`` is shared.  Returns limbs of the same
    length as ``c``.
    """
    L = c.shape[-1]
    max_shift = bit_capacity(L) - 1 - s_degree
    if max_shift < 0:
        return c
    r = c.clone()
    for shift in range(max_shift, -1, -1):
        pos = s_degree + shift
        bit = (r[..., pos // LIMB_BITS] >> (pos % LIMB_BITS)) & 1
        r ^= (-bit)[..., None] & shift_left_static(s, shift, L)
    return r


def reduction_rows(s: torch.Tensor, s_degree: int, n_rows: int) -> torch.Tensor:
    """Rows ``X^i mod S`` for i in [0, n_rows), bit-packed [n_rows, Ls] on
    ``s``'s device, ``Ls = limbs_for(s_degree)``; bit ``s_degree`` of every
    row is 0.

    The core of linear-map reduction: ``C mod S = XOR_i C_i * (X^i mod S)``.
    The JAX package runs the monic recurrence ``r' = (r << 1) ^ (bit_d(r <<
    1) ? S : 0)`` as a device scan; the port runs the same recurrence in
    the native engine (:func:`homomorph_tpu_torch.native.reduction_rows`)
    and moves the table to the device.  Requires ``S`` of exact degree
    ``s_degree``, which keygen forces (src/polynomial.rs:89-90).
    """
    # fit, not pad: a key loaded from the reference's 64-bit-word byte
    # format may carry a trailing all-zero limb; trimming is sound because
    # deg S = s_degree
    host = to_numpy(fit_limbs(s, limbs_for(s_degree)))
    return from_numpy(_native.reduction_rows(host, s_degree, n_rows), s.device)


def rem_linear(c: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Full remainder via the linear map: ``c mod S`` for shared ``S``.

    ``c``: [..., L]; ``rows``: [>= 32*L, Ls] from :func:`reduction_rows`.
    Returns [..., Ls].  The XOR-accumulation is a parity matmul: the bits
    of ``c`` times the bits of the rows as a ``torch.matmul`` of 0/1
    float32 values, whose counts are exact while ``32*L < 2^24`` (inputs
    of 0 and 1 are exact in TF32 and bf16 too, and the sums accumulate in
    float32), then each count's parity packed into limbs.
    """
    L = c.shape[-1]
    n_bits = bit_capacity(L)
    if rows.shape[0] < n_bits or n_bits >= 1 << 24:
        raise ValueError(f"rem_linear needs {n_bits} rows below 2^24, got {rows.shape[0]}")
    c_bits = unpack_bits(c, n_bits, dtype=torch.float32)
    rows_bits = unpack_bits(rows[:n_bits], bit_capacity(rows.shape[-1]), dtype=torch.float32)
    return parity_pack(torch.matmul(c_bits, rows_bits), rows.shape[-1])


# --------------------------------------------------------------------------
# Decryption by mask
# --------------------------------------------------------------------------


def decrypt_mask_words(s: np.ndarray, s_degree: int, n_limbs: int) -> np.ndarray:
    """Host mask: ``uint32`` words with bit ``i`` = ``(X^i mod S)(0)``.

    The monic recurrence ``r' = (r << 1) ^ (bit_d(r << 1) ? S : 0)`` of the
    JAX package (``poly.py:352-380``), run on Python integers: exact, and
    ``32 * n_limbs`` steps of a few big-int operations each.  The plain
    version that the tests and ``chip_smoke.py`` hold the native engine's
    mask and the device route's (:func:`decrypt_mask`) against.
    """
    s_int = int.from_bytes(np.asarray(s, dtype="<u4").tobytes(), "little")
    top = 1 << s_degree
    n_rows = bit_capacity(n_limbs)
    bits = bytearray(n_rows)
    r = 1
    for i in range(n_rows):
        bits[i] = r & 1
        r <<= 1
        if r & top:
            r ^= s_int
    packed = np.packbits(np.frombuffer(bytes(bits), dtype=np.uint8), bitorder="little")
    return packed.view("<u4").astype(np.uint32)


def decrypt_mask(
    s: torch.Tensor, s_degree: int, n_limbs: int, sstar: "torch.Tensor | None" = None
) -> torch.Tensor:
    """Packed vector ``w`` with ``w_i = (X^i mod S)(0)`` for i < 32*n_limbs,
    [n_limbs] limbs on ``s``'s device.

    Decryption of a ciphered bit is then one masked parity:
    ``(C mod S)(0) = parity(popcount(C & w))`` (src/cipher.rs:117-123).
    Computed on ``s``'s device as the power series ``w = 1 + S(0) * X^d *
    (1 / S*) mod X^n`` (:mod:`homomorph_tpu_torch.gf2.mask_kernel`), for
    every degree class, by the steps of
    :func:`~homomorph_tpu_torch.gf2.mask_kernel.mask_plan` (the kernels M3,
    M2, and M1 with K1 on a CUDA tensor, their plain versions on a CPU
    one; :func:`~homomorph_tpu_torch.gf2.mask_kernel.series_mask`).
    ``sstar`` is ``S*``
    (:func:`~homomorph_tpu_torch.gf2.mask_kernel.reversed_key`) where the
    caller keeps it, else it is built from ``s``.  When ``32 * n_limbs <=
    s_degree`` or ``S(0) = 0`` the mask is ``monomial(0)``; ``S(0)`` is
    applied as a bit mask on the device, with no branch on it.
    :func:`decrypt_mask_words` is the recurrence this is held against.
    """
    from . import mask_kernel  # lazily: gf2.kernels, which it imports, imports this module

    n_bits = bit_capacity(n_limbs)
    if n_bits <= s_degree:
        w = torch.zeros(n_limbs, dtype=LIMB_DTYPE, device=s.device)
        w[0] = 1
        return w
    if sstar is None:
        sstar = mask_kernel.reversed_key(s, s_degree)
    return mask_kernel.series_mask(sstar, s_degree, n_limbs)


def decipher_bits(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched decrypt: parity(popcount(c & w)) over the limb axis.

    ``c``: [..., L] ciphered-bit limbs; ``w``: [L] mask from
    :func:`decrypt_mask`.  Returns int32 0/1 with shape [...].  On a CUDA
    tensor this is the kernel D1, one read of ``c``; elsewhere
    :func:`decipher_bits_plain`
    (:func:`~homomorph_tpu_torch.gf2.decrypt_kernel.decipher` chooses).
    """
    from .decrypt_kernel import decipher  # lazily: it imports this module

    return decipher(c, w)


def decipher_bits_plain(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The torch expression of :func:`decipher_bits`: D1's plain version.
    Torch has no popcount: the limbs are XOR-folded to one word, then the
    word's 32 bits are folded to one."""
    return parity32(xor_fold(c & w))


# --------------------------------------------------------------------------
# Bit (un)packing
# --------------------------------------------------------------------------


def unpack_bits(limbs: torch.Tensor, n_bits: int, dtype=torch.uint8) -> torch.Tensor:
    """[..., L] limbs -> [..., n_bits] of 0/1 ``dtype``, LSB-first."""
    L = limbs.shape[-1]
    need = -(-n_bits // LIMB_BITS)
    x = pad_limbs(limbs, max(L, need))[..., :need]
    shifts = torch.arange(LIMB_BITS, dtype=limbs.dtype, device=limbs.device)
    bits = (x[..., :, None] >> shifts) & 1
    return bits.reshape(*limbs.shape[:-1], need * LIMB_BITS)[..., :n_bits].to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] of 0/1 -> [..., ceil(n/32)] int32 limbs, LSB-first.

    ORs the shifted bits together (a weighted ``torch.sum`` of int32 would
    promote to int64)."""
    n = bits.shape[-1]
    L = -(-n // LIMB_BITS)
    b = F.pad(bits.to(LIMB_DTYPE), (0, L * LIMB_BITS - n))
    b = b.reshape(*bits.shape[:-1], L, LIMB_BITS)
    out = b[..., 0].clone()
    for k in range(1, LIMB_BITS):
        out |= b[..., k] << k
    return out


def parity_pack(counts: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Integer-valued ``counts`` [..., D] -> packed parity limbs [..., out_limbs]."""
    return fit_limbs(pack_bits(counts.to(torch.int64) & 1), out_limbs)


# --------------------------------------------------------------------------
# Host-side serialization (byte format parity with src/polynomial.rs:98-122)
# --------------------------------------------------------------------------


def limbs_to_bytes(limbs: "np.ndarray | torch.Tensor") -> bytes:
    """Little-endian concatenation of limbs (src/polynomial.rs:98-105)."""
    arr = to_numpy(limbs) if isinstance(limbs, torch.Tensor) else limbs
    return np.asarray(arr, dtype=np.uint32).astype("<u4").tobytes()


def limbs_from_bytes(data: bytes) -> np.ndarray:
    """Bytes -> ``uint32`` limbs, zero-padding the trailing partial limb
    (src/polynomial.rs:107-122; word-size agnostic)."""
    if len(data) == 0:
        raise ValueError("The vector of bytes must not be empty.")
    n = -(-len(data) // 4)
    buf = np.zeros(n * 4, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.view("<u4").astype(np.uint32)
