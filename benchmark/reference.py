"""The plain reference of the scheme, in PyTorch operations only.

It imports nothing of the program.  The benchmark makes the keys and the
operands here, from the seed, and hands the same to the program; after the
window it decrypts what the program produced and compares it with the
plaintext result.

The scheme (mathisbot/homomorph-rust, src/cipher.rs, src/context.rs), over
GF(2)[X]:

* secret key ``S``, of exact degree ``d``; public key ``T_i = S Q_i + X R_i``
  for ``i < tau``, ``Q_i`` of exact degree ``dp``, ``R_i`` of exact degree
  ``delta``;
* a bit ``m`` encrypts as ``C = m + sum of T_i over a random subset``;
* ``C`` decrypts as ``(C mod S)(0)``.

Reduction mod ``S`` is linear, so ``(C mod S)(0)`` is the parity of ``C``
against a mask ``w`` with ``w_i = (X^i mod S)(0)``.  This module works the
mask out on its own, as ``w = 1 + S(0) X^d / S*`` to ``n`` terms, where
``S*`` is ``S`` reversed: the inverse series by Newton's iteration, each
step one product by ``S*`` through a float64 FFT.  :func:`mask_by_recurrence`
is the same mask by the definition, one coefficient at a time, for the
tests.

Bits are uint8 0/1 tensors; limbs are int32 words holding 32 coefficients,
coefficient ``i`` in bit ``i % 32`` of limb ``i // 32``.  A value of ``n``
bits is ``n`` lanes, lane ``i`` the ciphertext of bit ``i`` (LSB first).
"""

from __future__ import annotations

import torch

LIMB_BITS = 32


def limbs_for(degree: int) -> int:
    """Limbs that hold a polynomial of degree at most ``degree``."""
    return degree // LIMB_BITS + 1


# --------------------------------------------------------------------------
# Bits and limbs
# --------------------------------------------------------------------------


def pack(bits: torch.Tensor, n_limbs: "int | None" = None) -> torch.Tensor:
    """[..., n] 0/1 -> int32 limbs [..., n_limbs] (default: as few as hold n)."""
    n = bits.shape[-1]
    L = -(-n // LIMB_BITS) if n_limbs is None else n_limbs
    x = torch.zeros(bits.shape[:-1] + (L * LIMB_BITS,), dtype=torch.int64, device=bits.device)
    m = min(n, L * LIMB_BITS)
    x[..., :m] = bits[..., :m].to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(LIMB_BITS, dtype=torch.int64, device=bits.device),
        torch.arange(LIMB_BITS, dtype=torch.int64, device=bits.device))
    words = (x.view(bits.shape[:-1] + (L, LIMB_BITS)) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack(limbs: torch.Tensor, n: "int | None" = None) -> torch.Tensor:
    """int32 limbs [..., L] -> [..., n] 0/1 uint8 (default n = 32 L)."""
    shifts = torch.arange(LIMB_BITS, dtype=torch.int32, device=limbs.device)
    bits = ((limbs.unsqueeze(-1) >> shifts) & 1).to(torch.uint8)
    bits = bits.reshape(limbs.shape[:-1] + (limbs.shape[-1] * LIMB_BITS,))
    return bits if n is None else bits[..., :n]


def value_bits(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int64 values [...] -> their low ``n_bits`` bits [..., n_bits], LSB first."""
    shifts = torch.arange(n_bits, dtype=torch.int64, device=values.device)
    return ((values.unsqueeze(-1) >> shifts) & 1).to(torch.uint8)


# --------------------------------------------------------------------------
# GF(2)[X] products
# --------------------------------------------------------------------------


def gf2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less product of 0/1 coefficient vectors [..., na] x [..., nb] ->
    [..., na + nb - 1] uint8: the integer convolution by a float64 FFT,
    taken mod 2.  Every coefficient of the convolution is a count of at most
    ``min(na, nb)``; a rounding error of a quarter or more raises."""
    na, nb = a.shape[-1], b.shape[-1]
    n_out = na + nb - 1
    n_fft = 1 << (n_out - 1).bit_length()
    fa = torch.fft.rfft(a.to(torch.float64), n_fft)
    fb = torch.fft.rfft(b.to(torch.float64), n_fft)
    conv = torch.fft.irfft(fa * fb, n_fft)[..., :n_out]
    counts = torch.round(conv)
    err = (conv - counts).abs().max().item() if conv.numel() else 0.0
    if err >= 0.25:
        raise ArithmeticError(f"FFT product lost exactness (rounding error {err})")
    return (counts.to(torch.int64) & 1).to(torch.uint8)


# --------------------------------------------------------------------------
# Keys and encryption
# --------------------------------------------------------------------------


def random_bits(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=gen, device=device, dtype=torch.uint8)


class Keys:
    """A key pair as bits: ``s`` [d + 1] and ``t`` [tau, pk_degree + 1]."""

    def __init__(self, d: int, dp: int, delta: int, tau: int, gen: torch.Generator, device):
        self.d, self.pk_degree, self.tau = d, d + dp, tau
        s = random_bits(gen, (d + 1,), device)
        s[d] = 1
        # a key with S(0) = 0 is refused: the decrypt would read only the
        # constant coefficient; with S(0) = 1 it reads every coefficient
        s[0] = 1
        q = random_bits(gen, (tau, dp + 1), device)
        q[:, dp] = 1
        r = random_bits(gen, (tau, delta + 1), device)
        r[:, delta] = 1
        t = gf2_mul(q, s.expand(tau, d + 1))  # [tau, d + dp + 1]
        t[:, 1:delta + 2] ^= r  # + X R_i
        self.s, self.t = s, t

    def secret_limbs(self) -> torch.Tensor:
        return pack(self.s)

    def public_limbs(self) -> torch.Tensor:
        """[tau, limbs_for(pk_degree)] int32: what a fresh ciphertext holds."""
        return pack(self.t, limbs_for(self.pk_degree))


def encrypt(keys: Keys, plain: torch.Tensor, gen: torch.Generator, chunk: int = 1 << 20) -> torch.Tensor:
    """Bits [N] (0/1) -> ciphertext limbs [N, limbs_for(pk_degree)]: each bit
    plus the sum of the ``T_i`` its random subset selects.  The sum is a
    float32 product of the 0/1 selection and the keys' coefficients (counts
    of at most ``tau``, exact in float32 with TF32 off), taken mod 2."""
    dev = plain.device
    L = limbs_for(keys.pk_degree)
    t = keys.t.to(torch.float32)
    out = torch.empty((plain.shape[0], L), dtype=torch.int32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, plain.shape[0], chunk):
            hi = min(lo + chunk, plain.shape[0])
            sel = random_bits(gen, (hi - lo, keys.tau), dev).to(torch.float32)
            c = (sel @ t).to(torch.int64) & 1
            c[:, 0] ^= plain[lo:hi].to(torch.int64)
            out[lo:hi] = pack(c.to(torch.uint8), L)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


# --------------------------------------------------------------------------
# Decryption
# --------------------------------------------------------------------------


def inverse_series(f: torch.Tensor, m: int) -> torch.Tensor:
    """``1 / f`` mod ``X^m`` for ``f(0) = 1`` over GF(2), [m] uint8: Newton's
    step ``g <- f g^2`` doubles the terms that are right (in characteristic
    2, ``g (2 - f g) = f g^2``, and ``g^2`` is ``g`` spread to even powers)."""
    g = torch.ones(1, dtype=torch.uint8, device=f.device)
    k = 1
    while k < m:
        k2 = min(2 * k, m)
        sq = torch.zeros(2 * k - 1, dtype=torch.uint8, device=f.device)
        sq[::2] = g
        g = gf2_mul(sq[:k2], f[:k2])[:k2]
        k = k2
    return g[:m]


def mask(keys_s: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``w`` [n_bits] uint8 with ``w_i = (X^i mod S)(0)``, for ``S`` given as
    its bits [d + 1]."""
    d = keys_s.shape[0] - 1
    w = torch.zeros(n_bits, dtype=torch.uint8, device=keys_s.device)
    w[0] = 1
    if n_bits > d and int(keys_s[0]) == 1:
        w[d:] = inverse_series(keys_s.flip(0), n_bits - d)
    return w


def mask_by_recurrence(keys_s: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The same mask by its definition: ``r <- X r mod S`` from ``r = 1``,
    ``w_i`` the constant coefficient of ``r`` after ``i`` steps.  One Python
    integer step a coefficient: for the tests' small keys."""
    bits = keys_s.tolist()
    d = len(bits) - 1
    s_int = sum(1 << i for i, b in enumerate(bits) if b)
    out, r = [], 1
    for _ in range(n_bits):
        out.append(r & 1)
        r <<= 1
        if r >> d & 1:
            r ^= s_int
    return torch.tensor(out, dtype=torch.uint8, device=keys_s.device)


def _parity(words: torch.Tensor) -> torch.Tensor:
    """XOR of the 32 bits of each int32 word -> 0/1."""
    for k in (16, 8, 4, 2, 1):
        words = words ^ (words >> k)
    return words & 1


def decrypt(limbs: torch.Tensor, w_limbs: torch.Tensor, chunk: int = 1 << 17) -> torch.Tensor:
    """Ciphertext limbs [..., L] -> plaintext bits [...] uint8, by the
    parity of ``C & w`` (``w_limbs`` has at least L limbs)."""
    L = limbs.shape[-1]
    if w_limbs.shape[0] < L:
        raise ValueError(f"mask of {w_limbs.shape[0]} limbs for ciphertexts of {L}")
    w = w_limbs[:L]
    flat = limbs.reshape(-1, L)
    out = torch.empty(flat.shape[0], dtype=torch.uint8, device=limbs.device)
    for lo in range(0, flat.shape[0], chunk):
        x = flat[lo:lo + chunk] & w
        while x.shape[-1] > 1:
            h = x.shape[-1] // 2
            top = x[:, h:2 * h] ^ x[:, :h]
            x = torch.cat([top, x[:, 2 * h:]], dim=-1)
        out[lo:lo + chunk] = _parity(x[:, 0]).to(torch.uint8)
    return out.reshape(limbs.shape[:-1])


class Decryptor:
    """Decrypts ciphertexts under ``s``, with the mask made once for the
    widest ciphertext it is given."""

    def __init__(self, s: torch.Tensor):
        self.s = s
        self.w: "torch.Tensor | None" = None

    def __call__(self, limbs: torch.Tensor) -> torch.Tensor:
        L = limbs.shape[-1]
        if self.w is None or self.w.shape[0] < L:
            self.w = pack(mask(self.s.to(limbs.device), L * LIMB_BITS), L)
        return decrypt(limbs, self.w)
