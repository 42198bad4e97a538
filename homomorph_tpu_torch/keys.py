"""Secret and public keys.

Counterpart of :mod:`homomorph_tpu.keys` (reference:
src/context.rs:121-298):

* :class:`SecretKey` - one polynomial of exact degree ``d``, plus lazily
  built decrypt masks (power series computed on the key's device) and
  ``X^i mod S`` tables (computed on the host by the native engine), both
  cached on the device.
* :class:`PublicKey` - ``tau`` polynomials ``T_i = S*Q_i + X*R_i`` stored as
  one device tensor ``[tau, L]`` (which the encrypt kernel K2 reads),
  plus lazily built bit columns packed along tau and the int8 bit planes
  unpacked from them for the tensor-core kernels (K3, X1).

Both hold a numpy ``uint32`` host copy and an int32 tensor on their device
(``device=None`` means the CUDA card).  Byte formats are identical to the
reference and to the JAX package (LE limb concatenation,
src/polynomial.rs:98-122; public key = list of per-polynomial byte
strings, src/context.rs:239-245,291-298), so keys move between the three.
:func:`keys_from_numpy` carries the JAX package's key state into the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng as _rng
from . import device as _device
from .device import resolve as _resolve
from .gf2 import encrypt_kernel as _enc
from .gf2 import kernels as gf2k
from .gf2 import mask_kernel as _mask
from .gf2 import poly as gf2
from .params import Parameters
from .utils.errors import SecretKeyUnsetError

__all__ = [
    "SecretKey",
    "PublicKey",
    "generate_secret_key",
    "generate_public_key",
    "keys_from_numpy",
]


def _host_limbs(limbs) -> np.ndarray:
    if isinstance(limbs, torch.Tensor):
        return gf2.to_numpy(limbs).copy()
    return np.array(limbs, dtype=np.uint32)


class SecretKey:
    """The secret key ``S`` (reference: src/context.rs:121-206).

    Zeroization: the reference volatile-zeroes the polynomial on drop
    (src/context.rs:199-206, src/polynomial.rs:367-401).  Torch tensors are
    mutable, so :meth:`zeroize` overwrites the host copy, the device copy
    and every cached mask and table in place, then poisons the object.
    """

    def __init__(self, limbs, *, device=None):
        host = _host_limbs(limbs)
        if host.ndim != 1 or host.size == 0:
            raise ValueError("secret key must be a non-empty 1-D limb vector")
        self._host = host
        self._limbs = gf2.from_numpy(host, device)
        self._degree = int(_host_degree(host))
        # A null or constant polynomial cannot reduce anything (the
        # reference panics on division by a null polynomial,
        # src/polynomial.rs:318-322); a legitimate key has exact degree
        # d >= 1 (keygen forces the leading bit, src/polynomial.rs:89-90).
        if self._degree < 1:
            raise ValueError(
                "degenerate secret key: polynomial has degree 0 (null or "
                "constant) - a valid key has exact degree d >= 1"
            )
        self._mask_cache: dict[int, torch.Tensor] = {}
        self._rows_cache: dict[int, torch.Tensor] = {}
        self._sstar: torch.Tensor | None = None  # S*, the decrypt masks' reversed key

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes, *, device=None) -> "SecretKey":
        """Rebuild from bytes (reference: src/context.rs:153-155)."""
        return cls(gf2.limbs_from_bytes(data), device=device)

    @classmethod
    def random(cls, d: int, source: _rng.RandomSource, *, device=None) -> "SecretKey":
        """Uniform secret key of exact degree ``d`` (src/context.rs:157-162)."""
        return cls(_rng.random_poly_limbs(source, d), device=device)

    # -- accessors ----------------------------------------------------------

    @property
    def degree(self) -> int:
        self._check_alive()
        return self._degree

    @property
    def limbs(self) -> torch.Tensor:
        self._check_alive()
        return self._limbs

    @property
    def device(self) -> torch.device:
        return self._limbs.device

    def to_bytes(self) -> bytes:
        """Serialize (reference: src/context.rs:170-194)."""
        self._check_alive()
        return gf2.limbs_to_bytes(self._host)

    # -- reduction caches ---------------------------------------------------

    def decrypt_mask(self, n_limbs: int) -> torch.Tensor:
        """Packed ``w`` with ``w_i = (X^i mod S)(0)`` for ciphertexts of
        ``n_limbs`` limbs; cached on the device per degree class.

        Every class is computed on the key's device as a power series
        (:func:`~homomorph_tpu_torch.gf2.poly.decrypt_mask`, by the steps of
        :func:`~homomorph_tpu_torch.gf2.mask_kernel.mask_plan`), from ``S*``
        kept on the key.  The JAX package sends classes from
        ``NATIVE_MASK_MIN_LIMBS`` up to its native host engine because its
        device path is a scan of ``32 * n_limbs`` dependent steps; the
        series takes about ``log2`` of that many wide steps, and the plan
        runs its narrow ones in one launch (M3): the 9- and 65-limb classes
        are that one launch, the wider ones one more launch a step (M2; M1
        and K1 only under a key too wide for M2's table).  ``PERF.md``
        section 6 holds each class's times beside the native loop's
        (``chip_smoke.py`` phase 10).  So the port has no threshold: one
        route for every class, and nothing falls back to the host.

        Raises while a CUDA graph is capturing: a mask made under capture
        would live in the graph's pool and be refilled only by replays, so
        a compiled pipeline computes its masks before capture."""
        self._check_alive()
        if _device.capturing():
            raise RuntimeError("decrypt_mask under CUDA graph capture: compute the mask before capture")
        w = self._mask_cache.get(n_limbs)
        if w is None:
            if self._sstar is None:
                self._sstar = _mask.reversed_key(self._limbs, self._degree)
            w = gf2.decrypt_mask(self._limbs, self._degree, n_limbs, sstar=self._sstar)
            self._mask_cache[n_limbs] = w
        return w

    def reduction_rows(self, n_limbs: int) -> torch.Tensor:
        """Full ``X^i mod S`` table for remainders of ``n_limbs``-limb
        ciphertexts (:func:`~homomorph_tpu_torch.gf2.poly.reduction_rows`,
        [32*n_limbs, Ls]); cached on the device per degree class."""
        self._check_alive()
        rows = self._rows_cache.get(n_limbs)
        if rows is None:
            rows = gf2.reduction_rows(self._limbs, self._degree, gf2.bit_capacity(n_limbs))
            self._rows_cache[n_limbs] = rows
        return rows

    # -- lifecycle ----------------------------------------------------------

    def zeroize(self) -> None:
        """Overwrite ALL secret-derived material in place - the host copy,
        the device copy of ``S``, the reversed key ``S*`` of the decrypt
        masks, every cached decrypt mask and every ``X^i mod S`` table
        (linear images of ``S``) - then poison the object (reference
        semantics at src/polynomial.rs:367-401, src/context.rs:199-206).
        The mask route caches nothing else: its series, squares and
        products (M1, M2, M3 and the route's K1 outputs) are freed when the
        mask is made."""
        if self._host is not None:
            self._host.fill(0)
        self._host = None
        for t in (self._limbs, self._sstar):
            if t is not None:
                t.zero_()
        self._limbs = self._sstar = None
        for cache in (self._mask_cache, self._rows_cache):
            for t in cache.values():
                t.zero_()
            cache.clear()

    def _check_alive(self) -> None:
        if self._host is None:
            raise SecretKeyUnsetError("secret key has been zeroized")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SecretKey):
            return NotImplemented
        if self._host is None or other._host is None:
            return False  # a zeroized key equals nothing (incl. itself)
        # Trimmed-to-degree comparison (reference: src/polynomial.rs:417-426).
        return self._degree == other._degree and _trim_eq(
            self._host, other._host, self._degree
        )

    def __repr__(self) -> str:
        return f"SecretKey(degree={self._degree})"


class PublicKey:
    """The public key ``(T_i)_{1..tau}`` (reference: src/context.rs:208-298)."""

    def __init__(self, limbs, degrees: np.ndarray | None = None, *, device=None):
        host = _host_limbs(limbs)
        if host.ndim != 2 or host.shape[0] == 0:
            raise ValueError("public key must be a [tau, L] limb matrix")
        self._host = host
        self._limbs = gf2.from_numpy(host, device)
        self._degrees = (
            np.asarray(degrees, dtype=np.int64)
            if degrees is not None
            else np.array([_host_degree(row) for row in host], dtype=np.int64)
        )
        self._columns: torch.Tensor | None = None
        self._planes: torch.Tensor | None = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_bytes(cls, bytes_list: list[bytes], *, device=None) -> "PublicKey":
        """Rebuild from a list of per-polynomial byte strings
        (reference: src/context.rs:239-245).  The buffers are untrusted:
        an empty list, an empty row, or an all-zero row is rejected - a
        legitimate ``T_i = S*Q_i + X*R_i`` has exact degree ``d + dp >= 2``."""
        if not bytes_list:
            raise ValueError("public key must contain at least one polynomial")
        for i, b in enumerate(bytes_list):
            if len(b) == 0:
                raise ValueError(f"public key row {i} is empty")
        rows = [gf2.limbs_from_bytes(b) for b in bytes_list]
        for i, r in enumerate(rows):
            if not r.any():
                raise ValueError(
                    f"public key row {i} is the null polynomial - a valid "
                    "T_i has exact degree d + dp"
                )
        L = max(r.size for r in rows)
        mat = np.zeros((len(rows), L), dtype=np.uint32)
        for i, r in enumerate(rows):
            mat[i, : r.size] = r
        return cls(mat, device=device)

    # -- accessors ----------------------------------------------------------

    @property
    def tau(self) -> int:
        return self._host.shape[0]

    @property
    def num_limbs(self) -> int:
        return self._host.shape[1]

    @property
    def limbs(self) -> torch.Tensor:
        """[tau, L] int32 on the key's device, contiguous: what the table
        encrypt kernel (K2) reads."""
        return self._limbs

    @property
    def device(self) -> torch.device:
        return self._limbs.device

    @property
    def degrees(self) -> np.ndarray:
        return self._degrees

    @property
    def max_degree(self) -> int:
        """Static bound on fresh ciphertext degree (= max deg T_i)."""
        return int(self._degrees.max())

    def to_bytes(self) -> list[bytes]:
        """Serialize as per-polynomial byte strings trimmed to each
        polynomial's degree class (reference: src/context.rs:269-298)."""
        return [
            gf2.limbs_to_bytes(self._host[i, : gf2.limbs_for(int(self._degrees[i]))])
            for i in range(self.tau)
        ]

    def columns(self) -> torch.Tensor:
        """Bit columns packed along tau, [32*L, ceil(tau/32)] int32, from
        which :meth:`planes` unpacks (:func:`~homomorph_tpu_torch.gf2.
        encrypt_kernel.pk_columns`); built once per key."""
        if self._columns is None:
            self._columns = _enc.pk_columns(self._limbs)
        return self._columns

    def planes(self) -> torch.Tensor:
        """Bit planes, [32*L, 32*ceil(tau/32)] int8 0/1, k-contiguous and
        zero beyond tau, for the tensor-core encrypt kernels
        (:func:`~homomorph_tpu_torch.gf2.encrypt_kernel.pk_planes`); built
        once per key.  The counterpart of the JAX package's bf16
        ``bit_planes`` [tau, 32*L], transposed."""
        if self._planes is None:
            self._planes = _enc.pk_planes(self.columns())
        return self._planes

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PublicKey):
            return NotImplemented
        if self.tau != other.tau or (self._degrees != other._degrees).any():
            return False
        return all(
            _trim_eq(self._host[i], other._host[i], int(self._degrees[i]))
            for i in range(self.tau)
        )

    def __repr__(self) -> str:
        return f"PublicKey(tau={self.tau}, num_limbs={self.num_limbs})"


# --------------------------------------------------------------------------
# Key generation
# --------------------------------------------------------------------------


def generate_secret_key(
    params: Parameters, source: _rng.RandomSource, *, device=None
) -> SecretKey:
    return SecretKey.random(params.d, source, device=device)


def generate_public_key(
    params: Parameters, sk: SecretKey, source: _rng.RandomSource
) -> PublicKey:
    """Build ``T_i = S*Q_i + X*R_i`` for i in [0, tau) on ``sk``'s device.

    Randomness is drawn host-side in the reference's exact order (Q_i then
    R_i, per i - src/context.rs:249-258) so a recorded stream replays
    bit-identically.  The ``tau`` products ``S*Q_i`` share the operand
    ``S`` and run as ONE batched carry-less multiply, [tau, Lq] x [Ls].
    """
    dp, delta, tau = params.dp, params.delta, params.tau
    Lq = gf2.limbs_for(dp)
    Lr = gf2.limbs_for(delta)
    q_host = np.zeros((tau, Lq), dtype=np.uint32)
    r_host = np.zeros((tau, Lr), dtype=np.uint32)
    for i in range(tau):
        q_host[i] = _rng.random_poly_limbs(source, dp)
        r_host[i] = _rng.random_poly_limbs(source, delta)

    dev = sk.device
    pk_limbs = _pk_from_qr(
        sk.limbs, gf2.from_numpy(q_host, dev), gf2.from_numpy(r_host, dev),
        params.pk_degree,
    )
    # Exact degree d+dp for every T_i: leading terms of S and Q_i are forced
    # to 1, and deg(X*R_i) = delta+1 <= d cannot reach it.
    degrees = np.full((tau,), params.pk_degree, dtype=np.int64)
    return PublicKey(pk_limbs, degrees, device=dev)


def _pk_from_qr(
    s: torch.Tensor, q: torch.Tensor, r: torch.Tensor, pk_degree: int
) -> torch.Tensor:
    L = gf2.limbs_for(pk_degree)
    sq = gf2k.clmul(q, s)  # [tau, Lq + Ls]
    rx = gf2.shift_left_static(r, 1, L)  # X * R_i
    return gf2.pad_limbs(sq, max(L, sq.shape[-1]))[..., :L] ^ rx


def keys_from_numpy(
    sk_limbs: np.ndarray, pk_limbs: np.ndarray, device=None
) -> tuple[SecretKey, PublicKey]:
    """Carry key state held as numpy ``uint32`` limbs (as the JAX package
    holds it) into the port, on ``device``."""
    dev = _resolve(device)
    return SecretKey(sk_limbs, device=dev), PublicKey(pk_limbs, device=dev)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _host_degree(limbs: np.ndarray) -> int:
    nz = np.flatnonzero(limbs)
    if nz.size == 0:
        return 0
    j = int(nz[-1])
    return j * 32 + int(limbs[j]).bit_length() - 1


def _trim_eq(a: np.ndarray, b: np.ndarray, degree: int) -> bool:
    L = degree // 32 + 1
    return bool(np.array_equal(a[:L], b[:L]))
