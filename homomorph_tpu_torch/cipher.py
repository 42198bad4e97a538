"""Bit-level encryption: ``CipheredBit`` and typed ``Ciphered`` containers.

Counterpart of :mod:`homomorph_tpu.cipher` (reference: src/cipher.rs).
Semantics parity:

* encrypt one bit ``x``: draw a random subset ``U`` of ``[0, tau)`` and set
  ``C = (XOR_{i in U} T_i) + x`` (src/cipher.rs:92-115),
* decrypt: ``(C mod S)(0)`` (src/cipher.rs:117-123),
* ``Ciphered<T>``: bincode-encode then one ciphered bit per plaintext bit,
  LSB-first within each byte (src/cipher.rs:175-191); decipher reassembles
  LSB-first, requires a multiple-of-8 bit count and caps decode at 1 MiB
  (src/cipher.rs:15, 217-250).

Every encryption goes through the fused encrypt kernel
(:func:`~homomorph_tpu_torch.gf2.encrypt_kernel.encrypt_bits_fused`):
selection words drawn on the device from a threefry key
(:func:`~homomorph_tpu_torch.prng.random_bits`, the JAX package's
``jax.random.bits`` stream word for word), or the host source's selection
bits packed into words.  Decryption is the per-key mask and a parity
(:func:`~homomorph_tpu_torch.gf2.poly.decipher_bits`).  A ``Ciphered`` may
carry leading batch dimensions.

Limbs are int32 bit patterns (see :mod:`homomorph_tpu_torch.gf2.poly`); the
wire formats v1 and v2 are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from . import codec as _codec
from . import prng as _prng
from . import rng as _rng
from .device import resolve as _resolve
from .gf2 import kernels as gf2k
from .gf2 import poly as gf2
from .gf2.encrypt_kernel import encrypt_bits_fused
from .keys import PublicKey, SecretKey
from .utils.errors import (
    DecodeTooLargeError,
    DeserializeError,
    InvalidCipheredLengthError,
    SerializeError,
)

__all__ = ["CipheredBit", "Ciphered", "MAX_DECODE_BYTES"]

MAX_DECODE_BYTES = _codec.MAX_DECODE_BYTES  # src/cipher.rs:15


def _encode_values(
    desc: _codec.TypeDescriptor, values: list
) -> tuple[bytes, int]:
    """Encode a batch; return (payload, bits per value).

    Fixed-size types take the vectorized ``encode_batch`` path; variable-
    length types must encode to EQUAL lengths within one batch because a
    ``Ciphered`` is one rectangular lane tensor."""
    if not values:
        raise SerializeError("cannot encrypt an empty batch")
    if desc.is_fixed_size:
        return desc.encode_batch(values), desc.num_bits
    payloads = [desc.encode(v) for v in values]
    n_bytes = len(payloads[0])
    if any(len(p) != n_bytes for p in payloads):
        raise SerializeError(
            f"batched {desc.name} values must encode to equal byte lengths; "
            f"got {sorted({len(p) for p in payloads})} - pad the plaintexts "
            "or encrypt them separately"
        )
    if n_bytes == 0:
        raise SerializeError(f"{desc.name} encoded to zero bytes")
    return b"".join(payloads), n_bytes * 8


def _payload_bits(payload: bytes, n_values: int, n_bits: int) -> np.ndarray:
    return np.unpackbits(
        np.frombuffer(payload, dtype=np.uint8), bitorder="little"
    ).reshape(n_values, n_bits)


def _pack_selection(sel: np.ndarray, W: int) -> np.ndarray:
    """Host selection bits [n, tau] (0/1) -> ``uint32`` words [n, W], LSB-first."""
    packed = np.packbits(sel, axis=-1, bitorder="little")
    buf = np.zeros((sel.shape[0], 4 * W), dtype=np.uint8)
    buf[:, : packed.shape[1]] = packed
    return buf.view("<u4").astype(np.uint32)


#: Normalized (delta=1) worst-case noise degree of a FRESH ciphertext:
#: ``delta + 1`` evaluated at delta=1 (see the JAX package's cipher.py and
#: models/noise.py::required_ratio).
FRESH_NOISE = 2


# --------------------------------------------------------------------------
# CipheredBit
# --------------------------------------------------------------------------


class CipheredBit:
    """One encrypted bit - a GF(2) polynomial (reference: src/cipher.rs:26-123).

    May carry leading batch dimensions: ``limbs`` has shape [*batch, L].
    ``bound`` is the static degree-class bound; ``noise`` is the worst-case
    noise degree in normalized delta=1 units (:data:`FRESH_NOISE`),
    propagated through gates with the same algebra as ``bound`` (xor ->
    max, and -> sum); the checked API consumes it.
    """

    __slots__ = ("limbs", "bound", "noise")

    def __init__(self, limbs: torch.Tensor, bound: int, noise: int = FRESH_NOISE):
        self.limbs = limbs
        self.bound = int(bound)
        self.noise = int(noise)

    # -- trivial ciphertexts (src/cipher.rs:33-51) --------------------------

    @classmethod
    def zero(cls, batch: tuple[int, ...] = (), *, device=None) -> "CipheredBit":
        return cls(gf2.null(1, batch, device=device), 0, noise=0)

    @classmethod
    def one(cls, batch: tuple[int, ...] = (), *, device=None) -> "CipheredBit":
        # ``monomial(0)`` made on the device (a fill, not a host copy, so a
        # CUDA graph capture can hold it)
        m = torch.ones((1,), dtype=gf2.LIMB_DTYPE, device=_resolve(device))
        return cls(m.expand(batch + (1,)), 0, noise=0)

    # -- gates (src/cipher.rs:53-90) ----------------------------------------

    def xor(self, other: "CipheredBit") -> "CipheredBit":
        return CipheredBit(
            gf2.xor(self.limbs, other.limbs),
            max(self.bound, other.bound),
            noise=max(self.noise, other.noise),
        )

    def and_(self, other: "CipheredBit") -> "CipheredBit":
        prod = gf2k.clmul(self.limbs, other.limbs)
        bound = self.bound + other.bound
        # the JAX package's degree-class quantization, kept for equal shapes
        return CipheredBit(
            gf2.fit_limbs(prod, gf2.bucket(gf2.limbs_for(bound))),
            bound,
            noise=self.noise + other.noise,
        )

    def or_(self, other: "CipheredBit") -> "CipheredBit":
        # a + b + a*b (src/cipher.rs:71-81)
        return self.xor(other).xor(self.and_(other))

    def not_(self) -> "CipheredBit":
        # xor with the unit polynomial (src/cipher.rs:83-90)
        return CipheredBit(
            gf2.xor_const_bit(self.limbs, 1), self.bound, noise=self.noise
        )

    __xor__ = xor
    __and__ = and_
    __or__ = or_
    __invert__ = not_

    # -- accessors -----------------------------------------------------------

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    @property
    def num_limbs(self) -> int:
        return self.limbs.shape[-1]

    def degree(self) -> torch.Tensor:
        return gf2.compute_degree(self.limbs)

    def decipher(self, sk: SecretKey) -> torch.Tensor:
        """Decrypt to 0/1 (src/cipher.rs:117-123) via the reduction mask."""
        return gf2.decipher_bits(self.limbs, sk.decrypt_mask(self.num_limbs))

    def pad_to(self, num_limbs: int) -> "CipheredBit":
        return CipheredBit(
            gf2.pad_limbs(self.limbs, num_limbs), self.bound, noise=self.noise
        )

    def __repr__(self) -> str:
        return (
            f"CipheredBit(batch={self.batch_shape}, L={self.num_limbs}, "
            f"bound={self.bound}, noise={self.noise})"
        )


# --------------------------------------------------------------------------
# Ciphered
# --------------------------------------------------------------------------


class Ciphered:
    """Typed container of ciphered bits (reference: src/cipher.rs:125-259).

    ``limbs``: [*batch, n_bits, L] int32; lane ``i`` is plaintext bit ``i``
    (LSB-first within each serialized byte, src/cipher.rs:180-185).
    ``desc``: the plaintext :class:`~homomorph_tpu_torch.codec.TypeDescriptor`.
    ``bound``: static degree bound shared by all lanes.
    ``zero_lanes``: number of IMPLICIT trailing trivial-zero lanes that are
    not stored.  ``noise``: worst-case noise degree over all lanes, in
    normalized delta=1 units (:data:`FRESH_NOISE`), consumed by the checked
    API so that composed results keep a sound envelope.  ``sharding``:
    ``None``, or for a ciphertext encrypted with ``sharding=`` the
    :class:`~homomorph_tpu_torch.parallel.mesh.ShardedRows` record (the
    configuration, the global batch and the first global row): ``limbs``
    then holds the rows of this process's data blocks, in global order.
    """

    __slots__ = ("limbs", "bound", "desc", "zero_lanes", "noise", "sharding")

    def __init__(
        self,
        limbs: torch.Tensor,
        bound: int,
        desc: _codec.TypeDescriptor,
        zero_lanes: int = 0,
        noise: int = FRESH_NOISE,
        sharding=None,
    ):
        if limbs.ndim < 2:
            raise ValueError("Ciphered limbs must be at least [n_bits, L]")
        if zero_lanes < 0:
            raise ValueError("zero_lanes must be non-negative")
        self.limbs = limbs
        self.bound = int(bound)
        self.desc = desc
        self.zero_lanes = int(zero_lanes)
        self.noise = int(noise)
        self.sharding = sharding

    # -- construction --------------------------------------------------------

    @classmethod
    def cipher(
        cls,
        data: Any,
        pk: PublicKey,
        desc: _codec.TypeDescriptor | None = None,
        *,
        key: "tuple[int, int] | None" = None,
        source: _rng.RandomSource | None = None,
        batch: bool = False,
        sharding=None,
    ) -> "Ciphered":
        """Encrypt ``data`` on ``pk``'s device (reference: src/cipher.rs:153-191).

        Exactly one randomness mode:

        * ``key`` - a threefry key (two uint32 words,
          :func:`~homomorph_tpu_torch.rng.threefry_key`); the selection
          words are drawn on ``pk``'s device (production path), the same
          words ``jax.random.bits`` draws for the JAX package.
        * ``source`` - a host :class:`~homomorph_tpu_torch.rng.RandomSource`;
          bytes are consumed per bit in the reference's exact order
          (``ceil(tau/8)`` bytes each, src/cipher.rs:92-97) for bit-exact
          replay, then packed into words.

        Both go through the fused encrypt kernel.  With ``batch=True``,
        ``data`` is a sequence of values encrypted as one leading batch
        dimension.  With ``sharding=`` (a :class:`~homomorph_tpu_torch.
        parallel.mesh.ShardingConfig`), the batch goes through the sharded
        bulk pipeline (:func:`~homomorph_tpu_torch.parallel.bulk.
        sharded_encrypt_bits`): the value axis in data blocks, the key's
        rows in tau shards; it requires ``batch=True``, the ``key``
        randomness mode, a batch divisible by the data axis and tau by the
        tau axis.  The selection words are drawn as on the dense path, so
        for one key the bytes equal the dense path's; the result holds
        this process's rows and carries the ``sharding`` record.
        """
        if (key is None) == (source is None):
            raise ValueError("pass exactly one of key= or source=")
        values = list(data) if batch else [data]
        if desc is None:
            desc = _codec.descriptor_for(values[0])

        payload, n_bits = _encode_values(desc, values)
        all_bits = _payload_bits(payload, len(values), n_bits)

        tau = pk.tau
        shape = (len(values), n_bits)
        bound = pk.max_degree
        L = gf2.limbs_for(bound)
        total = len(values) * n_bits
        W = -(-tau // 32)
        dev = pk.device

        if sharding is not None:
            return cls._cipher_sharded(sharding, key, batch, pk, desc, all_bits, L, W)
        if key is not None:
            # The JAX package draws jax.random.bits(key, (total, W)) when
            # total % 128 == 0 and jax.random.bits(key, (n_values, n_bits,
            # W)) otherwise (cipher.py:116-119, 355-377): the same flat
            # words, so one draw serves both.
            selw = _prng.random_bits(key, (total, W), dev)
        else:
            sel_host = np.empty((total, tau), dtype=np.uint8)
            for i in range(total):
                sel_host[i] = _rng.random_selection_bits(source, tau)
            selw = gf2.from_numpy(_pack_selection(sel_host, W), dev)
        plain = torch.from_numpy(all_bits.reshape(total).astype(np.int32)).to(dev)
        limbs = encrypt_bits_fused(
            selw, pk.limbs, plain, L, planes=pk.planes
        ).reshape(shape + (L,))

        if not batch:
            limbs = limbs[0]
        return cls(limbs, bound, desc, noise=FRESH_NOISE)

    @classmethod
    def _cipher_sharded(cls, cfg, key, batch, pk, desc, all_bits, L, W) -> "Ciphered":
        """``cipher(sharding=cfg)``, after ``homomorph_tpu/cipher.py:331-353``."""
        if key is None or not batch:
            raise ValueError("sharding= requires the key= randomness mode and batch=True")
        from .parallel import bulk
        from .parallel.mesh import ShardedRows

        n_values, n_bits = all_bits.shape
        n_data = cfg.mesh.shape[cfg.data_axis]
        if n_values % n_data:
            raise ValueError(
                f"batch of {n_values} values not divisible by the mesh data axis ({n_data})"
            )
        n_tau = cfg.mesh.shape[cfg.tau_axis]
        if pk.tau % n_tau:
            raise ValueError(f"tau={pk.tau} not divisible by the mesh tau axis ({n_tau})")
        dev = cfg.device
        selw = _prng.random_bits(key, (n_values * n_bits, W), dev)
        sel = gf2.unpack_bits(selw, pk.tau, dtype=torch.int8).view(n_values, n_bits, pk.tau)
        limbs = bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, all_bits, L)
        lo, _ = cfg.local_rows(n_values)
        return cls(limbs, pk.max_degree, desc, noise=FRESH_NOISE,
                   sharding=ShardedRows(cfg, n_values, lo))

    # Both names bind one implementation, as in the JAX package: exceptions
    # are the typed error surface in Python (see homomorph_tpu.cipher).
    try_cipher = cipher

    @classmethod
    def trivial(
        cls,
        data: Any,
        desc: _codec.TypeDescriptor | None = None,
        *,
        batch: bool = False,
        device=None,
    ) -> "Ciphered":
        """Unencrypted (trivial) ciphertext of a plaintext value: bit ``i``
        of the encoding becomes ``monomial(0)`` or the null polynomial
        (src/cipher.rs:33-51 lifted to whole values).  Degree bound 0."""
        values = list(data) if batch else [data]
        if desc is None:
            desc = _codec.descriptor_for(values[0])
        payload, n_bits = _encode_values(desc, values)
        bits = _payload_bits(payload, len(values), n_bits)
        limbs = torch.from_numpy(bits.astype(np.int32)).to(_resolve(device))[..., None]
        if not batch:
            limbs = limbs[0]
        return cls(limbs, 0, desc, noise=0)

    @classmethod
    def new_from_raw(
        cls,
        bits: "Sequence[CipheredBit] | torch.Tensor",
        desc: _codec.TypeDescriptor,
        bound: int | None = None,
        noise: int | None = None,
    ) -> "Ciphered":
        """Assemble from raw ciphered bits (reference: src/cipher.rs:133-151).

        Accepts a list of :class:`CipheredBit` lanes (padded to the max
        degree class and stacked; their tracked ``noise`` carries over as
        the lane-wise worst) or a pre-stacked limb tensor, for which BOTH
        ``bound=`` and ``noise=`` are required: a raw tensor carries no
        tracked envelope, and assuming fresh would unsoundly reset it.
        """
        if isinstance(bits, (list, tuple)):
            L = max(b.num_limbs for b in bits)
            stacked = torch.stack([b.pad_to(L).limbs for b in bits], dim=-2)
            bnd = max(b.bound for b in bits) if bound is None else bound
            nz = max(b.noise for b in bits) if noise is None else noise
            return cls(stacked, bnd, desc, noise=nz)
        if bound is None:
            raise ValueError("bound= is required when passing a raw limb tensor")
        if noise is None:
            raise ValueError(
                "noise= is required when passing a raw limb tensor: a raw "
                "tensor has no tracked envelope, and assuming fresh would "
                "unsoundly reset it (pass the lanes' composed noise, or "
                "noise=bound for the conservative worst case)"
            )
        return cls(bits, bound, desc, noise=noise)

    # -- decryption ----------------------------------------------------------

    def decipher(self, sk: SecretKey) -> Any:
        """Decrypt and decode (reference: src/cipher.rs:193-250)."""
        n = len(self)
        if n % 8 != 0:
            raise InvalidCipheredLengthError(n)
        n_bytes = n // 8
        if n_bytes > MAX_DECODE_BYTES:
            raise DecodeTooLargeError(n_bytes, MAX_DECODE_BYTES)
        host = self.decipher_bits(sk)
        flat = host.reshape(-1, n)
        data = np.packbits(flat, axis=-1, bitorder="little")
        values = self.desc.decode_batch(data)
        if self.batch_shape == ():
            return values[0]
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out.reshape(self.batch_shape)

    try_decipher = decipher

    def decipher_bits(self, sk: SecretKey) -> np.ndarray:
        """Decrypt to raw plaintext bits [*batch, n_bits] (uint8) without decoding."""
        bits = gf2.decipher_bits(self.limbs, sk.decrypt_mask(self.num_limbs))
        host = bits.to(torch.uint8).cpu().numpy()
        if self.zero_lanes:
            host = np.concatenate(
                [host, np.zeros(host.shape[:-1] + (self.zero_lanes,), np.uint8)],
                axis=-1,
            )
        return host

    # -- bit-lane surface (Deref<[CipheredBit]> analogue) --------------------

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-2])

    @property
    def num_limbs(self) -> int:
        return self.limbs.shape[-1]

    def __len__(self) -> int:
        return self.limbs.shape[-2] + self.zero_lanes

    def __getitem__(self, i):
        """Bit-lane access: ``c[i]`` -> :class:`CipheredBit`, ``c[a:b]`` ->
        list of lanes (src/cipher.rs:253-259)."""
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n_phys = self.limbs.shape[-2]
        if i < 0:
            i += len(self)
        if i < 0 or i >= len(self):
            raise IndexError(i)
        if i >= n_phys:
            return CipheredBit.zero(self.batch_shape, device=self.limbs.device)
        return CipheredBit(self.limbs[..., i, :], self.bound, noise=self.noise)

    def densify(self) -> "Ciphered":
        """Materialize the implicit trailing zero lanes as physical lanes
        (no-op when ``zero_lanes == 0``)."""
        if not self.zero_lanes:
            return self
        z = self.limbs.new_zeros(
            self.limbs.shape[:-2] + (self.zero_lanes, self.limbs.shape[-1])
        )
        return Ciphered(
            torch.cat([self.limbs, z], dim=-2), self.bound, self.desc,
            noise=self.noise, sharding=self.sharding,
        )

    def bits(self) -> list[CipheredBit]:
        return [self[i] for i in range(len(self))]

    def split_at(self, mid: int) -> tuple[list[CipheredBit], list[CipheredBit]]:
        """Split the bit-lane slice (examples/simple_struct.rs:32-43)."""
        bs = self.bits()
        return bs[:mid], bs[mid:]

    def reinterpret(self, desc: _codec.TypeDescriptor) -> "Ciphered":
        """View the same lanes as a different plaintext type."""
        if desc.is_fixed_size and desc.num_bits != len(self):
            raise ValueError(
                f"{desc!r} needs {desc.num_bits} lanes, have {len(self)}"
            )
        return Ciphered(self.limbs, self.bound, desc, zero_lanes=self.zero_lanes,
                        noise=self.noise, sharding=self.sharding)

    # -- ciphertext serialization (the JAX package's wire format) ------------

    #: Wire-format magic ("HMCT" LE) + current version, as in the JAX package.
    WIRE_MAGIC = 0x54434D48
    WIRE_VERSION = 2  # v2 appends the tracked noise bound to the header

    def to_bytes(self) -> bytes:
        """Serialize: u32 header (magic, version, n_bits, zero_lanes, L,
        bound, noise, batch rank + dims) then LE limbs - byte-identical to
        the JAX package's ``Ciphered.to_bytes``."""
        host = gf2.to_numpy(self.limbs)
        bshape = self.batch_shape
        header = np.array(
            [
                self.WIRE_MAGIC,
                self.WIRE_VERSION,
                len(self),
                self.zero_lanes,
                self.num_limbs,
                self.bound,
                self.noise,
                len(bshape),
                *bshape,
            ],
            dtype="<u4",
        )
        return header.tobytes() + host.astype("<u4").tobytes()

    _WIRE_HEAD_V1 = 28  # 7 fixed u32 fields before the batch dims
    _WIRE_HEAD = 32  # v2: + noise field

    @classmethod
    def from_bytes(
        cls, data: bytes, desc: _codec.TypeDescriptor, *, device=None
    ) -> "Ciphered":
        """Deserialize onto ``device``; the buffer is untrusted input, so
        the header is fully validated (magic, version, sizes, rank,
        width-vs-desc) before any reshape.  Reads versions 1 and 2."""
        if len(data) < cls._WIRE_HEAD_V1 or len(data) % 4:
            raise DeserializeError(
                f"ciphertext buffer too short or misaligned ({len(data)} bytes)"
            )
        magic, version = (
            int(x) for x in np.frombuffer(data[:8], dtype="<u4")
        )
        if magic != cls.WIRE_MAGIC:
            raise DeserializeError(
                f"not a homomorph_tpu ciphertext (magic 0x{magic:08x}, "
                f"expected 0x{cls.WIRE_MAGIC:08x})"
            )
        if version not in (1, 2):
            raise DeserializeError(
                f"unsupported ciphertext wire version {version} "
                f"(this build reads versions 1-{cls.WIRE_VERSION})"
            )
        H = cls._WIRE_HEAD if version == 2 else cls._WIRE_HEAD_V1
        if len(data) < H:
            raise DeserializeError("ciphertext buffer truncated in header")
        head = np.frombuffer(data[8:H], dtype="<u4")
        if version == 2:
            n_bits, zero_lanes, L, bound, noise, rank = (int(x) for x in head)
        else:  # v1 writers predate noise tracking and wrote fresh ciphertexts
            n_bits, zero_lanes, L, bound, rank = (int(x) for x in head)
            noise = FRESH_NOISE
        if n_bits == 0 or L == 0 or rank > 8 or zero_lanes >= n_bits:
            raise DeserializeError(
                f"corrupt ciphertext header: n_bits={n_bits}, "
                f"zero_lanes={zero_lanes}, L={L}, rank={rank}"
            )
        if len(data) < H + 4 * rank:
            raise DeserializeError("ciphertext buffer truncated in batch dims")
        bshape = tuple(
            int(x) for x in np.frombuffer(data[H : H + 4 * rank], dtype="<u4")
        )
        body = np.frombuffer(data[H + 4 * rank :], dtype="<u4").astype(np.uint32)
        n_phys = n_bits - zero_lanes
        expect = int(np.prod(bshape, dtype=np.int64)) * n_phys * L if rank else n_phys * L
        if body.size != expect:
            raise DeserializeError(
                f"ciphertext body has {body.size} limbs, header implies {expect}"
            )
        if desc.is_fixed_size and desc.num_bits != n_bits:
            raise DeserializeError(
                f"{desc!r} expects {desc.num_bits} bit lanes, buffer has {n_bits}"
            )
        limbs = gf2.from_numpy(body.reshape(*bshape, n_phys, L), device)
        return cls(limbs, bound, desc, zero_lanes=zero_lanes, noise=noise)

    def __repr__(self) -> str:
        return (
            f"Ciphered<{self.desc.name}>(batch={self.batch_shape}, "
            f"n_bits={len(self)}, L={self.num_limbs}, bound={self.bound}, "
            f"noise={self.noise})"
        )
