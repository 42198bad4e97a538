"""Plaintext serialization, wire-compatible with the reference.

The reference serializes plaintexts with bincode 2 configured as
little-endian + fixed-int + no-limit (reference: src/cipher.rs:6-13) before
bit-slicing LSB-first (src/cipher.rs:180-185).  This module re-implements
that exact wire format for the types the framework ships:

* fixed-width ints (u8..u128, i8..i128, usize/isize as u64/i64 - bincode
  fixint encodes usize as u64), bool (1 byte), f32/f64 (LE IEEE-754),
* fixed-size arrays (element-wise, no length prefix),
* structs (declaration-order field concatenation - the invariant both
  reference examples lean on: examples/unbalanced_struct.rs:11-33),
* **variable-length types** (bincode 2 fixint rules): ``Vec<T>`` /
  ``String`` carry a u64 LE length prefix, ``Option<T>`` a 1-byte tag
  (0 = None, 1 = Some), enums a u32 LE discriminant + variant payload.
  These are exactly the plaintext classes whose decode path makes the
  reference's ``MAX_DECODE_BYTES`` 1 MiB decode-bomb cap load-bearing
  (src/cipher.rs:15, 239-247): a length prefix claiming more than the
  buffer holds raises :class:`DeserializeError`, and one claiming an
  allocation beyond the cap raises :class:`DecodeTooLargeError`.

Every type is described by a :class:`TypeDescriptor` with ``encode`` /
``decode`` / ``decode_from`` / ``num_bytes``.  Fixed-size types have a
static ``num_bytes``; variable-length types have ``num_bytes = None`` and
derive the ciphertext bit-length from each value's actual encoding
(``Ciphered::cipher`` semantics, src/cipher.rs:175-191).

Wire-format examples (executable; run by ``tests/test_torch_host.py``):

>>> from homomorph_tpu_torch import codec
>>> codec.U16.encode(0x1234).hex()       # fixint little-endian
'3412'
>>> codec.vec_of(codec.U8).encode([1, 2]).hex()   # u64 LE length prefix
'02000000000000000102'
>>> codec.Str.decode(bytes([2, 0, 0, 0, 0, 0, 0, 0]) + b'hi')
'hi'
>>> codec.option_of(codec.U8).encode(None).hex()  # 1-byte None tag
'00'

Structs concatenate fields in declaration order (the invariant the
reference's unbalanced_struct example demonstrates):

>>> import dataclasses
>>> @dataclasses.dataclass
... class Pair:
...     x: codec.TypeDescriptor = codec.U8
...     y: codec.TypeDescriptor = codec.U16
>>> d = codec.struct_of(Pair, x=codec.U8, y=codec.U16)
>>> d.encode({'x': 1, 'y': 0x0202}).hex()
'010202'
"""

from __future__ import annotations

import dataclasses
import operator as _operator
import struct as _struct
from typing import Any, Callable, Sequence

import numpy as np

from .utils.errors import DecodeTooLargeError, DeserializeError, SerializeError

__all__ = [
    "MAX_DECODE_BYTES",
    "TypeDescriptor",
    "IntDescriptor",
    "BoolDescriptor",
    "FloatDescriptor",
    "StructDescriptor",
    "ArrayDescriptor",
    "BytesDescriptor",
    "VecDescriptor",
    "StringDescriptor",
    "OptionDescriptor",
    "EnumDescriptor",
    "U8", "U16", "U32", "U64", "U128", "Usize",
    "I8", "I16", "I32", "I64", "I128", "Isize",
    "Bool", "F32", "F64", "Str",
    "vec_of", "option_of", "enum_of",
    "struct_of", "descriptor_for",
]

# Decode-bomb cap, identical to the reference (src/cipher.rs:15): no decode
# may commit to materializing more than this many bytes.
MAX_DECODE_BYTES = 1 << 20

# bincode 2 fixint: collection lengths are usize encoded as u64 LE.
_LEN_BYTES = 8
# bincode 2: enum discriminants are u32 (fixed LE under fixint).
_DISCRIMINANT_BYTES = 4


class TypeDescriptor:
    """Describes how a plaintext type maps to bincode-fixint-LE bytes.

    ``num_bytes`` is the static encoded size, or ``None`` for
    variable-length types (``Vec``, ``String``, ``Option``, enums with
    differently-sized variants); for those, the encoded size is a property
    of each value and the ciphertext bit-length follows the actual
    encoding.
    """

    name: str
    num_bytes: int | None

    @property
    def is_fixed_size(self) -> bool:
        return self.num_bytes is not None

    @property
    def num_bits(self) -> int:
        if self.num_bytes is None:
            raise TypeError(
                f"{self.name} is variable-length; its bit width is a "
                "property of each value, not of the type"
            )
        return self.num_bytes * 8

    def encode(self, value: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        """Decode a complete buffer (must consume it exactly)."""
        value, off = self.decode_from(bytes(data), 0)
        if off != len(data):
            raise DeserializeError(
                f"{self.name}: {len(data) - off} trailing byte(s) after decode"
            )
        return value

    def decode_from(self, data: bytes, offset: int) -> tuple[Any, int]:
        """Stream decode: parse one value at ``offset``, return
        ``(value, next_offset)``.  Default implementation for fixed-size
        types; variable-length descriptors override this."""
        end = offset + self.num_bytes
        if end > len(data):
            raise DeserializeError(
                f"{self.name} needs {self.num_bytes} bytes at offset "
                f"{offset}, buffer has {len(data)}"
            )
        return self._decode_fixed(data[offset:end]), end

    def _decode_fixed(self, data: bytes) -> Any:
        """Exact-size decode body for fixed-size types."""
        raise NotImplementedError

    # -- batch staging (host-side hot path) ---------------------------------

    def encode_batch(self, values: Sequence[Any]) -> bytes:
        """Concatenated encodings of a batch.

        The generic path is one Python ``encode`` call per value;
        fixed-width numeric descriptors override this with a vectorized
        numpy implementation (the host-side staging cost of
        ``Ciphered.cipher(batch=True)`` at production batch sizes).
        """
        return b"".join(self.encode(v) for v in values)

    def decode_batch(self, rows: "np.ndarray") -> list:
        """Decode ``rows`` ([batch, num_bytes] uint8) to a list of values."""
        return [self.decode(r.tobytes()) for r in rows]

    def __repr__(self) -> str:
        return self.name


class IntDescriptor(TypeDescriptor):
    def __init__(self, bits: int, signed: bool, name: str | None = None):
        if bits % 8:
            raise ValueError("bit width must be a multiple of 8")
        self.bits = bits
        self.signed = signed
        self.num_bytes = bits // 8
        self.name = name or f"{'i' if signed else 'u'}{bits}"

    def encode(self, value: Any) -> bytes:
        try:
            # operator.index, not int(): int(1.5) silently truncates, which
            # would encrypt a corrupted plaintext; index() accepts exactly
            # the integral types (int, bool, numpy ints) and rejects floats
            v = _operator.index(value)
            return v.to_bytes(self.num_bytes, "little", signed=self.signed)
        except (OverflowError, TypeError, ValueError) as e:
            raise SerializeError(f"cannot encode {value!r} as {self.name}: {e}") from e

    def _decode_fixed(self, data: bytes) -> int:
        return int.from_bytes(data, "little", signed=self.signed)

    def encode_batch(self, values: Sequence[Any]) -> bytes:
        """Vectorized batch encode for machine widths (1/2/4/8 bytes).

        Falls back to the per-value path (which raises precise
        SerializeErrors) on non-machine widths, non-integer input, or any
        out-of-range element.  The range check runs on the input's OWN
        dtype before any cast: ``np.asarray(ndarray, dtype=...)`` is a
        silent C-cast (no OverflowError), so casting first would wrap
        opposite-signedness values (e.g. uint64 2^64-1 -> int64 -1) past
        the check and silently encrypt corrupted plaintexts."""
        if self.num_bytes not in (1, 2, 4, 8):
            return super().encode_batch(values)
        try:
            raw = np.asarray(values)
        except (TypeError, ValueError):
            return super().encode_batch(values)
        if raw.ndim != 1 or raw.size == 0 or raw.dtype.kind not in "iu":
            return super().encode_batch(values)  # object/float/bool/str etc.
        if self.signed:
            lo, hi = -(1 << (self.bits - 1)), (1 << (self.bits - 1)) - 1
        else:
            lo, hi = 0, (1 << self.bits) - 1
        # exact: min/max on the original dtype, compared as Python ints
        if int(raw.min()) < lo or int(raw.max()) > hi:
            return super().encode_batch(values)  # per-value errors
        kind = "i" if self.signed else "u"
        return raw.astype(f"<{kind}{self.num_bytes}").tobytes()

    def decode_batch(self, rows: "np.ndarray") -> list:
        if self.num_bytes not in (1, 2, 4, 8):
            return super().decode_batch(rows)
        kind = "i" if self.signed else "u"
        arr = np.ascontiguousarray(rows, dtype=np.uint8).view(
            f"<{kind}{self.num_bytes}"
        ).reshape(len(rows))
        return [int(v) for v in arr]


class BoolDescriptor(TypeDescriptor):
    name = "bool"
    num_bytes = 1

    def encode(self, value: Any) -> bytes:
        # strict: Python truthiness would silently encode containers /
        # floats (bool([False]) is True); accept only bool-like integrals
        if not isinstance(value, (bool, np.bool_, int, np.integer)):
            raise SerializeError(f"cannot encode {value!r} as bool")
        return b"\x01" if value else b"\x00"

    def _decode_fixed(self, data: bytes) -> bool:
        if data not in (b"\x00", b"\x01"):
            raise DeserializeError(f"invalid bool byte {data!r}")
        return data == b"\x01"

    def encode_batch(self, values: Sequence[Any]) -> bytes:
        # same strictness as the scalar path: only bool/integer elements.
        # np.asarray dtype kinds: 'b' = bool, 'iu' = ints; anything else
        # (floats, objects holding containers, strings) takes the
        # per-value path so [0.5] raises exactly like 0.5 does.
        try:
            raw = np.asarray(values)
        except (TypeError, ValueError):
            return super().encode_batch(values)
        if raw.ndim != 1 or raw.dtype.kind not in "biu":
            return super().encode_batch(values)  # per-value errors
        return (raw != 0).astype(np.uint8).tobytes()

    def decode_batch(self, rows: "np.ndarray") -> list:
        flat = np.ascontiguousarray(rows, dtype=np.uint8).reshape(len(rows))
        if ((flat != 0) & (flat != 1)).any():
            return super().decode_batch(rows)  # per-value error
        return [bool(v) for v in flat]


class FloatDescriptor(TypeDescriptor):
    def __init__(self, bits: int):
        self.bits = bits
        self.num_bytes = bits // 8
        self.name = f"f{bits}"
        self._fmt = "<f" if bits == 32 else "<d"

    def encode(self, value: Any) -> bytes:
        try:
            return _struct.pack(self._fmt, float(value))
        except (TypeError, ValueError) as e:
            raise SerializeError(f"cannot encode {value!r} as {self.name}") from e

    def _decode_fixed(self, data: bytes) -> float:
        return _struct.unpack(self._fmt, data)[0]

    def encode_batch(self, values: Sequence[Any]) -> bytes:
        try:
            arr = np.asarray(values, dtype=np.float32 if self.bits == 32 else np.float64)
        except (TypeError, ValueError):
            return super().encode_batch(values)
        if arr.ndim != 1 or arr.size == 0:
            return super().encode_batch(values)  # per-value errors
        return arr.astype(f"<f{self.num_bytes}").tobytes()

    def decode_batch(self, rows: "np.ndarray") -> list:
        arr = np.ascontiguousarray(rows, dtype=np.uint8).view(
            f"<f{self.num_bytes}"
        ).reshape(len(rows))
        return [float(v) for v in arr]


class BytesDescriptor(TypeDescriptor):
    """A fixed-length raw byte string (``[u8; N]``)."""

    def __init__(self, n: int):
        self.num_bytes = n
        self.name = f"bytes{n}"

    def encode(self, value: Any) -> bytes:
        b = bytes(value)
        if len(b) != self.num_bytes:
            raise SerializeError(f"expected {self.num_bytes} bytes, got {len(b)}")
        return b

    def _decode_fixed(self, data: bytes) -> bytes:
        return bytes(data)


class ArrayDescriptor(TypeDescriptor):
    """Fixed-size array ``[T; N]`` - element-wise, no length prefix."""

    def __init__(self, element: TypeDescriptor, n: int):
        self.element = element
        self.n = n
        self.num_bytes = (
            element.num_bytes * n if element.num_bytes is not None else None
        )
        self.name = f"[{element.name}; {n}]"

    def encode(self, value: Sequence[Any]) -> bytes:
        if len(value) != self.n:
            raise SerializeError(f"expected {self.n} elements, got {len(value)}")
        return b"".join(self.element.encode(v) for v in value)

    def decode_from(self, data: bytes, offset: int) -> tuple[list, int]:
        out = []
        for _ in range(self.n):
            v, offset = self.element.decode_from(data, offset)
            out.append(v)
        return out, offset


class StructDescriptor(TypeDescriptor):
    """Declaration-order field concatenation (bincode derive semantics).

    The ciphered layout of a struct is its fields' bit-lanes in declaration
    order regardless of any in-memory layout optimization - the invariant
    demonstrated by the reference's examples/unbalanced_struct.rs:11-33.
    """

    def __init__(
        self,
        fields: Sequence[tuple[str, TypeDescriptor]],
        name: str = "struct",
        constructor: Callable[..., Any] | None = None,
    ):
        self.fields = list(fields)
        self.name = name
        sizes = [d.num_bytes for _, d in self.fields]
        self.num_bytes = None if any(s is None for s in sizes) else sum(sizes)
        self._constructor = constructor

    def field_bit_offsets(self) -> dict[str, tuple[int, int]]:
        """Map field name -> (bit_offset, bit_length) in the ciphered layout.

        This is the slice/recombine extension surface the reference exposes
        through ``Deref<[CipheredBit]>`` + ``split_at``
        (examples/simple_struct.rs:30-58).
        """
        out = {}
        off = 0
        for fname, d in self.fields:
            out[fname] = (off, d.num_bits)
            off += d.num_bits
        return out

    def encode(self, value: Any) -> bytes:
        parts = []
        for fname, d in self.fields:
            if isinstance(value, dict):
                v = value[fname]
            else:
                v = getattr(value, fname)
            parts.append(d.encode(v))
        return b"".join(parts)

    def decode_from(self, data: bytes, offset: int) -> tuple[Any, int]:
        out = {}
        for fname, d in self.fields:
            out[fname], offset = d.decode_from(data, offset)
        if self._constructor is not None:
            return self._constructor(**out), offset
        return out, offset


# -- variable-length types (bincode 2 fixint; see module docstring) -----------


def _read_len_prefix(name: str, data: bytes, offset: int) -> tuple[int, int]:
    """u64 LE length prefix (bincode fixint usize encoding) + bomb guards."""
    end = offset + _LEN_BYTES
    if end > len(data):
        raise DeserializeError(f"{name}: truncated length prefix at {offset}")
    n = int.from_bytes(data[offset:end], "little")
    return n, end


def _guard_alloc(name: str, n_bytes: int, data: bytes, offset: int) -> None:
    """Reject decode bombs BEFORE materializing anything: a prefix may not
    claim more than the cap (src/cipher.rs:15) nor more than the buffer
    actually holds."""
    if n_bytes > MAX_DECODE_BYTES:
        raise DecodeTooLargeError(n_bytes, MAX_DECODE_BYTES)
    if n_bytes > len(data) - offset:
        raise DeserializeError(
            f"{name}: length prefix claims {n_bytes} bytes but only "
            f"{len(data) - offset} remain"
        )


class VecDescriptor(TypeDescriptor):
    """``Vec<T>``: u64 LE element count + elements (bincode 2 fixint)."""

    num_bytes = None

    def __init__(self, element: TypeDescriptor):
        self.element = element
        self.name = f"Vec<{element.name}>"

    def encode(self, value: Sequence[Any]) -> bytes:
        items = list(value)
        return len(items).to_bytes(_LEN_BYTES, "little") + b"".join(
            self.element.encode(v) for v in items
        )

    def decode_from(self, data: bytes, offset: int) -> tuple[list, int]:
        n, offset = _read_len_prefix(self.name, data, offset)
        # claimed allocation is bounded below by n * min_element_size
        # (varlen elements occupy >= 1 byte); zero-size elements (e.g.
        # [u8; 0]) consume no buffer, so cap the element COUNT instead -
        # otherwise a huge prefix would either wrongly fail the buffer
        # check or spin the decode loop unboundedly
        min_elem = self.element.num_bytes if self.element.num_bytes is not None else 1
        if min_elem > 0:
            _guard_alloc(self.name, n * min_elem, data, offset)
        elif n > MAX_DECODE_BYTES:
            raise DecodeTooLargeError(n, MAX_DECODE_BYTES)
        out = []
        for _ in range(n):
            v, offset = self.element.decode_from(data, offset)
            out.append(v)
        return out, offset


class StringDescriptor(TypeDescriptor):
    """``String``: u64 LE byte count + UTF-8 bytes (bincode 2 fixint)."""

    num_bytes = None
    name = "String"

    def encode(self, value: Any) -> bytes:
        raw = str(value).encode("utf-8")
        return len(raw).to_bytes(_LEN_BYTES, "little") + raw

    def decode_from(self, data: bytes, offset: int) -> tuple[str, int]:
        n, offset = _read_len_prefix(self.name, data, offset)
        _guard_alloc(self.name, n, data, offset)
        raw = data[offset : offset + n]
        try:
            return raw.decode("utf-8"), offset + n
        except UnicodeDecodeError as e:
            raise DeserializeError(f"String: invalid UTF-8: {e}") from e


class OptionDescriptor(TypeDescriptor):
    """``Option<T>``: 1-byte tag (0 = None, 1 = Some) + payload if Some."""

    num_bytes = None

    def __init__(self, element: TypeDescriptor):
        self.element = element
        self.name = f"Option<{element.name}>"

    def encode(self, value: Any) -> bytes:
        if value is None:
            return b"\x00"
        return b"\x01" + self.element.encode(value)

    def decode_from(self, data: bytes, offset: int) -> tuple[Any, int]:
        if offset >= len(data):
            raise DeserializeError(f"{self.name}: missing tag byte")
        tag = data[offset]
        if tag == 0:
            return None, offset + 1
        if tag == 1:
            return self.element.decode_from(data, offset + 1)
        raise DeserializeError(f"{self.name}: invalid tag byte {tag}")


class EnumDescriptor(TypeDescriptor):
    """Rust enum: u32 LE discriminant + the variant's payload.

    ``variants`` is a sequence of ``(name, payload_descriptor_or_None)`` in
    declaration order (the discriminant is the index, bincode 2 default).
    C-like enums use ``None`` payloads; values are the variant name (str)
    for C-like variants, or ``(name, payload_value)`` tuples otherwise.
    Fixed-size iff every variant payload has the same static size (e.g. all
    C-like), letting pure C-like enums batch like ints.
    """

    def __init__(self, variants: Sequence[tuple[str, TypeDescriptor | None]],
                 name: str = "enum"):
        self.variants = list(variants)
        if not self.variants:
            raise ValueError("enum needs at least one variant")
        self.name = name
        self._index = {vname: i for i, (vname, _) in enumerate(self.variants)}
        sizes = {
            (d.num_bytes if d is not None else 0) for _, d in self.variants
        }
        self.num_bytes = (
            _DISCRIMINANT_BYTES + sizes.pop()
            if len(sizes) == 1 and None not in sizes
            else None
        )

    def encode(self, value: Any) -> bytes:
        if isinstance(value, tuple):
            vname, payload = value
        else:
            vname, payload = value, None
        if vname not in self._index:
            raise SerializeError(f"{self.name}: unknown variant {vname!r}")
        i = self._index[vname]
        head = i.to_bytes(_DISCRIMINANT_BYTES, "little")
        d = self.variants[i][1]
        if d is None:
            if payload is not None:
                raise SerializeError(f"{self.name}::{vname} takes no payload")
            return head
        return head + d.encode(payload)

    def decode_from(self, data: bytes, offset: int) -> tuple[Any, int]:
        end = offset + _DISCRIMINANT_BYTES
        if end > len(data):
            raise DeserializeError(f"{self.name}: truncated discriminant")
        i = int.from_bytes(data[offset:end], "little")
        if i >= len(self.variants):
            raise DeserializeError(
                f"{self.name}: discriminant {i} out of range "
                f"(have {len(self.variants)} variants)"
            )
        vname, d = self.variants[i]
        if d is None:
            return vname, end
        payload, off = d.decode_from(data, end)
        return (vname, payload), off


def vec_of(element: TypeDescriptor) -> VecDescriptor:
    return VecDescriptor(element)


def option_of(element: TypeDescriptor) -> OptionDescriptor:
    return OptionDescriptor(element)


def enum_of(*variant_names: str, name: str = "enum") -> EnumDescriptor:
    """C-like enum from variant names in declaration order."""
    return EnumDescriptor([(v, None) for v in variant_names], name=name)


# -- canonical instances ------------------------------------------------------

U8 = IntDescriptor(8, False)
U16 = IntDescriptor(16, False)
U32 = IntDescriptor(32, False)
U64 = IntDescriptor(64, False)
U128 = IntDescriptor(128, False)
Usize = IntDescriptor(64, False, name="usize")  # bincode fixint: usize as u64
I8 = IntDescriptor(8, True)
I16 = IntDescriptor(16, True)
I32 = IntDescriptor(32, True)
I64 = IntDescriptor(64, True)
I128 = IntDescriptor(128, True)
Isize = IntDescriptor(64, True, name="isize")
Bool = BoolDescriptor()
F32 = FloatDescriptor(32)
F64 = FloatDescriptor(64)
Str = StringDescriptor()

_NUMPY_MAP = {
    np.dtype(np.uint8): U8, np.dtype(np.uint16): U16,
    np.dtype(np.uint32): U32, np.dtype(np.uint64): U64,
    np.dtype(np.int8): I8, np.dtype(np.int16): I16,
    np.dtype(np.int32): I32, np.dtype(np.int64): I64,
    np.dtype(np.bool_): Bool,
    np.dtype(np.float32): F32, np.dtype(np.float64): F64,
}


def _resolve_annotation(ann: Any, where: str) -> TypeDescriptor:
    """Recursively map a type annotation to a :class:`TypeDescriptor`.

    Handles descriptors, nested dataclasses (recursive :func:`struct_of` -
    the analogue of the reference's ``derive`` feature composing
    ``Encode``/``Decode`` through struct fields, Cargo.toml:19-20),
    ``bool``/``str``/``float``, numpy dtypes, and the ``list[T]`` /
    ``Optional[T]`` typing generics.  Plain ``int`` is rejected with
    guidance: Python ints have no fixed wire width.
    """
    import types as _types
    import typing

    if isinstance(ann, TypeDescriptor):
        return ann
    if dataclasses.is_dataclass(ann) and isinstance(ann, type):
        return struct_of(ann)
    if ann is bool:
        return Bool
    if ann is str:
        return Str
    if ann is float:
        return F64  # Rust's default float literal type
    if ann is int:
        raise TypeError(
            f"{where}: plain `int` has no fixed wire width - annotate with "
            "a numpy dtype (np.uint32, ...) or a TypeDescriptor (U32, ...)"
        )
    origin = typing.get_origin(ann)
    if ann is list or origin is list:
        args = typing.get_args(ann)
        if len(args) != 1:
            raise TypeError(
                f"{where}: bare `list` has no element type - annotate as "
                "list[T] (e.g. list[np.uint8]) or use vec_of(...)"
            )
        return VecDescriptor(_resolve_annotation(args[0], where))
    if origin is typing.Union or origin is getattr(_types, "UnionType", None):
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if len(args) == 1 and type(None) in typing.get_args(ann):
            return OptionDescriptor(_resolve_annotation(args[0], where))
        raise TypeError(f"{where}: only Optional[T] unions are encodable")
    try:
        return _NUMPY_MAP[np.dtype(ann)]
    except Exception:
        raise TypeError(
            f"{where} needs an explicit TypeDescriptor "
            f"(got annotation {ann!r})"
        ) from None


def struct_of(cls: type, **field_descs: TypeDescriptor) -> StructDescriptor:
    """Build a :class:`StructDescriptor` from a dataclass.

    Field order follows the dataclass declaration order.  Descriptors are
    taken from ``field_descs`` overrides first, then inferred recursively
    from the annotations (:func:`_resolve_annotation`): ``TypeDescriptor``
    instances, nested dataclasses, ``bool``/``str``/``float``, numpy
    dtypes, ``list[T]`` and ``Optional[T]``.
    """
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    # Resolve postponed (string) annotations; fall back to raw f.type for
    # annotations that are live objects (e.g. TypeDescriptor instances,
    # which get_type_hints rejects as non-types).
    try:
        import typing

        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    fields = []
    for f in dataclasses.fields(cls):
        if f.name in field_descs:
            d = field_descs[f.name]
        else:
            ann = hints.get(f.name, f.type)
            d = _resolve_annotation(ann, f"field {f.name!r} of {cls.__name__}")
        fields.append((f.name, d))
    return StructDescriptor(fields, name=cls.__name__, constructor=cls)


def descriptor_for(value: Any) -> TypeDescriptor:
    """Infer a descriptor from a numpy scalar/bool/float/str; Python ints
    need an explicit descriptor (their width is ambiguous)."""
    if isinstance(value, TypeDescriptor):
        return value
    if isinstance(value, (bool, np.bool_)):
        return Bool
    if isinstance(value, str):
        return Str
    if isinstance(value, np.generic) and value.dtype in _NUMPY_MAP:
        return _NUMPY_MAP[value.dtype]
    raise TypeError(
        f"cannot infer a wire type for {type(value).__name__}; pass an explicit "
        "TypeDescriptor (e.g. U32) - Python ints have no fixed width"
    )
