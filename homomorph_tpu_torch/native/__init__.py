"""ctypes bindings for the port's native host GF(2) engine.

Counterpart of :mod:`homomorph_tpu.native`, with its own copy of the
engine (``gf2_native.cpp``) and the same entry points: :func:`clmul`,
:func:`rem`, :func:`decrypt_mask`, :func:`decrypt_batch`,
:func:`encrypt_batch`, and :func:`reduction_rows` (bound but not wrapped in
the JAX package).  Each takes and returns numpy ``uint32`` limbs.

The library is built at first use: ``g++`` (or ``$CXX``) compiles the
source into ``libgf2native-<hash>.so`` in the build directory
(:func:`homomorph_tpu_torch.utils.cache.build_dir`), where the hash covers
the source, the flags and the compiler's version.  The compiler writes a
file of its own and :func:`os.replace` moves it into place, so several
processes may build at once.  The flags are portable (no
``-march=native``): a library built on one machine runs on another.

There is no fallback: where the build fails, the first call raises with
the compiler's output.  The JAX bindings fall back to numpy or the device
scan; the port's callers (the decrypt masks of :mod:`homomorph_tpu_torch.
keys` and :func:`homomorph_tpu_torch.gf2.poly.reduction_rows`) have no
second path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils.cache import build_dir

__all__ = [
    "FLAGS",
    "library",
    "clmul",
    "rem",
    "decrypt_mask",
    "decrypt_batch",
    "encrypt_batch",
    "reduction_rows",
]

SOURCE = Path(__file__).resolve().parent / "gf2_native.cpp"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: "ctypes.CDLL | None" = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++, c++ or $CXX): the native engine cannot be built")
    return cxx


def _target(cxx: str) -> Path:
    # a compiler that cannot say its version fails the build below, with its output
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS).encode() + version.stdout.encode()
    ).hexdigest()
    return build_dir() / f"libgf2native-{digest[:16]}.so"


def _build() -> Path:
    cxx = _compiler()
    out = _target(cxx)
    if out.exists():
        return out
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native engine build failed ({cxx} exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded engine, built first if needed; raises if the build fails."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        for name, args in (
            ("gf2_clmul", [u64p, i64, u64p, i64, u64p]),
            ("gf2_rem", [u64p, i64, u64p, i64, i64]),
            ("gf2_decrypt_batch", [u64p, i64, i64, u64p, u8p]),
            ("gf2_encrypt_batch", [u64p, i64, i64, u8p, u8p, i64, u64p]),
            ("gf2_reduction_rows", [u64p, i64, i64, i64, u64p]),
            ("gf2_decrypt_mask", [u64p, i64, i64, i64, u64p]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
    return _lib


# -- word-level helpers (uint32 limbs <-> uint64 words) ----------------------


def _to_words(limbs: np.ndarray) -> np.ndarray:
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    if limbs.shape[-1] % 2:
        pad = [(0, 0)] * (limbs.ndim - 1) + [(0, 1)]
        limbs = np.pad(limbs, pad)
    return limbs.view(np.uint64)


def _to_limbs(words: np.ndarray, n_limbs: int) -> np.ndarray:
    return words.view(np.uint32)[..., :n_limbs].copy()


def _check_degree(s: np.ndarray, s_degree: int) -> None:
    if not 1 <= s_degree < 32 * s.shape[-1]:
        raise ValueError(f"degree {s_degree} outside a modulus of {s.shape[-1]} limbs")


def clmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Carry-less multiply of two 1-D uint32 limb vectors -> La + Lb limbs."""
    La, Lb = a.shape[-1], b.shape[-1]
    aw, bw = _to_words(a), _to_words(b)
    out = np.zeros(aw.size + bw.size, dtype=np.uint64)
    library().gf2_clmul(aw, aw.size, bw, bw.size, out)
    return _to_limbs(out, La + Lb)


def rem(c: np.ndarray, s: np.ndarray, s_degree: int) -> np.ndarray:
    """Remainder of ``c`` mod ``s`` (1-D uint32 limb vectors, ``s`` of exact
    degree ``s_degree``), in ``c``'s limbs."""
    _check_degree(s, s_degree)
    cw = _to_words(c).copy()
    sw = _to_words(s)
    library().gf2_rem(cw, cw.size, sw, sw.size, s_degree)
    return _to_limbs(cw, c.shape[-1])


def decrypt_mask(s: np.ndarray, s_degree: int, n_limbs: int) -> np.ndarray:
    """Decrypt mask ``w_i = (X^i mod S)(0)`` for i < 32*n_limbs, bit-packed
    into ``n_limbs`` uint32 limbs: the monic recurrence with a single-row
    workspace, O(32*n_limbs*d/64) word operations."""
    s = np.asarray(s, dtype=np.uint32)
    _check_degree(s, s_degree)
    n_rows = n_limbs * 32
    sw = _to_words(s)
    out = np.zeros((n_rows + 63) // 64, dtype=np.uint64)
    library().gf2_decrypt_mask(sw, sw.size, s_degree, n_rows, out)
    return _to_limbs(out, n_limbs)


def reduction_rows(s: np.ndarray, s_degree: int, n_rows: int) -> np.ndarray:
    """Rows ``X^i mod S`` for i < n_rows as [n_rows, s_degree//32 + 1]
    uint32 limbs (bit ``s_degree`` of every row is 0)."""
    s = np.asarray(s, dtype=np.uint32)
    _check_degree(s, s_degree)
    nw = s_degree // 64 + 1
    sw = _to_words(s)
    rows = np.empty((n_rows, nw), dtype=np.uint64)
    library().gf2_reduction_rows(sw, sw.size, s_degree, n_rows, rows)
    return _to_limbs(rows, s_degree // 32 + 1)


def decrypt_batch(c: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Linear-map decrypt of [B, L] uint32 ciphertext limbs with mask ``w``
    [L] -> [B] uint8 bits."""
    B = c.shape[0]
    cw = np.ascontiguousarray(_to_words(c))
    ww = _to_words(w)
    if ww.size != cw.shape[-1]:
        raise ValueError(f"mask of {w.shape[-1]} limbs for ciphertexts of {c.shape[-1]}")
    out = np.empty(B, dtype=np.uint8)
    library().gf2_decrypt_batch(cw, B, cw.shape[-1], ww, out)
    return out


def encrypt_batch(pk: np.ndarray, sel: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Subset-XOR encrypt: ``pk`` [tau, L] limbs, ``sel`` [B, tau] 0/1,
    ``x`` [B] bits -> [B, L] limbs."""
    tau, L = pk.shape
    B = sel.shape[0]
    if sel.shape != (B, tau) or x.shape != (B,):
        raise ValueError(f"selection {sel.shape} and bits {x.shape} for a key of {tau} rows")
    pkw = np.ascontiguousarray(_to_words(pk))
    out = np.zeros((B, pkw.shape[-1]), dtype=np.uint64)
    library().gf2_encrypt_batch(
        pkw, tau, pkw.shape[-1],
        np.ascontiguousarray(sel, np.uint8), np.ascontiguousarray(x, np.uint8),
        B, out,
    )
    return _to_limbs(out, L)
