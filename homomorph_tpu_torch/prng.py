"""Device random words: ``jax.random.bits`` on the threefry stream, and its
CUDA kernel (T1).

:func:`random_bits` returns the words ``jax.random.bits(key, shape,
uint32)`` returns for the same key data, as int32 bit patterns: word ``i``
of the row-major flat output is ``x0 ^ x1`` of Threefry-2x32 (20 rounds)
under ``key`` at the counter ``(i >> 32, i & 0xffffffff)``.  The encryption
path draws its selection words with it, so a seeded context gives the JAX
package's ciphertext bytes.

:func:`random_bits` is T1's wrapper: on a CUDA device it launches
``csrc/threefry.cu`` (see the note in that file) or raises; on the CPU it
computes :func:`random_bits_plain`, the same rounds in torch int64 ops
masked to 32 bits (torch has no ``uint32`` shifts on the CPU).
:func:`random_bits_device_key` is T1's second entry, which reads the key
from a tensor when the kernel runs: a CUDA graph bakes scalar kernel
arguments in at capture, so only this entry lets a replayed graph draw
under a new key.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .gf2 import poly as gf2

__all__ = ["random_bits", "random_bits_device_key", "random_bits_plain", "key_words"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# flat words per chunk of the plain version (bounds its int64 intermediates)
_PLAIN_CHUNK = 1 << 22

_fns: dict = {}
_ARGS = {
    "hm_threefry_bits": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                         ctypes.c_void_p],
    "hm_threefry_bits_dkey": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p],
}


def _kernel(symbol: str = "hm_threefry_bits"):
    fn = _fns.get(symbol)
    if fn is None:
        from .gf2.cuda_build import library

        fn = getattr(library("threefry"), symbol)
        fn.argtypes = _ARGS[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check_key(key) -> tuple[int, int]:
    k0, k1 = (int(w) for w in key)
    if not (0 <= k0 <= _M32 and 0 <= k1 <= _M32):
        raise ValueError(f"a threefry key is two uint32 words, got {key!r}")
    return k0, k1


def random_bits_plain(key, shape, device="cpu") -> torch.Tensor:
    """Plain torch version of T1: the 20 rounds on int64 tensors, each add
    and rotate masked to 32 bits."""
    k0, k1 = _check_key(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    parts = []
    for start in range(0, n, _PLAIN_CHUNK):
        i = torch.arange(start, min(n, start + _PLAIN_CHUNK), dtype=torch.int64, device=device)
        x0 = ((i >> 32) + k0) & _M32
        x1 = ((i & _M32) + k1) & _M32
        for r in range(5):
            for s in _ROTATIONS[r % 2]:
                x0 = (x0 + x1) & _M32
                x1 = ((x1 << s) & _M32) | (x1 >> (32 - s))
                x1 = x1 ^ x0
            x0 = (x0 + ks[(r + 1) % 3]) & _M32
            x1 = (x1 + ks[(r + 2) % 3] + r + 1) & _M32
        # uint32 word -> int32 bit pattern
        parts.append(((x0 ^ x1) - ((x0 ^ x1) >> 31 << 32)).to(gf2.LIMB_DTYPE))
    flat = torch.cat(parts) if parts else torch.zeros(0, dtype=gf2.LIMB_DTYPE, device=device)
    return flat.reshape(shape)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int32 tensor on
    ``device`` (``None`` means the CUDA card); T1's wrapper.

    ``key`` is the pair of uint32 key words
    (:func:`homomorph_tpu_torch.rng.threefry_key`).  A CPU device gets
    :func:`random_bits_plain`; a CUDA device launches the kernel on the
    current stream (and counts the launch) or raises."""
    from .device import resolve

    k0, k1 = _check_key(key)
    dev = resolve(device)
    if dev.type == "cpu":
        return random_bits_plain((k0, k1), shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"random_bits runs on cpu or cuda, not {dev}")
    out = torch.empty(tuple(int(s) for s in shape), dtype=gf2.LIMB_DTYPE, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(out.data_ptr(), out.numel(), k0, k1, stream)
    if err:
        raise RuntimeError(f"threefry kernel launch failed: cudaError {err}")
    random_bits.launches += 1
    return out


def random_bits_device_key(key: torch.Tensor, shape) -> torch.Tensor:
    """:func:`random_bits` under the key held in ``key``, a tensor of the
    two key words (int32 bit patterns of ``(k0, k1)``), on ``key``'s device.

    A CPU tensor gets :func:`random_bits_plain` of the words it holds; a
    CUDA tensor launches T1's device-key entry on the current stream (and
    counts the launch on this function) or raises.  The kernel reads the
    words when it runs, so a CUDA graph that captured the launch draws
    under whatever the buffer holds at each replay."""
    if key.shape != (2,) or key.dtype != gf2.LIMB_DTYPE or not key.is_contiguous():
        raise ValueError(f"a device key is 2 contiguous int32 words, got {key.dtype} {tuple(key.shape)}")
    if key.device.type == "cpu":
        k0, k1 = (int(w) & _M32 for w in key.tolist())
        return random_bits_plain((k0, k1), shape, key.device)
    if key.device.type != "cuda":
        raise ValueError(f"random_bits_device_key runs on cpu or cuda, not {key.device}")
    out = torch.empty(tuple(int(s) for s in shape), dtype=gf2.LIMB_DTYPE, device=key.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("hm_threefry_bits_dkey")(out.data_ptr(), out.numel(), key.data_ptr(), stream)
    if err:
        raise RuntimeError(f"threefry device-key launch failed: cudaError {err}")
    random_bits_device_key.launches += 1
    return out


def key_words(key) -> torch.Tensor:
    """A threefry key ``(k0, k1)`` as the 2-word int32 CPU tensor that
    :func:`random_bits_device_key` reads (copy it into a device buffer)."""
    k0, k1 = _check_key(key)
    return torch.tensor([k0, k1], dtype=torch.int64).to(gf2.LIMB_DTYPE)


#: launches of each CUDA kernel entry since the last reset (plain integers)
random_bits.launches = 0
random_bits_device_key.launches = 0
