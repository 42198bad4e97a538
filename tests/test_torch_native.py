"""The port's native host engine (``homomorph_tpu_torch.native``) against the
JAX package's (``homomorph_tpu.native``) and against the port's plain torch
versions, at the shapes of ``tests/test_native.py``; and the engine's build.

Every comparison is bit-exact (integer GF(2) values, tolerance 0).
"""

import multiprocessing
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu import native as jnative
from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch import native
from homomorph_tpu_torch.gf2 import encrypt_kernel as tenc
from homomorph_tpu_torch.gf2 import poly as tpoly
from homomorph_tpu_torch.utils import cache


def T(arr):
    return tpoly.from_numpy(arr, "cpu")


def modulus(rng, sdeg, n_bytes=8):
    s_int = (1 << sdeg) | int(rng.integers(0, 1 << min(sdeg, 30)))
    return np.frombuffer(s_int.to_bytes(n_bytes, "little"), dtype=np.uint32)[: sdeg // 32 + 1].copy()


def test_clmul(rng):
    for _ in range(20):
        La, Lb = int(rng.integers(1, 8)), int(rng.integers(1, 8))
        a = rng.integers(0, 2**32, size=La, dtype=np.uint32)
        b = rng.integers(0, 2**32, size=Lb, dtype=np.uint32)
        got = native.clmul(a, b)
        assert np.array_equal(got, jnative.clmul(a, b))
        assert np.array_equal(got, tpoly.to_numpy(tpoly.clmul(T(a), T(b))))


def test_rem(rng):
    for _ in range(20):
        Lc = int(rng.integers(1, 6))
        c = rng.integers(0, 2**32, size=Lc, dtype=np.uint32)
        sdeg = int(rng.integers(1, 48))
        s = modulus(rng, sdeg)
        got = native.rem(c, s, sdeg)
        assert np.array_equal(got, jnative.rem(c, s, sdeg))
        plain = tpoly.to_numpy(tpoly.rem_iterative(T(c), T(s), sdeg))
        assert np.array_equal(got, plain)


def test_decrypt_batch(rng):
    sdeg, L = 40, 6
    s = modulus(rng, sdeg)
    w = native.decrypt_mask(s, sdeg, L)
    c = rng.integers(0, 2**32, size=(128, L), dtype=np.uint32)
    got = native.decrypt_batch(c, w)
    assert np.array_equal(got, jnative.decrypt_batch(c, w))
    assert np.array_equal(got, tpoly.decipher_bits(T(c), T(w)).numpy().astype(np.uint8))


def test_encrypt_batch(rng):
    tau, L, B = 24, 5, 64
    pk = rng.integers(0, 2**32, size=(tau, L), dtype=np.uint32)
    sel = rng.integers(0, 2, size=(B, tau)).astype(np.uint8)
    x = rng.integers(0, 2, size=B).astype(np.uint8)
    got = native.encrypt_batch(pk, sel, x)
    assert np.array_equal(got, jnative.encrypt_batch(pk, sel, x))
    planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
    plain = tenc.encrypt_sel_plain(
        torch.from_numpy(sel.astype(np.int8)), planes, torch.from_numpy(x.astype(np.int32)), L)
    assert np.array_equal(got, tpoly.to_numpy(plain))


@pytest.mark.parametrize("sdeg", [5, 40, 130])
@pytest.mark.parametrize("L", [1, 7, 64])
def test_decrypt_mask(rng, sdeg, L):
    """The engine's mask equals the JAX package's engine, its device scan
    and the port's Python-int recurrence, word for word."""
    nby = sdeg // 8 + 1
    nby += (-nby) % 4
    s_int = (1 << sdeg) | int(rng.integers(0, 1 << min(sdeg, 30)))
    s = np.frombuffer(s_int.to_bytes(nby, "little"), dtype=np.uint32).copy()
    got = native.decrypt_mask(s, sdeg, L)
    assert np.array_equal(got, jnative.decrypt_mask(s, sdeg, L))
    assert np.array_equal(got, np.asarray(jpoly.decrypt_mask(jnp.asarray(s), sdeg, L)))
    assert np.array_equal(got, tpoly.decrypt_mask_words(s, sdeg, L))


@pytest.mark.parametrize("sdeg,n_rows", [(4, 64), (33, 100), (64, 96), (130, 300)])
def test_reduction_rows(rng, sdeg, n_rows):
    """The rows table (bound but unwrapped in the JAX package's engine)
    equals the JAX package's device scan, and every row is X^i mod S."""
    s = modulus(rng, sdeg, 24)
    got = native.reduction_rows(s, sdeg, n_rows)
    assert got.shape == (n_rows, sdeg // 32 + 1)
    assert np.array_equal(got, np.asarray(jpoly.reduction_rows(jnp.asarray(s), sdeg, n_rows)))
    s_int = int.from_bytes(s.tobytes(), "little")
    for i in (0, 1, sdeg, n_rows - 1):
        r = 1 << i
        while r.bit_length() - 1 >= sdeg:
            r ^= s_int << (r.bit_length() - 1 - sdeg)
        assert int.from_bytes(got[i].tobytes(), "little") == r


def test_rejects_a_degree_outside_the_modulus():
    with pytest.raises(ValueError, match="degree"):
        native.decrypt_mask(np.array([5], np.uint32), 40, 4)
    with pytest.raises(ValueError, match="degree"):
        native.reduction_rows(np.array([5], np.uint32), 0, 4)


def test_library_lands_in_the_build_directory():
    path = native._build()
    assert path.parent == cache.build_dir()
    assert path.name.startswith("libgf2native-") and path.suffix == ".so"


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """No fallback: a compiler that fails makes the first call raise with
    its output."""
    fake = tmp_path / "broken-cxx"
    fake.write_text("#!/bin/sh\necho 'fake compiler refuses' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(cache, "_enabled", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        native.decrypt_mask(np.array([0b1011], np.uint32), 3, 2)


def _build_and_mask(build_dir):
    os.environ[cache.CACHE_ENV] = build_dir
    from homomorph_tpu_torch import native as nat

    return nat.decrypt_mask(np.array([0b100101, 0], np.uint32), 5, 8).tolist()


def test_concurrent_builds_share_one_library(tmp_path):
    """Several processes building into one empty directory at once (as the
    test workers do) each load a working library; one file remains."""
    build = str(tmp_path / "shared")
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        results = pool.map(_build_and_mask, [build] * 3, chunksize=1)
    want = tpoly.decrypt_mask_words(np.array([0b100101, 0], np.uint32), 5, 8).tolist()
    assert all(r == want for r in results)
    libs = [n for n in os.listdir(build) if n.startswith("libgf2native-")]
    assert len(libs) == 1 and libs[0].endswith(".so") and ".tmp" not in libs[0]


def test_secret_key_mask_at_a_large_class_equals_the_jax_package():
    """``SecretKey.decrypt_mask`` at a class of 2^15 limbs (where the JAX
    package takes its native path) equals the JAX package's bytes."""
    import homomorph_tpu as hm
    import homomorph_tpu_torch as ht

    jctx = hm.Context(hm.Parameters(64, 16, 1, 16), source=hm.ThreefrySource(4))
    jctx.generate_secret_key()
    jsk = jctx.get_secret_key()
    L = 1 << 15
    assert L >= jsk.NATIVE_MASK_MIN_LIMBS
    sk = ht.SecretKey.from_bytes(jsk.to_bytes(), device="cpu")
    got = tpoly.limbs_to_bytes(sk.decrypt_mask(L))
    assert got == jpoly.limbs_to_bytes(np.asarray(jsk.decrypt_mask(L)))
