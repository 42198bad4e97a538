"""The port's compiled pipelines (``homomorph_tpu_torch.models.compiled``) on
the CPU, where a compiled callable runs its operation eagerly (graphs exist
only on the card: ``tests/test_torch_cuda.py``).  The six cases of
``tests/test_compiled.py``, each held against eager and against the JAX
package's compiled limbs or bits for the same keys and inputs (bit-exact);
the output metadata that the ``meta`` device gives against eager's; the
noise-declaration refusals; and the eager-sync knob under capture.
"""

import jax
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.models import compiled as jcompiled
from homomorph_tpu_torch import models as tmodels
from homomorph_tpu_torch import rng as hrng
from homomorph_tpu_torch.models import circuits
from homomorph_tpu_torch.models.compiled import (
    _derive_meta, compile_op1, compile_op2, compile_roundtrip,
)


def make_ctxs(seed=0, params=(64, 16, 1, 16)):
    """The JAX package's and the port's contexts on the same recorded
    stream: the same keys, and ciphertexts byte for byte."""
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(seed))
    tctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(seed), device="cpu")
    for c in (jctx, tctx):
        c.generate_secret_key()
        c.generate_public_key()
    return jctx, tctx


def encrypt_both(jctx, tctx, values, jdesc, tdesc):
    return jctx.encrypt(values, jdesc, batch=True), tctx.encrypt(values, tdesc, batch=True)


def same_limbs(tc, jc):
    return np.array_equal(tc.limbs.numpy().view(np.uint32), np.asarray(jc.limbs))


def u8_bits(values):
    return np.unpackbits(np.asarray(values, np.uint8)[:, None], axis=1,
                         bitorder="little").astype(np.uint32)


class TestCompiledOps:
    def test_compile_op2_matches_eager(self):
        jctx, tctx = make_ctxs(1)
        ja, ta = encrypt_both(jctx, tctx, [10, 200], hm.U8, ht.U8)
        jb, tb = encrypt_both(jctx, tctx, [32, 100], hm.U8, ht.U8)
        fn = compile_op2(tmodels.HomomorphicAddition, ht.U8, tctx.parameters.pk_degree)
        got = fn(ta, tb)
        want = circuits.add(ta, tb)
        assert torch.equal(got.limbs, want.limbs)
        assert (got.bound, got.noise) == (want.bound, want.noise)
        jfn = jcompiled.compile_op2(hm.models.HomomorphicAddition, hm.U8,
                                    jctx.parameters.pk_degree)
        jgot = jfn(ja, jb)
        assert same_limbs(got, jgot) and (got.bound, got.noise) == (jgot.bound, jgot.noise)
        assert [int(v) for v in tctx.decrypt(got)] == [42, (200 + 100) & 0xFF]

    def test_compile_op2_reuse_across_calls(self):
        _, tctx = make_ctxs(2)
        fn = compile_op2(tmodels.HomomorphicAddition, ht.U8, tctx.parameters.pk_degree)
        for x, y in [(1, 2), (250, 10), (0, 0)]:
            a, b = tctx.encrypt(x, ht.U8), tctx.encrypt(y, ht.U8)
            assert int(tctx.decrypt(fn(a, b))) == (x + y) & 0xFF

    def test_compile_op1(self):
        jctx, tctx = make_ctxs(3)
        ja, ta = encrypt_both(jctx, tctx, [-5, 42], hm.I8, ht.I8)
        fn = compile_op1(tmodels.HomomorphicNegation, ht.I8, tctx.parameters.pk_degree)
        got = fn(ta)
        assert torch.equal(got.limbs, circuits.neg(ta).limbs)
        assert got.bound == circuits.neg(ta).bound
        jgot = jcompiled.compile_op1(hm.models.HomomorphicNegation, hm.I8,
                                     jctx.parameters.pk_degree)(ja)
        assert same_limbs(got, jgot)
        assert [int(v) for v in tctx.decrypt(got)] == [5, -42]

    def test_compile_roundtrip_single_dispatch(self):
        jctx, tctx = make_ctxs(4)
        rng = np.random.default_rng(0)
        xs = rng.integers(0, 128, size=4).astype(np.uint8)
        ys = rng.integers(0, 127, size=4).astype(np.uint8)
        fn = compile_roundtrip(tctx, tmodels.HomomorphicAddition, ht.U8)
        out = fn(hrng.threefry_key(9), u8_bits(xs), u8_bits(ys))
        got = np.packbits(out.numpy().astype(np.uint8), axis=1, bitorder="little").reshape(-1)
        assert (got == xs + ys).all()
        jfn = jcompiled.compile_roundtrip(jctx, hm.models.HomomorphicAddition, hm.U8)
        jout = np.asarray(jfn(jax.random.key(9), u8_bits(xs), u8_bits(ys)))
        assert np.array_equal(out.numpy(), jout.astype(np.int32))

    def test_roundtrip_encrypts_as_the_jax_package_does(self):
        """The round trip's selection words are ``jax.random.bits`` under
        the split key, so its ciphertexts are the JAX package's: hold the
        encrypt step (through T1's device-key entry) against the JAX
        package's ``_random_selection`` + ``_encrypt_core``."""
        import jax.numpy as jnp

        from homomorph_tpu.cipher import _encrypt_core, _random_selection
        from homomorph_tpu_torch import prng
        from homomorph_tpu_torch.gf2.encrypt_kernel import encrypt_bits_fused

        jctx, tctx = make_ctxs(6)
        bits = u8_bits([3, 200, 77])
        ka, _ = jax.random.split(jax.random.key(9))
        jpk = jctx.get_public_key()
        L = (jpk.max_degree // 32) + 1
        want = np.asarray(_encrypt_core(_random_selection(ka, bits.shape, 16),
                                        jpk.bit_planes(), jnp.asarray(bits), L))
        tka, _ = hrng.threefry_split(hrng.threefry_key(9))
        selw = prng.random_bits_device_key(prng.key_words(tka), (bits.size, 1))
        pk = tctx.get_public_key()
        got = encrypt_bits_fused(selw, pk.limbs, torch.from_numpy(bits.reshape(-1).astype(np.int32)), L)
        assert np.array_equal(got.numpy().view(np.uint32).reshape(want.shape), want)


class TestCompiledSlimBool:
    def test_compile_op2_lessthan_decrypts(self):
        jctx, tctx = make_ctxs(3, (128, 16, 1, 16))
        ja, ta = encrypt_both(jctx, tctx, [10, 200], hm.U8, ht.U8)
        jb, tb = encrypt_both(jctx, tctx, [32, 100], hm.U8, ht.U8)
        fn = compile_op2(tmodels.HomomorphicLessThan, ht.U8, tctx.parameters.pk_degree)
        got = fn(ta, tb)
        assert len(got) == 8 and got.zero_lanes == 7
        assert got.desc is ht.Bool
        assert [bool(v) for v in tctx.decrypt(got)] == [True, False]
        jgot = jcompiled.compile_op2(hm.models.HomomorphicLessThan, hm.U8,
                                     jctx.parameters.pk_degree)(ja, jb)
        assert same_limbs(got, jgot) and got.zero_lanes == jgot.zero_lanes

    def test_compile_roundtrip_equality_bits(self):
        jctx, tctx = make_ctxs(4, (128, 16, 1, 16))
        a, b = u8_bits([7, 9]), u8_bits([7, 8])
        out = compile_roundtrip(tctx, tmodels.HomomorphicEquality, ht.U8)(
            hrng.threefry_key(0), a, b).numpy()
        assert out.shape[-1] == 8  # full logical byte, implicit lanes padded
        assert list(out[0]) == [1, 0, 0, 0, 0, 0, 0, 0]
        assert list(out[1]) == [0, 0, 0, 0, 0, 0, 0, 0]
        jout = np.asarray(jcompiled.compile_roundtrip(jctx, hm.models.HomomorphicEquality, hm.U8)(
            jax.random.key(0), a, b))
        assert np.array_equal(out, jout.astype(np.int32))


@pytest.mark.parametrize("op_name,desc,params,n_args", [
    ("HomomorphicAddition", "U8", (64, 16, 1, 16), 2),
    ("HomomorphicLessThan", "U8", (128, 16, 1, 16), 2),
    ("HomomorphicEquality", "U16", (128, 16, 1, 16), 2),
    ("HomomorphicMultiplication", "U8", (160, 16, 1, 16), 2),
    ("HomomorphicNegation", "I8", (64, 16, 1, 16), 1),
    ("HomomorphicPopCount", "U8", (64, 16, 1, 16), 1),
])
def test_meta_device_gives_eager_metadata(op_name, desc, params, n_args):
    """``bound``, ``noise``, ``zero_lanes``, ``desc`` and the output shape
    from the ``meta`` device equal eager's, and K1 counts no launch there."""
    from homomorph_tpu_torch.gf2 import kernels as k

    _, tctx = make_ctxs(7, params)
    d = getattr(ht, desc)
    args = [tctx.encrypt([1, 2, 3], d, batch=True) for _ in range(n_args)]
    op = getattr(tmodels, op_name)
    before = k.clmul_flat.launches
    meta = _derive_meta(op.unsafe_apply, tctx.parameters.pk_degree, d,
                        *(a.limbs.shape for a in args))
    assert k.clmul_flat.launches == before
    eager = op.unsafe_apply(*args)
    assert (meta["bound"], meta["noise"], meta["zero_lanes"], meta["desc"], meta["shape"]) == (
        eager.bound, eager.noise, eager.zero_lanes, eager.desc, tuple(eager.limbs.shape))


def test_noisier_operands_are_refused():
    _, tctx = make_ctxs(8)
    a, b = tctx.encrypt(1, ht.U8), tctx.encrypt(2, ht.U8)
    noisy = circuits.add(a, b)
    fn2 = compile_op2(tmodels.HomomorphicAddition, ht.U8, tctx.parameters.pk_degree)
    with pytest.raises(ValueError, match="exceeds the compiled declaration"):
        fn2(noisy, b)
    fn1 = compile_op1(tmodels.HomomorphicNegation, ht.U8, tctx.parameters.pk_degree)
    with pytest.raises(ValueError, match=f"recompile with noise={noisy.noise}"):
        fn1(noisy)


def test_roundtrip_validates_the_operation():
    _, tctx = make_ctxs(9, (32, 8, 2, 8))  # d/delta = 16 < the u8 add's 17
    with pytest.raises(ht.InvalidParametersError):
        compile_roundtrip(tctx, tmodels.HomomorphicAddition, ht.U8)


def test_eager_sync_raises_under_capture(monkeypatch):
    """With ``HOMOMORPH_TPU_TORCH_EAGER_SYNC=1`` the multiplier would
    synchronize inside a graph capture: it raises and names the variable
    (the capture is simulated here; the card test captures for real)."""
    from homomorph_tpu_torch import device

    _, tctx = make_ctxs(10, (160, 16, 1, 16))
    a, b = tctx.encrypt([3], ht.U8, batch=True), tctx.encrypt([5], ht.U8, batch=True)
    monkeypatch.setenv(circuits.EAGER_SYNC_ENV, "1")
    assert int(tctx.decrypt(circuits.mul_unsigned(a, b))[0]) == 15  # not capturing: runs
    monkeypatch.setattr(device, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match=circuits.EAGER_SYNC_ENV):
        circuits.mul_unsigned(a, b)
