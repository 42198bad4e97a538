"""The port's sharded bulk pipeline against the JAX package, on the CPU.

Every case of ``tests/test_sharding.py`` on the port's grid of places
(``homomorph_tpu_torch.parallel``): the same ``Parameters(32, 8, 1, 8)`` and
``(64, 16, 1, 16)``, meshes ``(8, 1)``, ``(4, 2)``, ``(2, 4)`` and ``(1, 8)``
of eight CPU places, and the rejections.  Added: the port's
``sharded_encrypt_bits`` against JAX ``bulk.sharded_encrypt_bits`` on the
same numpy selections and plaintexts, ``Context(sharding=, encrypt_seed=)``
bytes against the JAX context's, and a non-power-of-two tau axis, ``(2, 3)``
at tau = 12 (the ring combine; JAX sums counts there).  Tolerance 0: every
comparison is of integer limbs or bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.gf2 import poly as jgf2
from homomorph_tpu.parallel import bulk as jbulk
from homomorph_tpu.parallel import make_mesh as jmake_mesh
from homomorph_tpu_torch.gf2 import encrypt_kernel as tenc
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.parallel import Mesh, Place, bulk, distributed, make_mesh, ppermute

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def cpu_mesh(*shape):
    return make_mesh(*shape, ["cpu"] * (shape[0] * shape[1]))


def contexts(params, seed):
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(seed))
    tctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(seed), device="cpu")
    for ctx in (jctx, tctx):
        ctx.generate_secret_key()
        ctx.generate_public_key()
    return jctx, tctx


@pytest.fixture(scope="module")
def keyed():
    return contexts((32, 8, 1, 8), 31)


def inputs(tau, B=16, n=8, seed=0):
    rng = np.random.default_rng(seed)
    plain = rng.integers(0, 2, size=(B, n)).astype(np.uint32)
    sel = rng.integers(0, 2, size=(B, n, tau)).astype(np.uint8)
    return sel, plain


def dense(tctx, sel, plain):
    """The single-place path: X1's plain version on the whole key."""
    pk = tctx.get_public_key()
    L = gf2.limbs_for(pk.max_degree)
    B, n, tau = sel.shape
    flat = torch.from_numpy(sel.reshape(B * n, tau)).to(torch.int8)
    bits = torch.from_numpy(plain.reshape(-1).astype(np.int32))
    return tenc.encrypt_sel_plain(flat, pk.planes(), bits, L).view(B, n, L)


def roundtrip(cfg, tctx, seed=0):
    pk, sk = tctx.get_public_key(), tctx.get_secret_key()
    L = gf2.limbs_for(pk.max_degree)
    sel, plain = inputs(pk.tau, seed=seed)
    limbs = bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, plain, L)
    out = bulk.sharded_decrypt_bits(cfg, limbs, sk.decrypt_mask(L))
    assert (out.numpy() == plain).all()
    return limbs


def test_data_parallel_roundtrip(keyed):
    roundtrip(cpu_mesh(8, 1), keyed[1])


def test_tau_sharded_roundtrip(keyed):
    """tau-sharded key: packed partials combined by the butterfly - exact."""
    roundtrip(cpu_mesh(4, 2), keyed[1])


def test_tau_only_sharding(keyed):
    roundtrip(cpu_mesh(1, 8), keyed[1])


@pytest.mark.parametrize("shape", MESHES + [(2, 2), (1, 1)], ids=str)
def test_sharded_matches_single_device(keyed, shape):
    """Sharded encrypt is bit-identical to the single-place path."""
    sel, plain = inputs(8, seed=5)
    pk = keyed[1].get_public_key()
    L = gf2.limbs_for(pk.max_degree)
    got = bulk.sharded_encrypt_bits(cpu_mesh(*shape), sel, pk.limbs, plain, L)
    assert torch.equal(got, dense(keyed[1], sel, plain))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_matches_jax_sharded_encrypt(keyed, shape):
    """The port's sharded_encrypt_bits against JAX bulk.sharded_encrypt_bits
    on the same numpy selections and plaintexts, on the same mesh shape."""
    jctx, tctx = keyed
    sel, plain = inputs(8, seed=9)
    L = jgf2.limbs_for(jctx.parameters.pk_degree)
    want = jbulk.sharded_encrypt_bits(
        jmake_mesh(*shape), jnp.asarray(sel), jctx.get_public_key().bit_planes(),
        jnp.asarray(plain), L)
    got = bulk.sharded_encrypt_bits(cpu_mesh(*shape), sel, tctx.get_public_key().limbs, plain, L)
    assert np.array_equal(gf2.to_numpy(got), np.asarray(want, dtype=np.uint32))


def test_non_power_of_two_tau_axis():
    """(2, 3) at tau = 12: the ring of two one-hop exchanges gives the dense
    bits and the JAX package's (whose counts psum takes this case)."""
    jctx, tctx = contexts((32, 8, 1, 12), 4)
    sel, plain = inputs(12, B=8, seed=3)
    L = jgf2.limbs_for(jctx.parameters.pk_degree)
    cfg = cpu_mesh(2, 3)
    ppermute.local_bytes = 0
    got = bulk.sharded_encrypt_bits(cfg, sel, tctx.get_public_key().limbs, plain, L)
    assert torch.equal(got, dense(tctx, sel, plain))
    # 2 groups x 2 rounds x 3 places, each a [4*8, L] int32 partial
    assert ppermute.local_bytes == 2 * 2 * 3 * (4 * 8) * L * 4
    want = jbulk.sharded_encrypt_bits(
        jmake_mesh(2, 3, devices=jax.devices()[:6]), jnp.asarray(sel),
        jctx.get_public_key().bit_planes(), jnp.asarray(plain), L)
    assert np.array_equal(gf2.to_numpy(got), np.asarray(want, dtype=np.uint32))
    out = bulk.sharded_decrypt_bits(cfg, got, tctx.get_secret_key().decrypt_mask(L))
    assert (out.numpy() == plain).all()


def test_butterfly_bytes(keyed):
    """log2(n_tau) exchanges of the whole partial at every place."""
    ppermute.local_bytes = ppermute.cross_bytes = 0
    roundtrip(cpu_mesh(2, 4), keyed[1])
    L = gf2.limbs_for(keyed[1].get_public_key().max_degree)
    assert ppermute.local_bytes == 2 * 8 * (8 * 8) * L * 4 and ppermute.cross_bytes == 0


def test_sharded_gate_xor(keyed):
    cfg = cpu_mesh(8, 1)
    limbs = roundtrip(cfg, keyed[1])
    assert (bulk.sharded_gate_xor(cfg, limbs, limbs) == 0).all()  # c ^ c = trivial 0


class TestMesh:
    def test_value_errors_as_jax(self):
        with pytest.raises(ValueError, match="not divisible by n_tau"):
            make_mesh(None, 3, ["cpu"] * 8)
        with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
            make_mesh(3, 2, ["cpu"] * 8)
        cfg = make_mesh(None, 2, ["cpu"] * 8)
        assert cfg.mesh.shape == {"data": 4, "tau": 2}
        assert (cfg.data_axis, cfg.tau_axis) == ("data", "tau")

    def test_default_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2, 1)

    def test_one_process_one_device(self):
        with pytest.raises(ValueError, match="one process drives one device"):
            Mesh([Place(0, torch.device("cpu")), Place(0, torch.device("meta"))], ("limb",))

    def test_groups_and_local_rows(self):
        cfg = cpu_mesh(2, 4)
        assert cfg.mesh.groups("tau") == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert cfg.mesh.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
        assert cfg.local_rows(16) == (0, 16)
        # places of another process: this one holds data block 1 of 2
        other = make_mesh(2, 1, [Place(1, torch.device("cpu")), Place(0, torch.device("cpu"))])
        assert other.local_rows(16) == (8, 16)

    def test_remote_places_need_a_process_group(self):
        cfg = make_mesh(1, 2, [Place(0, torch.device("cpu")), Place(1, torch.device("cpu"))])
        with pytest.raises(RuntimeError, match="torch.distributed"):
            ppermute(cfg.mesh, {0: torch.zeros(2)}, "tau", [(0, 1)])


class TestShardedContext:
    """Context(sharding=cfg): the distributed production surface."""

    P = (64, 16, 1, 16)

    def test_encrypt_decrypt_through_sharded_context(self):
        cfg = cpu_mesh(4, 2)
        ctx = ht.Context(ht.Parameters(*self.P), sharding=cfg, device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        xs = list(range(40, 48))  # 8 values, divisible by the data axis (4)
        c = ctx.encrypt(xs, ht.U8, batch=True)
        assert c.sharding.config is cfg and (c.sharding.batch, c.sharding.first_row) == (8, 0)
        assert [int(v) for v in ctx.decrypt(c)] == xs

    def test_sharded_matches_unsharded_and_jax(self):
        """Same encrypt_seed and keys: the sharded bytes equal the dense
        path's and the JAX sharded context's."""
        jk, tk = contexts(self.P, 13)
        jsh = hm.Context(hm.Parameters(*self.P), encrypt_seed=5, sharding=jmake_mesh(8, 1))
        tsh = ht.Context(ht.Parameters(*self.P), encrypt_seed=5, sharding=cpu_mesh(8, 1),
                         device="cpu")
        tpl = ht.Context(ht.Parameters(*self.P), encrypt_seed=5, device="cpu")
        for ctx, src in ((jsh, jk), (tsh, tk), (tpl, tk)):
            ctx.set_secret_key(src.get_secret_key())
            ctx.set_public_key(src.get_public_key())
        xs = [7, 200, 0, 255] * 2
        c_sh, c_pl = tsh.encrypt(xs, ht.U8, batch=True), tpl.encrypt(xs, ht.U8, batch=True)
        assert torch.equal(c_sh.limbs, c_pl.limbs)
        assert c_sh.to_bytes() == c_pl.to_bytes()
        want = np.asarray(jsh.encrypt(xs, hm.U8, batch=True).limbs, dtype=np.uint32)
        assert np.array_equal(gf2.to_numpy(c_sh.limbs), want)
        # cross-decrypt: the dense context decrypts the sharded ciphertext
        assert [int(v) for v in tpl.decrypt(c_sh)] == xs

    @pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)], ids=str)
    def test_sharded_bytes_match_jax_per_mesh(self, shape):
        jk, tk = contexts(self.P, 21)
        jsh = hm.Context(hm.Parameters(*self.P), encrypt_seed=9, sharding=jmake_mesh(*shape))
        tsh = ht.Context(ht.Parameters(*self.P), encrypt_seed=9, sharding=cpu_mesh(*shape),
                         device="cpu")
        for ctx, src in ((jsh, jk), (tsh, tk)):
            ctx.set_secret_key(src.get_secret_key())
            ctx.set_public_key(src.get_public_key())
        xs = [3, 141, 59, 26, 53, 58, 97, 93]
        got = tsh.encrypt(xs, ht.U8, batch=True)
        want = jsh.encrypt(xs, hm.U8, batch=True)
        assert np.array_equal(gf2.to_numpy(got.limbs), np.asarray(want.limbs, dtype=np.uint32))
        assert [int(v) for v in tsh.decrypt(got)] == xs

    def test_homomorphic_op_on_sharded_ciphertexts(self):
        from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicXorGate

        cfg = cpu_mesh(4, 2)
        ctx = ht.Context(ht.Parameters(*self.P), sharding=cfg, device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        a = ctx.encrypt([10, 20, 30, 40], ht.U8, batch=True)
        b = ctx.encrypt([1, 2, 3, 4], ht.U8, batch=True)
        s = ctx.apply2(HomomorphicAddition, a, b)
        assert [int(v) for v in ctx.decrypt(s)] == [11, 22, 33, 44]
        assert s.sharding == a.sharding  # both inputs share it: kept
        dense_b = ht.Ciphered.cipher([1, 2, 3, 4], ctx.get_public_key(), ht.U8, key=(0, 7),
                                     batch=True)
        x = ctx.apply2(HomomorphicXorGate, a, dense_b)
        assert x.sharding is None  # a dense operand: dropped

    def test_indivisible_batch_rejected(self):
        ctx = ht.Context(ht.Parameters(*self.P), sharding=cpu_mesh(8, 1), device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        with pytest.raises(ValueError, match="not divisible"):
            ctx.encrypt([1, 2, 3], ht.U8, batch=True)

    def test_indivisible_tau_rejected(self):
        _, tk = contexts((32, 8, 1, 12), 2)
        with pytest.raises(ValueError, match="not divisible by the mesh tau axis"):
            ht.Ciphered.cipher([1, 2], tk.get_public_key(), ht.U8, key=(0, 1), batch=True,
                               sharding=cpu_mesh(2, 8))

    def test_key_and_batch_required(self, keyed):
        pk = keyed[1].get_public_key()
        with pytest.raises(ValueError, match="requires the key"):
            ht.Ciphered.cipher(1, pk, ht.U8, key=(0, 1), sharding=cpu_mesh(2, 1))
        with pytest.raises(ValueError, match="requires the key"):
            ht.Ciphered.cipher([1, 2], pk, ht.U8, source=ht.ThreefrySource(1), batch=True,
                               sharding=cpu_mesh(2, 1))

    def test_single_value_bypasses_sharding(self):
        ctx = ht.Context(ht.Parameters(*self.P), sharding=cpu_mesh(8, 1), device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        c = ctx.encrypt(99, ht.U8)  # batch=False -> the dense path
        assert c.sharding is None and int(ctx.decrypt(c)) == 99


class TestReviewRegressions:
    def test_source_plus_sharding_rejected(self):
        with pytest.raises(ValueError, match="incompatible"):
            ht.Context(ht.Parameters(64, 16, 1, 16), source=ht.ThreefrySource(1),
                       sharding=cpu_mesh(2, 1), device="cpu")

    def test_bulk_decrypt_composes_with_limb_mesh(self, monkeypatch):
        """The limb-mesh clmul hook stays inert inside the bulk pipeline's
        blocks, and the round trip is unchanged."""
        from homomorph_tpu_torch.parallel import limbmul

        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 1)
        cfg = cpu_mesh(2, 1)
        lmesh = Mesh(["cpu"] * 4, (limbmul.LIMB_AXIS,))
        ctx = ht.Context(ht.Parameters(64, 16, 1, 16), encrypt_seed=3, device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        pk, sk = ctx.get_public_key(), ctx.get_secret_key()
        L = gf2.limbs_for(pk.max_degree)
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, size=(4, 8)).astype(np.uint32)
        sel = rng.integers(0, 2, size=(4, 8, 16)).astype(np.uint8)
        with limbmul.use_limb_mesh(lmesh):
            ct = bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, bits, L)
            out = bulk.sharded_decrypt_bits(cfg, ct, sk.decrypt_mask(L))
        assert (out.numpy() == bits).all()


class TestShardedCheckpoint:
    """save_sharded/load_sharded: per-process rows + manifest, restored
    host-side; the files match the JAX package's names and fields."""

    def test_roundtrip_preserves_limbs_and_metadata(self, tmp_path):
        from homomorph_tpu_torch.models import circuits

        ctx = ht.Context(ht.Parameters(32, 8, 1, 8), encrypt_seed=31, sharding=cpu_mesh(4, 1),
                         device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        a = ctx.encrypt([3, 250, 17, 9], ht.U8, batch=True)
        b = ctx.encrypt([5, 6, 7, 8], ht.U8, batch=True)
        s = circuits.gate_xor(a, b)  # composed: nonzero tracked noise
        s.sharding = a.sharding
        distributed.save_sharded(str(tmp_path), s, name="ck")
        assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.json", "ck.p0s0.npz"]
        back = distributed.load_sharded(str(tmp_path), ht.U8, name="ck", device="cpu")
        assert torch.equal(back.limbs, s.limbs)
        assert back.bound == s.bound and back.noise == s.noise
        assert [int(v) for v in ctx.decrypt(back)] == [3 ^ 5, 250 ^ 6, 17 ^ 7, 9 ^ 8]

    def test_jax_reads_the_port_checkpoint(self, tmp_path):
        jctx, tctx = contexts((32, 8, 1, 8), 31)
        c = tctx.encrypt([1, 2], ht.U8, batch=True)
        distributed.save_sharded(str(tmp_path), c, name="ck")
        from homomorph_tpu.parallel import distributed as jdist

        back = jdist.load_sharded(str(tmp_path), hm.U8, name="ck")
        assert np.array_equal(np.asarray(back.limbs), gf2.to_numpy(c.limbs))
        assert [int(v) for v in jctx.decrypt(back)] == [1, 2]

    def test_wrong_desc_and_missing_shards(self, keyed, tmp_path):
        import os

        c = keyed[1].encrypt([1, 2], ht.U8, batch=True)
        distributed.save_sharded(str(tmp_path), c, name="ck")
        with pytest.raises(ht.DeserializeError, match="was u8"):
            distributed.load_sharded(str(tmp_path), ht.U16, name="ck", device="cpu")
        for fn in os.listdir(tmp_path):
            if fn.endswith(".npz"):
                os.remove(tmp_path / fn)
                break
        with pytest.raises(ht.DeserializeError, match="incomplete"):
            distributed.load_sharded(str(tmp_path), ht.U8, name="ck", device="cpu")
