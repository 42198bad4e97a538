"""The port's limb-sharded clmul against the dense port and the JAX package.

The cases of ``tests/test_limbmul.py`` on a one-axis grid of CPU places
(``homomorph_tpu_torch.parallel.limbmul``): bit-identity with the port's
dense :func:`homomorph_tpu_torch.gf2.kernels.clmul` and with JAX
``limbmul.sharded_clmul`` over 2-8 places, odd paddings, the top limbs, a
single row, the declines, the dispatcher's routing, operand order, broadcast
leading dims and a whole adder.  JAX's compiled-HLO volume test becomes the
exchange primitive's byte count, which must equal ``comm_bytes_per_call``.
Tolerance 0: every comparison is of integer limbs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from homomorph_tpu.gf2 import kernels as jgf2k
from homomorph_tpu.parallel import limbmul as jlimbmul
from homomorph_tpu_torch.gf2 import kernels as gf2k
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.parallel import Mesh, Place, limbmul, ppermute


def limb_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n, (limbmul.LIMB_AXIS,))


def rand_limbs(rng, batch, L):
    return rng.integers(0, 1 << 32, size=(batch, L), dtype=np.uint64).astype(np.uint32)


def t(x):
    return gf2.from_numpy(x, "cpu")


def assert_product_matches(a, b, n):
    """Sharded == dense port == JAX sharded, on ``n`` places."""
    got = limbmul.sharded_clmul(t(a), t(b), limb_mesh(n))
    assert torch.equal(got, gf2k.clmul(t(a), t(b)))
    jmesh = JMesh(np.array(jax.devices()[:n]), (jlimbmul.LIMB_AXIS,))
    want = np.asarray(jlimbmul.sharded_clmul(jnp.asarray(a), jnp.asarray(b), jmesh))
    assert np.array_equal(gf2.to_numpy(got), want)


class TestShardedClmul:
    @pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
    def test_matches_dense_across_shard_counts(self, rng, n_shards):
        assert_product_matches(rand_limbs(rng, 4, 96), rand_limbs(rng, 4, 7), n_shards)

    @pytest.mark.parametrize(
        "La,Lb",
        [
            (64, 1),    # minimal small operand
            (65, 3),    # odd La: out_len 68 not divisible by shards
            (96, 12),   # K governed by out_len
            (17, 9),    # K governed by Lb floor (block >= Lb)
            (33, 33),   # balanced operands (block = Lb edge)
            (250, 31),  # odd everything
        ],
    )
    def test_odd_paddings(self, rng, La, Lb):
        assert_product_matches(rand_limbs(rng, 3, La), rand_limbs(rng, 3, Lb), 4)

    def test_top_limbs_dense(self, rng):
        """Data in the very last limbs of the big operand is not dropped at
        the padded boundary."""
        a = np.zeros((2, 80), dtype=np.uint32)
        a[:, -1] = 0xFFFFFFFF
        assert_product_matches(a, rand_limbs(rng, 2, 5), 8)

    def test_single_row_batch(self, rng):
        assert_product_matches(rand_limbs(rng, 1, 128), rand_limbs(rng, 1, 4), 2)

    @pytest.mark.parametrize("n_shards", [2, 4, 8])
    def test_exchange_bytes_equal_comm_bytes_per_call(self, rng, n_shards):
        """One spill exchange of [B, Lb] limbs per boundary, whatever La:
        the primitive's count is comm_bytes_per_call (all within this
        process here)."""
        B, La, Lb = 2, 96, 6
        ppermute.local_bytes = ppermute.cross_bytes = 0
        limbmul.sharded_clmul(t(rand_limbs(rng, B, La)), t(rand_limbs(rng, B, Lb)),
                              limb_mesh(n_shards))
        assert ppermute.cross_bytes == 0
        assert ppermute.local_bytes == limbmul.comm_bytes_per_call(B, Lb, n_shards)
        assert limbmul.comm_bytes_per_call(B, Lb, 4) == 3 * B * Lb * 4

    def test_window_of_a_process(self, rng):
        """A process that holds places 2..3 of 4 gets the limbs of its two
        blocks, clipped to the product (limb_window)."""
        mesh = Mesh([Place(1, torch.device("cpu"))] * 2 + [Place(0, torch.device("cpu"))] * 2,
                    ("limb",))
        assert limbmul.limb_window(96, 6, mesh) == (52, 102)
        # K = max(ceil(120 / 4), 60) = 60: blocks 2..3 lie past the product
        assert limbmul.limb_window(60, 60, mesh) == (120, 120)


class TestDispatcherIntegration:
    def test_maybe_sharded_declines_without_mesh(self, rng):
        assert limbmul.get_default_limb_mesh()[0] is None
        assert gf2k.limb_hook is None  # the dispatcher offers nothing
        assert limbmul.maybe_sharded_clmul(t(rand_limbs(rng, 2, 512)),
                                           t(rand_limbs(rng, 2, 8))) is None

    def test_hook_slot_follows_the_registry(self):
        with limbmul.use_limb_mesh(limb_mesh(2)):
            assert gf2k.limb_hook is limbmul.maybe_sharded_clmul
            with limbmul.use_limb_mesh(None):
                assert gf2k.limb_hook is None
            assert gf2k.limb_hook is limbmul.maybe_sharded_clmul
        assert gf2k.limb_hook is None

    def test_meta_operands_take_the_dense_path(self, monkeypatch):
        """A compiled callable derives its output's metadata on ``meta``
        tensors: the hook declines them, and the dispatcher returns the
        product's shape."""
        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        a = torch.empty((2, 200), dtype=gf2.LIMB_DTYPE, device="meta")
        b = torch.empty((2, 6), dtype=gf2.LIMB_DTYPE, device="meta")
        with limbmul.use_limb_mesh(limb_mesh(4)):
            assert limbmul.maybe_sharded_clmul(a, b) is None
            out = gf2k.clmul(a, b)
        assert out.is_meta and tuple(out.shape) == (2, 206)

    def test_compiled_product_under_a_limb_mesh_equals_eager(self, monkeypatch):
        """``compile_op2`` of the u8 product under ``use_limb_mesh``: the
        metadata pass on ``meta`` tensors runs, the products that qualify
        take the mesh, and limbs and metadata equal eager's without it."""
        import homomorph_tpu_torch as ht
        from homomorph_tpu_torch.models import HomomorphicMultiplication
        from homomorph_tpu_torch.models.compiled import compile_op2

        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 1)
        ctx = ht.Context(ht.Parameters(512, 16, 1, 16), source=ht.ThreefrySource(17),
                         device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        a = ctx.encrypt([13, 200], ht.U8, batch=True)
        b = ctx.encrypt([11, 3], ht.U8, batch=True)
        want = HomomorphicMultiplication.unsafe_apply(a, b)
        fn = compile_op2(HomomorphicMultiplication, ht.U8, ctx.parameters.pk_degree)
        monkeypatch.setattr(limbmul.maybe_sharded_clmul, "taken", 0)
        with limbmul.use_limb_mesh(limb_mesh(2)):
            got = fn(a, b)
        assert limbmul.maybe_sharded_clmul.taken > 0, "no product took the limb mesh"
        assert torch.equal(got.limbs, want.limbs)
        assert (got.bound, got.noise, got.zero_lanes, got.desc) == (
            want.bound, want.noise, want.zero_lanes, want.desc)
        assert [int(v) for v in ctx.decrypt(got)] == [(13 * 11) & 0xFF, (200 * 3) & 0xFF]

    def test_maybe_sharded_declines_small_products(self, rng):
        with limbmul.use_limb_mesh(limb_mesh(4)):
            # Lg // n < _SHARD_MIN_BLOCK -> decline
            assert limbmul.maybe_sharded_clmul(t(rand_limbs(rng, 2, 32)),
                                               t(rand_limbs(rng, 2, 4))) is None

    def test_maybe_sharded_declines_remote_places(self, rng, monkeypatch):
        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        mesh = Mesh([Place(0, torch.device("cpu")), Place(1, torch.device("cpu"))], ("limb",))
        with limbmul.use_limb_mesh(mesh):
            assert limbmul.maybe_sharded_clmul(t(rand_limbs(rng, 2, 200)),
                                               t(rand_limbs(rng, 2, 6))) is None

    def test_mesh_without_the_axis_rejected(self):
        with pytest.raises(ValueError, match="no axis"):
            limbmul.set_default_limb_mesh(Mesh(["cpu"] * 2, ("data",)))

    def test_dispatcher_routes_large_products(self, rng, monkeypatch):
        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        a, b = t(rand_limbs(rng, 2, 200)), t(rand_limbs(rng, 2, 6))
        want = gf2k.clmul(a, b)  # dense, no mesh
        ppermute.local_bytes = 0
        monkeypatch.setattr(limbmul.maybe_sharded_clmul, "taken", 0)
        monkeypatch.setattr(limbmul.maybe_sharded_clmul, "planned_bytes", 0)
        with limbmul.use_limb_mesh(limb_mesh(4)):
            assert limbmul.maybe_sharded_clmul(a, b) is not None
            got = gf2k.clmul(a, b)  # same entry point, sharded
        assert torch.equal(got, want)
        assert ppermute.local_bytes == 2 * limbmul.comm_bytes_per_call(2, 6, 4)
        assert limbmul.maybe_sharded_clmul.taken == 2
        assert limbmul.maybe_sharded_clmul.planned_bytes == ppermute.local_bytes
        assert limbmul.get_default_limb_mesh()[0] is None  # scope restored

    def test_operand_order_irrelevant(self, rng, monkeypatch):
        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        a, b = t(rand_limbs(rng, 2, 200)), t(rand_limbs(rng, 2, 6))
        with limbmul.use_limb_mesh(limb_mesh(4)):
            got = gf2k.clmul(b, a)  # small x large
        assert torch.equal(got, gf2k.clmul(b, a))
        assert torch.equal(got, gf2k.clmul(a, b))

    def test_broadcast_leading_dims(self, rng, monkeypatch):
        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        a = t(rand_limbs(rng, 6, 128).reshape(3, 2, 128))
        b = t(rand_limbs(rng, 1, 5)[0])  # rank-1, broadcasts
        want = gf2k.clmul(a, b)
        with limbmul.use_limb_mesh(limb_mesh(8)):
            got = gf2k.clmul(a, b)
        assert torch.equal(got, want)
        jmesh = JMesh(np.array(jax.devices()[:8]), (jlimbmul.LIMB_AXIS,))
        monkeypatch.setattr(jlimbmul, "_SHARD_MIN_BLOCK", 8)
        with jlimbmul.use_limb_mesh(jmesh):
            jgot = jgf2k.clmul(jnp.asarray(gf2.to_numpy(a)), jnp.asarray(gf2.to_numpy(b)))
        assert np.array_equal(gf2.to_numpy(got), np.asarray(jgot))

    def test_suppressed_inside_a_block(self, rng, monkeypatch):
        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        a, b = t(rand_limbs(rng, 2, 200)), t(rand_limbs(rng, 2, 6))
        with limbmul.use_limb_mesh(limb_mesh(4)), limbmul.suppress_sharded_clmul():
            assert limbmul.maybe_sharded_clmul(a, b) is None

    def test_min_block_knob_name(self):
        assert limbmul.SHARD_MIN_BLOCK_ENV == "HOMOMORPH_TPU_TORCH_SHARD_MIN_BLOCK"

    def test_circuit_add_identical_under_limb_mesh(self, monkeypatch):
        """End to end: the adder at a large degree class gives the same
        ciphertext with and without the limb mesh, and the JAX package's."""
        import homomorph_tpu as hm
        import homomorph_tpu_torch as ht
        from homomorph_tpu_torch.models import circuits

        monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 8)
        p = (512, 512, 2, 16)
        ctx = ht.Context(ht.Parameters(*p), source=ht.ThreefrySource(31), device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        a = ctx.encrypt([231, 77], ht.U8, batch=True)
        b = ctx.encrypt([140, 99], ht.U8, batch=True)
        dense = circuits.add(a, b)
        monkeypatch.setattr(limbmul.maybe_sharded_clmul, "taken", 0)
        with limbmul.use_limb_mesh(limb_mesh(4)):
            sharded = circuits.add(a, b)
        assert limbmul.maybe_sharded_clmul.taken > 0, "no product took the limb mesh"
        assert torch.equal(dense.limbs, sharded.limbs)
        assert [int(v) for v in ctx.decrypt(sharded)] == [(231 + 140) & 0xFF, (77 + 99) & 0xFF]
        jctx = hm.Context(hm.Parameters(*p), source=hm.ThreefrySource(31))
        jctx.generate_secret_key()
        jctx.generate_public_key()
        from homomorph_tpu.models import circuits as jcircuits

        jsum = jcircuits.add(jctx.encrypt([231, 77], hm.U8, batch=True),
                             jctx.encrypt([140, 99], hm.U8, batch=True))
        assert np.array_equal(gf2.to_numpy(sharded.limbs), np.asarray(jsum.limbs))
