"""The port's experiments (``homomorph_tpu_torch.experiments``), on the CPU
at small parameters.

The u16 and u32 experiments' products are the JAX package's
``mul_unsigned`` limb for limb on the same ciphertexts (tolerance 0), and
the u16 product decrypts right inside its noise envelope under a key with
``S(0) = 1``, which reads every coefficient.  The u32 and u64 experiments
refuse parameters below their bounds whatever the key; below the bound the
u64 product's constant terms (all that a key with ``S(0) = 0`` reads) give
``x * y mod 2^64``.  The tree and the reference circuit decrypt alike, and
the staged roofline product decrypts right inside its envelope under a key
with ``S(0) = 1``; off the card every device time is ``None`` and the
bounds are the H100's.  The full sizes run on the card only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
from homomorph_tpu.models import circuits as jcirc
from homomorph_tpu_torch.gf2 import poly as tpoly

from homomorph_tpu_torch.experiments import (
    common,
    exp_add,
    exp_mul,
    exp_mul32,
    exp_mul64,
    exp_mul_roofline,
)

SMALL = (16, 8, 1, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes in long chains of tiny ops: one intra-op thread, so that
    the test runner's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(*a):
    pass


@pytest.fixture(scope="module")
def jax_products():
    """``get(width, B) -> (a, b, limbs)``: the experiment's operands at
    ``SMALL`` and the JAX package's tree product of the same ciphertexts
    (jitted once a width)."""
    cache = {}

    def get(width, B):
        if (width, B) not in cache:
            _, a, b, _, _ = exp_mul32.operands(width, SMALL, B, device="cpu")
            desc = getattr(hm, width.upper())

            @jax.jit
            def jstep(al, bl):
                return jcirc.mul_unsigned(hm.Ciphered(al, a.bound, desc),
                                          hm.Ciphered(bl, b.bound, desc)).limbs

            want = jstep(jnp.asarray(tpoly.to_numpy(a.limbs)), jnp.asarray(tpoly.to_numpy(b.limbs)))
            cache[width, B] = a, b, np.asarray(want, dtype=np.uint32)
        return cache[width, B]

    return get


@pytest.mark.parametrize("width,B", [("u16", 4), ("u32", 2)])
@pytest.mark.parametrize("eager", [False, True])
def test_mul32_products_decrypt_right(jax_products, width, B, eager):
    """Below the bound, where no key with ``S(0) = 1`` decrypts them, the
    experiment's products (compiled and eager) are the JAX package's limb
    for limb, so they decrypt as the JAX package's do."""
    a, b, want = jax_products(width, B)
    got = exp_mul32.product_step(a, b, eager)()
    assert got.limbs.shape[:2] == (B, {"u16": 16, "u32": 32}[width])
    assert np.array_equal(tpoly.to_numpy(got.limbs), want)


def test_u16_product_decrypts_right_inside_its_envelope():
    out = exp_mul32.run("u16", params=(448, 8, 1, 8), B=2, device="cpu", log=quiet)
    assert out["correct"] and out["s0"] == 1 and out["requirement"] == 417
    assert out["device_s"] is None and out["wall_s"] > 0 and out["product_shape"][:2] == [2, 16]


def test_mul32_refuses_parameters_below_the_bound():
    for seed in (11, common.CHECK_SEED):  # S(0) = 0 and 1
        with pytest.raises(ValueError, match="is below the u16 bound 417"):
            exp_mul32.run("u16", params=SMALL, B=2, seed=seed, device="cpu", log=quiet)
    assert exp_mul32.CONFIGS == {"u16": (1024, 512), "u32": (2432, 8)}


def test_mul64_product_decrypts_right():
    """The u64 experiment refuses the small parameters for every key; its
    product there has constant terms spelling ``x * y mod 2^64``, which is
    what a key with ``S(0) = 0`` decrypts at any depth.  The whole product
    decrypts under a key with ``S(0) = 1`` at ``PARAMS`` on the card."""
    from homomorph_tpu_torch.models import circuits

    for seed in (11, common.CHECK_SEED):
        with pytest.raises(ValueError, match="is below the u64 bound 13373"):
            exp_mul64.run(params=(16, 8, 1, 8), seed=seed, device="cpu", log=quiet)
    ctx = common.context((16, 8, 1, 8), 11, "cpu")
    assert common.key_s0(ctx) == 0
    x, y, a, b = exp_mul64.operands(ctx)
    prod = circuits.mul_unsigned(a, b)
    assert prod.limbs.shape[0] == 64
    constant_terms = [int(v) & 1 for v in prod.limbs[:, 0]]
    assert sum(bit << i for i, bit in enumerate(constant_terms)) == (x * y) % (1 << 64)
    assert int(ctx.decrypt(prod)) == (x * y) % (1 << 64)
    assert exp_mul64.PARAMS == (13440, 128, 1, 128)


def test_the_route_leaf_and_the_s0_rule():
    assert common.leaf_shape(8, 9, 9) == (8, 9, 9)  # below the route's threshold
    assert common.leaf_shape(2, 256, 256, kmin=64) == (2 * 27, 32, 32)  # three splits
    assert common.leaf_shape(3, 64, 256, kmin=64) == (3 * 4 * 3, 32, 32)  # chunks, a split
    assert common.key_s0(common.context(SMALL, 11, "cpu")) == 0
    assert common.key_s0(common.context(SMALL, common.CHECK_SEED, "cpu")) == 1


def test_tree_and_reference_decrypt_alike():
    out = exp_mul.run("u8", B=8, params=(32, 16, 1, 16), device="cpu", log=quiet)
    assert out["tree"]["decrypts"] == out["ref"]["decrypts"]
    assert out["tree"]["device_s"] is None


def test_roofline_stages_decrypt_right_and_carry_bounds():
    out = exp_mul_roofline.run("u8", B=8, device="cpu", log=quiet)
    names = [r["stage"] for r in out["stages"]]
    assert names[0] == "pp" and names[-1] == "ripple" and names[1] == "level0"
    # a level whose carries all fall off the top column launches no product
    assert all(r["bound_s"] >= 0 and r["device_s"] is None for r in out["stages"])
    assert out["stages"][0]["bound_s"] > 0 and out["stages"][-1]["bound_s"] > 0
    assert out["bound_total_s"] == pytest.approx(sum(r["bound_s"] for r in out["stages"]))


def test_add_and_scaled_models():
    add = exp_add.profile_add("cpu", n_add=16, log=quiet)
    assert add["device_s"] is None and add["clmul_bound_s"] > 0
    # the chain's bound grows with the batch (31 dependent steps, each linear in B)
    pk = common.peaks(torch.device("cpu"))
    assert exp_add.add_sol(2048, 256, pk) > exp_add.add_sol(16, 256, pk)
    sc = exp_add.profile_scaled("cpu", bits=2048, log=quiet)
    assert sc["encrypt_device_s"] is None and sc["decrypt_device_s"] is None
    assert sc["encrypt_bound_s"] > 0 and sc["count_product_bound_s"] > 0
    assert np.isfinite(sc["decrypt_bound_s"])


def test_chunked_variants_equal_the_baseline_and_k2():
    from homomorph_tpu_torch.experiments import exp_enc_chunked

    out = exp_enc_chunked.run(bits=2048, device="cpu", log=quiet)
    assert set(out["rows"]) == {"K2", "baseline", "chunkD-96", "chunkD-128", "weights-pack",
                                "mapB-8192", "mapB-32768", "mapB-131072",
                                "mapB+weights-32768"}
    for name, r in out["rows"].items():
        assert r["mismatches"] == 0 and r["device_s"] is None and r["wall_s"] > 0, name


def test_weights_pack_equals_parity_pack():
    from homomorph_tpu_torch.experiments.exp_enc_chunked import _weights_pack
    from homomorph_tpu_torch.gf2 import poly as gf2

    counts = torch.from_numpy(np.random.default_rng(1).integers(0, 129, size=(5, 96)))
    assert torch.equal(_weights_pack(counts, 4), gf2.parity_pack(counts, 4))


def test_scaling_model_reads_the_bench_and_the_link():
    from homomorph_tpu_torch.experiments import exp_scaling_model as m

    bench = {"extras": {"encrypt_device_busy_bits_per_s": 1e10,
                        "scaled_1024_encrypt_device_busy_bits_per_s": 1e9, "device": "card"}}
    out = m.model(bench, 450e9, "a data sheet")
    assert out["link"] == {"bytes_per_s": 450e9, "source": "a data sheet"}
    effs = {row["config"]: row["eff"] for row in out["tables"]}
    assert effs["data axis, bulk encrypt (no exchange)"]["8"] == 1.0
    tau = effs["tau axis, encrypt d=dp=128"]
    assert 0 < tau["8"] < tau["4"] < tau["2"] < 1
    # bytes a bit: 4 L a round, log2(n) rounds (a ring of n - 1 hops otherwise)
    assert m.tau_bytes_per_bit(4, 9) == 72 and m.tau_bytes_per_bit(3, 9) == 72
    with pytest.raises(ValueError, match="lacks"):
        m.model({"extras": {"encrypt_device_busy_bits_per_s": None}}, 1e9, "x")
    with pytest.raises(SystemExit):
        m.main(["--bench", "b.json"])  # the link's figure and source are required
