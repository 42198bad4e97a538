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
    exp_mask_steps,
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


def test_route_experiment_splits_records_by_kernel_and_needs_the_card():
    """``exp_route`` splits device records into K1, R1, R2 (every
    ``route_join`` launch: the ascent, a level alone, the chunk step) and
    the rest, and refuses to measure without a card; its routes are the
    paths' own (chip_smoke.py holds the bench's and the u64 path's widest
    products to them)."""
    from homomorph_tpu_torch.experiments import exp_route

    records = {"clmul_comb_kernel": 3.0, "route_split_kernel": 0.5,
               "route_join_ascent_kernel": 0.25, "route_join_level_kernel<4>": 0.125,
               "route_join_pieces_kernel<4>": 0.0625, "elementwise_kernel": 1.0}
    assert exp_route.by_kernel(records) == {"K1": 3.0, "R1": 0.5, "R2": 0.4375, "other": 1.0}
    assert [r[0] for r in exp_route.ROUTES] == ["u16-busiest", "u32-widest", "d5888-widest",
                                                "u64-widest"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            exp_route.run(log=quiet)


def test_route_probes_edit_the_kernel_source_once_each_and_need_the_card():
    """Each probe of ``exp_route_probe`` edits ``csrc/route.cu`` where it
    means to (every edit matches exactly once, and the kernel it names is
    the one it edits), an edit that matches nothing is refused, and the
    probes are measured only on a card."""
    from homomorph_tpu_torch.experiments import exp_route_probe as probe
    from homomorph_tpu_torch.gf2 import cuda_build

    source = (cuda_build.CSRC / "route.cu").read_text()
    r1, r2 = source.index("- R1 --"), source.index("- R2 --")  # the sections of each kernel
    for name, (kernel, edits) in probe.PROBES.items():
        edited = probe.probe_source(name, source)
        assert edited != source and edited.count("\n") == source.count("\n")
        for old, _ in edits:
            at = source.index(old)
            assert (r1 < at < r2) if kernel == "R1" else at > r2
    with pytest.raises(ValueError, match="0 matches"):
        probe.probe_source("r1-one-term", "no kernel here")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            probe.run(log=quiet)


def test_timer_takes_lost_traces_once_more(monkeypatch):
    """On the card ``Timer.device_s`` takes a second set of traces where the
    first held no device record, and raises where the second holds none
    either; any other error raises at once."""
    from homomorph_tpu_torch.utils import profiling

    answers = []

    def busy(fn, reps):
        out = answers.pop(0)
        if isinstance(out, Exception):
            raise out
        return out

    monkeypatch.setattr(profiling, "device_busy", busy)
    timer = common.Timer(torch.device("cuda"))
    lost = RuntimeError("torch.profiler recorded no device time in 3 traces")
    answers.extend([lost, (0.5, {"k": 1.0})])
    assert timer.device_s(lambda: None) == (0.5, {"k": 1.0}) and not answers
    answers.extend([lost, lost])
    with pytest.raises(RuntimeError, match="no device time"):
        timer.device_s(lambda: None)
    answers.extend([RuntimeError("device_records needs a CUDA card"), (0.5, {})])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        timer.device_s(lambda: None)


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


def test_mask_step_sweeps_agree_on_the_cpu():
    """The mask experiment's cap and step sweeps at small classes: every
    cap's mask equal to the default plan's, every step by M2 equal to the
    route's (it raises otherwise); off the card no device time."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    out = exp_mask_steps.run(classes=((40, 300), (100, 600)), caps=(1, 2, 64), device="cpu",
                             log=quiet)
    for c in out["classes"]:
        n_steps = len(mk.precisions(32 * c["limbs"] - c["degree"]))
        assert [r["m3_steps"] + r["m2_steps"] for r in c["caps"]] == [n_steps] * 3
        assert all(r["device_s"] is None and r["m3_device_s"] is None for r in c["caps"])
        assert c["steps"] and all(r["m2_device_s"] is None and r["bound_s"] > 0
                                  for r in c["steps"])
        assert len(c["steps"]) == sum(kind == "M2" for kind, _ in
                                      mk.mask_plan(c["degree"], c["limbs"]))


@pytest.mark.parametrize("Lo,Ls,leaf", [(3145308, 421, True), (261960, 185, True),
                                        (128, 421, False), (5, 3, False)])
def test_newton_step_work_takes_the_fewer_pairs(Lo, Ls, leaf):
    """A step's bound counts the fewer of M2's comb pairs and the Karatsuba
    route's leaf pairs: the route's at the wide last steps (5.8e8 against
    1.3e9 pairs at the u64 class), the comb's at narrow ones."""
    from homomorph_tpu_torch.utils.profiling import COMB_LOADS_PER_PAIR

    B, La, Lb = common.leaf_shape(1, min(Ls, Lo), Lo)
    leaf_pairs = B * La * (Lb + 1)
    comb = common.comb_pairs(Lo, Ls)
    smem, ops = common.newton_step_work(Lo, Ls)
    assert smem == min(comb, leaf_pairs) * COMB_LOADS_PER_PAIR * 4 and ops == smem * 16 // 60
    assert (leaf_pairs < comb) == leaf
