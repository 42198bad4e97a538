"""The port's bench (``homomorph_tpu_torch.bench``) against the JAX bench's
steps, on the CPU.

The JAX bench's steps are closures inside its ``main``; each test rebuilds
the JAX step from the JAX package as ``bench.py`` writes it and holds the
port's step to it on the same inputs: the encrypt step's ciphertext bytes
under the same threefry keys, the decrypt bits, an 8-step decrypt chain
against ``lax.scan``, and the add and ``lt`` steps' limbs.  The result's
keys are read from ``bench.py``'s source with ``ast`` (the JAX bench is
neither imported nor run), and the port's bench runs end to end at
``--quick`` on the CPU.  Tolerance 0: every comparison is of integer words
or bits.
"""

import ast
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.gf2 import poly as jgf2
from homomorph_tpu.gf2.encrypt_kernel import encrypt_bits_fused as jencrypt
from homomorph_tpu.models import circuits as jcircuits
from homomorph_tpu_torch import bench
from homomorph_tpu_torch.experiments.common import Timer, context
from homomorph_tpu_torch.gf2 import poly as tgf2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes in long chains of tiny ops: one intra-op thread, so that
    the test runner's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def u32(t):
    return t.numpy().view(np.uint32)


def jax_bench_context(params, seed):
    ctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(seed))
    ctx.generate_secret_key()
    ctx.generate_public_key()
    return ctx


@pytest.fixture(scope="module")
def contexts():
    """The bench's key pair at ``Parameters(128, 128, 64, 128)`` in both
    packages (``ThreefrySource(0)``, as ``bench.py:134``)."""
    return jax_bench_context(bench.PARAMS, 0), context(bench.PARAMS, 0, "cpu")


@pytest.fixture(scope="module")
def ciphertexts(contexts):
    """512 bits encrypted by each package's encrypt step under the bench's
    keys ``split(key(1), 8)[i]``."""
    jctx, tctx = contexts
    L = jgf2.limbs_for(jctx.parameters.pk_degree)
    B, W = 512, 4
    pk_bits = jctx.get_public_key().bit_planes()
    jkeys = jax.random.split(jax.random.key(1), 8)

    @jax.jit
    def enc_step(key):
        selw = jax.random.bits(key, (B, W), dtype=jnp.uint32)
        return jencrypt(selw, pk_bits, jnp.zeros((B,), dtype=jnp.uint32), L)

    step = bench.encrypt_step(tctx.get_public_key(), L, B, "cpu")
    tkeys = bench.bench_keys(8)
    return [(np.asarray(enc_step(jkeys[i])), step(tkeys[i])) for i in (0, 3)], L


def test_bench_keys_are_the_jax_split():
    keys = jax.random.split(jax.random.key(1), 20)
    assert bench.bench_keys(20) == tuple(
        tuple(int(w) for w in np.asarray(jax.random.key_data(k))) for k in keys)


def test_encrypt_step_gives_the_jax_bytes(ciphertexts):
    pairs, L = ciphertexts
    for want, got in pairs:
        assert got.shape == (512, L)
        assert u32(got).tobytes() == want.tobytes()


def test_decrypt_bits_match_jax(contexts, ciphertexts):
    jctx, tctx = contexts
    want_ct, ct = ciphertexts[0][0]
    L = ct.shape[-1]
    jw = jctx.get_secret_key().decrypt_mask(L)
    tw = tctx.get_secret_key().decrypt_mask(L)
    assert np.array_equal(u32(tw), np.asarray(jw))
    want = np.asarray(jgf2.decipher_bits(jnp.asarray(want_ct), jw))
    got = tgf2.decipher_bits(ct, tw).numpy()
    assert np.array_equal(got, want) and not got.any()  # the bench encrypts zeros


def test_decrypt_chain_matches_jax_scan(contexts, ciphertexts):
    """8 dependent decrypts of the first 32 rows, as ``bench.py:206-213``."""
    jctx, tctx = contexts
    want_ct, ct = ciphertexts[0][0]
    L = ct.shape[-1]
    jw = jctx.get_secret_key().decrypt_mask(L)

    @jax.jit
    def chain(c, z):
        def body(carry, _):
            bits = jgf2.decipher_bits(carry, jw)
            return carry ^ (bits * z)[..., None], bits

        _, outs = jax.lax.scan(body, c, None, length=8)
        return outs

    c32 = want_ct[:32].copy()
    c32[:, 0] ^= np.arange(32, dtype=np.uint32) & 1  # nonzero plaintexts
    want = np.asarray(chain(jnp.asarray(c32), jnp.uint32(0)))
    tchain = bench.decrypt_chain(tctx.get_secret_key().decrypt_mask(L), 8)
    got = tchain(torch.from_numpy(c32.view(np.int32)), torch.zeros((), dtype=torch.int32))
    assert got.shape == (8, 32)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got[0].numpy(), np.arange(32) & 1)


SMALL = (32, 16, 1, 16)


@pytest.fixture(scope="module")
def small_u8():
    """U8 operands at small parameters: each package encrypts 16 pairs with
    its bench encrypt step under the same key; the bytes are equal."""
    jctx = jax_bench_context(SMALL, 5)
    tctx = context(SMALL, 5, "cpu")
    L = jgf2.limbs_for(jctx.parameters.pk_degree)
    B = 2 * 16 * 8
    selw = jax.random.bits(jax.random.key(3), (B, 1), dtype=jnp.uint32)
    jct = np.asarray(jencrypt(selw, jctx.get_public_key().bit_planes(),
                              jnp.zeros((B,), dtype=jnp.uint32), L))
    tct = bench.encrypt_step(tctx.get_public_key(), L, B, "cpu")(ht.rng.threefry_key(3))
    assert u32(tct).tobytes() == jct.tobytes()
    return jctx, tctx, jct.reshape(2, 16, 8, L), tct.reshape(2, 16, 8, L)


@pytest.mark.parametrize("name", ["add", "lt"])
def test_circuit_steps_match_jax(small_u8, name):
    """The bench's add and ``lt`` steps (compiled callables; eager on the
    CPU) against the JAX circuits on the same limbs."""
    from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicLessThan
    from homomorph_tpu_torch.models.compiled import compile_op2

    jctx, tctx, jct, tct = small_u8
    bound = tctx.parameters.pk_degree
    jop = {"add": jcircuits.add, "lt": jcircuits.lt}[name]

    @jax.jit
    def jstep(a_limbs, b_limbs):  # as bench.py:237-241
        return jop(hm.Ciphered(a_limbs, bound, hm.U8), hm.Ciphered(b_limbs, bound, hm.U8)).limbs

    want = jstep(jnp.asarray(jct[0]), jnp.asarray(jct[1]))
    top = {"add": HomomorphicAddition, "lt": HomomorphicLessThan}[name]
    step = compile_op2(top, ht.U8, bound)
    got = step(ht.Ciphered(tct[0], bound, ht.U8), ht.Ciphered(tct[1], bound, ht.U8))
    assert u32(got.limbs).tobytes() == np.asarray(want).tobytes()


def jax_result_keys():
    """Every key the JAX bench puts in its result: the string keys of its
    dict literals and of its ``extras[...] =`` assignments."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == "extras" and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


def all_keys(obj):
    if isinstance(obj, dict):
        out = set(obj)
        for v in obj.values():
            out |= all_keys(v)
        return out
    return set()


FULL_MEASUREMENTS = dict(
    batch_bits=1, bit_enc_per_s=1.0, dev_enc_per_s=1.0, dec_per_s=1.0, dev_dec_per_s=1.0,
    dec_sync_s=1.0, dec_device_s=1.0, chain_method="m", add_per_s=1.0, dev_add_per_s=1.0,
    dab_per_s=1.0, lt_per_s=1.0, dev_lt_per_s=1.0, device="d", platform="gpu",
    device_count=1, mul_per_s=1.0, dev_mul_per_s=1.0, dm_per_s=1.0, mul16_per_s=1.0,
    dev_mul16_per_s=1.0, mul32_per_s=1.0, mul32_first_s=1.0, mul32_limbs=1, mul32_k1=1,
    mul32_peak_gb=1.0, mul32_mask_s=1.0, s_enc_per_s=1.0, s_dec_per_s=1.0, l_enc_per_s=1.0,
    l_dec_per_s=1.0, dev_senc_per_s=1.0, dev_sdec_per_s=1.0,
)


def test_result_carries_every_key_of_the_jax_bench():
    """The JAX bench's keys are in the port's result, or in the windows file
    it names.  ``measurement_windows`` is the JAX bench's inline fallback
    for a working directory it cannot write; the port always writes its
    windows under the build directory, which it creates."""
    t = Timer(torch.device("cpu"))
    t._record("encrypt", [1.0, 2.0, 3.0], 4)
    got = all_keys(bench.assemble(FULL_MEASUREMENTS, "bench_windows.json")) | all_keys(t.stats)
    want = jax_result_keys()
    assert {"metric", "headline", "mul_u32_first_eval_s", "windows_file",
            "scaled_1024_decrypt_device_busy_bits_per_s", "p95_s_per_step"} <= want
    assert want - {"measurement_windows"} <= got, sorted(want - got)


def test_main_quick_on_the_cpu(capsys):
    """``--quick --skip-scaled --json-only --device cpu`` end to end: one JSON
    line with the JAX bench's keys for those flags, the device-busy fields
    null off the card, the windows in the build directory, and the tracked
    ``bench_windows.json`` at the repo's root untouched."""
    tracked = os.path.join(ROOT, "bench_windows.json")
    before = hashlib.sha256(open(tracked, "rb").read()).hexdigest()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        rc = bench.main(["--quick", "--skip-scaled", "--json-only", "--device", "cpu",
                         "--batch-bits", "4096"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    assert hashlib.sha256(open(tracked, "rb").read()).hexdigest() == before
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    quick = jax_result_keys() - {k for k in jax_result_keys() if k.startswith(
        ("mul_u8", "decipher_after_mul", "mul_u16_device", "mul_u32", "scaled_"))}
    quick -= {"measurement_windows", "windows", "steps_per_window", "p50_s_per_step",
              "p95_s_per_step", "min_s_per_step", "mul_u16_per_s_batched"}
    assert quick <= all_keys(out), sorted(quick - all_keys(out))
    assert out["headline"]["mul_u16_per_s_batched"] is None
    ex = out["extras"]
    assert ex["batch_bits"] == 4096 and ex["platform"] == "cpu" and ex["device"] == "cpu"
    for k in ("encrypt_device_busy_bits_per_s", "decrypt_device_busy_bits_per_s",
              "add_u32_device_busy_per_s", "lt_u32_device_busy_per_s",
              "decrypt_u32_device_latency_us"):
        assert ex[k] is None, k
    assert out["value"] > 0 and ex["add_u32_per_s_batched"] > 0
    windows = json.load(open(ex["windows_file"]))
    assert os.path.dirname(ex["windows_file"]) != ROOT
    assert {"encrypt", "decrypt", "add_u32", "lt_u32", "decrypt_u32_sync"} <= set(windows)
