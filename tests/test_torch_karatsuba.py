"""The port's Karatsuba route (``homomorph_tpu_torch.gf2.kernels``) against
the JAX dispatcher and the plain product, on the CPU.

On a CPU tensor the route runs only when forced
(``HOMOMORPH_TPU_TORCH_FORCE_KARATSUBA=1``), over the plain version, as the
JAX package's own suite forces ``FORCE_KARATSUBA`` (``tests/
test_poly_golden.py``).  Products are integers of GF(2)[X]: parity is bit
for bit (tolerance 0).  Inputs come from numpy generators with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.gf2 import kernels as jk
from homomorph_tpu.models import circuits as jcirc
from homomorph_tpu_torch.gf2 import kernels as k
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.models import circuits as tcirc

# the JAX suite's dispatch shapes (tests/test_poly_golden.py:211-220)
SIZES = [(64, 64), (65, 64), (96, 96), (64, 96), (64, 160), (384, 384), (256, 384), (5, 384)]


def words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.fixture
def forced(monkeypatch):
    """Force the route on CPU tensors at a threshold the test picks."""
    monkeypatch.setenv(k.FORCE_KARATSUBA_ENV, "1")

    def at(kmin):
        monkeypatch.setenv(k.KARATSUBA_MIN_ENV, str(kmin))

    at(64)  # the JAX package's threshold, so both take the same levels
    return at


@pytest.fixture
def launches(monkeypatch):
    """Shapes of the calls the dispatcher makes to the kernel's wrapper."""
    shapes = []
    wrapper = k.clmul_flat

    def recording(af, bf):
        shapes.append((af.shape[0], af.shape[1], bf.shape[1]))
        return wrapper(af, bf)

    monkeypatch.setattr(k, "clmul_flat", recording)
    return shapes


@pytest.mark.parametrize("La,Lb", SIZES)
def test_forced_route_matches_jax(forced, monkeypatch, La, Lb):
    monkeypatch.setattr(jk, "FORCE_KARATSUBA", True)
    a, b = words(La * 1000 + Lb, (3, La)), words(Lb * 1000 + La, (3, Lb))
    want = np.asarray(jk.clmul(jnp.asarray(a), jnp.asarray(b)))
    got = k.clmul(gf2.from_numpy(a, "cpu"), gf2.from_numpy(b, "cpu"))
    assert np.array_equal(gf2.to_numpy(got), want)


def test_forced_route_scalar_lead_matches_jax(forced, monkeypatch):
    monkeypatch.setattr(jk, "FORCE_KARATSUBA", True)
    a, b = words(70, 70), words(66, 66)
    want = np.asarray(jk.clmul(jnp.asarray(a), jnp.asarray(b)))
    got = k.clmul(gf2.from_numpy(a, "cpu"), gf2.from_numpy(b, "cpu"))
    assert got.shape == (136,) and np.array_equal(gf2.to_numpy(got), want)


@pytest.mark.parametrize("kmin", [2, 3, 8, 33])
@pytest.mark.parametrize(
    "La,Lb", [(7, 7), (9, 9), (65, 64), (33, 100), (100, 33), (40, 41), (17, 200), (3, 17)]
)
def test_forced_route_matches_plain(forced, kmin, La, Lb):
    """Odd widths, chunk tails narrower than the smaller operand, either
    operand the wider one, thresholds down to 2 (many levels)."""
    forced(kmin)
    a = gf2.from_numpy(words(La + 7 * Lb, (5, La)), "cpu")
    b = gf2.from_numpy(words(Lb + 11 * La, (5, Lb)), "cpu")
    got = k.clmul(a, b)
    assert got.shape == (5, La + Lb)
    assert torch.equal(got, k.clmul_plain(a, b))


@pytest.mark.parametrize(
    "La,Lb,kmin,leaf",
    [
        (64, 64, 64, (3, 32, 32)),       # one split
        (65, 64, 33, (9, 17, 17)),       # two splits of an odd width
        (64, 160, 64, (9, 32, 32)),      # three pieces, then one split each
        (160, 64, 64, (9, 32, 32)),      # the same with the wider operand first
        (5, 384, 4, (231, 3, 3)),        # 77 pieces of 5 limbs, then one split
        (40, 41, 41, (1, 40, 41)),       # below the threshold: no level
    ],
)
def test_one_wrapper_call_per_routed_product(forced, launches, La, Lb, kmin, leaf):
    forced(kmin)
    B = 1
    a = gf2.from_numpy(words(1, (B, La)), "cpu")
    b = gf2.from_numpy(words(2, (B, Lb)), "cpu")
    got = k.clmul(a, b)
    assert launches == [leaf]
    assert torch.equal(got, k.clmul_plain(a, b))
    steps = k.route_plan(min(La, Lb), max(La, Lb), kmin)
    rows = B
    for kind, _, _, n in steps:
        rows *= n if kind == "chunk" else 3
    assert rows == leaf[0]


def test_cpu_default_is_unrouted(monkeypatch, launches):
    monkeypatch.delenv(k.FORCE_KARATSUBA_ENV, raising=False)
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "2")
    a = gf2.from_numpy(words(3, (2, 70)), "cpu")
    b = gf2.from_numpy(words(4, (2, 90)), "cpu")
    k.clmul(a, b)
    assert launches == [(2, 70, 90)]


def test_threshold_is_read_at_each_call(monkeypatch):
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "77")
    assert k.karatsuba_min() == 77
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "1")
    assert k.karatsuba_min() == 2  # a split must narrow the operands
    monkeypatch.delenv(k.KARATSUBA_MIN_ENV)
    assert k.karatsuba_min() == k._KARATSUBA_MIN


def test_u16_product_with_the_route_forced_matches_jax(forced, monkeypatch):
    """A u16 ``mul_unsigned`` at tiny parameters: its wider products take
    chunk and split levels in the port (the JAX package runs its default
    route), and the limbs, bound and noise are the JAX package's."""
    forced(8)
    dispatched = []
    rows = k.clmul_rows

    def recording(af, bf):
        dispatched.append((af.shape[1], bf.shape[1]))
        return rows(af, bf)

    monkeypatch.setattr(k, "clmul_rows", recording)
    params = (16, 8, 1, 8)
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(41))
    jctx.generate_secret_key()
    jctx.generate_public_key()
    xs, ys = [51234, 7], [65535, 40000]
    ja, jb = (jctx.encrypt(v, hm.U16, batch=True) for v in (xs, ys))
    ta, tb = (ht.Ciphered.from_bytes(c.to_bytes(), ht.U16, device="cpu") for c in (ja, jb))
    jc = jcirc.mul_unsigned(ja, jb)
    tc = tcirc.mul_unsigned(ta, tb)
    assert np.array_equal(gf2.to_numpy(tc.limbs), np.asarray(jc.limbs))
    assert (tc.bound, tc.noise, tc.zero_lanes) == (jc.bound, jc.noise, jc.zero_lanes)
    routed = [s for s in dispatched if k.route_plan(min(s), max(s), 8)]
    assert routed, f"no product took a level: {dispatched}"
