"""The port's verify gate (``homomorph_tpu_torch.verify``) on the CPU, where
every wrapper computes its plain torch version (``tests/test_torch_cuda.py``
runs it on the card): it must pass, and it must FAIL loudly, naming the
check, when a path returns wrong bits."""

import numpy as np
import pytest
import torch

import homomorph_tpu_torch as ht
from homomorph_tpu import verify as JV
from homomorph_tpu_torch import verify as V

CPU = torch.device("cpu")


def test_run_verification_quick_passes():
    lines = []
    ht.run_verification(quick=True, log=lines.append, device="cpu")
    assert any("clmul[chunks]" in line for line in lines)
    assert any("linear-map reduction ok" in line for line in lines)
    assert any("typed u32 round trip ok" in line for line in lines)


def test_scaled_roundtrip_check_passes():
    failures = []
    V._check_roundtrip_scaled(failures, lambda *a: None, CPU)
    assert failures == []


def test_multiplier_check_passes():
    failures = []
    V._check_circuits(failures, lambda *a: None, CPU, with_mul=True)
    assert failures == []


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.run_verification(quick=True, log=lambda *a: None)


def test_oracle_helpers_equal_the_jax_gate():
    assert V._int_clmul(0b1001, 0b11) == JV._int_clmul(0b1001, 0b11) == 0b11011
    assert V._int_rem(0b1010101101, 0b11011) == JV._int_rem(0b1010101101, 0b11011) == 0b1010
    row = np.array([0x01020304, 0x0A0B0C0D], dtype=np.uint32)
    assert V._limbs_to_int(row) == JV._limbs_to_int(row) == 0x0A0B0C0D01020304
    assert (V._int_to_limbs(V._limbs_to_int(row), 2) == row).all()


def test_clmul_shapes_cover_every_route():
    """On the card the four shapes take a direct launch, one without a
    level (Ls < 64), a split, and chunks plus a split."""
    from homomorph_tpu_torch.gf2 import kernels as k

    routes = [[s[0] for s in k.route_plan(min(a, b), max(a, b), k._KARATSUBA_MIN)]
              for _, a, b, _ in V.CLMUL_SHAPES]
    assert routes == [[], [], ["split"], ["chunk", "split"]]


@pytest.mark.parametrize("target,name", [
    ("_int_rem", "golden rem vector"),
    ("_int_clmul", "clmul[small]"),
])
def test_failure_is_loud_and_named(monkeypatch, target, name):
    monkeypatch.setattr(V, target, lambda *a: 0xDEAD)
    with pytest.raises(ht.VerificationError, match="FAILED") as info:
        ht.run_verification(quick=True, log=lambda *a: None, device="cpu")
    assert name in str(info.value)


def test_wrong_decryption_is_named(monkeypatch):
    """A decrypt path that returns wrong bits fails the round trips and
    the circuits, each by name."""
    from homomorph_tpu_torch.gf2 import poly as gf2

    real = gf2.decipher_bits
    monkeypatch.setattr(gf2, "decipher_bits", lambda c, w: real(c, w) ^ 1)
    with pytest.raises(V.VerificationError) as info:
        ht.run_verification(quick=True, log=lambda *a: None, device="cpu")
    msg = str(info.value)
    for name in ("d=dp=128 tau=128 round trip", "typed u32", "u8 homomorphic add"):
        assert name in msg
