"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False.  The file imports neither jax nor the JAX package and uses no
fixture of ``tests/conftest.py`` (which imports jax), so on a machine with a
card and no jax it runs as

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Parity is bit-exact (integer GF(2) values, tolerance 0).
"""

import numpy as np
import pytest
import torch

from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
from homomorph_tpu_torch.gf2 import kernels as k
from homomorph_tpu_torch.gf2 import poly as gf2

pytestmark = pytest.mark.cuda


def on_card(shape, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    arr = np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)
    return gf2.from_numpy(arr, "cuda")


@pytest.mark.parametrize(
    "B,La,Lb", [(1, 1, 1), (128, 5, 5), (4096, 9, 9), (257, 9, 256), (7, 96, 9), (3, 40, 25)]
)
def test_clmul_kernel_matches_plain(B, La, Lb):
    a, b = on_card((B, La), 1), on_card((B, Lb), 2)
    before = k.clmul_flat.launches
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    assert k.clmul_flat.launches == before + 1
    assert torch.equal(got, k.clmul_plain(a, b))


def test_clmul_broadcast_on_card():
    q, s = on_card((128, 5), 3), on_card((5,), 4)
    assert torch.equal(k.clmul(q, s), k.clmul_plain(q, s.expand(128, 5).contiguous()))


@pytest.mark.parametrize("tau,Lpk,L", [(1, 2, 2), (33, 9, 9), (128, 9, 9), (256, 65, 65), (128, 9, 12)])
def test_encrypt_kernel_matches_plain(tau, Lpk, L):
    B = 4096
    pkcol = enc.pk_columns(on_card((tau, Lpk), 5))
    selw = on_card((B, -(-tau // 32)), 6)
    plain = on_card((B,), 7) & 1
    before = enc.encrypt_bits_fused.launches
    got = enc.encrypt_bits_fused(selw, pkcol, plain, L)
    torch.cuda.synchronize()
    assert enc.encrypt_bits_fused.launches == before + 1
    assert torch.equal(got, enc.encrypt_plain(selw, pkcol, plain, L))


def test_wrappers_raise_on_unsupported_input():
    a = on_card((4, 9), 8)
    with pytest.raises(ValueError):
        k.clmul_flat(a.T, a.T)
    with pytest.raises(ValueError):
        k.clmul_flat(a, a.cpu())
    with pytest.raises(TypeError):
        enc.encrypt_bits_fused(a, a.to(torch.int64), a[:, 0].contiguous(), 9)
