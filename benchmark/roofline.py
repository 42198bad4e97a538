"""The yardstick of the kernels' roofline shares: the card's peaks and the
least time of the work a request asks for.

Frozen copies of the port's own arithmetic, kept here so that no change to
the program can move the yardstick: the peaks and the comb's work of
``homomorph_tpu_torch/utils/profiling.py`` (``chip_peaks``,
``clmul_comb_work``, ``clmul_bytes``, the encrypt's bytes of
``encrypt_sol``) and the Karatsuba route's leaf arithmetic of
``homomorph_tpu_torch/experiments/common.py::leaf_shape`` (through
``gf2/kernels.py::route_plan`` and ``leaf_rows``).

A product's bound takes the least comb work over every depth of the route,
down to one-limb leaves, so no change to the route's threshold can make the
count stale, and no design the repo knows can beat it.
"""

from __future__ import annotations

import subprocess

#: HBM3 rate of the H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: CUDA C guide, arithmetic throughput, compute capability 9.0
INT32_OPS_PER_SM_PER_CLOCK = 64
#: 32 banks of 4 bytes
SMEM_BYTES_PER_SM_PER_CLOCK = 128
#: K1's comb: 15 shared-memory loads and 8 funnel shifts and 8 XORs a limb pair
COMB_LOADS_PER_PAIR = 15
COMB_OPS_PER_PAIR = 16


def max_sm_clock_mhz(index: int = 0) -> float:
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return float(out.strip().splitlines()[0])


def peaks(sms: int, mhz: float) -> dict:
    """Peak rates, the per-SM ones scaled by ``sms`` and the clock ``mhz``."""
    clock = sms * mhz * 1e6
    return dict(hbm_bw=HBM_BYTES_PER_S, int32_ops=INT32_OPS_PER_SM_PER_CLOCK * clock,
                smem_bw=SMEM_BYTES_PER_SM_PER_CLOCK * clock, sms=sms, mhz=mhz)


def card_peaks(index: int = 0) -> dict:
    """The card's peaks: its SM count, and its maximum SM clock from ``nvidia-smi``."""
    import torch

    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return peaks(sms, max_sm_clock_mhz(index))


def route_depths(Ls: int, Lg: int) -> "list[tuple[int, int, int]]":
    """``(row factor, leaf Ls, leaf Lg)`` of an ``Ls x Lg`` product
    (``Ls <= Lg``) at every depth of the Karatsuba route: unrouted, and,
    after the chunk step where ``Lg > 3 Ls / 2`` cuts the wider operand into
    ``ceil(Lg / Ls)`` pieces, each number of halvings (rows times 3, width
    ``(L + 1) // 2``) down to one-limb leaves."""
    out = [(1, Ls, Lg)]
    rows = 1
    if Lg > (3 * Ls) // 2:
        rows = -(-Lg // Ls)
        Lg = Ls
        out.append((rows, Ls, Lg))
    while Ls > 1:
        Ls = Lg = (Lg + 1) // 2
        rows *= 3
        out.append((rows, Ls, Lg))
    return out


def least_leaf_pairs(B: int, La: int, Lb: int) -> int:
    """The fewest (limb, limb) pairs the comb needs for ``[B, La] x [B, Lb]``
    over every depth of the route: ``rows * Ls * (Lg + 1)`` a depth."""
    Ls, Lg = min(La, Lb), max(La, Lb)
    return min(B * f * s * (g + 1) for f, s, g in route_depths(Ls, Lg))


def clmul_bytes(B: int, La: int, Lb: int) -> int:
    """Both operands read once, the product written once."""
    return B * (La + Lb) * 4 * 2


def clmul_bound_s(B: int, La: int, Lb: int, pk: dict) -> float:
    """Least seconds of one product: the larger of its bytes over HBM and
    the comb's least work over the shared-memory and INT32 peaks."""
    pairs = least_leaf_pairs(B, La, Lb)
    return max(clmul_bytes(B, La, Lb) / pk["hbm_bw"],
               pairs * COMB_LOADS_PER_PAIR * 4 / pk["smem_bw"],
               pairs * COMB_OPS_PER_PAIR / pk["int32_ops"])


def encrypt_bytes(n_bits: int, tau: int, n_limbs: int) -> int:
    """One encrypt of ``n_bits`` bits: the selection words (``ceil(tau/32)``
    a bit), the key (``tau`` rows of ``n_limbs``), the plaintext bits (int32)
    and the ciphertext limbs, each moved once."""
    W = -(-tau // 32)
    return (n_bits * W + tau * n_limbs + n_bits + n_bits * n_limbs) * 4
