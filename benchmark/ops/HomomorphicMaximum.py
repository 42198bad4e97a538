"""Plaintext result of the program's ``HomomorphicMaximum`` on unsigned
operands: the larger of the two."""

import torch


def expected(a, b, n_bits: int):
    """int64 tensors of values under 2**n_bits -> the elementwise maximum."""
    return torch.maximum(a, b)
