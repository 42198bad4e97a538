"""Plaintext result of the program's ``HomomorphicAddition``: the sum,
wrapped to the operands' width."""


def expected(a, b, n_bits: int):
    """int64 tensors of values under 2**n_bits (n_bits <= 32) -> the wrapped sum."""
    return (a + b) & ((1 << n_bits) - 1)
