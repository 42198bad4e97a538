"""Plaintext result of the program's ``HomomorphicMultiplication`` on
unsigned operands: the product, wrapped to the operands' width."""


def expected(a, b, n_bits: int):
    """int64 tensors of values under 2**n_bits (n_bits <= 32) -> the wrapped
    product.  ``b`` is split in 16-bit halves, so no partial product passes
    2**48 and nothing overflows int64."""
    mask = (1 << n_bits) - 1
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & mask
