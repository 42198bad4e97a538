"""Encrypted aggregation: sum many ciphertexts in ONE N-ary op, then
count set bits - without decrypting anything.

Eight sensors each submit a batch of encrypted u8 readings.  The server
(public key only) aggregates them with ``HomomorphicSum`` - a single
carry-save tree over all eight operands instead of seven chained adders
whose folded noise would be far beyond any representable parameter set
(models/noise.py::chained_sum_noise_degree).  It also computes each
reading's homomorphic popcount.  Only the data owner can decrypt.

The reference defines the N-ary trait (src/operations.rs:143-213) but
ships no N-ary operation; this exercises the shipped one.

Port of ``examples/encrypted_aggregation.py``.
"""

import numpy as np

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import HomomorphicPopCount, HomomorphicSum

K = 8  # sensors (sum operands)
B = 32  # readings per sensor


def main(device=None) -> None:
    # exact bounds (models/noise.py, delta=1): 8-operand u8 sum needs
    # d/delta >= 187, u8 popcount >= 31 - d=192 clears both.
    ctx = hm.Context(hm.Parameters(192, 16, 1, 16), encrypt_seed=29, device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()

    rng = np.random.default_rng(5)
    readings = rng.integers(0, 256, size=(K, B))

    # --- each sensor encrypts its batch; server sees only ciphertexts -----
    c_sensors = [
        ctx.encrypt([int(v) for v in row], hm.U8, batch=True)
        for row in readings
    ]

    # --- server-side: one 8-operand homomorphic sum + per-reading popcount
    c_total = ctx.apply_n(HomomorphicSum, c_sensors)
    c_bits = ctx.apply1(HomomorphicPopCount, c_sensors[0])

    # --- data owner decrypts ----------------------------------------------
    total = [int(v) for v in ctx.decrypt(c_total)]
    bits = [int(v) for v in ctx.decrypt(c_bits)]

    assert total == [int(readings[:, j].sum()) & 0xFF for j in range(B)]
    assert bits == [bin(int(v)).count("1") for v in readings[0]]
    print(f"aggregated {K}x{B} encrypted readings; wrapping sums + "
          "popcounts decrypt correctly")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
