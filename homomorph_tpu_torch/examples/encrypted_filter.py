"""Encrypted filtering: compare a batch of ciphertexts against an
encrypted threshold without decrypting anything.

The server holds ONLY ciphertexts (records and threshold) and the public
key; it computes a per-record ``record < threshold`` mask homomorphically
(the log-depth tree comparator) plus a clamped copy of every record, all
as batched device work.  Only the data owner, holding the secret key, can
read the mask and the values.

Port of ``examples/encrypted_filter.py``.
"""

import numpy as np

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import HomomorphicLessThan, circuits


def main(device=None) -> None:
    # u8 comparisons need d/delta >= 19 (tree comparator, models/noise.py)
    ctx = hm.Context(hm.Parameters(64, 16, 1, 16), encrypt_seed=13, device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()

    rng = np.random.default_rng(42)
    records = [int(v) for v in rng.integers(0, 256, size=64)]
    threshold = 97

    # --- data owner encrypts; server sees only ciphertexts ----------------
    c_records = ctx.encrypt(records, hm.U8, batch=True)
    c_thresh = ctx.encrypt([threshold] * len(records), hm.U8, batch=True)

    # --- server-side homomorphic compute ----------------------------------
    c_mask = ctx.apply2(HomomorphicLessThan, c_records, c_thresh)
    lo = hm.Ciphered.trivial([16] * len(records), hm.U8, batch=True, device=ctx.device)
    hi = hm.Ciphered.trivial([200] * len(records), hm.U8, batch=True, device=ctx.device)
    c_clamped = circuits.clamp(c_records, lo, hi)

    # --- data owner decrypts ----------------------------------------------
    mask = [bool(v) for v in ctx.decrypt(c_mask)]
    clamped = [int(v) for v in ctx.decrypt(c_clamped)]

    assert mask == [r < threshold for r in records]
    assert clamped == [min(max(r, 16), 200) for r in records]
    n_hits = sum(mask)
    assert n_hits == sum(r < threshold for r in records)
    print(f"encrypted_filter: OK ({n_hits}/{len(records)} records below threshold)")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
