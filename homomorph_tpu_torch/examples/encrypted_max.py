"""Encrypted max: compare and select without decrypting.

The extension ops beyond the reference's set: the unsigned borrow-chain
comparison (``circuits.gt``) feeding the homomorphic mux
(``circuits.select``) - ``max(a, b)`` computed entirely on ciphertexts,
ending in asserts like the reference's examples (examples/simple_struct.rs).

Port of ``examples/encrypted_max.py``.
"""

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import circuits


def main(device=None) -> None:
    # gt's borrow chain shares the adder's requirement: d/delta >= 21
    ctx = hm.Context(hm.Parameters(d=64, dp=16, delta=1, tau=16), device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    sk = ctx.get_secret_key()

    xs = [12, 200, 7, 99]
    ys = [40, 13, 7, 255]
    a = ctx.encrypt(xs, hm.U8, batch=True)
    b = ctx.encrypt(ys, hm.U8, batch=True)

    is_gt = circuits.gt(a, b)            # Ciphered[Bool]
    mx = circuits.select(is_gt[0], a, b)  # gt ? a : b

    got = [int(v) for v in mx.decipher(sk)]
    want = [max(x, y) for x, y in zip(xs, ys)]
    assert got == want, (got, want)
    print(f"max({xs}, {ys}) = {got}  [homomorphic]")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
