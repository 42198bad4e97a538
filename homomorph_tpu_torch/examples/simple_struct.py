"""Custom homomorphic operation on a user struct.

Python analogue of the reference's examples/simple_struct.rs: a ``Vec3`` of
three u16 coordinates, encrypted as 48 flat bit-lanes (declaration order),
with a custom field-wise homomorphic addition defined by splitting the lane
slice, applying the shipped adder per field, and recombining.

Port of ``examples/simple_struct.py``.
"""

import dataclasses

import numpy as np

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import circuits


@dataclasses.dataclass
class Vec3:
    x: np.uint16
    y: np.uint16
    z: np.uint16


Vec3Desc = hm.struct_of(Vec3)


class Vec3Add(hm.HomomorphicOperation2):
    """Field-wise addition.

    d/delta on cipher must be at least 21 (the adder's boolean degree).
    """

    MIN_D_OVER_DELTA = 21

    @staticmethod
    def unsafe_apply(a: hm.Ciphered, b: hm.Ciphered) -> hm.Ciphered:
        out = []
        for name, (off, width) in Vec3Desc.field_bit_offsets().items():
            ax = hm.Ciphered.new_from_raw(
                [a[i] for i in range(off, off + width)], hm.U16
            )
            bx = hm.Ciphered.new_from_raw(
                [b[i] for i in range(off, off + width)], hm.U16
            )
            out.extend(circuits.add(ax, bx).bits())
        return hm.Ciphered.new_from_raw(out, a.desc)


def main(device=None) -> None:
    params = hm.Parameters(64, 32, 1, 32)
    ctx = hm.Context(params, device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()

    a = ctx.encrypt(Vec3(np.uint16(1), np.uint16(2), np.uint16(3)), Vec3Desc)
    b = ctx.encrypt(Vec3(np.uint16(4), np.uint16(5), np.uint16(6)), Vec3Desc)
    c = ctx.apply2(Vec3Add, a, b)
    d = ctx.decrypt(c)

    assert (d.x, d.y, d.z) == (5, 7, 9), d
    print(f"Vec3(1,2,3) + Vec3(4,5,6) = Vec3({d.x},{d.y},{d.z})  [homomorphic]")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
