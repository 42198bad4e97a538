"""Mixed-field-width struct with a custom homomorphic addition.

Python analogue of the reference's examples/unbalanced_struct.rs: field
ORDER in the ciphered layout follows the declaration, independent of any
in-memory layout optimization - the serialized wire format is the
contract.

Port of ``examples/unbalanced_struct.py``.
"""

import dataclasses

import numpy as np

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import circuits


@dataclasses.dataclass
class Unbalanced:
    x: np.uint8
    y: np.uint64
    z: np.uint8


UnbalancedDesc = hm.struct_of(Unbalanced)
FIELD_DESCS = {"x": hm.U8, "y": hm.U64, "z": hm.U8}


class UnbalancedAdd(hm.HomomorphicOperation2):
    """d/delta on cipher must be at least 21."""

    MIN_D_OVER_DELTA = 21

    @staticmethod
    def unsafe_apply(a: hm.Ciphered, b: hm.Ciphered) -> hm.Ciphered:
        out = []
        for name, (off, width) in UnbalancedDesc.field_bit_offsets().items():
            d = FIELD_DESCS[name]
            ax = hm.Ciphered.new_from_raw([a[i] for i in range(off, off + width)], d)
            bx = hm.Ciphered.new_from_raw([b[i] for i in range(off, off + width)], d)
            out.extend(circuits.add(ax, bx).bits())
        return hm.Ciphered.new_from_raw(out, a.desc)


def main(device=None) -> None:
    params = hm.Parameters(128, 32, 1, 32)
    ctx = hm.Context(params, device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()

    a = ctx.encrypt(Unbalanced(np.uint8(1), np.uint64(2), np.uint8(3)), UnbalancedDesc)
    b = ctx.encrypt(Unbalanced(np.uint8(4), np.uint64(5), np.uint8(6)), UnbalancedDesc)
    # 80 lanes (8+64+8), NOT 8*sizeof with padding
    assert len(a) == 80
    c = ctx.apply2(UnbalancedAdd, a, b)
    d = ctx.decrypt(c)

    assert (d.x, d.y, d.z) == (5, 7, 9), d
    print(f"Unbalanced(1,2,3) + Unbalanced(4,5,6) = ({d.x},{d.y},{d.z})  [homomorphic]")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
