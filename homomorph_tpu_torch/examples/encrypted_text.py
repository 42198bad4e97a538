"""Variable-length plaintexts: encrypted strings, vectors, options, enums.

The reference's ``Ciphered<T>`` covers any bincode-encodable ``T``
(reference: src/cipher.rs:125-259); this example exercises the
variable-length classes end to end - a ``String``, a ``Vec<u16>``, an
``Option<u32>`` in both states, and a C-like enum - plus a homomorphic
computation on a varlen value: equality-testing two encrypted enum tags
without decrypting them.

Port of ``examples/encrypted_text.py``.
"""

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import HomomorphicEquality


def main(device=None) -> None:
    # enum tags are u32 (32 lanes), so equality needs d/delta >= 65:
    # delta=1, d=128.
    ctx = hm.Context(hm.Parameters(128, 16, 1, 16), device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()

    # -- String ------------------------------------------------------------
    msg = "attack at dawn"
    c_msg = ctx.encrypt(msg, hm.Str)
    assert len(c_msg) == (8 + len(msg.encode())) * 8  # u64 prefix + utf-8
    assert ctx.decrypt(c_msg) == msg

    # -- Vec<u16> ----------------------------------------------------------
    readings = [1000, 2000, 65535]
    c_vec = ctx.encrypt(readings, hm.vec_of(hm.U16))
    assert ctx.decrypt(c_vec) == readings

    # -- Option<u32> -------------------------------------------------------
    maybe = hm.option_of(hm.U32)
    assert ctx.decrypt(ctx.encrypt(123456, maybe)) == 123456
    assert ctx.decrypt(ctx.encrypt(None, maybe)) is None

    # -- C-like enum + homomorphic comparison of tags ----------------------
    Command = hm.enum_of("Hold", "Advance", "Retreat", name="Command")
    order = ctx.encrypt("Advance", Command)
    assert ctx.decrypt(order) == "Advance"

    # The enum wire format is a fixed u32 discriminant, so two encrypted
    # commands can be compared homomorphically: reinterpret the 32 tag
    # lanes as a u32 and run the equality circuit - the server learns
    # nothing about either command, only the encrypted verdict.
    probe = ctx.encrypt("Advance", Command)
    is_advance = ctx.apply2(
        HomomorphicEquality, order.reinterpret(hm.U32), probe.reinterpret(hm.U32)
    )
    assert bool(ctx.decrypt(is_advance)) is True

    probe2 = ctx.encrypt("Retreat", Command)
    is_retreat = ctx.apply2(
        HomomorphicEquality, order.reinterpret(hm.U32), probe2.reinterpret(hm.U32)
    )
    assert bool(ctx.decrypt(is_retreat)) is False

    # -- decode-bomb cap is live (src/cipher.rs:15) --------------------------
    try:
        hm.vec_of(hm.U8).decode((1 << 40).to_bytes(8, "little"))
        raise AssertionError("decode bomb not caught")
    except hm.DecodeTooLargeError:
        pass

    print("encrypted_text: all assertions passed")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
