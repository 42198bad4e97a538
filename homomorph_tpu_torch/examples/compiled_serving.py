"""Serving with precompiled pipelines: whole encrypt->op->decrypt chains
as ONE CUDA graph replay per shape.

The eager circuit API issues its kernels gate by gate from Python; for
production serving, ``models.compiled`` captures a pipeline per input shape
so that a repeated call is one graph replay (on CPU tensors it runs
eagerly).  The reference has no such layer: every op is a direct call
(src/context.rs:496-546).

Port of ``examples/compiled_serving.py``.
"""

import numpy as np

import homomorph_tpu_torch as hm
from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicLessThan
from homomorph_tpu_torch.models.compiled import compile_op2, compile_roundtrip


def main(device=None) -> None:
    ctx = hm.Context(hm.Parameters(128, 16, 1, 16), encrypt_seed=7, device=device)
    ctx.generate_secret_key()
    ctx.generate_public_key()

    # --- compiled binary op: ciphertexts in, ciphertext out ---------------
    add = compile_op2(HomomorphicAddition, hm.U8, ctx.parameters.pk_degree)
    a = ctx.encrypt([10, 250], hm.U8, batch=True)
    b = ctx.encrypt([32, 10], hm.U8, batch=True)
    s = add(a, b)  # one replay, graphs cached per shape
    assert [int(v) for v in ctx.decrypt(s)] == [42, (250 + 10) & 0xFF]

    # comparison results come back in the slim Ciphered[Bool] layout
    less = compile_op2(HomomorphicLessThan, hm.U8, ctx.parameters.pk_degree)
    r = less(a, b)
    assert r.zero_lanes == 7 and len(r) == 8
    assert [bool(v) for v in ctx.decrypt(r)] == [True, False]

    # --- whole pipeline: encrypt -> op -> decrypt in ONE graph ------------
    pipe = compile_roundtrip(ctx, HomomorphicAddition, hm.U8)
    xs = np.array([[6], [200]], dtype=np.uint8)
    ys = np.array([[7], [99]], dtype=np.uint8)
    bits_x = np.unpackbits(xs, axis=1, bitorder="little").astype(np.uint32)
    bits_y = np.unpackbits(ys, axis=1, bitorder="little").astype(np.uint32)
    out_bits = pipe(hm.rng.threefry_key(0), bits_x, bits_y).cpu().numpy()
    out = np.packbits(out_bits.astype(np.uint8), axis=1, bitorder="little")
    assert list(out[:, 0]) == [13, (200 + 99) & 0xFF]

    # --- key lifecycle ----------------------------------------------------
    ctx.zeroize()  # scrub sk + caches; context reusable after fresh keygen
    assert ctx.get_secret_key() is None and ctx.get_public_key() is None

    print("compiled_serving: OK")


if __name__ == "__main__":
    from . import run

    run(main, __doc__)
