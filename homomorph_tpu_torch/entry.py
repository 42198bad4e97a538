"""Entry points of the port: the flagship step and the dry run on a grid.

Counterpart of the repo's ``__graft_entry__.py``:

* :func:`entry` - the flagship step on the card, with example args: encrypt
  two batches of bits from their selections (the encrypt kernel, K2, or K3
  under ``HOMOMORPH_TPU_TORCH_ENC_IMPL=pallas_v1``), an XOR and an AND gate
  layer (the AND is a clmul, K1) and the mask decrypt.
* :func:`dryrun_multichip` - one step of the sharded pipeline on a grid of
  ``n`` places: sharded encrypt (X1 partials combined by XOR exchanges over
  the tau axis), the add on the data-parallel rows, sharded decrypt;
  the limb-sharded clmul, the scaled degree class, a sharded ``Context``,
  and a u8 product and equality under the grid.

A grid of places is the port's mesh (:mod:`homomorph_tpu_torch.parallel`):
in one process every place lies on this process's device, the card or the
CPU; across cards the package runs one process per card
(:mod:`homomorph_tpu_torch.parallel.distributed`).  The JAX module's
virtual-device setup has no counterpart: ``dryrun_multichip(n)`` builds
``n`` places on the one device.

    python -m homomorph_tpu_torch.entry [--devices N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _encrypt_sel(sel: torch.Tensor, pk, bits: torch.Tensor, L: int) -> torch.Tensor:
    """Ciphertext limbs [..., L] of ``bits`` [...] from 0/1 selections
    [..., tau]: the selections packed to words, then the encrypt kernel."""
    from .gf2 import poly as gf2
    from .gf2.encrypt_kernel import encrypt_bits_fused

    selw = gf2.pack_bits(sel.reshape(-1, sel.shape[-1]))
    out = encrypt_bits_fused(selw, pk.limbs, bits.reshape(-1).to(gf2.LIMB_DTYPE), L,
                             planes=pk.planes)
    return out.reshape(*bits.shape, L)


def entry(device=None):
    """Return ``(fn, example_args)``: the flagship step and its inputs on
    ``device`` (``None`` means the CUDA card).

    The step encrypts two [B, n] batches of plaintext bits from their
    [B, n, tau] selections, applies a homomorphic XOR and AND gate layer,
    and decrypts both with the reduction-mask parity.  Its outputs are
    checked once here: the gates must decrypt to ``a ^ b`` and ``a & b``
    (noise degree <= 2 * (delta + 1) = 34 < d = 128)."""
    import homomorph_tpu_torch as ht
    from .device import resolve
    from .gf2 import kernels as gf2k
    from .gf2 import poly as gf2

    dev = resolve(device)
    params = ht.Parameters(128, 128, 16, 128)
    ctx = ht.Context(params, source=ht.ThreefrySource(0), device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    pk, sk = ctx.get_public_key(), ctx.get_secret_key()

    B, n = 256, 32
    L = gf2.limbs_for(params.pk_degree)
    w = sk.decrypt_mask(2 * L)

    def step(sel_a, sel_b, bits_a, bits_b):
        ca = _encrypt_sel(sel_a, pk, bits_a, L)
        cb = _encrypt_sel(sel_b, pk, bits_b, L)
        cx = ca ^ cb  # homomorphic XOR
        cm = gf2k.clmul(ca, cb)  # homomorphic AND (degree doubles)
        out_x = gf2.decipher_bits(gf2.pad_limbs(cx, 2 * L), w)
        out_m = gf2.decipher_bits(cm, w)
        return out_x, out_m

    rng = np.random.default_rng(0)
    sel_a = rng.integers(0, 2, size=(B, n, params.tau)).astype(np.uint8)
    sel_b = rng.integers(0, 2, size=(B, n, params.tau)).astype(np.uint8)
    bits_a = rng.integers(0, 2, size=(B, n)).astype(np.uint32)
    bits_b = rng.integers(0, 2, size=(B, n)).astype(np.uint32)
    example_args = (
        torch.from_numpy(sel_a).to(dev),
        torch.from_numpy(sel_b).to(dev),
        torch.from_numpy(bits_a.astype(np.int32)).to(dev),
        torch.from_numpy(bits_b.astype(np.int32)).to(dev),
    )
    out_x, out_m = step(*example_args)
    _check(np.array_equal(out_x.cpu().numpy(), bits_a ^ bits_b), "entry(): XOR decrypts wrong")
    _check(np.array_equal(out_m.cpu().numpy(), bits_a & bits_b), "entry(): AND decrypts wrong")
    return step, example_args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of the full sharded pipeline on a grid of ``n_devices``
    places on ``device`` (``None`` means the CUDA card), each part checked
    by decrypt; raises on any mismatch.  Returns what it checked: the grid,
    and the limb-sharded products the dispatcher took."""
    import homomorph_tpu_torch as ht
    from .device import resolve
    from .gf2 import kernels as gf2k
    from .gf2 import poly as gf2
    from .models import circuits
    from .parallel import Mesh, bulk, limbmul, make_mesh

    dev = resolve(device)
    n_tau = 2 if n_devices % 2 == 0 else 1
    cfg = make_mesh(n_devices // n_tau, n_tau, [dev] * n_devices)

    # u8 add exact bound: d/delta >= 17; d = 64 leaves a margin
    params = ht.Parameters(64, 8, 1, 8)
    ctx = ht.Context(params, source=ht.ThreefrySource(0), device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    pk, sk = ctx.get_public_key(), ctx.get_secret_key()
    B, n = 4 * n_devices, 8
    L = gf2.limbs_for(params.pk_degree)

    rng = np.random.default_rng(0)
    xs = rng.integers(0, 128, size=B).astype(np.uint8)
    ys = rng.integers(0, 127, size=B).astype(np.uint8)
    bits_a = np.unpackbits(xs[:, None], axis=1, bitorder="little")
    bits_b = np.unpackbits(ys[:, None], axis=1, bitorder="little")
    sel_a = rng.integers(0, 2, size=(B, n, params.tau)).astype(np.uint8)
    sel_b = rng.integers(0, 2, size=(B, n, params.tau)).astype(np.uint8)

    # sharded encrypt: data-parallel rows, tau-sharded key, XOR-combined partials
    ca = bulk.sharded_encrypt_bits(cfg, sel_a, pk.limbs, bits_a, L)
    cb = bulk.sharded_encrypt_bits(cfg, sel_b, pk.limbs, bits_b, L)
    dense = _encrypt_sel(torch.from_numpy(sel_a).to(dev), pk,
                         torch.from_numpy(bits_a.astype(np.int32)).to(dev), L)
    _check(torch.equal(ca, dense), "sharded encrypt: limbs differ from the dense encrypt's")

    # the homomorphic add on the data-parallel rows
    bound = params.pk_degree
    sum_limbs = circuits.add(ht.Ciphered(ca, bound, ht.U8), ht.Ciphered(cb, bound, ht.U8)).limbs

    # sharded decrypt
    w = sk.decrypt_mask(sum_limbs.shape[-1])
    bits_out = bulk.sharded_decrypt_bits(cfg, sum_limbs, w)
    got = np.packbits(bits_out.cpu().numpy().astype(np.uint8), axis=1,
                      bitorder="little").reshape(-1)
    want = (xs.astype(np.uint16) + ys.astype(np.uint16)).astype(np.uint8)
    _check(np.array_equal(got, want), f"sharded pipeline mismatch: {got[:8]} vs {want[:8]}")

    # the limb-sharded clmul over the same places, direct and through the
    # dispatcher (its block threshold lowered so that the small shapes qualify)
    lmesh = Mesh([dev] * n_devices, (limbmul.LIMB_AXIS,))
    La, Lb = 32 * n_devices, 5
    A = gf2.from_numpy(rng.integers(0, 1 << 32, size=(4, La), dtype=np.uint64).astype(np.uint32),
                       dev)
    Bq = gf2.from_numpy(rng.integers(0, 1 << 32, size=(4, Lb), dtype=np.uint64).astype(np.uint32),
                        dev)
    want_p = gf2k.clmul(A, Bq)
    _check(torch.equal(limbmul.sharded_clmul(A, Bq, lmesh), want_p),
           "limb-sharded clmul mismatch")
    saved, taken = limbmul._SHARD_MIN_BLOCK, limbmul.maybe_sharded_clmul.taken
    limbmul._SHARD_MIN_BLOCK = 8
    try:
        with limbmul.use_limb_mesh(lmesh):
            got_d = gf2k.clmul(A, Bq)
    finally:
        limbmul._SHARD_MIN_BLOCK = saved
    taken = limbmul.maybe_sharded_clmul.taken - taken
    _check(torch.equal(got_d, want_p) and (taken == 1 or n_devices == 1),
           f"dispatcher-routed limb-sharded clmul mismatch ({taken} products routed)")

    # the scaled degree class: d = dp = 1024, tau = 256
    sp = ht.Parameters(1024, 1024, 64, 256)
    sctx = ht.Context(sp, source=ht.ThreefrySource(7), device=dev)
    sctx.generate_secret_key()
    sctx.generate_public_key()
    spk, ssk = sctx.get_public_key(), sctx.get_secret_key()
    sL = gf2.limbs_for(sp.pk_degree)
    sB = 2 * n_devices
    s_bits = rng.integers(0, 2, size=(sB, 8)).astype(np.uint32)
    s_sel = rng.integers(0, 2, size=(sB, 8, sp.tau)).astype(np.uint8)
    s_ct = bulk.sharded_encrypt_bits(cfg, s_sel, spk.limbs, s_bits, sL)
    s_x = bulk.sharded_gate_xor(cfg, s_ct, s_ct ^ torch.zeros_like(s_ct))
    s_out = bulk.sharded_decrypt_bits(cfg, s_x ^ s_ct, ssk.decrypt_mask(sL))
    # c ^ c ^ c decrypts to the plaintext bits
    _check(np.array_equal(s_out.cpu().numpy(), s_bits),
           "scaled-config sharded encrypt/decrypt mismatch")

    # the sharded Context: the scale-out API
    dctx = ht.Context(params, sharding=cfg, encrypt_seed=17, device=dev)
    dctx.set_secret_key(sk)
    dctx.set_public_key(pk)
    vals = [int(v) for v in rng.integers(0, 200, size=2 * n_devices)]
    dc = dctx.encrypt(vals, ht.U8, batch=True)
    _check([int(v) for v in dctx.decrypt(dc)] == vals, "sharded Context mismatch")

    # a u8 product and equality on the grid's rows (u8 product bound 65 <= 160)
    mctx = ht.Context(ht.Parameters(160, 8, 1, 8), sharding=cfg, encrypt_seed=23, device=dev)
    mctx.generate_secret_key()
    mctx.generate_public_key()
    mx = [int(v) for v in rng.integers(0, 16, size=2 * n_devices)]
    my = [int(v) for v in rng.integers(0, 16, size=2 * n_devices)]
    ma = mctx.encrypt(mx, ht.U8, batch=True)
    mb = mctx.encrypt(my, ht.U8, batch=True)
    got_m = [int(v) for v in mctx.decrypt(circuits.mul_unsigned(ma, mb))]
    _check(got_m == [(x * y) & 0xFF for x, y in zip(mx, my)], "sharded u8 product mismatch")
    # x, y in [0, 16) hold equal and unequal pairs: both polarities
    got_eq = [bool(v) for v in mctx.decrypt(circuits.eq(ma, mb))]
    _check(got_eq == [x == y for x, y in zip(mx, my)], "sharded eq mismatch")
    return dict(grid=dict(cfg.mesh.shape), places=n_devices, device=str(dev),
                limb_products_routed=taken)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4, help="places of the dry run's grid")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry ok:", [tuple(o.shape) for o in out])
    print("dryrun_multichip ok:", dryrun_multichip(args.devices, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
