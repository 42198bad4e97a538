"""The u32 add's device breakdown, and the scaled configuration's encrypt
and decrypt against their bounds, on the card.

Counterpart of ``experiments/exp_add.py``:

* ``add``: one batched u32 homomorphic add of 2,048 pairs at
  ``Parameters(128, 128, 64, 128)`` (beyond the add's noise bound, so timed
  and not decrypted, as in the JAX experiment), as a compiled callable (one CUDA graph
  replay), its device time by kernel name (the carry chain's 31 dependent
  clmuls and the torch glue between them), against the summed bound of
  the products the circuit launches (recorded on the ``meta`` device);
* ``scaled``: encrypt and decrypt of 2^20 bits at ``Parameters(1024, 1024,
  64, 256)``, device time by kernel name, against the encrypt's bound
  (:func:`~homomorph_tpu_torch.utils.profiling.encrypt_sol`, K2's table
  lookups and the bytes), the tensor cores' count product (K3's design) and
  the decrypt's bound (:func:`~homomorph_tpu_torch.utils.profiling.
  decrypt_sol`).

    python -m homomorph_tpu_torch.experiments.exp_add [add|scaled|both]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from homomorph_tpu_torch.experiments.common import (
    Timer,
    peaks,
    products_sol,
    recorded_products,
)


def _top(ops: dict, n: int, log) -> list:
    tot = sum(ops.values())
    rows = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    for name, us in rows:
        log(f"  {us / 1e3:8.3f} ms  {100 * us / max(tot, 1e-9):5.1f}%  {name[:90]}")
    return [[name, us] for name, us in rows]


def add_sol(n_add: int, pk_degree: int, pk: dict) -> float:
    """Least seconds of the u32 add's products: the circuit run once on
    ``meta`` tensors (no device work) records every product it launches,
    each bounded as the card runs it (:func:`~homomorph_tpu_torch.
    experiments.common.products_sol`)."""
    import torch

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.models import circuits

    L = gf2.limbs_for(pk_degree)
    a = ht.Ciphered(torch.empty((n_add, 32, L), dtype=gf2.LIMB_DTYPE, device="meta"),
                    pk_degree, ht.U32)
    _, shapes = recorded_products(lambda: circuits.add(a, a))
    return products_sol(shapes, pk)


def profile_add(device=None, n_add: int = 2048, params=(128, 128, 64, 128), log=print) -> dict:
    """The u32 add's device time by kernel, and its bound."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.models import HomomorphicAddition
    from homomorph_tpu_torch.models.compiled import compile_op2

    dev = resolve(device)
    p = ht.Parameters(*params)
    ctx = ht.Context(p, encrypt_seed=1, device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    vals = list(range(n_add))
    ca = ctx.encrypt(vals, ht.U32, batch=True)
    cb = ctx.encrypt(vals[::-1], ht.U32, batch=True)
    # d/delta = 2 is below the add's bound (65): as in the JAX experiment,
    # the sums are timed, not decrypted
    add_step = compile_op2(HomomorphicAddition, ht.U32, p.pk_degree)
    secs, ops = Timer(dev).device_s(lambda: add_step(ca, cb))
    sol = add_sol(n_add, p.pk_degree, peaks(dev))
    log(f"\n== u32 add, B={n_add}, {p} on {dev} ==")
    if secs is None:
        log("device-busy total: not measured (no card)")
    else:
        log(f"device-busy total: {secs * 1e3:.3f} ms -> {n_add / secs:,.0f} adds/s")
    top = _top(ops, 18, log)
    log(f"  bound of the add's products: {sol * 1e3:.4f} ms ({n_add / sol:,.0f} adds/s)")
    return dict(pairs=n_add, device_s=secs, ops_us=top, clmul_bound_s=sol,
                bound_share=(sol / secs if secs else None), device=str(dev))


def profile_scaled(device=None, bits: int = 1 << 20, params=(1024, 1024, 64, 256),
                   log=print) -> dict:
    """Encrypt and decrypt at the scaled configuration: device time by
    kernel against their bounds, and the round trip checked."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.bench import encrypt_step
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.utils.profiling import decrypt_sol, encrypt_sol

    dev = resolve(device)
    sp = ht.Parameters(*params)
    sctx = ht.Context(sp, encrypt_seed=2, device=dev)
    sctx.generate_secret_key()
    sctx.generate_public_key()
    spk, ssk = sctx.get_public_key(), sctx.get_secret_key()
    sL = gf2.limbs_for(sp.pk_degree)
    senc = encrypt_step(spk, sL, bits, dev)
    key = hrng.threefry_key(0)
    ct = senc(key)
    w = ssk.decrypt_mask(sL)
    if int(gf2.decipher_bits(ct, w).sum()) != 0:  # zero plaintexts
        raise RuntimeError(f"the scaled encrypt/decrypt round trip is wrong on {dev}")

    pk = peaks(dev)
    D = gf2.bit_capacity(sL)
    enc_sol = encrypt_sol(bits, sp.tau, sL, pk)
    count_sol = 2 * bits * sp.tau * D / pk["int8_tc_ops"]
    dec_sol = decrypt_sol(bits, sL, pk)
    secs, ops = Timer(dev).device_s(lambda: senc(key))
    log(f"\n== scaled encrypt {sp}, B={bits} on {dev} ==")
    log("device-busy: " + ("not measured (no card)" if secs is None else
                           f"{secs * 1e3:.3f} ms -> {bits / secs:,.0f} bits/s"))
    top = _top(ops, 12, log)
    log(f"  bound (lookups and bytes): {enc_sol * 1e3:.4f} ms; tensor-core count product "
        f"2*B*tau*D = {2 * bits * sp.tau * D / 1e12:.3f} Tops -> {count_sol * 1e3:.4f} ms")
    dsecs, dops = Timer(dev).device_s(lambda: gf2.decipher_bits(ct, w))
    log("scaled decrypt device-busy: " + ("not measured (no card)" if dsecs is None else
                                          f"{dsecs * 1e3:.3f} ms -> {bits / dsecs:,.0f} bits/s")
        + f" (bound {dec_sol * 1e3:.4f} ms)")
    return dict(bits=bits, encrypt_device_s=secs, encrypt_ops_us=top, encrypt_bound_s=enc_sol,
                count_product_bound_s=count_sol, decrypt_device_s=dsecs,
                decrypt_ops_us=_top(dops, 8, lambda *a: None), decrypt_bound_s=dec_sol,
                device=str(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?", default="both", choices=("add", "scaled", "both"))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    out = {}
    if args.what in ("add", "both"):
        out["add"] = profile_add(args.device)
    if args.what in ("scaled", "both"):
        out["scaled"] = profile_scaled(args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
