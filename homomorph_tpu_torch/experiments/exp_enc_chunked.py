"""Restructurings of the plain count pipeline of encryption, on the card.

Counterpart of ``experiments/exp_enc_chunked.py``.  The plain pipeline
(the encrypt kernels' plain version in torch) unpacks the selection words
to 0/1, takes the counts as one bf16 matmul against the key's bit planes
(exact: tau = 128 <= 256), keeps each count's parity, packs the parities
into limbs and XORs the plaintext bit in.  Its ``[B, D]`` counts make a
round trip through device memory between the matmul and the pack.  The
variants restructure it:

* ``chunkD-<n>``: the key's D columns in blocks of ``n`` (whole limbs);
  each block's counts are packed at once;
* ``weights-pack``: the parities packed by a multiply with the weights
  ``2^k`` and a sum (the JAX experiment's ``vpu-pack``) instead of OR-ing
  shifted bits;
* ``mapB-<seg>``: the batch in segments of ``seg`` rows, so that one
  segment's counts are live at a time (the JAX experiment's ``lax.map``);
* ``mapB+weights-32768``: both.

Every variant is held bit for bit against the baseline, and the baseline
against the encrypt kernel (K2) on the same words; then each is timed:
wall time over back-to-back calls and device time from the profiler.

    python -m homomorph_tpu_torch.experiments.exp_enc_chunked [--bits N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from homomorph_tpu_torch.experiments.common import Timer, context

PARAMS = (128, 128, 64, 128)


def _weights_pack(counts: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Parities packed by weights: ``sum_k parity_k * 2^k`` in int64 per
    limb, then the low 32 bits as an int32 bit pattern."""
    from homomorph_tpu_torch.gf2 import poly as gf2

    parity = counts.to(torch.int64) & 1
    g = parity.reshape(*parity.shape[:-1], -1, 32)
    w = torch.ones(32, dtype=torch.int64, device=counts.device) << torch.arange(
        32, device=counts.device)
    words = (g * w).sum(dim=-1)
    return gf2.fit_limbs((words - ((words >> 31) << 32)).to(gf2.LIMB_DTYPE), out_limbs)


def variants(selw: torch.Tensor, planes: torch.Tensor, plain: torch.Tensor, tau: int,
             L: int) -> dict:
    """name -> step(): the baseline and its restructurings on the words
    ``selw`` [B, W], the planes [D, Kp], the plaintext bits ``plain`` [B]."""
    from homomorph_tpu_torch.gf2 import poly as gf2

    B = selw.shape[0]
    D = planes.shape[0]
    pk_bits = planes[:, :tau].T.to(torch.bfloat16)  # [tau, D]

    def sel_of(words):
        return gf2.unpack_bits(words, tau, dtype=torch.bfloat16)

    def finish(limbs, bits):
        return gf2.xor_const_bit(gf2.fit_limbs(limbs, L), bits)

    def baseline():
        return finish(gf2.parity_pack(sel_of(selw) @ pk_bits, L), plain)

    def chunk_d(cols):
        def step():
            s = sel_of(selw)
            parts = [gf2.parity_pack(s @ pk_bits[:, lo:min(lo + cols, D)],
                                     (min(lo + cols, D) - lo) // 32)
                     for lo in range(0, D, cols)]
            return finish(torch.cat(parts, dim=-1), plain)
        return step

    def weights():
        return finish(_weights_pack(sel_of(selw) @ pk_bits, L), plain)

    def map_b(seg, pack):
        def step():
            out = [finish(pack(sel_of(selw[r:r + seg]) @ pk_bits, L), plain[r:r + seg])
                   for r in range(0, B, seg)]
            return torch.cat(out)
        return step

    out = {"baseline": baseline}
    for cols in (96, 128):
        out[f"chunkD-{cols}"] = chunk_d(cols)
    out["weights-pack"] = weights
    for seg in (1 << 13, 1 << 15, 1 << 17):
        out[f"mapB-{seg}"] = map_b(seg, gf2.parity_pack)
    out["mapB+weights-32768"] = map_b(1 << 15, _weights_pack)
    return out


def run(bits: int = 1 << 21, params=PARAMS, device=None, log=print) -> dict:
    """Each variant against the baseline and the baseline against K2, then
    timed; returns ``{name: {mismatches, wall_s, device_s}}`` and K2's row."""
    from homomorph_tpu_torch import prng
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.device import resolve
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import poly as gf2

    dev = resolve(device)
    ctx = context(params, 0, dev)
    pk = ctx.get_public_key()
    tau = ctx.parameters.tau
    L = gf2.limbs_for(ctx.parameters.pk_degree)
    selw = prng.random_bits(hrng.threefry_key(1), (bits, -(-tau // 32)), dev)
    plain = torch.zeros(bits, dtype=gf2.LIMB_DTYPE, device=dev)
    steps = variants(selw, pk.planes(), plain, tau, L)
    want = steps["baseline"]()

    def k2():
        return enc.encrypt_words_table(selw, pk.limbs, plain, L)

    rows = {"K2": dict(mismatches=int((k2() != want).sum()))}
    log(f"\nB={bits}, D={pk.planes().shape[0]}, L={L} on {dev}")
    t = Timer(dev)
    for name, step in steps.items():
        rows[name] = dict(mismatches=0 if name == "baseline" else int((step() != want).sum()))
    for name, step in [("K2", k2)] + list(steps.items()):
        r = rows[name]
        if r["mismatches"]:
            log(f"{name:20s}: MISMATCH ({r['mismatches']} limbs differ from the baseline)")
            continue
        r["wall_s"] = t.throughput(step, 10, warmup=3, windows=1)
        r["device_s"], _ = t.device_s(step)
        dv = r["device_s"]
        log(f"{name:20s}: wall {r['wall_s'] * 1e3:8.3f} ms {bits / r['wall_s'] / 1e6:9.1f} M/s"
            f" | device " + ("not measured" if dv is None else
                             f"{dv * 1e3:8.3f} ms {bits / dv / 1e6:9.1f} M/s"))
    return dict(bits=bits, L=L, device=str(dev), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=1 << 21)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    out = run(args.bits, device=args.device)
    print(json.dumps(out))
    return 1 if any(r["mismatches"] for r in out["rows"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
