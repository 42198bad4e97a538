"""Analytic scaling model of the three parallel axes across cards.

Counterpart of ``experiments/exp_scaling_model.py``.  It combines

* single-card device-busy rates measured by the port's bench (its JSON
  line, ``python -m homomorph_tpu_torch.bench > bench.json``; no default:
  a rate the bench did not measure is refused),
* the bytes each axis exchanges, from :mod:`homomorph_tpu_torch.parallel`:
  the tau axis's XOR combine hands each place's whole partial, ``4 L``
  bytes a bit, over ``log2 n`` butterfly rounds (a ring of ``n - 1`` hops
  for other ``n``); the limb axis moves
  :func:`~homomorph_tpu_torch.parallel.limbmul.comm_bytes_per_call` a
  product,
* and a link bandwidth given as an argument with the source of its figure
  (there is no default and no TPU figure),

with compute and communication serialised (no overlap):

    T_n = T_1 / n + bytes_per_place(n) / bandwidth,   eff = T_1 / (n T_n)

The limb axis's compute is the product's bound as the card runs it (K1's
comb at the Karatsuba route's leaf shape, :func:`~homomorph_tpu_torch.
experiments.common.products_sol`), not a measurement.  The output names
where each input came from.

    python -m homomorph_tpu_torch.experiments.exp_scaling_model --bench bench.json
        --link-gbps 450 --link-source "..." [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

NS = (2, 4, 8)
#: limbs of a ciphertext bit at the bench's two bulk configurations
L128, L1024 = 9, 65
#: the limb-sharded products modelled: (label, B, La, Lb)
LIMB_SHAPES = (("limb clmul, scaled add step", 4096, 16384, 129),
               ("limb clmul, u32 product's widest (d = 5888)", 8, 262144, 16384))


def tau_bytes_per_bit(n: int, L: int) -> float:
    """Bytes a place sends a bit in the tau axis's XOR combine of ``n``
    places (:func:`homomorph_tpu_torch.parallel.bulk._xor_combine`)."""
    rounds = math.log2(n) if n & (n - 1) == 0 else n - 1
    return rounds * 4 * L


def eff_tau(n: int, per_bit_s: float, L: int, bw: float) -> float:
    t_n = per_bit_s / n + tau_bytes_per_bit(n, L) / bw
    return per_bit_s / (n * t_n)


def eff_limb(n: int, B: int, La: int, Lb: int, bw: float, peaks: dict) -> float:
    """One product's limb axis sharded over ``n`` places: its compute split
    ``n`` ways, and one hop of the small operand's spill a place
    (:func:`~homomorph_tpu_torch.parallel.limbmul.comm_bytes_per_call`
    over the ``n - 1`` hops, which run at once)."""
    from homomorph_tpu_torch.experiments.common import products_sol
    from homomorph_tpu_torch.parallel.limbmul import comm_bytes_per_call

    t1 = products_sol([(B, La, Lb)], peaks)
    t_comm = comm_bytes_per_call(B, Lb, n) / (n - 1) / bw
    return t1 / (n * (t1 / n + t_comm))


def model(bench: dict, link_bytes_per_s: float, link_source: str, peaks=None) -> dict:
    """The tables, from the bench's result and the link's bandwidth."""
    from homomorph_tpu_torch.experiments.common import H100_MHZ, H100_SMS
    from homomorph_tpu_torch.utils.profiling import chip_peaks

    ex = bench["extras"]
    need = ("encrypt_device_busy_bits_per_s", "scaled_1024_encrypt_device_busy_bits_per_s")
    missing = [k for k in need if ex.get(k) is None]
    if missing:
        raise ValueError(f"the bench result lacks {missing}: run the full bench on the card")
    peaks = peaks or chip_peaks(sms=H100_SMS, mhz=H100_MHZ)
    bw = link_bytes_per_s
    rows = [("data axis, bulk encrypt (no exchange)", {str(n): 1.0 for n in NS})]
    for label, rate, L in (("tau axis, encrypt d=dp=128", ex[need[0]], L128),
                           ("tau axis, encrypt d=dp=1024", ex[need[1]], L1024)):
        rows.append((label, {str(n): eff_tau(n, 1 / rate, L, bw) for n in NS}))
    for label, B, La, Lb in LIMB_SHAPES:
        rows.append((f"{label} (B={B}, La={La}, Lb={Lb})",
                     {str(n): eff_limb(n, B, La, Lb, bw, peaks) for n in NS}))
    return dict(
        link=dict(bytes_per_s=bw, source=link_source),
        single_card=dict(encrypt_bits_per_s=ex[need[0]], scaled_encrypt_bits_per_s=ex[need[1]],
                         source=f"the port's bench on {ex.get('device')}, device-busy rates"),
        limb_compute="the product's bound (experiments.common.products_sol), not measured",
        tables=[dict(config=label, eff=eff) for label, eff in rows],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", required=True, help="the bench's JSON line, in a file")
    ap.add_argument("--link-gbps", type=float, required=True,
                    help="one-way bytes/s of the link between two cards, in GB/s")
    ap.add_argument("--link-source", required=True, help="where the link's figure comes from")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    with open(args.bench) as f:
        bench = json.loads([ln for ln in f.read().splitlines() if ln.strip()][-1])
    out = model(bench, args.link_gbps * 1e9, args.link_source)
    print(f"link: {args.link_gbps} GB/s one way ({args.link_source})")
    print(f"single card: {out['single_card']['source']}")
    print(f"{'axis / configuration':<72}" + "".join(f"  n={n}" for n in NS))
    for row in out["tables"]:
        print(f"{row['config']:<72}" + "".join(f"  {row['eff'][str(n)]:4.2f}" for n in NS))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
