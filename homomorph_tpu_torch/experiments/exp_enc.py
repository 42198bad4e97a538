"""The encrypt speed experiment on the card: K2, K3 and X1 side by side.

Counterpart of ``experiments/exp_enc.py``.  At ``Parameters(128, 128, 64,
128)`` and 2^21 bits it draws the selection words with the threefry kernel
(:func:`homomorph_tpu_torch.prng.random_bits`), encrypts them with

* ``pallas_v2``: K2, :func:`~homomorph_tpu_torch.gf2.encrypt_kernel.
  encrypt_words_table` (the JAX experiment's in-kernel-unpack baseline;
  here table lookups in shared memory);
* ``pallas_v1``: K3, :func:`~homomorph_tpu_torch.gf2.encrypt_kernel.
  encrypt_words_mma` (words unpacked in the kernel, as the JAX
  experiment's ``pallas_v3w``);
* ``pallas_v3``: X1, :func:`~homomorph_tpu_torch.gf2.encrypt_kernel.
  encrypt_sel_mma`, after unpacking the words to int8 with torch ops (the
  JAX experiment unpacks with XLA, ``exp_enc.py:168``);

holds K3 and X1 against K2 bit for bit (``exp_enc.py:171-176``), and times
each step (draw, unpack where needed, encrypt) with CUDA events.  The JAX
experiment's ``xla`` and ``int8`` rows are XLA compositions whose
counterpart is the kernels' plain version, so they have no row here.

    python -m homomorph_tpu_torch.experiments.exp_enc [--bits N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import homomorph_tpu_torch as ht
from homomorph_tpu_torch import prng
from homomorph_tpu_torch import rng as _rng
from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
from homomorph_tpu_torch.gf2 import poly as gf2

PARAMS = (128, 128, 64, 128)


def _step_ms(fn, device, n=12, warmup=3) -> float | None:
    """Milliseconds per call of ``fn`` over ``n`` calls after ``warmup``,
    by CUDA events on the card; ``None`` on the CPU (no device time)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def run(bits: int = 1 << 21, device=None, params=PARAMS, seed: int = 0) -> dict:
    """Run the experiment; returns its rows and the mismatches against K2."""
    dev = torch.device("cuda" if device is None else device)
    p = ht.Parameters(*params)
    ctx = ht.Context(p, source=ht.ThreefrySource(seed), device=dev)
    ctx.generate_secret_key()
    ctx.generate_public_key()
    pk = ctx.get_public_key()
    planes = pk.planes()
    L = gf2.limbs_for(p.pk_degree)
    tau, W = p.tau, -(-p.tau // 32)
    plain = torch.zeros(bits, dtype=gf2.LIMB_DTYPE, device=dev)
    key = _rng.threefry_key(seed + 1)

    def words():
        return prng.random_bits(key, (bits, W), dev)

    steps = {
        "pallas_v2": lambda: enc.encrypt_words_table(words(), pk.limbs, plain, L),
        "pallas_v1": lambda: enc.encrypt_words_mma(words(), planes, plain, L),
        "pallas_v3": lambda: enc.encrypt_sel_mma(
            gf2.unpack_bits(words(), tau, dtype=torch.int8), planes, plain, L
        ),
    }
    want = steps["pallas_v2"]()
    rows = {}
    for name, fn in steps.items():
        got = fn()
        bad = int((got != want).sum())
        ms = _step_ms(fn, dev) if bad == 0 else None
        rows[name] = dict(mismatches=bad, ms=ms,
                          bits_per_s=bits / (ms / 1e3) if ms else None)
    return dict(bits=bits, tau=tau, D=planes.shape[0], L=L, device=str(dev), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, default=1 << 21)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.bits, args.device)
    print(f"\nB = {out['bits']} bits, tau={out['tau']}, D={out['D']}, L={out['L']} "
          f"on {out['device']}")
    for name, r in out["rows"].items():
        if r["mismatches"]:
            print(f"{name:12s}: MISMATCH ({r['mismatches']} limbs differ from pallas_v2)")
        elif r["ms"] is None:
            print(f"{name:12s}: matches pallas_v2 (no device time on the CPU)")
        else:
            print(f"{name:12s}: {r['ms']:9.4f} ms  -> {r['bits_per_s'] / 1e6:10.1f} M bit-enc/s")
    print(json.dumps(dict(out, seconds=time.perf_counter() - t0)))
    return 1 if any(r["mismatches"] for r in out["rows"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
