"""Two processes on gloo: the port's grid across a process boundary.

Counterpart of ``tests/test_multihost.py`` and ``tests/multihost_worker.py``.
The test starts this file twice as a script (``python
tests/test_torch_multihost.py <pid> 2 <port> <dir> cpu``); each process
joins a gloo group through ``parallel.distributed.initialize`` on the CPU
and holds two places.  With ``cuda`` as the last argument, process ``i``
drives card ``i`` and the group is NCCL (two cards needed; not run by the
test).  In one spawn the workers:

* receive process 0's keys (``broadcast_keys``) and check them
  (``assert_same_across_processes``);
* run the ``(2, 2)`` round trip twice, once with the tau exchange crossing
  the processes (rows ``[p0, p1]``) and once with the data axis crossing
  them (rows ``[p0, p0]``, ``[p1, p1]``), and a sharded ``Context`` under an
  encrypt seed;
* checkpoint the data-crossing ciphertext with ``save_sharded`` into the
  test's ``tmp_path`` and restore it with ``load_sharded``;
* run a ``sharded_clmul`` over four places whose spill crosses from place 1
  (process 0) to place 2 (process 1).

Every ciphertext and product is held, byte for byte, against the same
computation in one process on one place.  The worker imports no jax
(``tests/conftest.py`` does, and is not loaded by a script); it asserts so.
"""

import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_grid(tmp_path):
    import pytest

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), "2", str(port), str(tmp_path),
             "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"workers timed out; outputs so far: {outs}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker {p.args[2]} failed:\n{out}"
        assert "MULTIHOST OK" in out, out
    # the spill of boundary 1 -> 2 crossed once, from process 0; the other
    # two boundaries stayed inside a process
    counts = [dict(kv.split("=") for kv in line.split()[1:])
              for out in outs for line in out.splitlines() if line.startswith("CLMUL_BYTES")]
    B, Lb = 2, 4
    assert [int(c["cross"]) for c in counts] == [B * Lb * 4, 0]
    assert sum(int(c["cross"]) + int(c["local"]) for c in counts) == 3 * B * Lb * 4


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    import pytest
    import torch

    from homomorph_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_DEVICE", None)  # restored after the test
    distributed.initialize(None, 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()
    cfg = distributed.global_mesh()
    assert cfg.mesh.shape == {"data": 1, "tau": 1} and cfg.device == torch.device("cpu")
    with pytest.raises(ValueError, match="n_tau=2"):
        distributed.global_mesh(n_tau=2)  # one place: no tau axis of two


def test_initialize_refuses_a_card_without_nccl(monkeypatch):
    """A card needs NCCL: no quiet fall-back to gloo."""
    import pytest
    import torch

    from homomorph_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_resolve", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    monkeypatch.setattr(distributed, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="NCCL"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------
# The worker
# --------------------------------------------------------------------------


def worker(pid: int, nprocs: int, port: str, ckpt_dir: str, kind: str) -> None:
    import numpy as np
    import torch

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
    from homomorph_tpu_torch.gf2 import kernels as gf2k
    from homomorph_tpu_torch.gf2 import poly as gf2
    from homomorph_tpu_torch.parallel import (
        Place, bulk, distributed, limbmul, make_mesh, ppermute,
    )
    from homomorph_tpu_torch.parallel.mesh import Mesh

    def device(rank):
        return torch.device("cpu" if kind == "cpu" else f"cuda:{rank}")

    dev = device(pid)
    distributed.initialize(f"127.0.0.1:{port}", nprocs, pid, device=dev, timeout=60)
    dist = torch.distributed
    assert dist.get_world_size() == nprocs
    assert dist.get_backend() == ("gloo" if kind == "cpu" else "nccl")

    # keys: process 0 generates, the other receives the exact bytes
    params = ht.Parameters(64, 8, 1, 8)
    ctx = ht.Context(params, source=ht.ThreefrySource(0), device=dev)
    if pid == 0:
        ctx.generate_secret_key()
        ctx.generate_public_key()
    distributed.broadcast_keys(ctx)
    pk, sk = ctx.get_public_key(), ctx.get_secret_key()
    distributed.assert_same_across_processes(sk.to_bytes(), "secret key")
    distributed.assert_same_across_processes(b"".join(pk.to_bytes()), "public key")
    ref = ht.Context(params, source=ht.ThreefrySource(0), device="cpu")
    ref.generate_secret_key()
    ref.generate_public_key()
    assert sk.to_bytes() == ref.get_secret_key().to_bytes()
    assert pk.to_bytes() == ref.get_public_key().to_bytes()
    L = gf2.limbs_for(pk.max_degree)

    # identical global inputs on every process; the one-place result
    rng = np.random.default_rng(7)
    B, n = 4 * nprocs, 8
    xs = rng.integers(0, 256, size=B).astype(np.uint8)
    bits = np.unpackbits(xs[:, None], axis=1, bitorder="little").astype(np.uint32)
    sel = rng.integers(0, 2, size=(B, n, params.tau)).astype(np.uint8)
    single = enc.encrypt_sel_plain(
        torch.from_numpy(sel.reshape(B * n, -1)).to(torch.int8), ref.get_public_key().planes(),
        torch.from_numpy(bits.reshape(-1).astype(np.int32)), L).view(B, n, L)

    p0, p1 = Place(0, device(0)), Place(1, device(1))
    grids = {"tau-crossing": [p0, p1, p0, p1], "data-crossing": [p0, p0, p1, p1]}
    for label, places in grids.items():
        cfg = make_mesh(2, 2, places)
        ppermute.cross_bytes = 0
        ct = bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, bits, L)
        lo, hi = cfg.local_rows(B)
        assert torch.equal(ct.cpu(), single[lo:hi]), (label, pid)
        out = bulk.sharded_decrypt_bits(cfg, ct, sk.decrypt_mask(L))
        assert np.array_equal(out.cpu().numpy(), bits[lo:hi]), (label, pid)
        crossed = ppermute.cross_bytes
        assert (crossed > 0) == (label == "tau-crossing"), (label, crossed)
        print(f"{label}: rows {lo}:{hi}, crossed {crossed} bytes", flush=True)

    # a sharded Context under an encrypt seed against one unsharded context
    cfg = make_mesh(2, 2, grids["data-crossing"])
    sh = ht.Context(params, encrypt_seed=5, sharding=cfg, device=dev)
    one = ht.Context(params, encrypt_seed=5, device=dev)
    for c in (sh, one):
        c.set_secret_key(sk)
        c.set_public_key(pk)
    vals = [int(v) for v in xs]
    c_sh, c_one = sh.encrypt(vals, ht.U8, batch=True), one.encrypt(vals, ht.U8, batch=True)
    lo, hi = cfg.local_rows(B)
    assert c_sh.sharding.first_row == lo and c_sh.sharding.batch == B
    assert torch.equal(c_sh.limbs, c_one.limbs[lo:hi])
    assert [int(v) for v in sh.decrypt(c_sh)] == vals[lo:hi]

    # checkpoint: each process writes its rows, process 0 the manifest
    distributed.save_sharded(ckpt_dir, c_sh, name="mh")
    dist.barrier()
    restored = distributed.load_sharded(ckpt_dir, ht.U8, name="mh", device=dev)
    assert torch.equal(restored.limbs, c_one.limbs)
    assert (restored.bound, restored.noise) == (c_one.bound, c_one.noise)
    assert [int(v) for v in ctx.decrypt(restored)] == vals

    # limb-sharded clmul: places 0-1 on process 0, 2-3 on process 1
    limb_mesh = Mesh([p0, p0, p1, p1], ("limb",))
    r2 = np.random.default_rng(11)
    Bc, La, Lb = 2, 64, 4
    a = gf2.from_numpy(r2.integers(0, 1 << 32, size=(Bc, La), dtype=np.uint64), dev)
    b = gf2.from_numpy(r2.integers(0, 1 << 32, size=(Bc, Lb), dtype=np.uint64), dev)
    ppermute.cross_bytes = ppermute.local_bytes = 0
    got = limbmul.sharded_clmul(a, b, limb_mesh)
    lo, hi = limbmul.limb_window(La, Lb, limb_mesh)
    assert (lo, hi) == ((0, 34) if pid == 0 else (34, 68))
    assert torch.equal(got.cpu(), gf2k.clmul(a.cpu(), b.cpu())[:, lo:hi])
    print(f"CLMUL_BYTES cross={ppermute.cross_bytes} local={ppermute.local_bytes}", flush=True)

    assert "jax" not in sys.modules and "homomorph_tpu" not in sys.modules
    dist.destroy_process_group()
    print(f"MULTIHOST OK pid={pid}", flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
