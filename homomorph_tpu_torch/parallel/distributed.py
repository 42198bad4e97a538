"""Multi-process orchestration on ``torch.distributed``.

Counterpart of :mod:`homomorph_tpu.parallel.distributed`:
:func:`initialize` joins the process group, :func:`global_mesh` builds a
grid over every process's places, :func:`broadcast_keys` and
:func:`assert_same_across_processes` distribute and check the keys, and
:func:`save_sharded` / :func:`load_sharded` checkpoint a sharded
ciphertext without gathering it.  The sharded pipelines of :mod:`.bulk`
and :mod:`.limbmul` run unchanged on the returned grid; their exchanges
cross processes point to point (NCCL between cards, gloo on the CPU).

Failure semantics follow ``torch.distributed``: a lost process makes the
others' next exchange fail at the group's timeout; a restart re-enters
through :func:`initialize`, and the keys reload from their bytes (the
reference's only durable state, src/lib.rs:39-54), the ciphertexts from
:func:`save_sharded`'s files.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os

import numpy as np
import torch

from ..device import resolve as _resolve
from .mesh import Place, ShardingConfig, make_mesh, this_rank

__all__ = [
    "initialize",
    "global_mesh",
    "broadcast_keys",
    "assert_same_across_processes",
    "save_sharded",
    "load_sharded",
]

#: the device :func:`initialize` bound this process to
_DEVICE: torch.device | None = None


def _dist():
    return torch.distributed


def _multi() -> bool:
    d = _dist()
    return d.is_available() and d.is_initialized() and d.get_world_size() > 1


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
    timeout: float = 60.0,
) -> None:
    """Join the process group (a no-op for one process).

    ``coordinator_address`` is ``host:port`` of process 0's rendezvous.
    The backend is NCCL when this process's ``device`` is a card (the card
    by default) and gloo on the CPU; a card without NCCL raises rather
    than falling back to gloo.  ``timeout`` (seconds) bounds the
    rendezvous and every later exchange."""
    global _DEVICE
    dev = _resolve(device)
    _DEVICE = dev
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a group of processes needs coordinator_address and process_id")
    dist = _dist()
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL here: a card needs it, and the "
                               "port does not fall back to gloo")
        backend = "nccl"
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for {dev}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout),
    )


def _device() -> torch.device:
    return _DEVICE if _DEVICE is not None else _resolve(None)


def global_mesh(n_tau: int = 1) -> ShardingConfig:
    """A grid over ALL processes' places, rank-major: one place per process,
    on its device (one process per card); ``n_tau`` consecutive processes
    form the tau axis and the rest of the processes the data axis."""
    dev = _device()
    if not _multi():
        return make_mesh(None, n_tau, [dev])
    dist = _dist()
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(dev))
    return make_mesh(None, n_tau, [Place(r, torch.device(d)) for r, d in enumerate(devices)])


def _broadcast(t: torch.Tensor) -> torch.Tensor:
    """``dist.broadcast`` from process 0 on the group's device."""
    dist = _dist()
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = t.to(dev)
    dist.broadcast(t, src=0)
    return t.cpu()


def _bcast_bytes(data: bytes | None, is_src: bool) -> bytes:
    # two-phase: the length first (fixed shape), then the padded payload
    n = torch.tensor([len(data) if data else 0], dtype=torch.int64)
    n = int(_broadcast(n)[0])
    if n == 0:
        return b""
    buf = torch.zeros(n, dtype=torch.uint8)
    if is_src:
        buf[:] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return bytes(_broadcast(buf).numpy().tobytes())


def broadcast_keys(ctx) -> None:
    """Broadcast process 0's keys to every process.

    Process 0 generates (or loads) the keys; every other process receives
    their exact BYTES and installs them through ``from_bytes``, so all
    hold byte-identical keys (the precondition of every sharded
    pipeline).  Two-phase length-then-payload broadcasts, the secret key
    first, then the public key's row count and rows (``distributed.py:
    92-125``).  Every process takes part in every broadcast, a source
    without a key sending length 0.  A no-op for one process."""
    if not _multi():
        return
    from ..keys import PublicKey, SecretKey

    is_src = this_rank() == 0
    sk = ctx.get_secret_key() if is_src else None
    pk = ctx.get_public_key() if is_src else None
    sk_bytes = _bcast_bytes(sk.to_bytes() if sk is not None else None, is_src)
    rows = pk.to_bytes() if is_src and pk is not None else None
    n_rows = int(_broadcast(torch.tensor([len(rows) if rows else 0], dtype=torch.int64))[0])
    pk_rows = [_bcast_bytes(rows[i] if is_src else None, is_src) for i in range(n_rows)]
    if not is_src:
        dev = ctx.device
        if sk_bytes:
            ctx.set_secret_key(SecretKey.from_bytes(sk_bytes, device=dev))
        if pk_rows:
            # after the secret key: set_secret_key clears the public key
            # (reference invariant, src/context.rs:568-571)
            ctx.set_public_key(PublicKey.from_bytes(pk_rows, device=dev))


def assert_same_across_processes(data: bytes, label: str = "value") -> None:
    """Raise ``AssertionError`` on every process whose ``data`` differs from
    process 0's, by its sha256 digest (one small broadcast)."""
    if not _multi():
        return
    digest = torch.frombuffer(bytearray(hashlib.sha256(data).digest()), dtype=torch.uint8)
    ref = _broadcast(digest.clone())
    if not torch.equal(ref, digest):
        raise AssertionError(f"{label} differs from process 0 on process {this_rank()}")


def save_sharded(directory: str, ciphered, *, name: str = "ciphertext") -> None:
    """Checkpoint a (possibly sharded, possibly multi-process) ciphertext.

    Each process writes ONLY the rows it holds, ``<name>.p<pid>s0.npz``
    with their global index window, and process 0 writes the manifest
    ``<name>.json`` (name, global shape, bound, noise, zero_lanes, desc):
    no gather.  Restore with :func:`load_sharded`."""
    from ..gf2 import poly as gf2

    os.makedirs(directory, exist_ok=True)
    pid = this_rank() if _multi() else 0
    shape = list(ciphered.limbs.shape)
    rec = getattr(ciphered, "sharding", None)
    first = 0
    if rec is not None:
        shape[0], first = rec.batch, rec.first_row
    local = ciphered.limbs.shape
    index = [(first, first + local[0])] + [(0, d) for d in local[1:]]
    np.savez(os.path.join(directory, f"{name}.p{pid}s0.npz"),
             data=gf2.to_numpy(ciphered.limbs), index=np.asarray(index, dtype=np.int64))
    if pid == 0:
        manifest = {
            "name": name,
            "shape": shape,
            "bound": ciphered.bound,
            "noise": ciphered.noise,
            "zero_lanes": ciphered.zero_lanes,
            "desc": ciphered.desc.name,
        }
        with open(os.path.join(directory, f"{name}.json"), "w") as f:
            json.dump(manifest, f)


def load_sharded(directory: str, desc, *, name: str = "ciphertext", device=None):
    """Restore a :func:`save_sharded` checkpoint as one whole ``Ciphered``
    on ``device``.  Every process reads every shard file it can see (a
    shared filesystem, the normal setup) and assembles the full array;
    ``desc`` must be the descriptor the ciphertext was built with."""
    from ..cipher import FRESH_NOISE, Ciphered
    from ..gf2 import poly as gf2
    from ..utils.errors import DeserializeError

    with open(os.path.join(directory, f"{name}.json")) as f:
        manifest = json.load(f)
    if desc.name != manifest["desc"]:
        raise DeserializeError(f"checkpoint {name} was {manifest['desc']}, not {desc.name}")
    full = np.zeros(manifest["shape"], dtype=np.uint32)
    covered = np.zeros(manifest["shape"], dtype=bool)
    found = False
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith(f"{name}.p") and fn.endswith(".npz")):
            continue
        found = True
        with np.load(os.path.join(directory, fn)) as z:
            idx = tuple(slice(int(a), int(b)) for a, b in z["index"])
            full[idx] = z["data"]
            covered[idx] = True
    if not found or not covered.all():
        raise DeserializeError(f"checkpoint {name} is incomplete in {directory} (missing shards)")
    return Ciphered(
        gf2.from_numpy(full, device),
        manifest["bound"],
        desc,
        zero_lanes=manifest["zero_lanes"],
        noise=manifest.get("noise", FRESH_NOISE),
    )
