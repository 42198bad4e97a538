"""Grids of places, the sharding configuration, and the one exchange primitive.

Counterpart of :mod:`homomorph_tpu.parallel.mesh`.  The workload's two
parallel axes are the JAX package's:

* ``data`` - ciphertext bits: encryption, decryption and every gate act
  per bit, so the batch splits into blocks with no communication;
* ``tau`` - public-key rows: encryption XORs the selected rows, so each
  tau shard computes the packed parity of its own rows and the shards
  combine their partials by XOR (:mod:`.bulk`).

**Places.** A JAX mesh is a grid of devices in one SPMD program.  NCCL
refuses a communicator in which two ranks share one GPU, so a
one-rank-per-device grid could never exchange anything on a machine with
one card.  The port's grid is therefore a grid of *places*: a
:class:`Place` is a ``(rank, device)`` pair, and a grid may repeat a
device, as the JAX tests repeat virtual CPU devices.

* Within a process, an exchange between two places is a tensor handed
  over on the device (and an XOR where the algorithm combines).
* Between processes it is a point-to-point ``dist.batch_isend_irecv``:
  NCCL between cards, gloo on the CPU.

For a real multi-GPU run the torch idiom holds: one process per card.  A
process whose places span two devices raises.

**The exchange primitive.** :func:`ppermute` is the counterpart of
``lax.ppermute(x, axis, perm)`` and carries every exchange of the package.
It counts the bytes it moves across processes and within a process, as
plain integers (``ppermute.cross_bytes``, ``ppermute.local_bytes``; a
cross-process message is counted once, by its sender).  NCCL has no
bitwise reduction (no ``ReduceOp.BXOR``), so the package builds its XOR
reductions from these exchanges and calls no all-reduce.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Sequence

import torch

from ..device import resolve as _resolve

__all__ = [
    "DATA_AXIS", "TAU_AXIS", "Place", "Mesh", "ShardingConfig", "ShardedRows",
    "make_mesh", "ppermute", "this_rank",
]

DATA_AXIS = "data"
TAU_AXIS = "tau"


def this_rank() -> int:
    """This process's rank: 0 unless ``torch.distributed`` is initialized."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Place(NamedTuple):
    """One cell of a grid: the process (rank) that holds it and its device."""

    rank: int
    device: torch.device


def _place(p, rank: int) -> Place:
    if isinstance(p, Place):
        return Place(int(p.rank), torch.device(p.device))
    return Place(rank, _resolve(p))


class Mesh:
    """A row-major grid of places with named axes (the counterpart of
    ``jax.sharding.Mesh``): ``shape`` maps each axis name to its size,
    ``places`` is the flat row-major tuple.

    Every place of this process must lie on one device."""

    def __init__(self, places: Sequence, axis_names: Sequence[str],
                 sizes: Sequence[int] | None = None):
        rank = this_rank()
        flat = tuple(_place(p, rank) for p in places)
        sizes = tuple(sizes) if sizes is not None else (len(flat),)
        if len(sizes) != len(axis_names) or math.prod(sizes) != len(flat) or not flat:
            raise ValueError(f"{len(flat)} places do not fill a grid {dict(zip(axis_names, sizes))}")
        self.places = flat
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        mine = {p.device for p in flat if p.rank == rank}
        if len(mine) > 1:
            raise ValueError(
                f"process {rank} holds places on {sorted(map(str, mine))}: one process "
                "drives one device (run one process per card)"
            )
        self.device = mine.pop() if mine else None

    @property
    def size(self) -> int:
        return len(self.places)

    def coords(self, flat: int) -> dict[str, int]:
        out, rest = {}, flat
        for name in reversed(self.axis_names):
            out[name] = rest % self.shape[name]
            rest //= self.shape[name]
        return out

    def local(self) -> list[int]:
        """Flat indices of this process's places, in grid order."""
        r = this_rank()
        return [i for i, p in enumerate(self.places) if p.rank == r]

    def groups(self, axis: str) -> list[list[int]]:
        """For each setting of the other axes, the flat indices along ``axis``
        in order (the sets ``lax.ppermute`` permutes within)."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes: {self.axis_names}")
        names = self.axis_names
        k = names.index(axis)
        strides = [math.prod(self.shape[n] for n in names[i + 1:]) for i in range(len(names))]
        others = [range(self.shape[n]) if i != k else range(1) for i, n in enumerate(names)]
        return [[sum(c * s for c, s in zip(base, strides)) + j * strides[k]
                 for j in range(self.shape[axis])]
                for base in itertools.product(*others)]

    def first_local(self, axis: str) -> dict[int, int]:
        """For each coordinate along ``axis`` this process holds, its first
        place there (flat index): the place whose value stands for the
        others of that coordinate when they all hold the same result."""
        out: dict[int, int] = {}
        for i in self.local():
            out.setdefault(self.coords(i)[axis], i)
        return out

    def local_range(self, axis: str) -> tuple[int, int]:
        """The coordinates along ``axis`` that this process holds a place at,
        as a half-open range; raises if they are not contiguous (a process's
        blocks must be one run of the axis) or if it holds none."""
        held = sorted({self.coords(i)[axis] for i in self.local()})
        if not held:
            raise ValueError(f"process {this_rank()} holds no place of this mesh")
        if held != list(range(held[0], held[-1] + 1)):
            raise ValueError(
                f"process {this_rank()} holds {axis} coordinates {held}: a process's "
                f"blocks must be contiguous along {axis!r}"
            )
        return held[0], held[-1] + 1

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={sorted({p.rank for p in self.places})})"


def ppermute(mesh: Mesh, values: dict[int, torch.Tensor], axis: str,
             perm: Sequence[tuple[int, int]]) -> dict[int, torch.Tensor]:
    """Send each place's value to another place along ``axis``.

    ``values`` maps each of this process's places (flat index) to its
    tensor, all of one shape and type.  Within every group along ``axis``
    (:meth:`Mesh.groups`), the place at coordinate ``i`` sends to ``j`` for
    each ``(i, j)`` of ``perm``.  Returns each local place's received
    tensor, zeros where nothing arrives, as ``lax.ppermute`` does.

    A pair of places of this process is a hand-over on the device; a pair
    that crosses processes is one ``dist.P2POp`` of one
    ``dist.batch_isend_irecv`` for the whole call (every process walks the
    same pair list in the same order, so messages between two ranks match
    by their order; each also carries its index as its tag)."""
    dist = torch.distributed
    me = this_rank()
    pairs = [(g[i], g[j]) for g in mesh.groups(axis) for i, j in perm]
    ranks = {mesh.places[i].rank for pair in pairs for i in pair}
    if ranks - {me} and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh with places of other processes needs torch.distributed "
                           "(parallel.distributed.initialize)")
    out: dict[int, torch.Tensor] = {}
    ops = []
    for tag, (src, dst) in enumerate(pairs):
        ps, pd = mesh.places[src], mesh.places[dst]
        if ps.rank == me and pd.rank == me:
            out[dst] = values[src]
            ppermute.local_bytes += values[src].numel() * values[src].element_size()
        elif ps.rank == me:
            v = values[src].contiguous()
            ops.append(dist.P2POp(dist.isend, v, pd.rank, tag=tag))
            ppermute.cross_bytes += v.numel() * v.element_size()
        elif pd.rank == me:
            out[dst] = torch.empty_like(values[dst], memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, out[dst], ps.rank, tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {i: out[i] if i in out else torch.zeros_like(values[i]) for i in values}


#: bytes moved by :func:`ppermute` since the last reset (plain integers)
ppermute.cross_bytes = 0
ppermute.local_bytes = 0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How the homomorphic workload lies on a ``(data, tau)`` grid."""

    mesh: Mesh

    @property
    def data_axis(self) -> str:
        return DATA_AXIS

    @property
    def tau_axis(self) -> str:
        return TAU_AXIS

    @property
    def device(self) -> torch.device:
        """The device of this process's places."""
        if self.mesh.device is None:
            raise ValueError(f"process {this_rank()} holds no place of {self.mesh}")
        return self.mesh.device

    def local_rows(self, batch: int) -> tuple[int, int]:
        """The rows ``[lo, hi)`` of a ``batch`` that this process's data
        blocks hold (its blocks are contiguous, :meth:`Mesh.local_range`)."""
        n = self.mesh.shape[DATA_AXIS]
        if batch % n:
            raise ValueError(f"batch of {batch} not divisible by the mesh data axis ({n})")
        lo, hi = self.mesh.local_range(DATA_AXIS)
        return lo * (batch // n), hi * (batch // n)


class ShardedRows(NamedTuple):
    """What a sharded ``Ciphered`` carries (the counterpart of
    ``limbs.sharding.spec[0] == "data"``): the configuration, the global
    batch, and the first global row of the rows this process holds."""

    config: ShardingConfig
    batch: int
    first_row: int


def make_mesh(n_data: int | None = None, n_tau: int = 1,
              devices: list | None = None) -> ShardingConfig:
    """Build a ``(data, tau)`` grid of places.

    ``devices`` lists the places (:class:`Place`), or devices of this
    process, in row-major order (``["cpu"] * 4`` for four places on the
    CPU); with ``n_data=None`` all of them not on the tau axis go to the
    data axis.  With ``devices=None`` every place is this process's card,
    as many as the grid needs (``n_data=None`` then means 1).
    """
    if devices is None:
        devices = [_resolve(None)] * ((1 if n_data is None else n_data) * n_tau)
    n = len(devices)
    if n_data is None:
        if n % n_tau:
            raise ValueError(f"{n} devices not divisible by n_tau={n_tau}")
        n_data = n // n_tau
    if n_data * n_tau != n:
        raise ValueError(f"mesh {n_data}x{n_tau} != {n} devices")
    return ShardingConfig(Mesh(devices, (DATA_AXIS, TAU_AXIS), (n_data, n_tau)))
