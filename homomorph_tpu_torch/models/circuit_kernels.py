"""The carry-save tree's and the ripple's glue as launches of C1, C2 and C3.

Counterpart of the glue in :mod:`homomorph_tpu.models.circuits` (the XORs,
pads, slices, operand stacks and degree-class fits of ``_batched_clmul_pairs``,
``_fit_bit``, ``_csa_accumulate``, ``_ripple_add_rows`` and ``add``'s carry
chain), which XLA fuses under ``jax.jit`` and which the port ran one torch op
per bit.  Here a circuit runs from a **plan**, made once per circuit shape and
holding no tensor:

* :func:`tree_plan`: for each level of a :class:`~.csaplan.CsaPlan`, each
  compressor's source bits and widths, each sum's width, the clmul groups
  keyed exactly as ``_batched_clmul_pairs`` keys them (``(Lu, Lv)`` in the
  order of the pairs), each carry's bucketed width, bound and noise, then the
  final ripple's; the bounds and noises are the ones ``models/noise.py``
  replays.  A pure function of the plan and the input bits' widths, bounds
  and noises (the rows come in at launch).
* :func:`ripple_plan` (the two-row ripple and ``add_lanes``) and
  :func:`add_plan` (``add``: its ``g`` is one whole-tensor product).

A level is then one launch of C1 (``hm_csa_level_in``: every sum, and every
row of the level's grouped clmul operands written into the group's tensors),
the grouped clmuls as before, and one launch of C2 (``hm_csa_level_out``:
every carry from the groups' product rows at its bucketed width).  A ripple
is one C1 launch (each column's ``x``, its ``g`` operands, and the output
lanes no carry reaches), the grouped ``g`` clmuls, and one launch of C3
(``hm_ripple_step``) a step: ``carry' = fit(prod, Lc) ^ g`` and ``out[i+1] =
x[i+1] ^ carry'`` written straight into its lane of the preallocated output
``[..., n, L]``.  A level of more ops than a launch takes (:data:`CSA_IN`,
:data:`CSA_OUT`; ``csrc/circuit.cu``) is split into as many launches.

The ops reach a wrapper as a **program**: an int64 array with one row an op,
each source ``(slot, offset, row stride, width)`` and each destination
``(slot, offset, row stride, width, mask)`` in limbs of the tensor in that
slot; destination ``d`` is the XOR of the sources in its mask, each read as
zero past its own width, over the destination's whole width (zero-extended,
or truncated where the circuit knows the limbs past the width are zero).
On a CUDA tensor a wrapper turns the slots into pointers and launches its
kernel (and counts the launch) or raises; on a ``cpu`` tensor it runs its
plain version, the same program in torch ops (:func:`xor_rows_plain`); on a
``meta`` tensor, which holds no values, it checks the program and computes
nothing (the outputs' shapes are the plan's).  There is no other path.
A plan's programs at a row count and its inputs' row strides are made and
prepared (their launches' words laid out) once, and kept in one bounded
cache (:func:`_programs_at`), whichever runner asks: the tree, the two-row
ripple or the add.  A program passed in as an array is prepared at each call.

Memory: a level's outputs live in one buffer for each level at which they
die, so a buffer is freed with its last bit, as each bit was before; the
operand buffer of a level goes once its clmuls are issued.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..cipher import Ciphered, CipheredBit
from ..gf2 import kernels as gf2k
from ..gf2 import poly as gf2
from ..utils.profiling import counters, span

__all__ = [
    "Spec", "CSA_IN", "CSA_OUT", "RIPPLE", "launch_chunks", "csa_level_in", "csa_level_out",
    "ripple_step", "xor_rows_plain", "Lanes", "tree_plan", "ripple_plan", "add_plan", "TreeState",
    "tree_start", "tree_level", "tree_ripple", "run_tree", "run_ripple", "run_add",
    "clmul_pairs",
]


# --------------------------------------------------------------------------
# The kernels (csrc/circuit.cu) and their plain versions
# --------------------------------------------------------------------------


class Spec(NamedTuple):
    """A kernel's C entry, its sources and destinations an op, the ops a
    launch takes at most (``csrc/circuit.cu``'s constants: its parameter of
    at most 32,764 bytes), and its id among the launch counters."""

    entry: str
    srcs: int
    dsts: int
    ops: int
    kernel: str

    @property
    def fields(self) -> int:
        return 4 * self.srcs + 5 * self.dsts


CSA_IN = Spec("hm_csa_level_in", 3, 5, 240, "C1")
CSA_OUT = Spec("hm_csa_level_out", 2, 1, 600, "C2")
RIPPLE = Spec("hm_ripple_step", 3, 2, 1, "C3")

_fns: dict = {}


def _kernel(spec: Spec):
    fn = _fns.get(spec.entry)
    if fn is None:
        from ..gf2.cuda_build import library

        lib = library("circuit")
        caps = (ctypes.c_longlong * 3)()
        lib.hm_circuit_caps(caps)
        want = (CSA_IN.ops, CSA_OUT.ops, RIPPLE.ops)
        if tuple(caps) != want:
            raise RuntimeError(f"csrc/circuit.cu takes {tuple(caps)} ops a launch, the wrapper "
                               f"{want}: change both together")
        fn = getattr(lib, spec.entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[spec.entry] = fn
    return fn


def launch_chunks(n_ops: int, cap: int) -> "list[tuple[int, int]]":
    """The launches a program of ``n_ops`` ops takes: ``[start, stop)`` runs
    of at most ``cap`` ops, every op in exactly one."""
    return [(i, min(i + cap, n_ops)) for i in range(0, n_ops, cap)]


def _extent(t: torch.Tensor) -> int:
    """Limbs from ``t``'s first element to one past its last reachable one."""
    if t.numel() == 0:
        return 0
    return 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))


def _split(spec: Spec, prog: np.ndarray):
    """(sources [n, NS, 4], destinations [n, ND, 5]) of a program."""
    n = prog.shape[0]
    return (prog[:, : 4 * spec.srcs].reshape(n, spec.srcs, 4),
            prog[:, 4 * spec.srcs:].reshape(n, spec.dsts, 5))


class _Prepared(NamedTuple):
    """A program checked at a row count: the program, the extent each
    slot's tensor must have, and each launch's words with the pointers left
    to fill (``words[pos] = pointer of slot[...] + off``)."""

    prog: np.ndarray
    spec: Spec
    rows: int
    need: np.ndarray
    calls: tuple  # (words, pos, slot, off) a launch


def _prepare(spec: Spec, prog, rows: int) -> _Prepared:
    """Check a program's fields and lay out its launches' words (the C
    entry's: ops, rows, then per op each source's pointer, stride and
    width and each destination's pointer, stride, width and mask)."""
    name = spec.entry[3:]
    if not isinstance(prog, np.ndarray) or prog.dtype != np.int64 or prog.ndim != 2 \
            or prog.shape[1] != spec.fields:
        raise ValueError(f"{name} takes an int64 program of [ops, {spec.fields}]")
    if rows < 0:
        raise ValueError(f"{name} takes rows >= 0, got {rows}")
    src, dst = _split(spec, prog)
    need: dict = {}
    for f in (src, dst):
        slot, off, stride, width = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
        used = width > 0
        if (width < 0).any() or (used & ((slot < 0) | (off < 0) | (stride < 0))).any():
            raise ValueError(f"{name}: a field names no tensor or a negative offset or stride")
        reach = off + max(rows - 1, 0) * stride + width
        for sl, r in zip(slot[used].tolist(), reach[used].tolist()):
            need[sl] = max(need.get(sl, 0), r)
    mask = dst[..., 4]
    if ((mask < 0) | (mask >= 1 << spec.srcs)).any():
        raise ValueError(f"{name}: a mask names a source past {spec.srcs}")
    needs = np.zeros(max(need, default=-1) + 1, dtype=np.int64)
    for sl, r in need.items():
        needs[sl] = r
    per_op = 3 * spec.srcs + 4 * spec.dsts
    at = np.array([3 * j for j in range(spec.srcs)] + [3 * spec.srcs + 4 * j
                                                       for j in range(spec.dsts)])
    launches = []
    for start, stop in launch_chunks(prog.shape[0], spec.ops):
        n, sf, df = stop - start, src[start:stop], dst[start:stop]
        zero = np.zeros_like(sf[..., 0])
        body = np.concatenate([
            np.stack([zero, sf[..., 2], sf[..., 3]], axis=-1).reshape(n, -1),
            np.stack([np.zeros_like(df[..., 0]), df[..., 2], df[..., 3], df[..., 4]],
                     axis=-1).reshape(n, -1)], axis=1)
        words = np.concatenate([np.array([n, rows], dtype=np.int64), body.reshape(-1)])
        # each used field's pointer: its tensor's address plus its offset
        used = np.concatenate([sf[..., 3] > 0, df[..., 3] > 0], axis=1)
        slots = np.concatenate([sf[..., 0], df[..., 0]], axis=1)[used]
        offs = np.concatenate([sf[..., 1], df[..., 1]], axis=1)[used]
        pos = (2 + np.arange(n)[:, None] * per_op + at[None, :])[used]
        launches.append((words, pos, slots, 4 * offs))
    return _Prepared(prog, spec, rows, needs, tuple(launches))


def _check(spec: Spec, prep: _Prepared, tensors) -> "torch.device | None":
    """The tensors against a prepared program: int32, on one device, each
    at least the extent its fields reach."""
    name = spec.entry[3:]
    if len(prep.need) > len(tensors):
        raise ValueError(f"{name}: a field names no tensor")
    if not tensors:
        return None
    dev = tensors[0].device
    for t, need in zip(tensors, prep.need.tolist() + [0] * (len(tensors) - len(prep.need))):
        if t.dtype != gf2.LIMB_DTYPE:
            raise TypeError(f"{name} takes int32 limbs, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} takes tensors on one device, got {t.device} and {dev}")
        if need and _extent(t) < need:
            raise ValueError(f"{name}: a field reaches past its tensor")
    return dev


def _view(t: torch.Tensor, off: int, stride: int, width: int, rows: int) -> torch.Tensor:
    return torch.as_strided(t, (rows, width), (stride, 1), t.storage_offset() + off)


def xor_rows_plain(spec: Spec, prog: np.ndarray, tensors, rows: int) -> None:
    """The plain version of C1, C2 and C3 (``spec`` says which program it
    reads): the program op by op in torch, every destination computed from
    the sources before any is written (as each thread of a kernel loads
    before it stores)."""
    src, dst = _split(spec, prog)
    for i in range(prog.shape[0]):
        srcs = [_view(tensors[s], o, st, w, rows) if w > 0 else None
                for s, o, st, w in src[i].tolist()]
        outs = []
        for slot, off, stride, width, mask in dst[i].tolist():
            if width <= 0:
                continue
            t = tensors[slot]
            acc = torch.zeros((rows, width), dtype=gf2.LIMB_DTYPE, device=t.device)
            for s, v in enumerate(srcs):
                if v is not None and (mask >> s) & 1:
                    w = min(v.shape[1], width)
                    acc[:, :w] ^= v[:, :w]
            outs.append((_view(t, off, stride, width, rows), acc))
        for view, acc in outs:
            view.copy_(acc)


def _run(spec: Spec, prog, tensors, rows: int) -> None:
    prep = prog if isinstance(prog, _Prepared) else _prepare(spec, prog, rows)
    if prep.spec != spec or prep.rows != rows:
        raise ValueError(f"{spec.entry[3:]}: a program prepared for "
                         f"{prep.spec.entry[3:]} at {prep.rows} rows, run at {rows}")
    dev = _check(spec, prep, tensors)
    prog = prep.prog
    if rows == 0 or prog.shape[0] == 0:
        return
    if dev.type == "meta":  # no values to compute: the outputs' shapes are the caller's
        return
    if dev.type == "cpu":
        for start, stop in launch_chunks(prog.shape[0], spec.ops):
            xor_rows_plain(spec, prog[start:stop], tensors, rows)
        return
    if dev.type != "cuda":
        raise ValueError(f"{spec.entry[3:]} runs on cpu, meta or cuda, not {dev}")
    fn = _kernel(spec)
    ptrs = np.array([t.data_ptr() for t in tensors], dtype=np.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for words, pos, slot, off in prep.calls:
            words = words.copy()
            words[pos] = ptrs[slot] + off
            err = fn(words.ctypes.data, len(words), stream)
            if err:
                raise RuntimeError(f"{spec.entry[3:]} kernel launch failed: cudaError {err}")
            counters.add(spec.kernel)


def csa_level_in(prog: "np.ndarray | _Prepared", tensors, rows: int) -> None:
    """C1's wrapper (``hm_csa_level_in``): a level's compressors, ops of 3
    sources and 5 destinations (:func:`tree_plan`), in launches of at most
    ``CSA_IN.ops``.  ``prog`` is an int64 program or one prepared at
    ``rows`` (:func:`_prepare`); so too for C2 and C3."""
    _run(CSA_IN, prog, tensors, rows)


def csa_level_out(prog: "np.ndarray | _Prepared", tensors, rows: int) -> None:
    """C2's wrapper (``hm_csa_level_out``): a level's carries, ops of 2
    sources and 1 destination, in launches of at most ``CSA_OUT.ops``."""
    _run(CSA_OUT, prog, tensors, rows)


def ripple_step(prog: "np.ndarray | _Prepared", tensors, rows: int) -> None:
    """C3's wrapper (``hm_ripple_step``): one step of a carry chain, one op
    of 3 sources (prod, g, the next x) and 2 destinations (the carry, the
    next output lane)."""
    _run(RIPPLE, prog, tensors, rows)



# --------------------------------------------------------------------------
# Plans: widths, bounds and noises, no tensor
# --------------------------------------------------------------------------


class Bit(NamedTuple):
    width: int
    bound: int
    noise: int


def _xor(*bits: Bit) -> Bit:
    return Bit(max(b.width for b in bits), max(b.bound for b in bits),
               max(b.noise for b in bits))


def _fitted(bound: int) -> int:
    """The degree-class width of a product's bound (``_fit_bit``)."""
    return gf2.bucket(gf2.limbs_for(bound))


# A location: (slot key, offset in rows, offset in limbs, row stride or None
# for the input's own, width).  Its offset into the slot's tensor is
# ``rows_off * B + limbs_off``: a bit of a buffer takes B rows of its width.
def _loc(key, width, rows_off=0, limbs_off=0, stride=-1):
    return (key, rows_off, limbs_off, width if stride == -1 else stride, width)


def _input(key, width):
    """A location of a whole input tensor, at the input's own row stride."""
    return (key, 0, 0, None, width)


class Group(NamedTuple):
    """One clmul of a level: ``count`` pairs of ``(Lu, Lv)`` limbs, their
    ``U`` and ``V`` at ``u_at`` and ``v_at`` (rows units) of the operand
    buffer."""

    Lu: int
    Lv: int
    count: int
    u_at: int
    v_at: int


def _groups(pairs) -> "tuple[tuple[Group, ...], int, list[tuple[int, int]]]":
    """``_batched_clmul_pairs``' grouping of ``(Lu, Lv)`` pairs: groups in
    the order of their first pair, and (group, index) of each pair; with
    the operand buffer's layout (limbs a row)."""
    order: dict = {}
    where = []
    for Lu, Lv in pairs:
        items = order.setdefault((Lu, Lv), [])
        where.append((list(order).index((Lu, Lv)), len(items)))
        items.append(None)
    groups, at = [], 0
    for (Lu, Lv), items in order.items():
        groups.append(Group(Lu, Lv, len(items), at, at + len(items) * Lu))
        at += len(items) * (Lu + Lv)
    return tuple(groups), at, where


def _operands(groups, li_key, g: int, idx: int):
    """Locations of pair ``idx`` of group ``g``'s ``U`` and ``V`` rows."""
    G = groups[g]
    return (_loc(li_key, G.Lu, G.u_at + idx * G.Lu), _loc(li_key, G.Lv, G.v_at + idx * G.Lv))


def _product(groups, key, g: int, idx: int, width: int):
    """Location of pair ``idx``'s product in group ``g``'s ``[count B, Lu +
    Lv]`` product, read at most ``width`` limbs (a degree-class fit)."""
    G = groups[g]
    Lp = G.Lu + G.Lv
    return _loc(key, min(Lp, width), idx * Lp, stride=Lp)


class Level(NamedTuple):
    c1: tuple        # symbolic ops: (sources, destinations)
    groups: tuple    # Group per clmul, in order
    opnd: int        # operand buffer, limbs a row
    c2: tuple
    buffers: tuple   # ((key, limbs a row), ...) of the level's outputs
    dead: tuple      # slot keys dropped after the level


class Step(NamedTuple):
    """One C3 launch: carry ``i+1`` and output lane ``i+1``.  ``x`` and
    ``carry`` are the clmul's operands (None: carry ``i+1`` is ``g_i``);
    ``keep`` is the new carry's width if a later step multiplies it, else 0."""

    i: int
    x: "tuple | None"
    carry: "tuple | None"
    op: tuple
    keep: int


class Ripple(NamedTuple):
    """A two-row ripple: its first C1 launch, the ``g`` groups, the steps,
    and the C1 launch that stacks its lanes.  Each lane is written at its
    own width into a tensor of its own as its step runs, and stacked into
    ``[..., n, width]`` at the end: an output allocated whole before the
    first step would hold its full width through the chain's widest clmul
    (the u64 product's ``[1, 64, 3,145,728]`` is 0.81 GB, where the lanes
    written by then are a fifth of it)."""

    c1: tuple
    groups: tuple
    opnd: int
    xs: int          # the x buffer (two-row columns), limbs a row
    early: tuple     # lanes the first launch writes (no carry reaches them)
    steps: tuple
    stack: tuple     # the last launch: each lane into the output
    lanes: tuple     # Bit per output lane
    width: int       # L of the output


class TreePlan(NamedTuple):
    levels: tuple
    ripple: Ripple


def tree_plan(plan, inputs: "tuple[tuple[int, int, int, int], ...]") -> TreePlan:
    """The plan of a carry-save tree and its final ripple for input bits
    ``(id, width, bound, noise)`` (sorted by id); cached."""
    return _tree_plan(plan.n, plan.levels, plan.final_cols, inputs)


@functools.lru_cache(maxsize=64)
def _tree_plan(n, levels, final_cols, inputs) -> TreePlan:
    meta = {bid: Bit(w, b, nz) for bid, w, b, nz in inputs}
    where = {bid: _input(("in", bid), meta[bid].width) for bid in meta}
    L = len(levels)
    death = {bid: -1 for bid in meta}
    for li, level in enumerate(levels):
        for op in level:
            for bid in (op.x, op.y, op.z):
                if bid is not None:
                    death[bid] = li
    final = [c[:2] for c in final_cols]
    for c in final:
        for bid in c:
            death[bid] = L
    for li, level in enumerate(levels):
        for op in level:  # outputs no later level reads die here
            death.setdefault(op.sum, li)
            if op.carry is not None:
                death.setdefault(op.carry, li)

    inputs_dying: dict = {}
    for bid, *_ in inputs:
        inputs_dying.setdefault(death[bid], []).append(bid)
    buffers_made: dict = {}
    out_levels = []
    for li, level in enumerate(levels):
        pairs = []
        sums, carries = [], []
        for op in level:
            x, y = meta[op.x], meta[op.y]
            if op.z is None:
                meta[op.sum] = _xor(x, y)
                if op.carry is not None:
                    pairs.append((x.width, y.width))
                    meta[op.carry] = Bit(_fitted(x.bound + y.bound), x.bound + y.bound,
                                             x.noise + y.noise)
            else:
                z = meta[op.z]
                xy = _xor(x, y)
                meta[op.sum] = _xor(xy, z)
                if op.carry is not None:
                    pairs += [(x.width, y.width), (xy.width, z.width)]
                    b = max(x.bound + y.bound, xy.bound + z.bound)
                    meta[op.carry] = Bit(_fitted(b), b, max(x.noise + y.noise, xy.noise + z.noise))
            sums.append(op.sum)
            if op.carry is not None:
                carries.append(op.carry)
        groups, opnd, slots = _groups(pairs)
        # the outputs, one buffer for each level at which they die
        bufs: dict = {}  # key -> limbs a row so far
        for bid in sums + carries:
            key = ("buf", li, death[bid])
            at = bufs.get(key, 0)
            where[bid] = _loc(key, meta[bid].width, at)
            bufs[key] = at + meta[bid].width
        c1, c2, k = [], [], 0
        opnd_key, prod = ("opnd",), lambda g: ("prod", g)
        for op in level:
            srcs = [where[op.x], where[op.y]] + ([where[op.z]] if op.z is not None else [])
            dsts = [(where[op.sum], 7 if op.z is not None else 3)]
            if op.carry is not None:
                u1, v1 = _operands(groups, opnd_key, *slots[k])
                dsts += [(u1, 1), (v1, 2)]
                if op.z is None:
                    p = [_product(groups, prod(slots[k][0]), *slots[k], meta[op.carry].width)]
                    k += 1
                else:
                    u2, v2 = _operands(groups, opnd_key, *slots[k + 1])
                    dsts += [(u2, 3), (v2, 4)]
                    p = [_product(groups, prod(slots[j][0]), *slots[j], meta[op.carry].width)
                         for j in (k, k + 1)]
                    k += 2
                c2.append((p, [(where[op.carry], 3 if len(p) == 2 else 1)]))
            c1.append((srcs, dsts))
        dead = [("in", bid) for bid in inputs_dying.get(li, ())]
        dead += [key for key in buffers_made if key[2] == li]
        buffers_made.update(bufs)
        out_levels.append(Level(
            c1=tuple(c1), groups=groups, opnd=opnd, c2=tuple(c2),
            buffers=tuple(bufs.items()),
            dead=tuple(dead)))
    A = [where[c[0]] if len(c) > 0 else None for c in final]
    B = [where[c[1]] if len(c) > 1 else None for c in final]
    mA = [meta[c[0]] if len(c) > 0 else None for c in final]
    mB = [meta[c[1]] if len(c) > 1 else None for c in final]
    return TreePlan(levels=tuple(out_levels), ripple=_ripple(A, B, mA, mB, None, None))


def ripple_plan(A: tuple, B: tuple, cin: "Bit | None" = None) -> Ripple:
    """The plan of a two-row ripple on input bits: ``A[i]``, ``B[i]`` are
    ``(width, bound, noise)`` or None (a trivial zero), read from slots
    ``("a", i)`` and ``("b", i)``; ``cin`` the carry into column 0, slot
    ``("cin",)``."""
    return _ripple_plan(tuple(A), tuple(B), cin)


@functools.lru_cache(maxsize=64)
def _ripple_plan(A, B, cin) -> Ripple:
    locs = [[None if m is None else _input((side, i), m[0]) for i, m in enumerate(rows)]
            for side, rows in (("a", A), ("b", B))]
    return _ripple(locs[0], locs[1], [None if m is None else Bit(*m) for m in A],
                   [None if m is None else Bit(*m) for m in B],
                   None if cin is None else Bit(*cin),
                   None if cin is None else _input(("cin",), cin[0]))


def _ripple(A, B, mA, mB, cin: "Bit | None", cin_loc) -> Ripple:
    """The ripple's launches (``_ripple_add_rows``' recurrence ``c' = g ^
    x*c``; a single-row column has no ``g``, an empty one zeroes the carry).
    ``A``, ``B``: each column's locations (or None), ``mA``, ``mB`` their
    bits."""
    n = len(A)
    cols = []  # (a loc, b loc, a bit, b bit), a present where either is
    for i in range(n):
        a, b, ma, mb = A[i], B[i], mA[i], mB[i]
        if a is None and b is not None:
            a, b, ma, mb = b, a, mb, ma
        cols.append((a, b, ma, mb))
    pairs = [(ma.width, mb.width) for i, (a, b, ma, mb) in enumerate(cols)
             if b is not None and i + 1 < n]
    groups, opnd, slots = _groups(pairs)
    gslot, xs_at, k = {}, {}, 0
    xm, xloc = [], []
    for i, (a, b, ma, mb) in enumerate(cols):
        if a is None:
            xm.append(None)
            xloc.append(None)
        elif b is None:
            xm.append(ma)
            xloc.append(a)
        else:
            m = _xor(ma, mb)
            xs_at[i] = sum(xm[j].width for j in xs_at)
            xm.append(m)
            xloc.append(_loc(("x",), m.width, xs_at[i]))
            if i + 1 < n:
                gslot[i] = slots[k]
                k += 1
    # carries and lanes
    lanes, carries = [], [None] * (n + 1)
    carries[0] = cin
    gbit = {i: Bit(_fitted(cols[i][2].bound + cols[i][3].bound),
                   cols[i][2].bound + cols[i][3].bound,
                   cols[i][2].noise + cols[i][3].noise) for i in gslot}
    kinds = [None] * n
    for i in range(n):
        x, c = xm[i], carries[i]
        if x is None:
            lanes.append(c if c is not None else Bit(1, 0, 0))
        else:
            lanes.append(x if c is None else _xor(x, c))
        if i + 1 >= n:
            break
        g = gbit.get(i)
        if x is None:
            carries[i + 1] = None
        elif c is None:
            carries[i + 1] = g
            kinds[i] = "g" if g is not None else None
        else:
            if g is None:
                nb, nn = x.bound + c.bound, x.noise + c.noise
                carries[i + 1] = Bit(_fitted(nb), nb, nn)
            else:
                nb, nn = max(g.bound, x.bound + c.bound), max(g.noise, x.noise + c.noise)
                carries[i + 1] = Bit(max(_fitted(nb), g.width), nb, nn)
            kinds[i] = "prod"
    width = max(b.width for b in lanes)
    out = lambda j: _loc(("lane", j), lanes[j].width)  # noqa: E731
    # the first launch: each column's x and g operands, and every lane that
    # no carry reaches (carry None: out = x, or zero)
    c1 = []
    for i, (a, b, ma, mb) in enumerate(cols):
        srcs = [s for s in (a, b) if s is not None]
        dsts = []
        if b is not None:
            dsts.append((xloc[i], 3))
            if i in gslot:
                u, v = _operands(groups, ("gop",), *gslot[i])
                dsts += [(u, 1), (v, 2)]
        if carries[i] is None:
            dsts.append((out(i), (1 << len(srcs)) - 1))
        elif i == 0:  # the carry in
            srcs = srcs + [None] * (2 - len(srcs)) + [cin_loc]
            dsts.append((out(0), 4 | ((1 << len([s for s in (a, b) if s is not None])) - 1)))
        if dsts:
            c1.append((srcs, dsts))
    steps = []
    for i in range(n - 1):
        if kinds[i] is None:
            continue
        c_next = carries[i + 1]
        later = i + 1 < n - 1 and kinds[i + 1] == "prod"
        keep = c_next.width if later else 0
        g = (_product(groups, ("gprod", gslot[i][0]), *gslot[i], gbit[i].width)
             if i in gslot else None)
        xn = xloc[i + 1]
        if kinds[i] == "g":
            srcs, x_op, c_op = [None, g, xn], None, None
        else:
            xw = xm[i].width
            cw = carries[i].width
            prod = _loc(("step",), min(xw + cw, _fitted(c_next.bound)), stride=xw + cw)
            srcs, x_op = [prod, g, xn], xloc[i]
            c_op = ("carry", i) if i > 0 or cin is None else ("cin",)
        dsts = [(_loc(("carry", i + 1), keep), 3) if keep else None, (out(i + 1), 7)]
        steps.append(Step(i, x_op, c_op, (srcs, dsts), keep))
    early = tuple(i for i in range(n) if carries[i] is None or i == 0)
    stack = tuple(([out(j)], [(_loc(("out",), width, 0, j * width, n * width), 1)])
                  for j in range(n))
    return Ripple(c1=tuple(c1), groups=groups, opnd=opnd,
                  xs=sum(xm[j].width for j in xs_at), early=early, steps=tuple(steps),
                  stack=stack, lanes=tuple(lanes), width=width)


class AddPlan(NamedTuple):
    c1: tuple
    xs: int          # limbs a row of the x lanes (n of Lx)
    steps: tuple
    lanes: tuple
    width: int


def add_plan(n: int, a: Bit, b: Bit, cin: "Bit | None") -> AddPlan:
    """The plan of ``add``: ``x = a ^ b`` and the whole-tensor ``g = a * b``
    (one clmul, as ``gate_and``), then ``c' = g ^ x*c`` a lane at a time
    with ``x`` at its exact width (``limbs_for`` of its bound) and ``g``
    fitted to its degree class; output lanes as ``add`` makes them."""
    return _add_plan(n, Bit(*a), Bit(*b), None if cin is None else Bit(*cin))


@functools.lru_cache(maxsize=64)
def _add_plan(n, a: Bit, b: Bit, cin) -> AddPlan:
    x = _xor(a, b)
    Lx = gf2.limbs_for(x.bound)
    g = Bit(_fitted(a.bound + b.bound), a.bound + b.bound, a.noise + b.noise)
    Lp = a.width + b.width
    carries, lanes = [cin], []
    for i in range(n):
        c = carries[i]
        lanes.append(x if c is None else _xor(x, c))
        if i + 1 >= n:
            break
        if c is None:
            carries.append(g)
        else:
            nb, nn = max(g.bound, x.bound + c.bound), max(g.noise, x.noise + c.noise)
            carries.append(Bit(max(_fitted(nb), g.width), nb, nn))
    width = max(lane.width for lane in lanes)
    out = lambda j: _loc(("out",), width, 0, j * width, n * width)  # noqa: E731
    lane_a = lambda key, L, i: (key, 0, i * L, n * L, L)  # noqa: E731
    xloc = lambda i: _loc(("x",), Lx, i * Lx)  # noqa: E731
    c1 = []
    for i in range(n):
        srcs = [lane_a(("a",), a.width, i), lane_a(("b",), b.width, i)]
        dsts = [(xloc(i), 3)]
        if i == 0:
            if cin is None:
                dsts.append((out(0), 3))
            else:
                srcs.append(_input(("cin",), cin.width))
                dsts.append((out(0), 7))
        c1.append((srcs, dsts))
    steps = []
    for i in range(n - 1):
        c_next = carries[i + 1]
        keep = c_next.width if i + 1 < n - 1 else 0
        gl = ("g",), 0, i * Lp, n * Lp, min(Lp, g.width)
        if carries[i] is None:
            srcs, x_op, c_op = [None, gl, xloc(i + 1)], None, None
        else:
            cw = carries[i].width
            prod = _loc(("step",), min(Lx + cw, _fitted(c_next.bound)), stride=Lx + cw)
            srcs, x_op = [prod, gl, xloc(i + 1)], xloc(i)
            c_op = ("carry", i) if i > 0 else ("cin",)
        dsts = [(_loc(("carry", i + 1), keep), 3) if keep else None, (out(i + 1), 7)]
        steps.append(Step(i, x_op, c_op, (srcs, dsts), keep))
    return AddPlan(c1=tuple(c1), xs=n * Lx, steps=tuple(steps), lanes=tuple(lanes),
                   width=width)


# --------------------------------------------------------------------------
# Programs: a plan's ops at a row count, as the wrappers take them
# --------------------------------------------------------------------------


def _program(spec: Spec, ops, rows: int, strides: dict) -> "tuple[_Prepared, tuple]":
    """(program prepared at ``rows`` rows, slot keys) of symbolic ops;
    ``strides`` gives the row stride of each slot whose locations leave it
    open."""
    keys: dict = {}
    out = np.zeros((len(ops), spec.fields), dtype=np.int64)
    for r, (srcs, dsts) in enumerate(ops):
        row = []
        for j in range(spec.srcs):
            loc = srcs[j] if j < len(srcs) else None
            row += [-1, 0, 0, 0] if loc is None else _fields(loc, keys, rows, strides)
        for j in range(spec.dsts):
            d = dsts[j] if j < len(dsts) else None
            row += [-1, 0, 0, 0, 0] if d is None else _fields(d[0], keys, rows, strides) + [d[1]]
        out[r] = row
    return _prepare(spec, out, rows), tuple(keys)


def _fields(loc, keys: dict, rows: int, strides: dict) -> list:
    key, rows_off, limbs_off, stride, width = loc
    slot = keys.setdefault(key, len(keys))
    return [slot, rows_off * rows + limbs_off, strides[key] if stride is None else stride, width]


def _add_programs(plan, rows: int, strides: dict):
    """An add's (or a ripple's) first C1 and one C3 a step."""
    return (_program(CSA_IN, plan.c1, rows, strides),
            [_program(RIPPLE, [s.op], rows, strides) for s in plan.steps])


def _ripple_programs(rp: Ripple, rows: int, strides: dict):
    """A ripple's first C1, one C3 a step and the C1 that stacks its lanes."""
    return (*_add_programs(rp, rows, strides), _program(CSA_IN, rp.stack, rows, strides))


def _tree_programs(tp: TreePlan, rows: int, strides: dict):
    """A tree's ``(C1, C2)`` a level and its ripple's programs."""
    return ([(_program(CSA_IN, lv.c1, rows, strides), _program(CSA_OUT, lv.c2, rows, strides))
             for lv in tp.levels], _ripple_programs(tp.ripple, rows, strides))


#: every runner's programs, least recently used first: (id(plan), rows, input
#: strides) -> (plan, programs); an entry holds its plan, so its id names no other
_programs: OrderedDict = OrderedDict()
_PROGRAMS_KEPT = 256


def _programs_at(plan, rows: int, strides: dict, make):
    """``make(plan, rows, strides)``, the runner's programs of its plan,
    made and prepared once for each row count and input strides.  A plan
    comes from its own ``lru_cache``, so one shape gives one plan object,
    and the key is its identity: nothing here hashes a plan."""
    key = (id(plan), rows, tuple(strides.values()))
    hit = _programs.get(key)
    if hit is not None:
        _programs.move_to_end(key)
        return hit[1]
    progs = make(plan, rows, strides)
    _programs[key] = (plan, progs)
    if len(_programs) > _PROGRAMS_KEPT:
        _programs.popitem(last=False)
    return progs


# --------------------------------------------------------------------------
# Executors
# --------------------------------------------------------------------------


class Lanes(NamedTuple):
    """A circuit's output: ``limbs`` [*batch, n, L] and each lane's own
    width, bound and noise."""

    limbs: torch.Tensor
    lanes: tuple

    def ciphered(self, desc) -> Ciphered:
        """As ``Ciphered.new_from_raw`` of the lanes: the worst bound and noise."""
        return Ciphered(self.limbs, max(b.bound for b in self.lanes), desc,
                        noise=max(b.noise for b in self.lanes))

    def bits(self) -> "list[CipheredBit]":
        """Each lane at its own width, bound and noise."""
        return [CipheredBit(self.limbs[..., i, : b.width], b.bound, noise=b.noise)
                for i, b in enumerate(self.lanes)]

    @staticmethod
    def stack(bits: "list[CipheredBit]") -> "Lanes":
        """Lanes of a list of bits (pads and a stack, as ``new_from_raw``)."""
        L = max(b.num_limbs for b in bits)
        return Lanes(torch.stack([b.pad_to(L).limbs for b in bits], dim=-2),
                     tuple(Bit(b.num_limbs, b.bound, b.noise) for b in bits))


def _rows(t: torch.Tensor, batch: tuple) -> "tuple[torch.Tensor, int]":
    """A bit's limbs as rows: (tensor, row stride) with row ``r`` at limb
    ``r * stride`` of it; broadcast to ``batch``, copied only where its
    batch dimensions do not fold into one stride."""
    if t.dim() == 2 and len(batch) == 1 and t.shape[0] == batch[0] and t.stride(1) == 1:
        return t, t.stride(0)
    if tuple(t.shape[:-1]) != batch:
        t = t.expand(*batch, t.shape[-1])
    if t.stride(-1) != 1:
        t = t.contiguous()
    dims = [(s, st) for s, st in zip(t.shape[:-1], t.stride()[:-1]) if s != 1]
    for (_, outer), (size, inner) in zip(dims, dims[1:]):
        if outer != inner * size:
            t = t.contiguous()
            return t, t.shape[-1]
    return t, dims[-1][1] if dims else t.shape[-1]


def _rows_view(t: torch.Tensor, loc, rows: int) -> torch.Tensor:
    """The ``[rows, width]`` view of a location in a flat buffer."""
    _, rows_off, limbs_off, _, width = loc
    at = rows_off * rows + limbs_off
    return t[at: at + rows * width].view(rows, width)


def _operand_views(buf, groups, rows):
    for G in groups:
        yield (buf[G.u_at * rows: (G.u_at + G.count * G.Lu) * rows].view(G.count * rows, G.Lu),
               buf[G.v_at * rows: (G.v_at + G.count * G.Lv) * rows].view(G.count * rows, G.Lv))


def _product_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` through the clmul dispatcher, its rows contiguous as the
    programs read them (the limb-sharded path may return a strided view)."""
    return gf2k.clmul(a, b).contiguous()


def _empty(words: int, dev) -> torch.Tensor:
    return torch.empty(words, dtype=gf2.LIMB_DTYPE, device=dev)


class TreeState(NamedTuple):
    """A carry-save tree between launches: the live tensors by slot key, the
    plan and its programs at these rows."""

    env: dict
    plan: TreePlan
    programs: tuple
    rows: int
    batch: tuple
    device: torch.device


def tree_start(bits: "dict[int, CipheredBit]", plan, batch: tuple) -> TreeState:
    """The tree's input bits in their slots, with the plan
    (:func:`tree_plan`) and its programs at these rows
    (:func:`_programs_at`)."""
    rows = math.prod(batch)
    env, strides, inputs = {}, {}, []
    for bid in sorted(bits):
        bit = bits[bid]
        t, s = _rows(bit.limbs, batch)
        env[("in", bid)] = t
        strides[("in", bid)] = s
        inputs.append((bid, t.shape[-1], bit.bound, bit.noise))
    tp = tree_plan(plan, tuple(inputs))
    return TreeState(env, tp, _programs_at(tp, rows, strides, _tree_programs), rows, batch,
                     t.device)


def tree_level(state: TreeState, li: int) -> TreeState:
    """Level ``li``: one C1 launch (sums, operand rows), the grouped clmuls,
    one C2 launch (carries); then the bits that die here are dropped.  A
    span, ``circuit.csa_level``."""
    with span("circuit.csa_level"):
        env, rows, dev = dict(state.env), state.rows, state.device
        lv = state.plan.levels[li]
        (p1, k1), (p2, k2) = state.programs[0][li]
        for bkey, words in lv.buffers:
            env[bkey] = _empty(rows * words, dev)
        env[("opnd",)] = _empty(rows * lv.opnd, dev)
        csa_level_in(p1, [env[k] for k in k1], rows)
        prods = [_product_rows(U, V)
                 for U, V in _operand_views(env.pop(("opnd",)), lv.groups, rows)]
        env.update((("prod", g), P) for g, P in enumerate(prods))
        del prods
        csa_level_out(p2, [env[k] for k in k2], rows)
        for g in range(len(lv.groups)):
            del env[("prod", g)]
        for k in lv.dead:
            del env[k]
        return state._replace(env=env)


def tree_ripple(state: TreeState) -> Lanes:
    """The final two-row ripple of a tree whose levels have all run."""
    return _ripple_run(state.plan.ripple, state.programs[1], dict(state.env), state.rows,
                       state.batch, state.device)


def run_tree(bits: "dict[int, CipheredBit]", plan, batch: tuple) -> Lanes:
    """Run a carry-save plan (``models/csaplan.py``) and its final ripple on
    live bits: :func:`tree_level` a level (one C1 launch, the grouped
    clmuls, one C2 launch), then :func:`tree_ripple`."""
    state = tree_start(bits, plan, batch)
    for li in range(len(state.plan.levels)):
        state = tree_level(state, li)
    return tree_ripple(state)


def _operand(env, key_or_loc, rows):
    """A clmul operand as ``[rows, width]``: an input bit's or the carry
    in's own rows, a carry's tensor, or a location's view in a buffer."""
    if isinstance(key_or_loc[0], tuple):
        t = env[key_or_loc[0]]
        if key_or_loc[0][0] not in ("in", "a", "b"):
            return _rows_view(t, key_or_loc, rows)
    else:
        t = env[key_or_loc]
    return t.reshape(rows, t.shape[-1])


def _chain(steps, progs, env: dict, rows: int, dev, lanes: "tuple | None" = None) -> None:
    """A carry chain, a step at a time, each in a span, ``circuit.ripple``:
    its clmul ``x * carry``, the next carry's buffer, one C3 launch, then
    the old carry and the product dropped.  With ``lanes`` (each output
    lane's Bit) a step's output lane is a tensor of its own, made before
    its launch (the ripple); without, the steps write into the stacked
    output already in ``env`` (the add)."""
    for step, (prog, keys) in zip(steps, progs):
        with span("circuit.ripple"):
            if step.x is not None:
                env[("step",)] = _product_rows(_operand(env, step.x, rows),
                                               _operand(env, step.carry, rows))
            if step.keep:
                env[("carry", step.i + 1)] = _empty(rows * step.keep, dev).view(rows, step.keep)
            if lanes is not None:
                env[("lane", step.i + 1)] = _empty(rows * lanes[step.i + 1].width, dev)
            ripple_step(prog, [env[k] for k in keys], rows)
            env.pop(("carry", step.i), None)
            env.pop(("step",), None)


def _ripple_run(rp: Ripple, progs, env, rows, batch, dev) -> Lanes:
    (p1, k1), steps, (p3, k3) = progs
    n = len(rp.lanes)
    for j in rp.early:
        env[("lane", j)] = _empty(rows * rp.lanes[j].width, dev)
    env[("x",)] = _empty(rows * rp.xs, dev)
    env[("gop",)] = _empty(rows * rp.opnd, dev)
    csa_level_in(p1, [env[k] for k in k1], rows)
    prods = [_product_rows(U, V) for U, V in _operand_views(env.pop(("gop",)), rp.groups, rows)]
    env.update((("gprod", g), P) for g, P in enumerate(prods))
    del prods
    _chain(rp.steps, steps, env, rows, dev, rp.lanes)
    for k in [k for k in env if k[0] != "lane"]:  # freed before the output is made
        del env[k]
    out = torch.empty(batch + (n, rp.width), dtype=gf2.LIMB_DTYPE, device=dev)
    env[("out",)] = out.view(-1)
    csa_level_in(p3, [env[k] for k in k3], rows)
    return Lanes(out, rp.lanes)


def run_ripple(A, B, batch: tuple, carry_in: "CipheredBit | None" = None) -> Lanes:
    """The two-row ripple on lane lists (``None``: a trivial zero), as
    ``_ripple_add_rows``; with ``carry_in`` the carry into column 0."""
    rows = math.prod(batch)
    env, strides, meta = {}, {}, {"a": [], "b": []}
    for side, bits in (("a", A), ("b", B)):
        for i, bit in enumerate(bits):
            if bit is None:
                meta[side].append(None)
                continue
            t, s = _rows(bit.limbs, batch)
            env[(side, i)] = t
            strides[(side, i)] = s
            meta[side].append((t.shape[-1], bit.bound, bit.noise))
    cin = None
    if carry_in is not None:
        t, s = _rows(carry_in.limbs, batch)
        env[("cin",)], strides[("cin",)] = t, s
        cin = (t.shape[-1], carry_in.bound, carry_in.noise)
    dev = next(iter(env.values())).device
    rp = ripple_plan(tuple(meta["a"]), tuple(meta["b"]), cin)
    return _ripple_run(rp, _programs_at(rp, rows, strides, _ripple_programs), env, rows, batch,
                       dev)


def run_add(a: torch.Tensor, b: torch.Tensor, a_bit: Bit, b_bit: Bit,
            carry_in: "CipheredBit | None" = None) -> Lanes:
    """``add``'s carry chain on lane tensors ``[*batch, n, La]`` and ``[*batch,
    n, Lb]`` (bounds and noises in ``a_bit``, ``b_bit``): one C1 launch (the
    ``x`` lanes, output lane 0), the whole-tensor ``g`` clmul, one C3 launch
    a step, each after its chain clmul."""
    batch, n = tuple(a.shape[:-2]), a.shape[-2]
    rows = math.prod(batch)
    a, b = a.contiguous(), b.contiguous()
    env = {("a",): a.view(-1), ("b",): b.view(-1)}
    strides = {}
    cin = None
    if carry_in is not None:
        t, s = _rows(carry_in.limbs, batch)
        env[("cin",)], strides[("cin",)] = t, s
        cin = Bit(t.shape[-1], carry_in.bound, carry_in.noise)
    ap = add_plan(n, a_bit, b_bit, cin)
    (p1, k1), steps = _programs_at(ap, rows, strides, _add_programs)
    dev = a.device
    out = torch.empty(batch + (n, ap.width), dtype=gf2.LIMB_DTYPE, device=dev)
    env[("out",)] = out.view(-1)
    env[("x",)] = _empty(rows * ap.xs, dev)
    csa_level_in(p1, [env[k] for k in k1], rows)
    if n > 1:
        env[("g",)] = _product_rows(a, b).view(-1)
    _chain(ap.steps, steps, env, rows, dev)
    return Lanes(out, ap.lanes)


def clmul_pairs(pairs, batch: tuple) -> dict:
    """``_batched_clmul_pairs``: many independent products ``(u, v, key)``,
    one clmul per group of equal operand widths, the groups' operands
    stacked by one C1 launch; products at their exact bounds, unfitted."""
    rows = math.prod(batch)
    env, strides, ops, widths = {}, {}, [], []
    for j, (u, v, key) in enumerate(pairs):
        for side, bit in (("u", u), ("v", v)):
            t, s = _rows(bit.limbs, batch)
            env[(side, j)], strides[(side, j)] = t, s
        widths.append((env[("u", j)].shape[-1], env[("v", j)].shape[-1]))
    groups, opnd, slots = _groups(widths)
    for j, (Lu, Lv) in enumerate(widths):
        u, v = _operands(groups, ("opnd",), *slots[j])
        ops.append(([_input(("u", j), Lu), _input(("v", j), Lv)], [(u, 1), (v, 2)]))
    dev = next(iter(env.values())).device
    env[("opnd",)] = _empty(rows * opnd, dev)
    prog, pkeys = _program(CSA_IN, ops, rows, strides)
    csa_level_in(prog, [env[k] for k in pkeys], rows)
    prods = [gf2k.clmul(U, V) for U, V in _operand_views(env.pop(("opnd",)), groups, rows)]
    out = {}
    for j, (u, v, key) in enumerate(pairs):
        g, idx = slots[j]
        P = prods[g]
        out[key] = CipheredBit(P[idx * rows: (idx + 1) * rows].view(*batch, P.shape[-1]),
                               u.bound + v.bound, noise=u.noise + v.noise)
    return out
