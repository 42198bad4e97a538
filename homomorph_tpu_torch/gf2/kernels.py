"""The clmul dispatcher, its Karatsuba route and its CUDA kernels (K1, R1, R2).

Counterpart of :mod:`homomorph_tpu.gf2.kernels`.  :func:`clmul` broadcasts
the leading dimensions as the JAX dispatcher does (``kernels.py:179-185``),
flattens both operands to [B, L] rows and hands them to the route
(:func:`clmul_rows`), which ends in one call of :func:`clmul_flat`, the
kernel's wrapper:

* on a CUDA tensor it launches ``csrc/clmul.cu`` or raises: a 4-bit
  windowed comb (Lopez-Dahab) that stages the 16 multiples ``u*g`` of the
  wider operand in shared memory and adds one funnel-shifted multiple per
  nibble of the smaller one, one thread per output limb (see the note in
  that file); its bound is the comb's shared-memory loads.  Square
  products (every leaf of the route) take its square path, which the
  kernel picks from the widths alone (:func:`square_path`): the same comb,
  the row's ``L + 2`` output columns ``k`` to a lane, each lane walking
  every limb once, so no lane walks a limb pair its output does not need,
  and each nibble's decode, address and window words serve its ``k``
  columns (``k`` from the width: :func:`square_columns`); such a launch
  also counts ``K1.square``, and ``K1.square.tiled`` where ``k > 1``;
* on a CPU tensor it computes :func:`clmul_plain`, the 32-plane sweep of
  :func:`homomorph_tpu_torch.gf2.poly.clmul`, chunked over the batch.

:func:`clmul_comb_plain` follows the kernel's decomposition step by step in
torch (the multiples, then the nibble walk with funnel shifts), and
:func:`clmul_square_plain` the square path's (its blocks' shared memory, each
lane's steps and window positions), so the CPU tests check their indexing
against the JAX package; no path calls them.

**The Karatsuba route** (counterpart of ``_karatsuba_flat`` and of the
chunk branch of ``_clmul_flat``, ``kernels.py:212-225, 356-387``).  When
the smaller operand has at least :func:`karatsuba_min` limbs, the product
is cut as the JAX package cuts it: a wider operand of more than
``3*Ls//2`` limbs into ``Ls``-limb pieces, and a balanced product at
``h = (L+1)//2`` of the wider operand's ``L`` limbs (the smaller one padded
to ``L``) into ``a0*b0``, ``a1*b1`` and ``(a0^a1)*(b0^b1)``, with
``mid = pm ^ p0 ^ p2`` and the output truncated to ``Ls + Lg``.  The JAX
package recurses product by product; here each level is one step on all
rows at once (:func:`route_plan`): the pieces, and the three half-products
(``a1``, ``b1`` padded to ``h``), are stacked on the row axis, each row's
three after one another, so every row of a level has one width.  Below the
threshold, ONE K1 launch takes all ``3^k * B`` rows (times the pieces).  Padding (odd ``L``, a last piece
narrower than ``Ls``) only adds zero limbs, so every route gives the same
bits.

The route's glue has kernels of its own (``csrc/route.cu``): on a CUDA
tensor a routed product is ONE launch of R1 (:func:`route_split`, the whole
descent for both operands, nodes of a depth staged a block:
:func:`split_plan`), one of K1, and the launches of R2 (:func:`route_join`:
one ascent from the leaves to a depth, then one launch a level above it
and one for the chunk step: :func:`join_launches`), with no torch op
between them.  The leaves are node-major (:func:`leaf_rows`): the three
halves of a row are stacked row after row, so the leaves under any node
are one run of rows, which R1 writes and R2 streams whole.  On a CPU
tensor the same wrappers compute their plain versions, the level-by-level
torch steps :func:`_split_levels` and :func:`_join_levels`.
:func:`route_split_plain` (R1's staging by index map at any depth) and
:func:`route_join_plain` (R2's launches in their own order) mirror the
kernels in torch for the CPU tests; no path calls them.

The route runs on CUDA tensors from the threshold up.  On a CPU tensor the
plain version runs unrouted, as the JAX package gates Karatsuba to TPU
backends, unless ``HOMOMORPH_TPU_TORCH_FORCE_KARATSUBA=1``; then the same
decomposition runs over :func:`clmul_plain`, which is how the CPU tests
cover its indexing.  ``HOMOMORPH_TPU_TORCH_KARATSUBA_MIN`` overrides the
threshold.  Both are read at each eager call; a compiled callable keeps the
value it was captured with.

**Not ported as routes: the strips and the blocked scan**
(``kernels.py:244-254, 257-353``).  The strips exist because the Pallas
body unrolls over at most 48 limbs of the smaller operand; the scan exists
to bound the XLA trace, Mosaic compile time and VMEM at u32 widths.  K1
takes any widths (it tiles its output at 512 limbs and its windows at 64,
``csrc/clmul.cu``) and eager PyTorch has no trace to bound.  The scan's
other idea, laying blocks of a wide operand onto rows so that small
batches fill the machine, is what the stacked pieces and levels do here.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch
import torch.nn.functional as F

from . import poly as gf2
from ..utils.profiling import counters, span

__all__ = [
    "clmul", "clmul_rows", "clmul_flat", "clmul_plain", "clmul_comb_plain",
    "clmul_square_plain", "square_layout", "square_path", "square_columns", "clmul_mapping",
    "karatsuba_min", "route_plan", "route_split", "route_join", "split_plan", "split_layout",
    "join_launches", "ascent_layout", "join_plans", "leaf_rows", "route_split_plain",
    "route_join_plain", "join_pieces_plain",
]

# cap on the [batch, La, Lb] planes the plain sweep materializes at once
_PLAIN_ELEM_CAP = 1 << 22

KARATSUBA_MIN_ENV = "HOMOMORPH_TPU_TORCH_KARATSUBA_MIN"
FORCE_KARATSUBA_ENV = "HOMOMORPH_TPU_TORCH_FORCE_KARATSUBA"
# Smallest width (limbs) of the smaller operand from which the route takes a
# level: the crossover of chip_smoke.py's route sweep (phase 3c) on an NVIDIA
# H100 80GB HBM3 at 700 W, where one level (R1, K1, R2) first beats a direct
# K1 launch at 64 limbs and keeps winning above; at 48 it loses (K1 on
# 24-limb leaves).  Measured so with the first R1 and R2 and again with
# their redesign on node-major leaves (PERF.md section 6).
_KARATSUBA_MIN = 64

_fn = None

#: the limb-sharded path's entry (``fn(a, b) -> tensor or None``), or None:
#: :func:`homomorph_tpu_torch.parallel.limbmul.set_default_limb_mesh` fills
#: it while a limb mesh is registered and empties it when the mesh goes
limb_hook = None


def _kernel():
    """``csrc/clmul.cu``'s library, its entries typed."""
    global _fn
    if _fn is None:
        from .cuda_build import library

        lib = library("clmul")
        operands = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.hm_clmul.argtypes = operands + [ctypes.c_void_p]
        lib.hm_clmul_mapping.argtypes = operands + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hm_clmul_square.argtypes = [ctypes.c_int, ctypes.c_int]
        for fn in (lib.hm_clmul, lib.hm_clmul_mapping, lib.hm_clmul_square):
            fn.restype = ctypes.c_int
        _fn = lib
    return _fn


@functools.lru_cache(maxsize=256)
def square_columns(Ls: int, Lg: int) -> int:
    """The output columns a lane of K1's square path owns at these widths,
    or 0 where K1 takes the comb (``csrc/clmul.cu`` decides from the widths
    alone: ``Ls == Lg`` from its measured ``SQUARE_MIN``, ``k`` from its
    measured ``SQUARE_COLUMNS``); builds the kernel on first use."""
    return _kernel().hm_clmul_square(Ls, Lg)


def square_path(Ls: int, Lg: int) -> bool:
    """Whether K1 takes its square path at these widths."""
    return square_columns(Ls, Lg) > 0


def clmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched carry-less multiply: [..., La] x [..., Lb] -> [..., La+Lb].

    Same contract as :func:`homomorph_tpu_torch.gf2.poly.clmul`, with the
    leading dims broadcast (keygen multiplies a [tau, Lq] operand by an
    [Ls] one): an operand whose rows are broadcast is copied to every row,
    and the limbs written count as ``clmul.expand``.

    While a limb mesh is registered, :data:`limb_hook` is set and the
    product is first offered to the limb-sharded path, as the JAX
    dispatcher does (``kernels.py:174-178``); the path returns None when
    the shapes do not qualify.  With no mesh the slot is None and the
    product goes straight to the dense route (:func:`clmul_rows`), which on
    the card raises for a route of more than 18 split levels."""
    if limb_hook is not None:
        sharded = limb_hook(a, b)
        if sharded is not None:
            return sharded
    La, Lb = a.shape[-1], b.shape[-1]
    lead = a.shape[:-1]
    if b.shape[:-1] != lead:
        lead = torch.broadcast_shapes(lead, b.shape[:-1])
    batch = math.prod(lead)
    for x, L in ((a, La), (b, Lb)):
        if math.prod(x.shape[:-1]) != batch and x.device.type != "meta":
            counters.add("clmul.expand", batch * L)  # the broadcast rows' copy below
    af = a.expand(*lead, La).reshape(batch, La).contiguous()
    bf = b.expand(*lead, Lb).reshape(batch, Lb).contiguous()
    return clmul_rows(af, bf).reshape(*lead, La + Lb)


def karatsuba_min() -> int:
    """The route's threshold: ``HOMOMORPH_TPU_TORCH_KARATSUBA_MIN`` if set,
    else :data:`_KARATSUBA_MIN`; at least 2, where a split still narrows."""
    return max(2, int(os.environ.get(KARATSUBA_MIN_ENV, _KARATSUBA_MIN)))


def route_plan(Ls: int, Lg: int, kmin: int) -> "list[tuple[str, int, int, int]]":
    """The levels of an ``Ls x Lg`` product (``Ls <= Lg``) down to the
    threshold ``kmin``: ``("chunk", Ls, Lg, n)`` cuts the wider operand
    into ``n`` pieces of ``Ls`` limbs (rows times ``n``), and ``("split",
    Ls, Lg, h)`` halves a balanced product at ``h`` (rows times 3).  The
    launch then takes operands of the last level's width."""
    steps = []
    while Ls >= kmin:
        if Lg > (3 * Ls) // 2:
            n = -(-Lg // Ls)
            steps.append(("chunk", Ls, Lg, n))
            Lg = Ls
        else:
            h = (Lg + 1) // 2
            steps.append(("split", Ls, Lg, h))
            Ls = Lg = h
    return steps


def _routed(device: torch.device) -> bool:
    return device.type == "cuda" or os.environ.get(FORCE_KARATSUBA_ENV, "0") == "1"


def clmul_rows(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The dispatcher on flat rows: [B, La] x [B, Lb] -> [B, La+Lb] through
    the Karatsuba route (:func:`route_plan`): :func:`route_split`, ONE
    :func:`clmul_flat` and :func:`route_join`, each in a span (``route.plan``,
    ``route.split``, ``route.leaves``, ``route.join``).  On the card a route
    of more than 18 split levels raises (:func:`split_plan`)."""
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    with span("route.plan"):
        steps = route_plan(small.shape[1], big.shape[1], karatsuba_min())
    if not steps or af.shape[0] == 0 or not _routed(af.device):
        return clmul_flat(af, bf)
    with span("route.split"):
        leaf_s, leaf_g = route_split(small, big, steps)
    with span("route.leaves"):
        p = clmul_flat(leaf_s, leaf_g)
    with span("route.join"):
        return route_join(p, small.shape[0], steps)


def _halves(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L'] with L' <= 2h -> [3B, h]: each row's ``x0``, ``x1`` (padded
    to ``h``) and ``x0 ^ x1``, in that order, row after row: the children
    of row ``r`` are rows ``3r``, ``3r+1`` and ``3r+2`` (node-major)."""
    xp = F.pad(x, (0, 2 * h - x.shape[1])).reshape(x.shape[0], 2, h)
    x0, x1 = xp[:, 0], xp[:, 1]
    return torch.stack([x0, x1, x0 ^ x1], dim=1).reshape(-1, h)


def _join_halves(p: torch.Tensor, B: int, Ls: int, Lg: int, h: int) -> torch.Tensor:
    """[3B, 2h] products of :func:`_halves`' rows -> [B, Ls+Lg]:
    ``p0 ^ (pm ^ p0 ^ p2) X^h ^ p2 X^2h``.  Every term's limbs past
    ``Ls + Lg`` are zero, so each is truncated on its own."""
    Lo = Ls + Lg
    p0, p2, pm = p.view(B, 3, 2 * h).unbind(1)
    pm = pm ^ p0 ^ p2
    out = p.new_empty((B, Lo))
    out[:, : 2 * h] = p0
    out[:, 2 * h :] = p2[:, : Lo - 2 * h]
    w = min(2 * h, Lo - h)
    out[:, h : h + w] ^= pm[:, :w]
    return out


def _join_pieces(p: torch.Tensor, B: int, Ls: int, Lg: int, n: int) -> torch.Tensor:
    """[B*n, 2Ls] piece products -> [B, Ls+Lg]: piece ``j`` lands at limb
    ``j*Ls``, so the even pieces tile from 0 and the odd ones from ``Ls``."""
    p = p.view(B, n, 2 * Ls)
    even = p[:, 0::2].reshape(B, -1)
    out = F.pad(even, (0, (n + 1) * Ls - even.shape[1]))
    if n > 1:
        odd = p[:, 1::2].reshape(B, -1)
        out[:, Ls : Ls + odd.shape[1]] ^= odd
    return out[:, : Ls + Lg].contiguous()


def _split_levels(small: torch.Tensor, big: torch.Tensor, steps) -> "tuple[torch.Tensor, torch.Tensor]":
    """R1's plain version: the route's levels one torch step at a time (the
    chunk's pieces, then :func:`_halves` of each split)."""
    for kind, Ls, Lg, n in steps:
        if kind == "chunk":
            big = F.pad(big, (0, n * Ls - Lg)).reshape(-1, Ls)
            small = small.repeat_interleave(n, dim=0)
        else:
            small, big = _halves(small, n), _halves(big, n)
    return small, big


def _join_levels(p: torch.Tensor, B: int, steps) -> torch.Tensor:
    """R2's plain version: :func:`_join_halves` and :func:`_join_pieces`
    level by level, from the leaves' products up."""
    rows = []
    for kind, _, _, n in steps:
        rows.append(B)
        B *= n if kind == "chunk" else 3
    for (kind, Ls, Lg, n), R in zip(reversed(steps), reversed(rows)):
        p = _join_pieces(p, R, Ls, Lg, n) if kind == "chunk" else _join_halves(p, R, Ls, Lg, n)
    return p


# --------------------------------------------------------------------------
# R1 and R2: the route's split and join as CUDA kernels (csrc/route.cu)
# --------------------------------------------------------------------------

# The launch plans and their shared-memory layouts are made here and passed
# to csrc/route.cu by value, which checks that each region of a layout lies
# inside it and that the whole fits the card.
#: words of shared memory a block of R1 may take (108 KB: two blocks share
#: an SM of the H100)
SPLIT_SMEM_WORDS = 27648
#: words of shared memory a block of R2's ascent may take (216 KB of the
#: H100's 227)
JOIN_SMEM_WORDS = 55296
#: R2's ascent loads its leaf products in tiles of at most this many words.
#: Each tile's levels cost a block barrier each whatever the tile's size, so
#: the larger tile wins while the ring still fits
JOIN_TILE_WORDS = 16384
#: slots of the ascent's ring: a constant of csrc/route.cu (a deeper ring
#: measured no faster, PERF.md)
RING = 2
#: nodes a launch is given at least where the route allows: two an SM of
#: the H100 (132 SMs)
MIN_NODES = 264
#: R1 at depth 0: rows a block takes at once, at most, and limbs of leaves
#: a block takes at once, at least
MAX_GROUP = 64
GROUP_WORK = 4096

_PLAN = ctypes.POINTER(ctypes.c_longlong)
# small, big, leaf_s, leaf_g, plan, layout, its words, stream /
# in, out, plan, launch, its words, stream
_ROUTE_ARGS = {
    "hm_route_split": [ctypes.c_void_p] * 4 + [_PLAN, _PLAN, ctypes.c_int, ctypes.c_void_p],
    "hm_route_join": [ctypes.c_void_p] * 2 + [_PLAN, _PLAN, ctypes.c_int, ctypes.c_void_p],
}
_route_fns: dict = {}


def _route_kernel(name: str):
    fn = _route_fns.get(name)
    if fn is None:
        from .cuda_build import library

        fn = getattr(library("route"), name)
        fn.argtypes = _ROUTE_ARGS[name]
        fn.restype = ctypes.c_int
        _route_fns[name] = fn
    return fn


def _levels(steps) -> "tuple[int, list[int], list[int]]":
    """(pieces of the chunk step or 0, each split level's ``h``, each split
    level's product width ``Ls + Lg``)."""
    n = steps[0][3] if steps[0][0] == "chunk" else 0
    splits = [s for s in steps if s[0] == "split"]
    return n, [s[3] for s in splits], [s[1] + s[2] for s in splits]


def leaf_rows(B: int, steps) -> "tuple[int, int]":
    """(rows, width) of each operand's leaves: what the K1 launch takes.
    Leaf ``r0 * 3^k + t_1 3^(k-1) + ... + t_k`` (``r0 = b * n + j``, ``t_i``
    the digit of split level ``i``: 0 for ``x0``, 1 for ``x1``, 2 for
    ``x0 ^ x1``) is node-major: the leaves under any node are one run."""
    n, h, _ = _levels(steps)
    return B * max(n, 1) * 3 ** len(h), h[-1]


def _words(values):
    return (ctypes.c_longlong * len(values))(*values)


def _plan_words(B: int, steps):
    """The route's table as ``csrc/route.cu``'s ``read_route`` takes it: B,
    Ls, Lg, n (0 without a chunk), k, h[0..k-1], Ls+Lg of each level; passed
    by value at each launch, never through device memory."""
    n, h, lo = _levels(steps)
    return _words([B, steps[0][1], steps[0][2], n, len(h), *h, *lo])


def _r4(words: int) -> int:
    return -(-words // 4) * 4


def split_buffers(h, depth: int, group: int) -> "tuple[int, int]":
    """Words of R1's two shared buffers for ``group`` nodes at ``depth``:
    the first holds the staged nodes (``2 h[depth]`` limbs each) and the
    children of levels ``depth+1``, ``depth+3``, ...; the second those of
    ``depth``, ``depth+2``, ... (each child ``2 h`` limbs of the level below
    it); the last level writes to device memory."""
    k = len(h)
    if depth == k:
        return 0, 0
    bufs = [group * 2 * h[depth], 0]
    for i in range(depth, k - 1):
        j = (i - depth + 1) % 2
        bufs[j] = max(bufs[j], group * 3 ** (i + 1 - depth) * 2 * h[i + 1])
    return _r4(bufs[0]), _r4(bufs[1])


def split_layout(h, depth: int, group: int) -> dict:
    """R1's shared memory for ``group`` nodes at ``depth``, as offsets in
    words: ``inputs``, the input of each split level from ``depth`` on (the
    staged nodes, then each level's children), in the two buffers of
    :func:`split_buffers` by turns; ``base``, the nodes' row starts (two
    words each); ``off`` and ``lim``, the staging terms' offsets and limits
    (``cap`` words each: one term a node at depth 0, up to ``2^depth``
    else); ``words``, all of it."""
    first, second = split_buffers(h, depth, group)
    cap = group if depth == 0 else 2 ** depth
    base = first + second
    off = base + 2 * group
    return dict(inputs=[(0, first)[(i - depth) % 2] for i in range(depth, len(h))], base=base,
                off=off, lim=off + cap, cap=cap, words=_r4(off + 2 * cap))


def split_plan(B: int, steps) -> "tuple[int, int]":
    """R1's launch, ``(depth, group)``: a block stages ``group`` nodes of
    ``depth`` at once.  The depth is the least whose layout
    (:func:`split_layout`) fits :data:`SPLIT_SMEM_WORDS`, deepened until the
    launch has :data:`MIN_NODES` nodes; at depth 0 small rows are grouped
    up to :data:`GROUP_WORK` leaf limbs a block.  Raises where no depth
    fits: the staging terms take ``2^depth`` words twice, so a route of more
    than 18 split levels (at ``w = 32``: a smaller operand of 2^24 limbs or
    more) is refused; the widest product of the repo's paths, the u64
    product's, has 12."""
    n, h, _ = _levels(steps)
    rows0, k = B * max(n, 1), len(h)

    def fits(depth, group=1):
        return split_layout(h, depth, group)["words"] <= SPLIT_SMEM_WORDS

    depth = 0
    while depth <= k and not fits(depth):
        depth += 1
    if depth > k:
        raise ValueError(f"route_split stages no node of a route of {k} split levels "
                         f"within {SPLIT_SMEM_WORDS} words")
    while depth < k and rows0 * 3 ** depth < MIN_NODES and fits(depth + 1):
        depth += 1
    group = 1
    if depth == 0:
        group = max(1, min(-(-GROUP_WORK // (3 ** k * h[-1])), MAX_GROUP, rows0 // MIN_NODES))
        while group > 1 and not fits(0, group):
            group -= 1
    return depth, group


def _split_words(h, depth: int, group: int):
    """R1's launch as ``hm_route_split`` takes it: depth, group, base, off,
    lim, cap, words, then the input offset of each split level."""
    lay = split_layout(h, depth, group)
    return _words([depth, group, lay["base"], lay["off"], lay["lim"], lay["cap"], lay["words"],
                   *lay["inputs"]])


def ascent_group(h, rows0: int, top: int, tile: int) -> int:
    """Nodes of depth ``top`` a block of R2's ascent takes at once: where a
    tile is a node's whole subtree, as many as :data:`JOIN_TILE_WORDS` holds
    while the launch keeps :data:`MIN_NODES` groups; else 1."""
    if top + tile < len(h):
        return 1
    return max(1, min(JOIN_TILE_WORDS // (3 ** tile * 2 * h[-1]), rows0 * 3 ** top // MIN_NODES))


def ascent_layout(h, lo, top: int, tile: int, group: int) -> dict:
    """The shared memory of R2's ascent from the leaves to ``top`` in tiles
    of ``tile`` levels, as offsets in words: the ring of :data:`RING` slots
    of ``slot`` words from 0 (``3^tile`` leaf products of each of ``group``
    nodes a slot); ``lvl``, the output of each tile level from ``k-tile``
    to ``k-1``, in two buffers by turns (level ``k-1`` in the first; -1 for
    a level ``top``, which writes to device memory); ``acc``, the product
    of each level from ``top`` to the tile, written to device memory once
    complete; ``words``, all of it."""
    k = len(h)
    bottom = k - tile
    slot = _r4(group * 3 ** tile * 2 * h[-1])
    xy = [0, 0]
    for j in range(k - 1, max(bottom, top + 1) - 1, -1):
        xy[(k - 1 - j) % 2] = max(xy[(k - 1 - j) % 2], group * 3 ** (j - bottom) * lo[j])
    x = RING * slot
    y = x + _r4(xy[0])
    at = y + _r4(xy[1])
    acc = []
    for i in range(top, bottom):
        acc.append(at)
        at += _r4(lo[i])
    return dict(slot=slot, lvl=[-1 if j == top else (x, y)[(k - 1 - j) % 2] for j in range(bottom, k)],
                acc=acc, words=at)


def join_launches(B: int, steps) -> "list[tuple[int, int, int]]":
    """R2's launches for a route, in order, each ``(top, tile, group)``:
    first the ascent, ``tile > 0``: a block takes ``group`` nodes of depth
    ``top`` (:func:`ascent_group`), streams their leaf products (one run)
    in tiles of ``tile`` levels and joins them up to the nodes; then ``(i,
    0, 0)``: split level ``i`` alone, for each level above ``top``; last
    ``(-1, 0, 0)``: the chunk step's pieces.  The tile is the deepest of at
    most :data:`JOIN_TILE_WORDS`; ``top`` the least depth whose ascent
    (:func:`ascent_layout`) fits :data:`JOIN_SMEM_WORDS` and gives
    :data:`MIN_NODES` nodes (or a block one tile)."""
    n, h, lo = _levels(steps)
    k, w2, rows0 = len(h), 2 * h[-1], B * max(n, 1)
    tile0 = 1
    while tile0 < k and 3 ** (tile0 + 1) * w2 <= JOIN_TILE_WORDS:
        tile0 += 1
    launches = [(i, 0, 0) for i in range(k - 1, -1, -1)]
    for top in range(k):
        tile = min(tile0, k - top)
        group = ascent_group(h, rows0, top, tile)
        if (ascent_layout(h, lo, top, tile, group)["words"] <= JOIN_SMEM_WORDS
                and (rows0 * 3 ** top >= MIN_NODES or top >= k - tile0)):
            launches = [(top, tile, group)] + [(i, 0, 0) for i in range(top - 1, -1, -1)]
            break
    if n:
        launches.append((-1, 0, 0))
    return launches


def join_plans(B: int, steps) -> "list[list[tuple[int, int, int]]]":
    """Every plan R2 takes at a route, for the tests and the sweep: one
    launch a level, and each ascent (every ``top``, every tile below it, one
    node a block and :func:`ascent_group`'s) with the levels above it alone;
    the chunk step last where there is one.  Some ascents' layouts pass
    :data:`JOIN_SMEM_WORDS`."""
    n, h, _ = _levels(steps)
    rows0, k = B * max(n, 1), len(h)
    chunk = [(-1, 0, 0)] if n else []
    plans = [[(i, 0, 0) for i in range(k - 1, -1, -1)] + chunk]
    for top in range(k):
        for tile in range(1, k - top + 1):
            for group in sorted({1, ascent_group(h, rows0, top, tile)}):
                plans.append([(top, tile, group)] + [(i, 0, 0) for i in range(top - 1, -1, -1)]
                             + chunk)
    return plans


def _launch_words(h, lo, launch):
    """One R2 launch as ``hm_route_join`` takes it: ``(top, 0)`` for a level
    alone or the chunk step; for the ascent top, tile, group, slot, words,
    then :func:`ascent_layout`'s ``lvl`` and ``acc``."""
    top, tile, group = launch
    if not tile:
        return _words([top, 0])
    lay = ascent_layout(h, lo, top, tile, group)
    return _words([top, tile, group, lay["slot"], lay["words"], *lay["lvl"], *lay["acc"]])


def _check_route(small: torch.Tensor, big: torch.Tensor, steps) -> None:
    if small.dtype != gf2.LIMB_DTYPE or big.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"route_split takes int32 limbs, got {small.dtype} and {big.dtype}")
    if not steps or steps[-1][0] != "split":
        raise ValueError(f"route_split takes a route that ends in a split, got {steps}")
    want = (steps[0][1], steps[0][2])
    if (small.ndim != 2 or big.ndim != 2 or small.shape[0] != big.shape[0]
            or (small.shape[1], big.shape[1]) != want):
        raise ValueError(f"route_split takes [B, {want[0]}] and [B, {want[1]}], got "
                         f"{tuple(small.shape)} and {tuple(big.shape)}")
    if small.device != big.device:
        raise ValueError(f"route_split operands on {small.device} and {big.device}")
    if not (small.is_contiguous() and big.is_contiguous()):
        raise ValueError("route_split takes contiguous operands")


def route_split(small: torch.Tensor, big: torch.Tensor, steps) -> "tuple[torch.Tensor, torch.Tensor]":
    """R1's wrapper: the route's descent, ``[B, Ls]`` and ``[B, Lg]`` (the
    first step's widths) -> each operand's leaves, :func:`leaf_rows`.

    A CPU tensor gets the plain version (:func:`_split_levels`); a CUDA
    tensor launches ``hm_route_split`` once on the current stream with
    :func:`split_plan` and :func:`split_layout` (and counts the launch) or
    raises, also for a route of more than 18 split levels, whose staging
    fits no depth."""
    _check_route(small, big, steps)
    if small.device.type == "cpu":
        return _split_levels(small, big, steps)
    if small.device.type != "cuda":
        raise ValueError(f"route_split runs on cpu or cuda, not {small.device}")
    shape = leaf_rows(small.shape[0], steps)
    leaf_s = torch.empty(shape, dtype=gf2.LIMB_DTYPE, device=small.device)
    leaf_g = torch.empty(shape, dtype=gf2.LIMB_DTYPE, device=small.device)
    if small.shape[0] == 0:
        return leaf_s, leaf_g
    layout = _split_words(_levels(steps)[1], *split_plan(small.shape[0], steps))
    with torch.cuda.device(small.device):
        err = _route_kernel("hm_route_split")(
            small.data_ptr(), big.data_ptr(), leaf_s.data_ptr(), leaf_g.data_ptr(),
            _plan_words(small.shape[0], steps), layout, len(layout),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"route split kernel launch failed: cudaError {err}")
    counters.add("R1")
    return leaf_s, leaf_g


def _check_products(p: torch.Tensor, B: int, steps) -> None:
    if p.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"route_join takes int32 limbs, got {p.dtype}")
    rows, w = leaf_rows(B, steps)
    if p.ndim != 2 or tuple(p.shape) != (rows, 2 * w):
        raise ValueError(f"route_join takes [{rows}, {2 * w}] products, got {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("route_join takes contiguous products")


def route_join(p: torch.Tensor, B: int, steps) -> torch.Tensor:
    """R2's wrapper: the leaves' products ``[rows, 2w]`` (:func:`leaf_rows`)
    -> the product ``[B, Ls+Lg]`` of the route's first step.

    A CPU tensor gets the plain version (:func:`_join_levels`); a CUDA
    tensor launches ``hm_route_join`` once for each of
    :func:`join_launches` on the current stream (and counts each launch)
    or raises."""
    _check_products(p, B, steps)
    if p.device.type == "cpu":
        return _join_levels(p, B, steps)
    return _route_join(p, B, steps, join_launches(B, steps))


def _route_join(p: torch.Tensor, B: int, steps, launches) -> torch.Tensor:
    """:func:`route_join` on the card through the given launches (the
    card tests also give other plans than :func:`join_launches`)."""
    if p.device.type != "cuda":
        raise ValueError(f"route_join runs on cpu or cuda, not {p.device}")
    n, h, lo = _levels(steps)
    if B == 0:
        return p.new_empty((0, steps[0][1] + steps[0][2]))
    words = _plan_words(B, steps)
    rows0 = B * max(n, 1)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launches:
            top = launch[0]
            shape = (B, steps[0][1] + steps[0][2]) if top < 0 else (rows0 * 3 ** top, lo[top])
            out = torch.empty(shape, dtype=gf2.LIMB_DTYPE, device=p.device)
            spec = _launch_words(h, lo, launch)
            err = _route_kernel("hm_route_join")(p.data_ptr(), out.data_ptr(), words, spec,
                                                 len(spec), stream)
            if err:
                raise RuntimeError(f"route join kernel launch failed: cudaError {err}")
            counters.add("R2")
            p = out
    return p


def route_split_plain(small: torch.Tensor, big: torch.Tensor, steps,
                      depth: "int | None" = None) -> "tuple[torch.Tensor, torch.Tensor]":
    """R1's design in torch: every node at ``depth`` (default: the launch's,
    :func:`split_plan`; ``len(h)``: every leaf) staged from its row, then
    split level by level below it.  Node ``r0 * 3^D + t_1 3^(D-1) + ... +
    t_D`` has, for each choice ``c_i`` of the levels above it (0 for digit
    0, 1 for digit 1, either for digit 2), the term of the row's limbs from
    ``sum c_i h_i`` (past the piece's start), read below ``lim``: the least,
    over the levels, of the real width of the node there less the offset
    still to add below it (``W' = min(W, h)`` for digits 0 and 2,
    ``clamp(W - h, 0, h)`` for 1), and the node's own real width.  The
    same leaves as :func:`_split_levels`, limb for limb; no path calls it."""
    n, h, _ = _levels(steps)
    B, Ls = small.shape
    Lg, nn, k = big.shape[1], max(n, 1), len(h)
    D = split_plan(B, steps)[0] if depth is None else depth
    dev = small.device
    node = torch.arange(B * nn * 3 ** D, device=dev)
    r0, v = node // 3 ** D, node % 3 ** D
    b, j = r0 // nn, r0 % nn
    digits = [(v // 3 ** (D - 1 - i)) % 3 for i in range(D)]
    u = torch.arange(2 * h[D] if D < k else h[-1], device=dev)
    out = []
    for x, chunked in ((small, False), (big, n > 0)):
        L = x.shape[1]
        base = b * L + (j * Ls if chunked else 0)
        widths = [(Lg - j * Ls).clamp(max=Ls) if chunked else torch.full_like(j, L)]
        for t, hh in zip(digits, h):
            W = widths[-1]
            widths.append(torch.where(t == 1, (W - hh).clamp(0, hh), W.clamp(max=hh)))
        acc = torch.zeros((node.numel(), u.numel()), dtype=x.dtype, device=dev)
        flat = x.reshape(-1)
        for choice in range(2 ** D):
            ok, off, lim = torch.ones_like(node, dtype=torch.bool), 0, widths[D]
            for i in reversed(range(D)):
                c = (choice >> i) & 1
                ok &= (digits[i] == 2) | (digits[i] == c)
                off += c * h[i]
                lim = torch.minimum(lim, widths[i] - off)
            read = ok[:, None] & (u[None, :] < lim[:, None])
            idx = (base + off)[:, None] + u[None, :]
            vals = flat[idx.clamp(0, flat.numel() - 1)]
            acc ^= torch.where(read, vals, torch.zeros_like(vals))
        for hh in h[D:]:
            acc = _halves(acc, hh)
        out.append(acc)
    return out[0], out[1]


def _shifted(x: torch.Tensor, shift: int, lo: int) -> torch.Tensor:
    """``x X^shift`` truncated to ``lo`` limbs (last axis)."""
    t = torch.arange(lo, device=x.device) - shift
    ok = (t >= 0) & (t < x.shape[-1])
    vals = x[..., t.clamp(0, x.shape[-1] - 1)]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _join_terms(p0: torch.Tensor, p2: torch.Tensor, pm: torch.Tensor, h: int, lo: int) -> torch.Tensor:
    """R2's formula on products of ``2h`` limbs (last axis): ``out[t] =
    p0[t] ^ p0[t-h] ^ pm[t-h] ^ p2[t-h] ^ p2[t-2h]`` for ``t < lo``, each
    term zero outside its row."""
    return (_shifted(p0, 0, lo) ^ _shifted(p0, h, lo) ^ _shifted(pm, h, lo)
            ^ _shifted(p2, h, lo) ^ _shifted(p2, 2 * h, lo))


def _accumulate(acc: "torch.Tensor | None", c: torch.Tensor, t: int, h: int, lo: int) -> torch.Tensor:
    """R2's ascent: child ``t`` (0: ``p0``, 1: ``p2``, 2: ``pm``; ``2h``
    limbs) into its node's product (``lo`` limbs), which child 0 starts:
    ``p0`` at shifts 0 and ``h``, ``p2`` at ``h`` and ``2h``, ``pm`` at ``h``."""
    shifts = ((0, h), (h, 2 * h), (h,))[t]
    part = _shifted(c, shifts[0], lo)
    for s in shifts[1:]:
        part = part ^ _shifted(c, s, lo)
    return part if t == 0 else acc ^ part


def join_pieces_plain(p: torch.Tensor, B: int, Ls: int, Lg: int, n: int) -> torch.Tensor:
    """R2's chunk formula: ``out[t] = piece[t/Ls][t%Ls] ^ piece[t/Ls -
    1][Ls + t%Ls]`` (terms outside the pieces zero), [B*n, 2Ls] -> [B, Ls+Lg]."""
    pieces = p.view(B, n, 2 * Ls)
    t = torch.arange(Ls + Lg, device=p.device)
    j, q = t // Ls, t % Ls
    a = pieces[:, j.clamp(max=n - 1), q]
    c = pieces[:, (j - 1).clamp(0, n - 1), Ls + q]
    zero = torch.zeros_like(a)
    return torch.where(j < n, a, zero) ^ torch.where(j >= 1, c, zero)


def _ascent_plain(p: torch.Tensor, rows0: int, h, lo, top: int, tile: int) -> torch.Tensor:
    """R2's ascent in its order: for all nodes of depth ``top`` at once,
    tile after tile of each node's run (``3^tile`` leaf products), the
    tile's levels joined by formula, then its product accumulated up the
    levels above it (:func:`_accumulate`), a level's product going up when
    its third child is in."""
    k = len(h)
    nodes, tiles = rows0 * 3 ** top, 3 ** (k - top - tile)
    run = p.view(nodes, tiles, 3 ** tile, 2 * h[-1])
    accs: dict = {}
    for u in range(tiles):
        cur = run[:, u]
        for j in range(k - 1, k - tile - 1, -1):
            c = cur.reshape(nodes, -1, 3, 2 * h[j])
            cur = _join_terms(c[:, :, 0], c[:, :, 1], c[:, :, 2], h[j], lo[j])
        child, v = cur[:, 0], u
        for i in range(k - tile - 1, top - 1, -1):
            t, v = v % 3, v // 3
            accs[i] = child = _accumulate(accs.get(i), child, t, h[i], lo[i])
            if t != 2:
                break
    return child if top == k - tile else accs[top]


def route_join_plain(p: torch.Tensor, B: int, steps, launches=None) -> torch.Tensor:
    """R2's launches (default :func:`join_launches`) in torch, each in its
    own order: the ascent by :func:`_ascent_plain`, a level alone and the
    chunk step by their formulas on whole rows.  The same product as
    :func:`_join_levels`; no path calls it."""
    n, h, lo = _levels(steps)
    rows0 = B * max(n, 1)
    for top, tile, *_ in join_launches(B, steps) if launches is None else launches:
        if top < 0:
            p = join_pieces_plain(p, B, steps[0][1], steps[0][2], n)
        elif tile:
            p = _ascent_plain(p, rows0, h, lo, top, tile)
        else:
            c = p.view(rows0 * 3 ** top, 3, 2 * h[top])
            p = _join_terms(c[:, 0], c[:, 1], c[:, 2], h[top], lo[top])
    return p


def clmul_plain(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: flat [B, La] x [B, Lb] -> [B, La+Lb],
    the 32-plane sweep chunked over the rows (:func:`~homomorph_tpu_torch.
    gf2.poly.clmul_chunked`)."""
    return gf2.clmul_chunked(af, bf, cap=_PLAIN_ELEM_CAP)


def _funnel_l(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """CUDA's ``__funnelshift_l(lo, hi, n)`` for a static 0 <= n < 32: the
    high word of ``(hi:lo) << n``."""
    return hi if n == 0 else (hi << n) | gf2.srl(lo, gf2.LIMB_BITS - n)


def clmul_comb_plain(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The kernel's comb in torch: flat [B, La] x [B, Lb] -> [B, La+Lb].

    Builds the 16 multiples ``T[u] = u*g`` ([B, 16, Lg+1]) of the wider
    operand ``g`` from ``g, 2g, 4g, 8g``, then for each limb ``i`` and
    nibble ``w`` of the smaller operand XORs ``funnel_l(T[nib][j-1],
    T[nib][j], 4w)`` into output limb ``i + j``, as ``csrc/clmul.cu`` does
    for each of its threads."""
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    B, Ls = small.shape
    Lg = big.shape[1]
    gp = F.pad(big, (1, 1))  # gp[:, j + 1] = g[j] for j = -1 .. Lg
    t1 = gp[:, 1:]
    t2, t4, t8 = (_funnel_l(gp[:, :-1], gp[:, 1:], n) for n in (1, 2, 3))
    T = torch.zeros((B, 16, Lg + 1), dtype=gf2.LIMB_DTYPE, device=af.device)
    for u in range(1, 16):
        for bit, t in ((1, t1), (2, t2), (4, t4), (8, t8)):
            if u & bit:
                T[:, u] ^= t
    Tp = F.pad(T, (1, 1))  # Tp[:, u, j + 1] = T[u][j] for j = -1 .. Lg + 1
    rows = torch.arange(B, device=af.device)
    out = torch.zeros((B, Ls + Lg + 1), dtype=gf2.LIMB_DTYPE, device=af.device)
    for i in range(Ls):
        for w in range(8):
            Tn = Tp[rows, (gf2.srl(small[:, i], 4 * w) & 15).long()]  # [B, Lg + 3]
            out[:, i : i + Lg + 2] ^= _funnel_l(Tn[:, :-1], Tn[:, 1:], 4 * w)
    return out[:, : Ls + Lg].contiguous()  # limb Ls+Lg only ever gets zeros


#: ``csrc/clmul.cu``'s ``SQUARE_COLUMNS``: the first width of each run of
#: widths and the columns ``k`` a lane of the square path owns there (a card
#: test holds the two equal at every width)
SQUARE_COLUMNS = ((1, 1), (9, 3), (10, 1), (13, 3), (17, 5), (19, 3), (29, 5), (33, 3), (35, 5),
                  (39, 3), (41, 5), (44, 3), (47, 5), (49, 3), (56, 5), (59, 3), (62, 5), (64, 3),
                  (65, 5))
#: the ``k`` the square path has an instance of: odd, so a warp's lanes
#: read at an odd stride
SQUARE_KS = (1, 3, 5)


def square_layout(L: int, columns: "int | None" = None) -> "tuple[int, int, int, int, int]":
    """The square path's block layout at ``L`` limbs, as ``csrc/clmul.cu``'s
    ``square_plan`` makes it: ``(rows, row_words, nib_words, s_words, k)``,
    the rows a block (the fewest idle lanes in the last warp, a row, within
    1,024 threads and, past one row, 113 KB), a row's window in one
    multiple (``k`` times the row's ``ceil((L + 2) / k)`` lanes, mod 32), a
    multiple's stride (a multiple of 32), a row's limbs of the smaller
    operand (odd) and the columns a lane: ``columns``, or by default the
    width's ``k`` in :data:`SQUARE_COLUMNS`."""
    K = [k for L0, k in SQUARE_COLUMNS if L >= L0][-1] if columns is None else columns
    if K not in SQUARE_KS:
        raise ValueError(f"the square path takes {SQUARE_KS} columns a lane, not {K}")
    Q = -(-(L + 2) // K)  # lanes a row
    row_words = K * Q + 32 * -(-L // 32)
    s_words = L | 1
    best = None
    for rows in range(1, 1024 // Q + 1):
        nib_words = -(-rows * row_words // 32) * 32
        if rows > 1 and (16 * nib_words + rows * s_words) * 4 > 113 * 1024:
            break
        spare = -(-rows * Q // 32) * 32 - rows * Q
        if best is None or spare * best[0] < best[1] * rows:
            best = (rows, spare, nib_words)
    return best[0], row_words, best[2], s_words, K


def clmul_square_plain(af: torch.Tensor, bf: torch.Tensor, columns: "int | None" = None) -> torch.Tensor:
    """The square path's comb in torch: flat [B, L] x [B, L] -> [B, 2L],
    walked as ``csrc/clmul.cu``'s ``clmul_comb_kernel_square<k>`` walks it.

    Each block's shared memory is a flat tensor laid out by
    :func:`square_layout` (``columns`` as there); thread ``(r, l)`` of a
    block (row ``r``, lane ``l``) owns the ``k`` columns ``t0 = k l`` ..
    ``t0 + k - 1`` of the row's ``L + 2`` (columns past them are the last
    lane's spare), stages each column ``t`` of the 16 multiples at positions
    ``L + t`` and, for ``t >= 2``, ``t - 2``, then at each step ``i`` and
    nibble reads the ``k + 1`` words from position ``t0 - i + L - 1`` on
    (:func:`square_addresses`), adding into output limb ``t`` until
    ``i == t`` and into limb ``t + L + 2`` after."""
    B, L = af.shape
    if bf.shape != af.shape:
        raise ValueError(f"the square path takes [B, L] x [B, L], got {tuple(af.shape)} and {tuple(bf.shape)}")
    rows, row_words, nib_words, s_words, K = square_layout(L, columns)
    P = L + 2
    Q = -(-P // K)
    blocks = -(-B // rows)
    dev = af.device
    pad = (0, 0, 0, blocks * rows - B)
    s = F.pad(af, pad).view(blocks, rows, L)
    g = F.pad(bf, pad).view(blocks, rows, L)
    tid = torch.arange(rows * Q, device=dev)
    r, t0 = tid // Q, tid % Q * K
    sh = torch.zeros((blocks, 16 * nib_words + rows * s_words), dtype=gf2.LIMB_DTYPE, device=dev)
    gp = F.pad(g, (1, K * Q - L))  # gp[..., j + 1] = g[j] for j = -1 .. K Q - 1
    u = torch.arange(16, device=dev)[:, None]
    for c in range(K):
        t = t0 + c
        staged = t < P
        g0, g1 = gp[:, r, t], gp[:, r, t + 1]  # g[t - 1], g[t]
        t2, t4, t8 = (_funnel_l(g0, g1, n) for n in (1, 2, 3))
        for bit, mult in ((1, g1), (2, t2), (4, t4), (8, t8)):
            m = torch.where((u & bit) != 0, mult[:, None, :], 0)  # [blocks, 16, threads]
            at = r * row_words + u * nib_words
            sh[:, (at + L + t)[:, staged]] ^= m[:, :, staged]
            twice = staged & (t >= 2)  # columns 2 .. L + 1 have a second copy
            sh[:, (at + t - 2)[:, twice]] ^= m[:, :, twice]
        lanes = t < L
        sh[:, 16 * nib_words + r[lanes] * s_words + t[lanes]] = s[:, r[lanes], t[lanes]]

    acc = torch.zeros((K, blocks, rows * Q), dtype=gf2.LIMB_DTYPE, device=dev)
    low = torch.zeros_like(acc)
    for i in range(L):
        si = sh[:, 16 * nib_words + r * s_words + i]
        for w in range(8):
            at = square_addresses(L, r, t0, i, gf2.srl(si, 4 * w) & 15, nib_words, row_words)
            v = [sh.gather(1, at + c - 1) for c in range(K + 1)]
            for c in range(K):
                acc[c] ^= v[c + 1] if w == 0 else _funnel_l(v[c], v[c + 1], 4 * w)
        for c in range(K):
            low[c] = torch.where(t0 + c == i, acc[c], low[c])

    out = torch.zeros((blocks, rows, 2 * L), dtype=gf2.LIMB_DTYPE, device=dev)
    for c in range(K):
        t = t0 + c
        lanes = t < L
        out[:, r[lanes], t[lanes]] = low[c][:, lanes]
        top = lanes & (t + P < 2 * L)
        out[:, r[top], t[top] + P] = (acc[c] ^ low[c])[:, top]
        mid = (t >= L) & (t < P) & (t < 2 * L)
        out[:, r[mid], t[mid]] = acc[c][:, mid]
    return out.view(blocks * rows, 2 * L)[:B].contiguous()


def square_addresses(L: int, r, t0, i: int, nib, nib_words: int, row_words: int):
    """The shared-memory word at which thread ``(r, l)`` of the square path,
    whose first column is ``t0``, reads at step ``i`` for a nibble ``nib``:
    multiple ``nib``'s window of row ``r``, position ``t0 - i + L``.  Its
    column ``t0 + c`` funnels the words at ``c - 1`` and ``c`` from there, so
    a nibble's ``k + 1`` loads are the words ``-1 .. k - 1`` from it."""
    return nib.long() * nib_words + r * row_words + t0 - i + L


def _check(af: torch.Tensor, bf: torch.Tensor) -> None:
    if af.dtype != gf2.LIMB_DTYPE or bf.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"clmul takes int32 limbs, got {af.dtype} and {bf.dtype}")
    if af.ndim != 2 or bf.ndim != 2 or af.shape[0] != bf.shape[0]:
        raise ValueError(f"clmul takes [B, La] and [B, Lb], got {tuple(af.shape)} and {tuple(bf.shape)}")
    if af.shape[1] == 0 or bf.shape[1] == 0:
        raise ValueError("clmul operands need at least one limb")
    if af.device != bf.device:
        raise ValueError(f"clmul operands on {af.device} and {bf.device}")
    if not (af.is_contiguous() and bf.is_contiguous()):
        raise ValueError("clmul takes contiguous operands")


def clmul_flat(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: flat [B, La] x [B, Lb] -> [B, La+Lb] int32.

    A CPU tensor gets :func:`clmul_plain`; a CUDA tensor launches the
    kernel on the current stream (and counts the launch as ``K1``, as
    ``K1.square`` too where it takes the square path, and as
    ``K1.square.tiled`` as well where that path's lanes own more than one
    output column) or raises.  A
    tensor on PyTorch's ``meta`` device gets an empty output of the
    product's shape and counts nothing: the compiled pipelines read an
    operation's output metadata that way, with no device work."""
    _check(af, bf)
    if af.device.type == "cpu":
        return clmul_plain(af, bf)
    if af.device.type == "meta":
        return torch.empty((af.shape[0], af.shape[1] + bf.shape[1]), dtype=gf2.LIMB_DTYPE,
                           device="meta")
    if af.device.type != "cuda":
        raise ValueError(f"clmul runs on cpu, cuda or meta, not {af.device}")
    B = af.shape[0]
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    out = torch.empty((B, af.shape[1] + bf.shape[1]), dtype=gf2.LIMB_DTYPE, device=af.device)
    if B == 0:
        return out
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().hm_clmul(
            small.data_ptr(), big.data_ptr(), out.data_ptr(),
            B, small.shape[1], big.shape[1], stream,
        )
    if err:
        raise RuntimeError(f"clmul kernel launch failed: cudaError {err}")
    counters.add("K1")
    columns = square_columns(small.shape[1], big.shape[1])
    if columns:
        counters.add("K1.square")
        if columns > 1:
            counters.add("K1.square.tiled")
    return out


def clmul_mapping(af: torch.Tensor, bf: torch.Tensor, square: bool,
                  columns: "int | None" = None) -> torch.Tensor:
    """K1 through one thread mapping, named: the square path (``square``:
    any ``La == Lb`` up to the kernel's ``SQUARE_MAX``; ``columns`` a lane,
    one of :data:`SQUARE_KS`, or by default the width's ``k``) or the comb
    of unbalanced products, on CUDA tensors, whatever :func:`clmul_flat`
    would take.  It counts no launch: the crossover and ``k`` measurements
    and the card tests call it; no path does."""
    _check(af, bf)
    if af.device.type != "cuda":
        raise ValueError(f"clmul_mapping launches on cuda, not {af.device}")
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    out = torch.empty((af.shape[0], af.shape[1] + bf.shape[1]), dtype=gf2.LIMB_DTYPE,
                      device=af.device)
    with torch.cuda.device(af.device):
        err = _kernel().hm_clmul_mapping(
            small.data_ptr(), big.data_ptr(), out.data_ptr(), af.shape[0], small.shape[1],
            big.shape[1], int(square), columns or 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"clmul kernel launch failed: cudaError {err}")
    return out

