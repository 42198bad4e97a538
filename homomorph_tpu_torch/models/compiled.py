"""Compiled homomorphic pipelines for serving: one CUDA graph replay per call.

Counterpart of :mod:`homomorph_tpu.models.compiled`, which closes an
operation (or a whole encrypt -> op -> decrypt chain) over static shapes
and jits it into one XLA program, so that a call pays one device dispatch
whatever the circuit's depth.  The port's counterpart of that program is a
CUDA graph: the circuit library issues hundreds of kernels from Python (a
u32 product's route levels and circuit ops), and a replay issues them all
at once.

On CUDA tensors a compiled callable captures one ``torch.cuda.CUDAGraph``
per input shape, after one eager warm-up on a side stream (the warm-up
builds the kernels, runs K2's ``cudaFuncSetAttribute``, fills the caching
allocator and the key's cached planes and masks).  A call copies its
inputs into the graph's static buffers, replays the graph and returns a
clone of the static output.  A capture that fails raises; a call never
falls back to eager on the card.  Graphs exist only on the card: on CPU
tensors (as in the tests) the callable runs the operation eagerly.

The output's metadata (``bound``, ``noise``, ``zero_lanes``, ``desc``)
comes from running the operation on tensors of PyTorch's ``meta`` device,
the counterpart of ``jax.eval_shape``: shapes only, no device work (the
clmul wrapper returns an empty product there and counts no launch).

Two things a graph cannot hold, and what happens to them:

* scalar kernel arguments are baked in at capture, so T1's key would be
  the capture key at every replay: :func:`compile_roundtrip` draws its
  selection words through T1's device-key entry
  (:func:`~homomorph_tpu_torch.prng.random_bits_device_key`) and writes the
  call's split keys into the buffer it reads before each replay;
* the routing knobs (``HOMOMORPH_TPU_TORCH_KARATSUBA_MIN``,
  ``HOMOMORPH_TPU_TORCH_FORCE_KARATSUBA`` and
  ``HOMOMORPH_TPU_TORCH_ENC_IMPL``) and the limb mesh registered with
  :func:`~homomorph_tpu_torch.parallel.limbmul.set_default_limb_mesh` are
  read when a graph is captured, and a replay keeps the route, kernel and
  limb sharding it was captured with, as the JAX package's knobs and its
  limb-mesh registry are snapshots taken when a function is traced
  (``homomorph_tpu/parallel/limbmul.py:63-71``).  Set them before the
  first call of a shape.

What a call counts (:data:`~homomorph_tpu_torch.utils.profiling.counters`):
the warm-up's launches count as eager calls'; a capture launches nothing,
so what is counted while a graph is captured is set aside as the graph's
manifest, what one replay launches of each hand-written kernel, and each
replay adds the manifest to the counters.  Each call is a span,
``compiled.call``, whose record carries ``launches``: every node of the
replayed graph that runs work on the card (:func:`graph_launches`; torch's
kernels and copies as well as the port's), read from the driver at
capture, and, where the graph copies a broadcast operand, ``expand_limbs``:
the manifest's ``clmul.expand``, the limbs a replay writes for it.  Its
inner spans are ``graph.copy_in``, ``graph.replay`` and ``graph.clone``
(``graph.capture`` at a capture), and after each replay a device span of
every :func:`~homomorph_tpu_torch.utils.profiling.device_region` the
capture recorded (the comparator's ``circuit.lt_tree`` and the mux's
``circuit.select``), with the card's milliseconds between its two timing
events; the round trip's add
``roundtrip.bits_in`` (the host arrays' copies to the card),
``roundtrip.keys`` and ``roundtrip.mask`` (the first shape's mask), and
``roundtrip.decrypt``, the card's time of the decrypt stage between two
CUDA events the graph records.

The reference has no such layer (every op is a direct function call,
src/context.rs:496-546).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import codec as _codec
from .. import prng as _prng
from .. import rng as _rng
from ..cipher import FRESH_NOISE, Ciphered
from ..context import Context
from ..gf2 import poly as gf2
from ..gf2.encrypt_kernel import encrypt_bits_fused
from ..utils import profiling
from ..utils.profiling import span

__all__ = ["compile_op2", "compile_op1", "compile_roundtrip", "Graphed"]


def _derive_meta(apply_fn, bound: int, desc, *shapes, noise: int = FRESH_NOISE) -> dict:
    """Output metadata of an operation on fresh-layout operands of
    ``shapes``, from one run on ``meta`` tensors (no device work)."""
    args = [
        Ciphered(torch.empty(shape, dtype=gf2.LIMB_DTYPE, device="meta"), bound, desc,
                 noise=noise)
        for shape in shapes
    ]
    out = apply_fn(*args)
    return dict(bound=out.bound, zero_lanes=out.zero_lanes, desc=out.desc, noise=out.noise,
                shape=tuple(out.limbs.shape))


#: ``CUgraphNodeType`` values (``cuda.h``) of the nodes that run work on
#: the card: kernels, copies and sets
_WORK_NODES = (0, 1, 2)


def graph_launches(graph: "torch.cuda.CUDAGraph") -> int:
    """The nodes of a captured graph (``keep_graph=True``) that run work on
    the card, torch's kernels and copies among them: what one replay
    launches.  Read from the CUDA driver (``cuGraphGetNodes``)."""
    import ctypes

    driver = ctypes.CDLL("libcuda.so.1")

    def check(err):
        if err:
            raise RuntimeError(f"reading a CUDA graph's nodes failed: CUresult {err}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(driver.cuGraphGetNodes(raw, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(driver.cuGraphGetNodes(raw, nodes, ctypes.byref(n)))
    kind = ctypes.c_int(-1)
    count = 0
    for node in nodes:
        check(driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        count += kind.value in _WORK_NODES
    return count


class Graphed:
    """``fn(*tensors) -> tensor`` with one CUDA graph per input shape on the
    card, and eager on the CPU."""

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self._name = name
        self._graphs: dict = {}

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        dev = inputs[0].device
        if dev.type != "cuda":
            return self._fn(*inputs)
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(inputs, dev)
        graph, static_in, static_out, manifest, launches, regions = entry
        if regions:
            profiling.settle()  # the last replay's events are recorded again now
        with span("graph.copy_in"):
            for buf, x in zip(static_in, inputs):
                buf.copy_(x)
        with span("graph.replay"):
            graph.replay()
        profiling.counters.replay(manifest)
        profiling.annotate("launches", launches)
        if "clmul.expand" in manifest:
            profiling.annotate("expand_limbs", manifest["clmul.expand"])
        for name, events in regions:
            profiling.device_span(name, *events)
        with span("graph.clone"):
            return static_out.clone()

    def _capture(self, inputs, dev: torch.device):
        with span("graph.capture"), torch.cuda.device(dev):
            static_in = [x.detach().clone() for x in inputs]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn(*static_in)  # warm-up: builds, attributes, allocator
            torch.cuda.current_stream().wait_stream(side)
            # kept to count its nodes, then instantiated here, not at the
            # first replay
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with profiling.counters.aside() as captured, profiling.regions() as regions, \
                        torch.cuda.graph(graph):
                    static_out = self._fn(*static_in)
            except RuntimeError as err:
                raise RuntimeError(f"CUDA graph capture of {self._name} failed: {err}") from err
            graph.instantiate()
        return graph, static_in, static_out, captured, graph_launches(graph), regions

    @property
    def manifests(self) -> "list[dict[str, int]]":
        """What one replay counts, for each graph captured so far."""
        return [dict(entry[3]) for entry in self._graphs.values()]

    @property
    def launches(self) -> "list[int]":
        """What one replay launches on the card, for each graph captured so
        far (:func:`graph_launches`)."""
        return [entry[4] for entry in self._graphs.values()]

    @property
    def graphs(self) -> int:
        """Number of graphs captured so far (one per input shape)."""
        return len(self._graphs)


def _noise_check(noise: int, *operands: Ciphered) -> None:
    # the compiled callable is specialized on the declared operand noise;
    # noisier operands would get an understated output stamp, silently
    # weakening the checked envelope downstream
    worst = max(c.noise for c in operands)
    if worst > noise:
        got = ", ".join(str(c.noise) for c in operands)
        raise ValueError(
            f"operand noise ({got}) exceeds the compiled declaration "
            f"({noise}); recompile with noise={worst}"
        )


def _stamp(limbs: torch.Tensor, meta: dict) -> Ciphered:
    # re-attach the derived metadata: comparison/equality ops return the
    # slim Ciphered[Bool] layout (zero_lanes=7) and a Bool desc; the noise
    # bound keeps the checked API sound downstream
    return Ciphered(limbs, meta["bound"], meta["desc"], zero_lanes=meta["zero_lanes"],
                    noise=meta["noise"])


def compile_op2(
    op, desc: _codec.TypeDescriptor, bound: int, noise: int = FRESH_NOISE
) -> Callable[[Ciphered, Ciphered], Ciphered]:
    """Compile a binary operation into one CUDA graph per operand shape.

    ``bound`` is the operands' degree bound (``params.pk_degree`` for
    fresh ciphertexts) and ``noise`` their tracked noise bound (fresh by
    default; pass the composed value when the pipeline consumes circuit
    outputs).  Noisier operands are refused.
    """
    out_meta: dict = {}

    def run(a_limbs, b_limbs):
        a = Ciphered(a_limbs, bound, desc, noise=noise)
        b = Ciphered(b_limbs, bound, desc, noise=noise)
        return op.unsafe_apply(a, b).limbs

    graphed = Graphed(run, getattr(op, "__name__", "op"))

    def call(a: Ciphered, b: Ciphered) -> Ciphered:
        with span("compiled.call"):
            _noise_check(noise, a, b)
            if not out_meta:
                out_meta.update(_derive_meta(op.unsafe_apply, bound, desc, a.limbs.shape,
                                             b.limbs.shape, noise=noise))
            return _stamp(graphed(a.limbs, b.limbs), out_meta)

    call.graphed = graphed
    return call


def compile_op1(
    op, desc: _codec.TypeDescriptor, bound: int, noise: int = FRESH_NOISE
) -> Callable[[Ciphered], Ciphered]:
    """Compile a unary operation (see :func:`compile_op2`)."""
    out_meta: dict = {}

    def run(a_limbs):
        return op.unsafe_apply(Ciphered(a_limbs, bound, desc, noise=noise)).limbs

    graphed = Graphed(run, getattr(op, "__name__", "op"))

    def call(a: Ciphered) -> Ciphered:
        with span("compiled.call"):
            _noise_check(noise, a)
            if not out_meta:
                out_meta.update(_derive_meta(op.unsafe_apply, bound, desc, a.limbs.shape,
                                             noise=noise))
            return _stamp(graphed(a.limbs), out_meta)

    call.graphed = graphed
    return call


def _bits_tensor(bits, dev: torch.device) -> torch.Tensor:
    """Plaintext bits (numpy or torch, any integer type, 0/1) -> int32 on ``dev``."""
    if isinstance(bits, torch.Tensor):
        return bits.to(device=dev, dtype=gf2.LIMB_DTYPE).contiguous()
    return torch.from_numpy(np.ascontiguousarray(bits, dtype=np.int32)).to(dev)


def compile_roundtrip(ctx: Context, op, desc: _codec.TypeDescriptor) -> Callable:
    """Compile encrypt(a), encrypt(b) -> op -> decrypt-bits as ONE graph.

    Returns ``f(key, bits_a, bits_b) -> plain_bits``: ``key`` is a threefry
    key (:func:`~homomorph_tpu_torch.rng.threefry_key`), ``bits_*`` are
    [batch, n_bits] plaintext bits, and the result is the decrypted output
    bits of ``op`` as an int32 tensor on the context's device, the implicit
    zero lanes of a slim Bool result included.  The host splits ``key``
    (:func:`~homomorph_tpu_torch.rng.threefry_split`, as the JAX package
    splits inside its jit); T1 draws the selection words under the halves,
    the encrypt kernel encrypts (K2, or K3 under
    ``HOMOMORPH_TPU_TORCH_ENC_IMPL=pallas_v1``), the op runs and the key's
    decrypt mask (computed before capture) decrypts.  Keys must already be
    generated on ``ctx``.
    """
    pk = ctx.get_public_key()
    sk = ctx.get_secret_key()
    if pk is None or sk is None:
        raise ValueError("context needs both keys")
    params = ctx.parameters
    if desc.is_fixed_size:
        # validate with the statically-known operand width so width-aware
        # requirements (requirement_for) apply, not the blanket constant
        class _Lanes:
            noise = FRESH_NOISE  # compile_roundtrip encrypts fresh inputs

            def __len__(self):
                return desc.num_bits

        ctx.validate_operation(op, _Lanes(), _Lanes())
    else:
        ctx.validate_operation(op)
    bound = pk.max_degree
    L = gf2.limbs_for(bound)
    W = -(-params.tau // 32)
    dev = pk.device
    # input shapes -> (decrypt mask, zero lanes, the decrypt's two timing
    # events on the card or None)
    masks: dict = {}

    def encrypt(key: torch.Tensor, bits: torch.Tensor) -> Ciphered:
        total = bits.numel()
        selw = _prng.random_bits_device_key(key, (total, W))
        limbs = encrypt_bits_fused(selw, pk.limbs, bits.reshape(total), L, planes=pk.planes)
        return Ciphered(limbs.reshape(tuple(bits.shape) + (L,)), bound, desc)

    def run(keys, bits_a, bits_b):
        out = op.unsafe_apply(encrypt(keys[0], bits_a), encrypt(keys[1], bits_b))
        w, zero_lanes, events = masks[(tuple(bits_a.shape), tuple(bits_b.shape))]
        if events is not None:
            events[0].record()
        bits = gf2.decipher_bits(out.limbs, w)
        if zero_lanes:  # slim bool layout: implicit lanes decrypt to 0
            bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (zero_lanes,))], dim=-1)
        if events is not None:
            events[1].record()
        return bits

    graphed = Graphed(run, f"roundtrip of {getattr(op, '__name__', 'op')}")

    def call(key, bits_a, bits_b) -> torch.Tensor:
        with span("compiled.call"):
            with span("roundtrip.bits_in"):
                ba, bb = _bits_tensor(bits_a, dev), _bits_tensor(bits_b, dev)
            shapes = (tuple(ba.shape), tuple(bb.shape))
            if shapes not in masks:
                with span("roundtrip.mask"):
                    meta = _derive_meta(op.unsafe_apply, bound, desc, shapes[0] + (L,),
                                        shapes[1] + (L,))
                    # recorded in the graph (external: a node of their own),
                    # whether or not tracing is on when it is captured
                    events = (tuple(torch.cuda.Event(enable_timing=True, external=True)
                                    for _ in range(2)) if dev.type == "cuda" else None)
                    masks[shapes] = (sk.decrypt_mask(meta["shape"][-1]), meta["zero_lanes"],
                                     events)
            with span("roundtrip.keys"):
                ka, kb = _rng.threefry_split(key)
                keys = torch.stack([_prng.key_words(ka), _prng.key_words(kb)]).to(dev)
            profiling.settle()  # the last replay's events are recorded again now
            out = graphed(keys, ba, bb)
            events = masks[shapes][2]
            if events is not None:
                profiling.device_span("roundtrip.decrypt", *events)
            return out

    call.graphed = graphed
    return call
