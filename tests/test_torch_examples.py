"""The port's examples, structs and variable-length plaintexts, on the CPU.

Each module of ``homomorph_tpu_torch/examples`` (one per script of
``examples/``) runs its ``main(device="cpu")``, which ends in the script's
asserts.  Beside them, the cases of ``tests/test_structs.py`` and the round
trips of ``tests/test_codec_varlen.py::TestCipheredVarlen`` run through both
packages from the same recorded key and encryption stream
(``ThreefrySource``): ciphertext wire bytes and decrypted values must be
identical (integer data, tolerance 0).
"""

import dataclasses
import importlib
import pkgutil

import numpy as np
import pytest

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
import homomorph_tpu_torch.examples as texamples
from homomorph_tpu import codec as jcodec
from homomorph_tpu.models import circuits as jcircuits
from homomorph_tpu_torch import codec as tcodec
from homomorph_tpu_torch.models import circuits as tcircuits

EXAMPLES = sorted(m.name for m in pkgutil.iter_modules(texamples.__path__))


def test_every_script_has_its_port():
    import pathlib

    scripts = sorted(p.stem for p in (pathlib.Path(__file__).parent.parent / "examples").glob("*.py"))
    assert EXAMPLES == scripts


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_on_cpu(name, capsys):
    importlib.import_module(f"homomorph_tpu_torch.examples.{name}").main(device="cpu")
    assert capsys.readouterr().out.strip()


def pair(params, seed):
    """The same keys and recorded encryption stream in both packages."""
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(seed))
    tctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(seed), device="cpu")
    for ctx in (jctx, tctx):
        ctx.generate_secret_key()
        ctx.generate_public_key()
    return jctx, tctx


def same_bytes(tc, jc):
    assert tc.to_bytes() == jc.to_bytes()


# -- structs (tests/test_structs.py) ------------------------------------------


@dataclasses.dataclass
class Vec3:
    x: np.uint16
    y: np.uint16
    z: np.uint16


@dataclasses.dataclass
class Unbalanced:
    x: np.uint8
    y: np.uint64
    z: np.uint8


def field_add(pkg, circuits, desc, widths):
    """Field-wise addition by split/recombine (examples/simple_struct.rs:30-58)."""

    class FieldAdd(pkg.HomomorphicOperation2):
        MIN_D_OVER_DELTA = 21

        @staticmethod
        def unsafe_apply(a, b):
            out, off = [], 0
            for w, d in widths:
                ax = pkg.Ciphered.new_from_raw([a[i] for i in range(off, off + w)], d)
                bx = pkg.Ciphered.new_from_raw([b[i] for i in range(off, off + w)], d)
                out.extend(circuits.add(ax, bx).bits())
                off += w
            return pkg.Ciphered.new_from_raw(out, a.desc)

    return FieldAdd


STRUCTS = {
    # name: (dataclass, params, seed, field widths, operands, sum)
    "simple": (Vec3, (64, 32, 1, 32), 8, [(16, "U16")] * 3, ((1, 2, 3), (4, 5, 6)), (5, 7, 9)),
    "unbalanced": (Unbalanced, (128, 32, 1, 32), 9, [(8, "U8"), (64, "U64"), (8, "U8")],
                   ((1, 2, 3), (4, 5, 6)), (5, 7, 9)),
    "whole_struct": (Vec3, (64, 32, 1, 32), 10, [(16, "U16")] * 3,
                     ((100, 200, 300), (1, 2, 3)), (101, 202, 303)),
}


@pytest.mark.parametrize("case", sorted(STRUCTS))
def test_struct_add_matches_jax(case):
    cls, params, seed, widths, (va, vb), want = STRUCTS[case]
    jctx, tctx = pair(params, seed)
    outs = []
    for pkg, circuits, ctx in ((hm, jcircuits, jctx), (ht, tcircuits, tctx)):
        desc = pkg.struct_of(cls)
        op = field_add(pkg, circuits, desc, [(w, getattr(pkg, d)) for w, d in widths])
        mk = [cls(*(f.type(v) for f, v in zip(dataclasses.fields(cls), vals)))
              for vals in (va, vb)]
        a, b = ctx.encrypt(mk[0], desc), ctx.encrypt(mk[1], desc)
        assert len(a) == sum(w for w, _ in widths)
        c = ctx.apply2(op, a, b)
        d = ctx.decrypt(c)
        assert (d.x, d.y, d.z) == want
        outs.append((a, c))
    (ja, jc), (ta, tc) = outs
    same_bytes(ta, ja)
    same_bytes(tc, jc)


def test_field_bit_offsets():
    assert ht.struct_of(Unbalanced).field_bit_offsets() == hm.struct_of(
        Unbalanced).field_bit_offsets() == {"x": (0, 8), "y": (8, 64), "z": (72, 8)}


def test_nary_operation_matches_jax():
    """HomomorphicOperationN surface (src/operations.rs:204-213)."""
    jctx, tctx = pair((256, 16, 1, 16), 11)
    outs = []
    for pkg, circuits, ctx in ((hm, jcircuits, jctx), (ht, tcircuits, tctx)):
        class Sum3(pkg.HomomorphicOperationN):
            MIN_D_OVER_DELTA = 42

            @staticmethod
            def unsafe_apply(args):
                acc = args[0]
                for nxt in args[1:]:
                    acc = circuits.add(acc, nxt)
                return acc

        out = ctx.apply_n(Sum3, [ctx.encrypt(v, pkg.U8) for v in (10, 20, 30)])
        assert ctx.decrypt(out) == 60
        outs.append(out)
    same_bytes(outs[1], outs[0])


def test_bit_lane_slicing():
    """c[a:b] mirrors the reference's Deref<[CipheredBit]> slice semantics."""
    c = ht.Ciphered.trivial(0b10110101, ht.U8, device="cpu")
    assert len(c[2:6]) == 4
    rebuilt = ht.Ciphered.new_from_raw(c[:], ht.U8)
    assert rebuilt.limbs.equal(c.limbs)
    assert rebuilt.to_bytes() == hm.Ciphered.trivial(0b10110101, hm.U8).to_bytes()


# -- variable-length plaintexts (TestCipheredVarlen) --------------------------

VARLEN = {
    # name: (seed, descriptor name and args, value, batch)
    "vec_u8": (1, ("vec_of", "U8"), [10, 20, 255], False),
    "string": (2, ("Str",), "homomorph", False),
    "string_inferred": (3, None, "abc", False),
    "option_some": (4, ("option_of", "U16"), 1234, False),
    "option_none": (4, ("option_of", "U16"), None, False),
    "enum_batched": (5, ("enum",), ["Blue", "Red"], True),
    "vec_batched": (6, ("vec_of", "U8"), [[1, 2], [3, 4]], True),
}


def descriptor(pkg, spec):
    if spec is None:
        return None
    if spec[0] == "enum":
        return pkg.enum_of("Red", "Green", "Blue", name="Color")
    if len(spec) == 1:
        return getattr(pkg, spec[0])
    return getattr(pkg, spec[0])(getattr(pkg, spec[1]))


def plain(v):
    return [plain(x) for x in v] if isinstance(v, (list, np.ndarray)) else v


@pytest.mark.parametrize("case", sorted(VARLEN))
def test_varlen_roundtrip_matches_jax(case):
    seed, spec, value, batch = VARLEN[case]
    jctx, tctx = pair((64, 32, 8, 32), seed)
    cs = []
    for pkg, ctx in ((hm, jctx), (ht, tctx)):
        c = ctx.encrypt(value, descriptor(pkg, spec), batch=batch)
        assert plain(ctx.decrypt(c)) == value
        cs.append(c)
    same_bytes(cs[1], cs[0])
    if case == "vec_u8":
        assert len(cs[1]) == (8 + 3) * 8  # u64 prefix + 3 elements


def test_batch_varlen_unequal_lengths_rejected():
    _, tctx = pair((64, 32, 8, 32), 7)
    with pytest.raises(ht.SerializeError, match="equal byte lengths"):
        tctx.encrypt([[1], [2, 3]], ht.vec_of(ht.U8), batch=True)


def test_trivial_varlen():
    _, tctx = pair((64, 32, 8, 32), 8)
    c = ht.Ciphered.trivial("xyz", ht.Str, device="cpu")
    assert tctx.decrypt(c) == "xyz"
    assert c.to_bytes() == hm.Ciphered.trivial("xyz", hm.Str).to_bytes()


def test_decipher_bomb_raises():
    """A plaintext that claims a huge allocation fails at decode in both."""
    huge = (1 << 40).to_bytes(8, "little")
    jctx, tctx = pair((64, 32, 8, 32), 9)
    for pkg, codec, ctx, kw in ((hm, jcodec, jctx, {}), (ht, tcodec, tctx, {"device": "cpu"})):
        bomb = pkg.Ciphered.trivial(huge, codec.BytesDescriptor(8), **kw)
        with pytest.raises(pkg.DecodeTooLargeError):
            ctx.decrypt(bomb.reinterpret(pkg.vec_of(pkg.U8)))
