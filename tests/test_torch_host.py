"""Host layer of the PyTorch port against the JAX package.

``homomorph_tpu_torch`` keeps its own copies of the framework-free modules
(``params``, ``rng``, ``codec``, ``utils/errors``): these tests hold each copy
equal to the JAX package's, byte for byte, on the same seeds and inputs.
"""

import doctest

import numpy as np
import pytest

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu import codec as jcodec
from homomorph_tpu import rng as jrng
from homomorph_tpu_torch import codec as tcodec
from homomorph_tpu_torch import rng as trng

CODEC_CASES = [
    ("U8", [0, 1, 255, 128]),
    ("U16", [0, 65535, 1234]),
    ("U32", [0, 2**32 - 1, 7]),
    ("U64", [0, 2**64 - 1, 2**63]),
    ("U128", [0, 2**128 - 1]),
    ("I8", [-128, 127, 0, -1]),
    ("I16", [-32768, 32767]),
    ("I64", [-2**63, 2**63 - 1, -5]),
    ("I128", [-2**127, 2**127 - 1]),
    ("Bool", [True, False, True]),
    ("F32", [1.5, -0.25, 3.14e8]),
    ("F64", [1e-300, -2.5, 0.0]),
]


class TestRandomSources:
    @pytest.mark.parametrize("seed", [0, 7, 2**63 + 5])
    def test_threefry_bytes_match(self, seed):
        a, b = jrng.ThreefrySource(seed), trng.ThreefrySource(seed)
        for n in (1, 7, 8, 33, 1000):
            assert a.draw_bytes(n).tobytes() == b.draw_bytes(n).tobytes()

    def test_recorded_bytes_match_and_exhaust(self):
        data = np.random.default_rng(3).integers(0, 256, 64, dtype=np.uint8).tobytes()
        a, b = jrng.RecordedSource(data), trng.RecordedSource(data)
        for n in (5, 11, 48):
            assert a.draw_bytes(n).tobytes() == b.draw_bytes(n).tobytes()
        assert b.remaining == 0
        with pytest.raises(ht.RandomnessError):
            b.draw_bytes(1)

    @pytest.mark.parametrize("degree", [1, 5, 31, 32, 63, 64, 127, 128, 1024])
    def test_random_poly_limbs_match(self, degree):
        a, b = jrng.ThreefrySource(11), trng.ThreefrySource(11)
        got = trng.random_poly_limbs(b, degree)
        assert np.array_equal(jrng.random_poly_limbs(a, degree), got)
        assert int.from_bytes(got.tobytes(), "little").bit_length() - 1 == degree

    @pytest.mark.parametrize("tau", [1, 16, 33, 128])
    def test_random_selection_bits_match(self, tau):
        a, b = jrng.ThreefrySource(5), trng.ThreefrySource(5)
        for _ in range(4):
            assert np.array_equal(
                jrng.random_selection_bits(a, tau), trng.random_selection_bits(b, tau)
            )

    def test_os_entropy_generator_is_seeded_torch_generator(self):
        import torch

        g = trng.os_entropy_generator("cpu")
        assert isinstance(g, torch.Generator)
        assert g.device.type == "cpu"


class TestCodec:
    @pytest.mark.parametrize("name,vals", CODEC_CASES, ids=[c[0] for c in CODEC_CASES])
    def test_batch_bytes_match(self, name, vals):
        jd, td = getattr(jcodec, name), getattr(tcodec, name)
        payload = td.encode_batch(vals)
        assert payload == jd.encode_batch(vals)
        assert payload == b"".join(td.encode(v) for v in vals)
        rows = np.frombuffer(payload, np.uint8).reshape(len(vals), td.num_bytes)
        assert td.decode_batch(rows) == jd.decode_batch(rows)

    def test_varlen_bytes_match(self):
        cases = [
            (jcodec.vec_of(jcodec.U32), tcodec.vec_of(tcodec.U32), [1, 2, 2**32 - 1]),
            (jcodec.Str, tcodec.Str, "héllo"),
            (jcodec.option_of(jcodec.U8), tcodec.option_of(tcodec.U8), 7),
            (jcodec.option_of(jcodec.U8), tcodec.option_of(tcodec.U8), None),
        ]
        for jd, td, v in cases:
            assert td.encode(v) == jd.encode(v)
            assert td.decode(td.encode(v)) == v

    def test_doctests(self):
        result = doctest.testmod(tcodec, optionflags=doctest.IGNORE_EXCEPTION_DETAIL)
        assert result.attempted > 0 and result.failed == 0


class TestErrorsAndParameters:
    NAMES = [
        "HomomorphError", "CipherError", "ContextCryptoError", "OperationError",
        "RandomnessError", "SerializeError", "DeserializeError",
        "InvalidCipheredLengthError", "DecodeTooLargeError",
        "SecretKeyUnsetError", "PublicKeyUnsetError", "InvalidParametersError",
    ]

    def test_error_hierarchy_matches(self):
        for name in self.NAMES:
            jc, tc = getattr(hm, name), getattr(ht, name)
            assert jc is not tc
            assert [b.__name__ for b in jc.__mro__] == [b.__name__ for b in tc.__mro__]
        e = ht.InvalidParametersError(65, 64, 1)
        assert str(e) == str(hm.InvalidParametersError(65, 64, 1))

    @pytest.mark.parametrize(
        "args", [(6, 3, 6, 5), (0, 1, 1, 1), (70000, 1, 1, 1), (4, 4, 4, 4)]
    )
    def test_invalid_parameters_raise_alike(self, args):
        with pytest.raises(ValueError) as je:
            hm.Parameters(*args)
        with pytest.raises(ValueError) as te:
            ht.Parameters(*args)
        assert str(je.value) == str(te.value)

    def test_pk_degree(self):
        assert ht.Parameters(128, 128, 1, 128).pk_degree == 256
        with pytest.raises(TypeError):
            ht.Parameters(1.5, 1, 1, 1)
