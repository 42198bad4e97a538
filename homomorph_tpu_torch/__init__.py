"""homomorph_tpu_torch - the PyTorch/CUDA port of ``homomorph_tpu``.

Bit-level partially homomorphic encryption over GF(2)[X] (the capabilities
of the ``homomorph`` Rust crate, mathisbot/homomorph-rust) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).  The package keeps
the JAX package's module layout and public names; its own modules import
``torch`` and never ``jax``.  The JAX package is the reference it is held
against bit for bit (``tests/test_torch_*.py``).

Entry points run on the CUDA card by default (``device=None``) and raise
when CUDA is missing; pass ``device="cpu"`` to run on the CPU, where each
kernel wrapper computes its plain torch version.

Quick start (on the CPU here; drop ``device="cpu"`` on a machine with a
card):

>>> import homomorph_tpu_torch as hm
>>> ctx = hm.Context(hm.Parameters(64, 16, 1, 16), source=hm.ThreefrySource(7),
...                  device="cpu")
>>> ctx.generate_secret_key()
>>> ctx.generate_public_key()
>>> c = ctx.encrypt(42, hm.U8)
>>> int(ctx.decrypt(c))
42

Homomorphic arithmetic through the checked API:

>>> from homomorph_tpu_torch.models import HomomorphicAddition
>>> a, b = ctx.encrypt(20, hm.U8), ctx.encrypt(22, hm.U8)
>>> int(ctx.decrypt(ctx.apply2(HomomorphicAddition, a, b)))
42

Keys persist as reference-compatible bytes (src/lib.rs:39-54):

>>> sk_bytes = ctx.get_secret_key().to_bytes()
>>> restored = hm.SecretKey.from_bytes(sk_bytes, device="cpu")
>>> int(c.decipher(restored))
42
"""

from .cipher import MAX_DECODE_BYTES, Ciphered, CipheredBit  # noqa: F401
from .codec import (  # noqa: F401
    F32,
    F64,
    I8,
    I16,
    I32,
    I64,
    I128,
    Bool,
    Isize,
    U8,
    U16,
    U32,
    U64,
    U128,
    Usize,
    ArrayDescriptor,
    BytesDescriptor,
    EnumDescriptor,
    OptionDescriptor,
    Str,
    StringDescriptor,
    StructDescriptor,
    TypeDescriptor,
    VecDescriptor,
    descriptor_for,
    enum_of,
    option_of,
    struct_of,
    vec_of,
)
from .context import Context  # noqa: F401
from .keys import PublicKey, SecretKey  # noqa: F401
from .operations import (  # noqa: F401
    HomomorphicOperation1,
    HomomorphicOperation2,
    HomomorphicOperationN,
    OperationRequirement,
)
from .params import Parameters  # noqa: F401
from .rng import OsRandomSource, RandomSource, RecordedSource, ThreefrySource  # noqa: F401
from .utils.cache import enable_compilation_cache  # noqa: F401
from .verify import VerificationError, run_verification  # noqa: F401
from .utils.errors import (  # noqa: F401
    CipherError,
    ContextCryptoError,
    DecodeTooLargeError,
    DeserializeError,
    HomomorphError,
    InvalidCipheredLengthError,
    InvalidParametersError,
    OperationError,
    PublicKeyUnsetError,
    RandomnessError,
    SecretKeyUnsetError,
    SerializeError,
)

__version__ = "0.5.0"

__all__ = [
    "Parameters",
    "Context",
    "SecretKey",
    "PublicKey",
    "Ciphered",
    "CipheredBit",
    "MAX_DECODE_BYTES",
    "HomomorphicOperation1",
    "HomomorphicOperation2",
    "HomomorphicOperationN",
    "OperationRequirement",
    "RandomSource",
    "OsRandomSource",
    "RecordedSource",
    "ThreefrySource",
    "enable_compilation_cache",
    "run_verification", "VerificationError",
    # codec
    "TypeDescriptor", "StructDescriptor", "ArrayDescriptor", "BytesDescriptor",
    "VecDescriptor", "StringDescriptor", "OptionDescriptor", "EnumDescriptor",
    "U8", "U16", "U32", "U64", "U128", "Usize",
    "I8", "I16", "I32", "I64", "I128", "Isize",
    "Bool", "F32", "F64", "Str",
    "struct_of", "descriptor_for", "vec_of", "option_of", "enum_of",
    # errors
    "HomomorphError", "CipherError", "ContextCryptoError", "OperationError",
    "RandomnessError", "SerializeError", "DeserializeError",
    "InvalidCipheredLengthError", "DecodeTooLargeError",
    "SecretKeyUnsetError", "PublicKeyUnsetError", "InvalidParametersError",
]
