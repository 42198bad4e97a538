"""The cipher context: parameters + keys + the safe checked API.

Counterpart of :mod:`homomorph_tpu.context` (reference:
src/context.rs:300-596): key generation in the enforced order, explicit
key set/get, ``encrypt``/``decrypt``, and the checked operation API
``apply1/apply2/apply_n`` gated by ``validate_operation``
(``d >= required * delta``, src/context.rs:310-323, 496-546).

A context lives on one device (``device=None`` means the CUDA card; it
raises when CUDA is missing).  Randomness mirrors the JAX package:

* **Key generation** defaults to :class:`~homomorph_tpu_torch.rng.
  OsRandomSource` (``os.urandom``), exactly like the reference.
* **Encryption** draws its selection words on the device from a threefry
  key filled with 64 fresh bits of ``os.urandom`` for every ``encrypt``
  call (:func:`~homomorph_tpu_torch.rng.os_entropy_key`).
* **Reproducibility seams** (opt-in): ``source=`` pins key generation AND
  routes encryption through the host byte stream in the reference's exact
  draw order (byte-identical to the JAX package); ``encrypt_seed=`` starts
  a threefry key chain, ``jax.random.key(encrypt_seed)``, that every
  ``encrypt`` call splits as the JAX package does, so a seeded context
  gives the JAX package's ciphertext bytes for the same keys.

With ``sharding=`` (a :class:`~homomorph_tpu_torch.parallel.mesh.
ShardingConfig`), ``encrypt(batch=True)`` goes through the sharded bulk
pipeline and the ciphertexts hold this process's rows
(:class:`~homomorph_tpu_torch.parallel.mesh.ShardedRows`); decrypt and the
checked API act on those rows without communication.
"""

from __future__ import annotations

from typing import Any, Sequence, Type

from . import codec as _codec
from . import keys as _keys
from . import rng as _rng
from .cipher import Ciphered
from .device import resolve as _resolve
from .operations import OperationRequirement
from .params import Parameters
from .utils.profiling import span
from .utils.errors import (
    InvalidParametersError,
    PublicKeyUnsetError,
    SecretKeyUnsetError,
)

__all__ = ["Context"]


class Context:
    """Parameters + keys + the safe checked API (src/context.rs:300-596).

    Key-generation order is enforced (src/context.rs:444-454), and
    generating or setting a secret key clears the public key
    (src/context.rs:421-424, 568-571):

    >>> import homomorph_tpu_torch as hm
    >>> ctx = hm.Context(hm.Parameters(64, 16, 1, 16), source=hm.ThreefrySource(1),
    ...                  device="cpu")
    >>> ctx.generate_public_key()
    Traceback (most recent call last):
        ...
    homomorph_tpu_torch.utils.errors.SecretKeyUnsetError: Secret key not generated yet
    >>> ctx.generate_secret_key()
    >>> ctx.generate_public_key()
    >>> ctx.generate_secret_key()          # invalidates the public key
    >>> ctx.get_public_key() is None
    True

    The checked API validates ``d >= required * delta`` before applying
    (src/context.rs:310-323):

    >>> from homomorph_tpu_torch.models import HomomorphicAddition
    >>> small = hm.Context(hm.Parameters(32, 8, 2, 8), device="cpu")  # d/delta = 16 < 21
    >>> small.validate_operation(HomomorphicAddition)
    Traceback (most recent call last):
        ...
    homomorph_tpu_torch.utils.errors.InvalidParametersError: operation requires \
d/delta >= 21, got d=32, delta=2
    """

    def __init__(
        self,
        parameters: Parameters,
        *,
        source: _rng.RandomSource | None = None,
        encrypt_seed: int | None = None,
        sharding=None,
        device=None,
    ):
        if source is not None and encrypt_seed is not None:
            raise ValueError(
                "source= and encrypt_seed= are mutually exclusive: with a "
                "source, encryption replays the host byte stream and the "
                "seeded device key chain would be silently unused"
            )
        self._device = _resolve(device)
        self._parameters = parameters
        self._secret_key: _keys.SecretKey | None = None
        self._public_key: _keys.PublicKey | None = None
        self._source = source if source is not None else _rng.OsRandomSource()
        self._use_source_for_encrypt = source is not None
        self._enc_key = (
            _rng.threefry_key(encrypt_seed) if encrypt_seed is not None else None
        )
        if sharding is not None and source is not None:
            raise ValueError(
                "sharding= is incompatible with source=: the host byte-"
                "stream replay path encrypts bit-by-bit and cannot route "
                "through the sharded bulk pipeline; use encrypt_seed= for "
                "deterministic distributed encryption"
            )
        self._sharding = sharding

    # -- accessors (src/context.rs:353-402) ----------------------------------

    @property
    def parameters(self) -> Parameters:
        return self._parameters

    @property
    def device(self) -> "torch.device":
        return self._device

    def get_secret_key(self) -> _keys.SecretKey | None:
        return self._secret_key

    def get_public_key(self) -> _keys.PublicKey | None:
        return self._public_key

    # -- key generation (src/context.rs:404-454) -----------------------------

    def generate_secret_key(self) -> None:
        """Generate a fresh secret key; clears any public key
        (src/context.rs:421-424)."""
        self._secret_key = _keys.generate_secret_key(
            self._parameters, self._source, device=self._device
        )
        self._public_key = None

    def generate_public_key(self) -> None:
        """Generate the public key from the secret key; raises
        :class:`SecretKeyUnsetError` if none (src/context.rs:444-454)."""
        if self._secret_key is None:
            raise SecretKeyUnsetError("Secret key not generated yet")
        self._public_key = _keys.generate_public_key(
            self._parameters, self._secret_key, self._source
        )

    def set_secret_key(self, sk: _keys.SecretKey) -> None:
        """Explicitly set the secret key; clears the public key
        (src/context.rs:568-571)."""
        self._secret_key = sk
        self._public_key = None

    def set_public_key(self, pk: _keys.PublicKey) -> None:
        self._public_key = pk

    # -- encrypt / decrypt (src/context.rs:456-488) --------------------------

    def encrypt(
        self,
        data: Any,
        desc: _codec.TypeDescriptor | None = None,
        *,
        batch: bool = False,
    ) -> Ciphered:
        if self._public_key is None:
            raise PublicKeyUnsetError("Public key not generated yet")
        with span("context.encrypt"):
            if self._use_source_for_encrypt:
                return Ciphered.cipher(
                    data, self._public_key, desc, source=self._source, batch=batch
                )
            if self._enc_key is not None:
                self._enc_key, sub = _rng.threefry_split(self._enc_key)
            else:
                sub = _rng.os_entropy_key()  # fresh OS entropy per stream
            sharding = self._sharding if batch else None
            return Ciphered.cipher(
                data, self._public_key, desc, key=sub, batch=batch, sharding=sharding
            )

    def decrypt(self, ciphered: Ciphered) -> Any:
        if self._secret_key is None:
            raise SecretKeyUnsetError("Secret key not generated yet")
        with span("context.decrypt"):
            return ciphered.decipher(self._secret_key)

    def zeroize(self) -> None:
        """Scrub all key material held by this context: the secret key and
        its cached masks are overwritten in place
        (:meth:`~homomorph_tpu_torch.keys.SecretKey.zeroize`) and both key
        references are cleared (the reference zeroizes on Drop,
        src/context.rs:199-206)."""
        if self._secret_key is not None:
            self._secret_key.zeroize()
        self._secret_key = None
        self._public_key = None

    # -- checked operation API (src/context.rs:308-323, 490-546) -------------

    def validate_operation(
        self, op: Type[OperationRequirement], *operands: Ciphered
    ) -> None:
        """Check ``d >= required * delta`` in wide integers
        (src/context.rs:310-323).  With operands given, the requirement is
        the operation's operand-specific bound (``requirement_for``);
        without, the blanket class constant - the reference's behaviour."""
        required = op.requirement_for(*operands) if operands else op.MIN_D_OVER_DELTA
        d, delta = self._parameters.d, self._parameters.delta
        if d < required * delta:
            raise InvalidParametersError(required, d, delta)

    def apply1(self, op, a: Ciphered) -> Ciphered:
        with span("context.apply"):
            self.validate_operation(op, a)
            return _keep_sharding(op.unsafe_apply(a), (a,))

    def apply2(self, op, a: Ciphered, b: Ciphered) -> Ciphered:
        with span("context.apply"):
            self.validate_operation(op, a, b)
            return _keep_sharding(op.unsafe_apply(a, b), (a, b))

    def apply_n(self, op, args: Sequence[Ciphered]) -> Ciphered:
        with span("context.apply"):
            self.validate_operation(op, *args)
            return _keep_sharding(op.unsafe_apply(args), args)


def _keep_sharding(out: Ciphered, operands: Sequence[Ciphered]) -> Ciphered:
    """An operation acts on the rows each operand holds, with no
    communication: the result keeps the operands' sharding record when
    they all share it."""
    recs = {getattr(x, "sharding", None) for x in operands}
    if len(recs) == 1 and None not in recs and isinstance(out, Ciphered):
        out.sharding = recs.pop()
    return out
