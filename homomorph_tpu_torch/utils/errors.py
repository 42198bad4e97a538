"""Typed error surface.

Mirrors the reference's error enums one-to-one so users can map failure
modes across implementations:

* ``CipherError`` variants (reference: src/cipher.rs:17-24)
* ``ContextCryptoError`` variants (reference: src/context.rs:41-52)
* ``OperationError::InvalidParameters`` (reference: src/operations.rs:9-18)
"""

from __future__ import annotations


class HomomorphError(Exception):
    """Base class for all errors raised by this framework."""


# --- CipherError (src/cipher.rs:17-24) --------------------------------------


class CipherError(HomomorphError):
    pass


class RandomnessError(CipherError):
    """Secure randomness could not be generated / stream exhausted."""


class SerializeError(CipherError):
    """Plaintext could not be serialized before encryption."""


class DeserializeError(CipherError):
    """Decrypted bytes could not be deserialized into the target type."""


class InvalidCipheredLengthError(CipherError):
    """Ciphertext bit-length is not a multiple of 8 (src/cipher.rs:218-220)."""

    def __init__(self, length: int):
        self.length = length
        super().__init__(f"ciphered length {length} is not a multiple of 8")


class DecodeTooLargeError(CipherError):
    """Decoded payload exceeds the 1 MiB decode cap (src/cipher.rs:15,239-244)."""

    def __init__(self, length: int, maximum: int):
        self.length = length
        self.maximum = maximum
        super().__init__(f"decode of {length} bytes exceeds cap of {maximum}")


# --- ContextCryptoError (src/context.rs:41-52) ------------------------------


class ContextCryptoError(HomomorphError):
    pass


class SecretKeyUnsetError(ContextCryptoError):
    """Operation requires a secret key that has not been generated/set."""


class PublicKeyUnsetError(ContextCryptoError):
    """Operation requires a public key that has not been generated/set."""


# --- OperationError (src/operations.rs:9-18) --------------------------------


class OperationError(HomomorphError):
    pass


class InvalidParametersError(OperationError):
    """Context parameters do not satisfy an operation's d/delta requirement."""

    def __init__(self, required_min_d_over_delta: int, actual_d: int, actual_delta: int):
        self.required_min_d_over_delta = required_min_d_over_delta
        self.actual_d = actual_d
        self.actual_delta = actual_delta
        super().__init__(
            f"operation requires d/delta >= {required_min_d_over_delta}, "
            f"got d={actual_d}, delta={actual_delta}"
        )
