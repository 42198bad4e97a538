"""Shipped homomorphic operation library (the reference's ``impls`` layer)."""

from . import circuits, numbers  # noqa: F401
from .numbers import (  # noqa: F401
    HomomorphicAddition,
    HomomorphicAndGate,
    HomomorphicNotGate,
    HomomorphicOrGate,
    HomomorphicXorGate,
)
