"""Device selection for the port's entry points.

Every entry point (``Context``, the key constructors, ``Ciphered.from_bytes``
and so on) takes ``device=None``, which means the CUDA card.  When CUDA is
missing they raise instead of quietly moving to the CPU; the CPU is used
only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

__all__ = ["resolve", "capturing"]


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda``; raise if the requested CUDA device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: homomorph_tpu_torch runs on the card by "
            "default; pass device='cpu' to run on the CPU"
        )
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    the card is absent: the CPU build of torch cannot answer the query)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
