"""Where the port's compiled libraries live.

Counterpart of :mod:`homomorph_tpu.utils.cache`.  The JAX package caches
XLA programs; the port has no trace to compile, but it builds two kinds of
shared library at first use: the CUDA kernels (``nvcc``,
:mod:`homomorph_tpu_torch.gf2.cuda_build`) and the native host engine
(``g++``, :mod:`homomorph_tpu_torch.native`).  Each library's file name
carries a hash of its source and flags, so a directory that outlives the
process turns every later build of an unchanged source into a load.
:func:`enable_compilation_cache` points both builders at such a directory.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CACHE_ENV", "enable_compilation_cache", "build_dir"]

#: environment variable naming the build directory, read at each build
CACHE_ENV = "HOMOMORPH_TPU_TORCH_CACHE_DIR"
_DEFAULT = Path(__file__).resolve().parents[1] / "_build"

_enabled: "str | None" = None


def enable_compilation_cache(path: "str | None" = None) -> str:
    """Build the port's CUDA kernels and native engine into ``path``
    (idempotent).

    ``path`` defaults to ``$HOMOMORPH_TPU_TORCH_CACHE_DIR`` or
    ``homomorph_tpu_torch/_build/`` (listed in ``.gitignore``).  Creates the
    directory and returns its path.  Libraries already loaded by this
    process stay loaded; the next build or load reads the new directory.
    """
    global _enabled
    path = path or os.environ.get(CACHE_ENV) or str(_DEFAULT)
    os.makedirs(path, exist_ok=True)
    _enabled = os.path.abspath(path)
    return path


def build_dir() -> Path:
    """The directory builds go to: the one :func:`enable_compilation_cache`
    set, else ``$HOMOMORPH_TPU_TORCH_CACHE_DIR``, else
    ``homomorph_tpu_torch/_build/``; created if missing."""
    path = Path(_enabled or os.environ.get(CACHE_ENV) or _DEFAULT)
    path.mkdir(parents=True, exist_ok=True)
    return path
