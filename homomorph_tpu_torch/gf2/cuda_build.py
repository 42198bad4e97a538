"""Build and load the port's CUDA kernels at first use.

Each source ``homomorph_tpu_torch/csrc/<name>.cu`` exports a plain C
function and is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library in the build directory (``homomorph_tpu_torch/_build/``, listed in
``.gitignore``, unless :func:`~homomorph_tpu_torch.utils.cache.
enable_compilation_cache` names another), then loaded with ``ctypes``.  A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils.cache import build_dir

__all__ = ["SOURCES", "build", "library", "build_logs"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("clmul", "encrypt", "encrypt_mma", "threefry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register and spill report) of each build this process ran
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, in parallel."""
    pending = {}
    for name in names:
        out = _target(name)
        if not out.exists():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            pending[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _libs[name] = lib
    return lib
