"""The port stands on torch alone.

``homomorph_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` /
``jaxlib`` nor the JAX package ``homomorph_tpu`` (any import of it runs
``homomorph_tpu/__init__.py``, which imports jax); importing the port does
not load jax; and without CUDA the port's entry points raise instead of
running on the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "homomorph_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "homomorph_tpu")


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_exist():
    assert os.path.exists(os.path.join(ROOT, "chip_smoke.py"))
    assert len(port_files()) > 15
    for rel in ("prng.py", "experiments/exp_enc.py", "csrc/encrypt_mma.cu", "csrc/threefry.cu",
                "native/__init__.py", "native/gf2_native.cpp", "verify.py",
                "models/compiled.py", "utils/profiling.py", "utils/cache.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/bulk.py",
                "parallel/limbmul.py", "parallel/distributed.py", "examples/__init__.py",
                "bench.py", "entry.py", "bench_scaling.py", "experiments/common.py",
                "experiments/exp_mul32.py", "experiments/exp_mul64.py", "experiments/exp_add.py",
                "experiments/exp_mul.py", "experiments/exp_mul_roofline.py",
                "experiments/exp_enc_chunked.py", "experiments/exp_scaling_model.py"):
        assert os.path.exists(os.path.join(PKG, rel)), rel


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_does_not_load_jax():
    code = (
        "import sys, homomorph_tpu_torch, homomorph_tpu_torch.models, "
        "homomorph_tpu_torch.gf2.kernels, homomorph_tpu_torch.gf2.encrypt_kernel, "
        "homomorph_tpu_torch.prng, homomorph_tpu_torch.experiments.exp_enc, "
        "homomorph_tpu_torch.native, homomorph_tpu_torch.verify, "
        "homomorph_tpu_torch.models.compiled, homomorph_tpu_torch.utils.profiling, "
        "homomorph_tpu_torch.utils.cache, homomorph_tpu_torch.parallel, "
        "homomorph_tpu_torch.parallel.distributed, homomorph_tpu_torch.examples, "
        "homomorph_tpu_torch.bench, homomorph_tpu_torch.entry, "
        "homomorph_tpu_torch.bench_scaling; "
        "import importlib, pkgutil, homomorph_tpu_torch.examples as ex, "
        "homomorph_tpu_torch.experiments as xp; "
        "[importlib.import_module(p.__name__ + '.' + m.name) "
        "for p in (ex, xp) for m in pkgutil.iter_modules(p.__path__)]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'homomorph_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_exports_match_jax_package():
    import homomorph_tpu_torch.parallel as tpar
    from homomorph_tpu_torch.parallel import distributed

    for name in ("ShardingConfig", "make_mesh", "sharded_encrypt_bits", "sharded_decrypt_bits",
                 "sharded_gate_xor", "sharded_clmul", "maybe_sharded_clmul",
                 "set_default_limb_mesh", "get_default_limb_mesh", "use_limb_mesh",
                 "comm_bytes_per_call", "bulk", "limbmul", "mesh"):
        assert hasattr(tpar, name), name
    for name in ("initialize", "global_mesh", "broadcast_keys", "assert_same_across_processes",
                 "save_sharded", "load_sharded"):
        assert callable(getattr(distributed, name)), name


def test_parallel_calls_no_all_reduce():
    """NCCL has no ReduceOp.BXOR: the XOR combines are point-to-point
    exchanges, one code path for gloo and NCCL."""
    for name in os.listdir(os.path.join(PKG, "parallel")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(PKG, "parallel", name)).read())
        used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        used |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not used & {"all_reduce", "ReduceOp", "reduce_scatter"}, name


def test_context_raises_without_cuda():
    import homomorph_tpu_torch as ht

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Context(ht.Parameters(64, 16, 1, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.Context(ht.Parameters(64, 16, 1, 16), device="cuda")


def run_smoke(args, cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_without_cuda_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = run_smoke([], ROOT)
    assert proc.returncode == 2 and proc.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = run_smoke([], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
