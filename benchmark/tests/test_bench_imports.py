"""No module the benchmark runs imports JAX or the JAX package, each
top-level module name compared whole (the port's name begins with the JAX
package's); the reference imports nothing of the program."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from benchmark import harness

PROBE = textwrap.dedent("""
    import sys
    from pathlib import Path
    from benchmark import (harness, control, operands, readers, reference, roofline, run,
                           sweep, trace)
    b = harness.BENCH
    for kind in ("entries", "metrics", "ops"):
        for p in sorted((b / kind).glob("*.py")):
            harness.load_module(kind, p.stem)
    import homomorph_tpu_torch, homomorph_tpu_torch.models.compiled
    print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
""")


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(out.split())


def test_the_benchmark_and_the_port_load_no_jax():
    names = _top_names(PROBE)
    assert "homomorph_tpu_torch" in names and "benchmark" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    names = _top_names("import sys; import benchmark.reference, benchmark.roofline, benchmark.trace;"
                       "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "homomorph_tpu_torch" not in names and not names & set(harness.FORBIDDEN)


def test_top_level_names_are_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    fake["homomorph_tpu_torch_extra"] = sys
    fake["jaxtyping_like"] = sys
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake["homomorph_tpu.cipher"] = sys
    fake["jax"] = sys
    assert harness.forbidden_modules() == ["homomorph_tpu", "jax"]
