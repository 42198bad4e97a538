"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"]
    assert len(SPEC["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                                  for w in SPEC["command"])


def test_names_units_and_text():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def _reports(cell, group):
    return [m["name"] for m in SPEC[group] if "workloads" not in m or cell in m["workloads"]]


def test_every_cell_reports_what_the_contract_asks():
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for cell in cells:
        e2e = _reports(cell, "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = [m for m in SPEC["per_layer"] if cell in m["workloads"]]
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e_names and m["moves"] in e2e


def test_every_cell_resolves_to_its_files():
    for w in SPEC["workloads"]:
        s = harness.cell_spec(w["name"])
        assert s["config"]["name"] == w["config"]
        assert (harness.BENCH / "entries" / f"{s['traffic']['entry']}.py").is_file()
        assert (harness.BENCH / "ops" / f"{s['traffic']['op']}.py").is_file()
        for m in s["end_to_end"] + s["per_layer"]:
            assert callable(harness.load_module("metrics", m["name"]).read)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    for family in ("clmul", "encrypt"):
        assert harness.kernel_patterns(family)


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    (b / "configs" / "tiny_u8.json").write_text(json.dumps(
        {"name": "tiny_u8", "source": "test", "type": "U8",
         "parameters": {"d": 128, "dp": 128, "delta": 1, "tau": 128}}))
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"entry": "graph", "op": "HomomorphicMultiplication", "pairs": 2, "pool": 2,
         "basis": 4, "keep": 1, "trace_requests": 2}))
    (b / "metrics" / "tiny_requests.count.py").write_text("def read(run):\n    return run.requests\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_u8", "source": "test", "file": "benchmark/configs/tiny_u8.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_u8.tiny_mix", "config": "tiny_u8", "traffic": "tiny_mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "tiny_requests.count", "unit": "requests", "better": "higher",
                               "bound": 0.25, "source": "host_clock", "workloads": ["tiny_u8.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(b)
    assert all(after[p] == d for p, d in before.items())  # nothing that was there changed
    s = harness.cell_spec("tiny_u8.tiny_mix", root=tmp_path)
    assert s["bench"] == b and s["config"]["type"] == "U8"
    import time

    line = harness.run_cell(s, 5, 0.1, False, "cpu", time.perf_counter())
    assert line["correct"] and line["metrics"]["tiny_requests.count"]["value"] >= 1
    assert "setup_s" in line["metrics"]
