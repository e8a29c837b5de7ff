"""``BENCHMARK.json`` against the rules it is checked by, the files the
harness finds by name, what the benchmark may import, and the command's
refusal to run without a card."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from splaybench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer"):
            if k in e:
                assert _line(e[k])


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(cfgs) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    files = [c["file"] for c in cfgs.values()]
    assert len(set(files)) == len(files)
    for c in cfgs.values():
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"splaybench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (pairs.add((w["config"], w["traffic"])) is None)
        assert (ROOT / "splaybench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert len(pairs) == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == set(cfgs)
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_bounds_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "splaybench" / "metrics" / f"{m['name']}.py"
                ).is_file()
        assert callable(harness.load_reader(m["name"]))
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in cells:
        ends = [m["name"] for m in harness.cell_metrics(BENCH, c, False)]
        assert "setup_s" in ends and len(ends) >= 2
        assert harness.cell_metrics(BENCH, c, True)
        for m in harness.cell_metrics(BENCH, c, True):
            assert m["moves"] in ends


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_and_no_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the program,
    ``repro`` the JAX package it was ported from."""
    files = sorted((ROOT / "splaybench").rglob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & set(harness.FORBIDDEN)
        assert not bad, (f, bad)
    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_loaded_modules_are_compared_by_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core.splaylist", "numpy",
            "jaxtyping", "flax_like"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["jax.numpy", "repro.core"]) \
        == ["jax", "repro"]


def test_reference_imports_nothing_of_the_program():
    assert _imports(ROOT / "splaybench" / "reference.py") <= {
        "__future__", "typing", "numpy"}


def _digest(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_configuration_and_mix_are_files_alone(tmp_path):
    """A cell on a configuration and a mix that are new files runs with
    no edit to any file the benchmark has."""
    shutil.copytree(ROOT / "splaybench", tmp_path / "splaybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "splaybench")
    bench = dict(BENCH)
    (tmp_path / "splaybench" / "configs" / "tiny-uniform.json").write_text(
        json.dumps({"source": "a uniform key set (Fig. 11's law)",
                    "keys": 300, "key_space": 300, "populate_share": 1.0,
                    "read_keys": {"dist": "uniform"},
                    "write_keys": {"share": 1.0}, "coin_p": 0.05,
                    "capacity": 302, "max_level": 10, "count_dtype": "int32",
                    "plane": {"levels": 10, "width": 512}}))
    (tmp_path / "splaybench" / "traffic" / "read-b32.json").write_text(
        json.dumps({"batch": 32, "mix": {"contains": 1.0},
                    "warmup_batches": 1}))
    bench["configs"] = BENCH["configs"] + [
        {"name": "tiny-uniform", "source": "test", "reduced": [],
         "file": "splaybench/configs/tiny-uniform.json", "why": "test"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "tiny.read-b32", "config": "tiny-uniform",
         "traffic": "read-b32", "chips": 1, "why": "test"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out, _ = harness.run_cell("tiny.read-b32", 3, 0.1, False,
                              device="cpu", root=tmp_path)
    assert out["correct"]
    assert out["attempted"] >= 32
    after = _digest(tmp_path / "splaybench")
    assert {p: d for p, d in after.items() if p in before} == before


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, str(ROOT / "splaybench" / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=120, cwd=ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")
    for w in BENCH["workloads"]:
        r = subprocess.run(
            [sys.executable, str(ROOT / "splaybench" / "run.py"),
             "--workload", w["name"], "--seed", "2", "--seconds", "2",
             "--trace", str(trace)], capture_output=True, text=True,
            timeout=600, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
        names = {m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                         bool(trace))}
        assert set(out["metrics"]) == names
