"""PyTorch port, package hygiene: ``repro_torch`` (and the card's smoke
script) imports neither JAX nor anything of the JAX package, and its
entry points refuse to fall back to the CPU when no card is present."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import convert
from repro_torch.core import splaylist as tsx
from repro_torch.core.splay_cache import SplayVocabCache

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("kernels.splay_search", "kernels.hot_gather",
              "core.splay_cache", "core.level_arrays", "core.convert",
              "configs.base", "configs.minitron_8b"):
        assert f"repro_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "scripts/fold_timing.py",
       "scripts/torch_fold_ab.py", "tests/test_torch_cuda.py"]))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    bad = [n for n in names if _forbidden(n)]
    assert not bad, bad


def test_entry_points_refuse_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsx.make(8, 4)
    st = tsx.make(8, 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_numpy(tsx.to_numpy(st))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.plane_from_numpy({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplayVocabCache(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.table_from_numpy(np.zeros((2, 2), np.float32))
