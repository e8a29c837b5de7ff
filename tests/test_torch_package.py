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
from repro_torch.configs import registry
from repro_torch.core.splay_cache import SplayVocabCache
from repro_torch.launch import serve
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.engine import Engine

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
              "configs.base", "configs.minitron_8b",
              "core.route_controller", "core.plane_check", "core.faults",
              "core.ref_py", "parallel.sharding", "serve.kv_cache",
              "configs.registry", "configs.arctic_480b",
              "configs.mamba2_1_3b", "configs.paligemma_3b",
              "configs.phi35_moe", "configs.qwen1_5_110b",
              "configs.qwen2_0_5b", "configs.stablelm_3b",
              "configs.whisper_large_v3", "configs.zamba2_7b",
              "models.layers", "models.attention", "models.moe",
              "models.ssm", "models.model_zoo", "serve.serve_step",
              "serve.engine", "launch.serve", "core.tree",
              "train.checkpoint", "serve.snapshot", "train.optimizer",
              "parallel.compression", "train.train_step", "train.data",
              "train.straggler", "launch.train", "parallel.collectives",
              "train.elastic", "launch.spmd"):
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
       "scripts/torch_fold_ab.py", "scripts/search_timing.py",
       "scripts/torch_search_ab.py", "scripts/engine_step_profile.py",
       "scripts/train_step_profile.py", "scripts/card_checks.py",
       "tests/test_torch_cuda.py"]))
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"embed": np.zeros((2, 2), np.float32)})
    cfg = registry.get_smoke("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.build_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.init_cache(cfg, 1, 4)
    params = zoo.build_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])


def test_train_and_snapshot_entry_points_refuse_cpu_fallback(tmp_path):
    """The trainer and a device-pool restore default to the card, and
    raise without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    from repro_torch.launch import train
    from repro_torch.serve import snapshot as snap
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.train.checkpoint import CheckpointManager
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    mgr = CheckpointManager(str(tmp_path))
    pool = PagedKVPool(16, 4, device=True, index_width=8, index_batch=4,
                       torch_device="cpu")
    snap.save_serving_snapshot(mgr, 1, pool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snap.restore_serving_snapshot(mgr)
    back, _, _ = snap.restore_serving_snapshot(mgr, device="cpu")
    assert back._st.key.device.type == "cpu"


def test_spmd_launch_refuses_cpu_fallback_without_a_card():
    """A rank asked for the card finds none and fails the launch; the
    launcher stops its processes and raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    from repro_torch.launch import spmd
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.spawn(print, 2, device="cuda", timeout=120)
    with pytest.raises(ValueError, match="backend"):
        spmd.spawn(print, 1, backend="mpi")


def test_mesh_entry_points_default_to_the_card():
    """``spawn``, ``Mesh``, ``world_mesh`` and ``elastic.remesh`` put
    their ranks on the card unless the caller passes ``device="cpu"``:
    without a card, ``spawn(fn, 1)`` with no device fails the launch."""
    import inspect

    from repro_torch.launch import spmd
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    for fn in (spmd.spawn, shd.Mesh, shd.world_mesh, elastic.remesh):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.spawn(print, 1, timeout=120)
