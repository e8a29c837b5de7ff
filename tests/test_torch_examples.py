"""PyTorch port, the example entry points (``repro_torch.examples``)
against the reference's ``examples/`` on the CPU:

* ``quickstart``: every printed line equal (the section header names
  the port's state engine where the reference names its JAX engine);
* ``splay_workloads`` at ``--n 2000 --ops 5000``: every line equal but
  the ops/s column, which is the host's clock;
* ``train_adaptive_lm``: the trainer's arguments equal (but the
  checkpoint directory, which the port keeps under the checkout, and
  the device), and a 2-step run of those arguments on the CPU
  completes;
* ``serve_adaptive``: the reference runs in a subprocess (this file's
  ``__main__``) on a host mesh of 4 devices with Auto axes, as
  ``tests/mesh_cases.py`` builds it (``jax.make_mesh`` gives Explicit
  axes in jax 0.9.0, which the JAX package's sharded code refuses), and
  the port's sharded demos run on 4 gloo CPU ranks: every printed line
  equal; the engine demo from the reference's own parameters
  (``build_params(cfg, PRNGKey(0))`` converted array by array): every
  line equal."""

import contextlib
import io
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the reference's examples import ``benchmarks.common``
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from examples import quickstart as rqs  # noqa: E402
from examples import splay_workloads as rsw  # noqa: E402
from examples import train_adaptive_lm as rtl  # noqa: E402
from repro_torch.examples import quickstart as tqs  # noqa: E402
from repro_torch.examples import serve_adaptive as tsa  # noqa: E402
from repro_torch.examples import splay_workloads as tsw  # noqa: E402
from repro_torch.examples import train_adaptive_lm as ttl  # noqa: E402


def _run(fn, *args, **kw):
    """``(printed lines, result)`` of ``fn(*args, **kw)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue().splitlines(), out


def _printed(fn, *args, **kw):
    return _run(fn, *args, **kw)[0]


def test_quickstart_matches_reference():
    want = _printed(rqs.main)
    got, out = _run(tqs.main, ["--device", "cpu"])
    assert [line.replace("JAX engine", "state engine") for line in want] \
        == got
    assert out["found"] == 256 and out["hot_height"] > out["all_height"]


def _drop_rate(lines):
    """The table's rows without the ops/s column."""
    out = []
    for line in lines:
        cols = line.rsplit(None, 2)
        if len(cols) == 3 and cols[1].isdigit():
            line = f"{cols[0]} {cols[2]}"
        out.append(line)
    return out


def test_splay_workloads_matches_reference(monkeypatch):
    argv = ["--n", "2000", "--ops", "5000"]
    monkeypatch.setattr(sys, "argv", ["splay_workloads.py"] + argv)
    want = _drop_rate(_printed(rsw.main))
    got_lines, rows = _run(tsw.main, argv)
    got = _drop_rate(got_lines)
    assert want == got and len(got) == 7
    assert got_lines != got            # the ops/s column was there
    assert [f"{e} p={p} {path:.2f}" for e, p, _, path in rows] == got[2:]


def _options(argv):
    """``--flag value`` pairs (a flag with no value maps to True)."""
    out, i = {}, 0
    while i < len(argv):
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            out[argv[i]] = argv[i + 1]
            i += 2
        else:
            out[argv[i]] = True
            i += 1
    return out


def test_train_adaptive_lm_matches_reference(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(rtl.train, "main", seen.append)
    rtl.main()
    want = _options(seen[0])
    got = _options(ttl.train_argv(tmp_path / "ckpt"))
    assert want.pop("--ckpt-dir") and got.pop("--ckpt-dir") == \
        str(tmp_path / "ckpt")
    assert got.pop("--device") == "cuda"
    assert want == got
    assert _options(ttl.train_argv(ttl.CKPT_DIR))["--ckpt-dir"].startswith(
        str(ROOT / "build"))
    losses = ttl.train.main(ttl.train_argv(tmp_path / "run", steps=2,
                                           device="cpu"))
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert (tmp_path / "run").exists()


def test_serve_adaptive_matches_reference(tmp_path):
    from repro_torch.core import convert
    from repro_torch.launch import spmd
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests"), str(ROOT)]))
    proc = subprocess.Popen([sys.executable, __file__, str(out)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        sharded = spmd.spawn(tsa.sharded_demos, 4, device="cpu",
                             threads=1, timeout=600)
        log, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log
    with open(out, "rb") as f:
        ref = pickle.load(f)
    assert sharded[0]["lines"] == (ref["routed_sharded_serving_demo"]
                                   + ref["controlled_serving_demo"])
    assert all(r["lines"] == [] for r in sharded[1:])
    assert all(r["device"] == "cpu" for r in sharded)
    assert any("re-split recovery" in line for line in sharded[0]["lines"])
    lines = []
    tsa.engine_demo("cpu", convert.params_from_numpy(ref["params"],
                                                     device="cpu"),
                    say=lines.append)
    assert lines == ref["engine_demo"] and len(lines) == 10


def test_serve_adaptive_main_on_one_cpu_rank(monkeypatch):
    """The entry point: the engine demo with the port's own seeded
    weights, then the sharded demos on a world of one rank
    (``SERVE_SHARDS=1``), which skip as the reference's do on one
    device."""
    monkeypatch.setattr(tsa, "N_SHARDS", 1)
    lines, out = _run(tsa.main, ["--device", "cpu"])
    [rank] = out["ranks"]
    assert len(out["engine"]) == 10 and rank["lines"] == [
        "routed sharded serving skipped (1 device(s))",
        "controlled serving skipped (1 device(s))"]
    assert rank["device"] == "cpu"
    assert rank["launches"] == dict.fromkeys(rank["launches"], 0)
    assert lines == out["engine"] + rank["lines"]


if __name__ == "__main__":
    # the reference's serve_adaptive on a host mesh with Auto axes
    import jax

    from repro.configs import registry
    from repro.models import model_zoo as zoo

    def auto_mesh(shape, names, **kw):
        devs = jax.devices()[:int(np.prod(shape))]
        return jax.sharding.Mesh(np.array(devs).reshape(shape), names)

    jax.make_mesh = auto_mesh
    from examples import serve_adaptive as rsa
    res = {name: _printed(getattr(rsa, name))
           for name in ("engine_demo", "routed_sharded_serving_demo",
                        "controlled_serving_demo")}
    params, _ = zoo.build_params(registry.get_smoke("minitron-8b"),
                                 jax.random.PRNGKey(0))
    res["params"] = jax.tree.map(np.asarray, params)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
