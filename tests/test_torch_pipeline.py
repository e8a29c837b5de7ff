"""GPipe over ranks (``parallel.pipeline``) and ``collectives.ppermute``
against the JAX package: the port on a gloo world of 4 CPU ranks
(``mesh_cases.pipeline_rank``), against the reference test's sequential
stack (``tests/test_sharding_launch.py``: L 8, D 16, B 8, rtol 2e-4)
and against the JAX ``pipeline_forward`` itself, run in a subprocess on
a ``jax.sharding.Mesh`` of 4 host devices with Auto axes (as
``tests/mesh_cases.py`` builds its meshes)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import mesh_cases as mc
from repro.parallel import pipeline as jpl

CASES = [(4, "block"), (4, "stack"), (1, "block"), (8, "block")]

JAX_PIPE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
import mesh_cases as mc
from repro.parallel.pipeline import pipeline_forward, split_stages

mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(4, 1),
                         ("pod", "model"))
w, x = mc.pipe_inputs()

def stage_fn(params_i, h):
    def body(h, wi):
        return jnp.tanh(h @ wi), None
    h, _ = jax.lax.scan(body, h, params_i)
    return h

out = pipeline_forward(jnp.asarray(x), split_stages(jnp.asarray(w), 4),
                       stage_fn, mesh, n_microbatches=4, axis="pod")
np.save(sys.argv[1], np.asarray(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4-rank world and, while it runs, the JAX pipeline in
    its subprocess: ``(per-rank results, JAX output)``."""
    from repro_torch.launch import spmd
    path = str(tmp_path_factory.mktemp("pipe") / "jax.npy")
    repo = mc.REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(repo, "src"), os.path.join(repo, "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_PIPE, path],
                            cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = spmd.spawn(mc.pipeline_rank, 4, CASES, device="cpu",
                          threads=1, timeout=300)
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log
    return port, np.load(path)


def _sequential():
    w, x = mc.pipe_inputs()
    ref = x
    for i in range(mc.PIPE_L):
        ref = np.tanh(ref @ w[i])
    return ref


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_sequential_stack(runs, case):
    """Every rank holds the last stage's output, allclose to the layers
    run in order (the reference test's tolerance)."""
    ref = _sequential()
    for r, out in enumerate(runs[0]):
        np.testing.assert_allclose(out["pipe"][case], ref, rtol=2e-4,
                                   atol=2e-4, err_msg=f"rank {r}")


def test_pipeline_matches_jax_pipeline(runs):
    port, want = runs
    for out in port:
        np.testing.assert_allclose(out["pipe"][4, "block"], want,
                                   rtol=2e-4, atol=2e-4)


def test_split_stages_matches_jax():
    from repro_torch.parallel import pipeline as pl
    w, _ = mc.pipe_inputs()
    got = pl.split_stages({"w": w, "b": w[:, 0]}, 4)
    want = jpl.split_stages({"w": w, "b": w[:, 0]}, 4)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    with pytest.raises(ValueError, match="do not split"):
        pl.split_stages(w, 3)


def test_ppermute_moves_each_rank_to_its_destination(runs):
    """A ring, its reverse, a partial permutation (ranks no pair names
    as a destination get zeros, as ``jax.lax.ppermute`` gives) and
    16-bit floats moved as their bytes; a permutation naming a rank
    twice is refused."""
    port, _ = runs
    S = len(port)
    for r, out in enumerate(port):
        assert out["ring"] == [float((r - 1) % S + 1)] * 3
        assert out["back"] == [float((r + 1) % S + 1)] * 3
        assert out["partial"] == [1.0 if r == S - 1 else 0.0] * 3
        assert out["bf16"] == [(r - 1) % S + 1.5] * 3
        assert "partial permutation" in out["refused"]
