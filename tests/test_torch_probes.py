"""PyTorch port, the ``--bench`` halves of the sharded probes: the
twins in ``repro_torch.benchmarks`` (``sharded_refresh_probe``,
``sharded_search_probe``, ``ordered_search_probe``) against the
reference's ``benchmarks/*_probe.py`` ``run_bench`` at small widths.

The port runs on gloo worlds of 1 and 4 CPU ranks; the JAX side in one
subprocess (this file's ``__main__``) under
``--xla_force_host_platform_device_count=4``, on ``jax.sharding.Mesh``
host meshes of 1 and 4 devices (Auto axes: the probes'
``jax.make_mesh`` gives Explicit axes under jax 0.9, so it is replaced
in that process only, and the probes' ``N_DEV`` set to the shard
count).  Every column but the timing ones and the execution-mode label
(``kernels_bench.deterministic``) is compared with tolerance 0, key for
key, on every rank: the rest are integers or exact functions of
integers (shares, Gini, spill rates, bytes ratios)."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

import mesh_cases as mc
from repro_torch.benchmarks import ordered_search_probe as osp
from repro_torch.benchmarks import sharded_refresh_probe as srp
from repro_torch.benchmarks import sharded_search_probe as ssp
from repro_torch.benchmarks.kernels_bench import deterministic

ROOT = Path(__file__).resolve().parents[1]
SHARDS = (1, 4)
SHAPES = {
    "sharded_refresh_probe": dict(width=512, reps=1),
    "sharded_search_probe": dict(width=1024, nq=1024, reps=1, routed=True),
    "ordered_search_probe": dict(width=1024, nq=1024, max_range=64, reps=1),
}
MAINS = {
    "sharded_refresh_probe": (srp, ["--width", "512"]),
    "sharded_search_probe": (ssp, ["--routed", "--width", "1024",
                                   "--nq", "1024"]),
    "ordered_search_probe": (osp, ["--width", "1024", "--nq", "1024"]),
}


def jax_benches(out_path: str) -> None:
    """The reference's ``run_bench`` of each probe at ``SHAPES`` on
    host meshes of each of ``SHARDS``, pickled to ``out_path``."""
    import importlib
    sys.path.insert(0, str(ROOT))
    mc.auto_axes_make_mesh()
    mods = {n: importlib.import_module(f"benchmarks.{n}") for n in SHAPES}
    out = {}
    for S in SHARDS:
        out[S] = {}
        for name, mod in mods.items():
            mod.N_DEV = S
            out[S][name] = mod.run_bench(**SHAPES[name])
    mc.write_pickle(out_path, out)


@pytest.fixture(scope="module")
def benches(tmp_path_factory):
    from repro_torch.launch import spmd
    path = str(tmp_path_factory.mktemp("probes") / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]))
    proc = subprocess.Popen([sys.executable, __file__, path], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = {S: spmd.spawn(mc.probe_bench_rank, S, SHAPES, device="cpu",
                              threads=1, timeout=600) for S in SHARDS}
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log
        with open(path, "rb") as f:
            ref = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return ref, port


def _det(d: dict) -> dict:
    return deterministic(d)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("probe", sorted(SHAPES))
def test_bench_matches_reference(benches, S, probe):
    ref, port = benches
    want = _det(ref[S][probe])
    assert want["shards"] == S and want["bit_identical"] is True
    for r, rank in enumerate(port[S]):
        got = _det(rank[probe])
        assert sorted(got) == sorted(want), (r, sorted(got), sorted(want))
        for k in want:
            assert got[k] == want[k], (probe, S, r, k, got[k], want[k])
        # the timing columns are there too, as the reference has them
        assert sorted(rank[probe]) == sorted(
            k for k in ref[S][probe]), r


def test_search_bench_routes_and_spills(benches):
    """The 4-shard search race is not trivial: the lanes split spills
    on the Zipf batch, the mass split does not, and the resident
    mass-split descent re-assembles no local sub-plane."""
    _, port = benches
    out = port[4][0]["sharded_search_probe"]
    assert out["spill_count"] > 0 and out["spill_count_mass"] == 0
    assert sum(out["occupancy_per_shard"]) == out["nq"]
    assert out["assembled_resident"] == 0
    assert out["assembled_forced"] == 4


def test_main_prints_rank0_bench(benches, capsys):
    """``main(["--bench", ..., "--device", "cpu"])`` spawns 4 ranks and
    prints rank 0's dict as the last line; at the fixture's width its
    deterministic columns are the reference's at 4 shards."""
    mod, argv = MAINS["sharded_refresh_probe"]
    out = mod.main(["--bench", *argv, "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    ref, _ = benches
    assert _det(out) == _det(ref[4]["sharded_refresh_probe"])


@pytest.mark.parametrize("probe", sorted(MAINS))
def test_main_passes_its_arguments(probe, monkeypatch, capsys):
    """Each ``main`` hands its arguments to ``run_bench`` on
    ``N_DEV`` ranks of the asked device and backend (the ranks' work
    stubbed: the fixture holds the real runs)."""
    from repro_torch.launch import spmd
    mod, argv = MAINS[probe]
    seen = {}

    def fake_spawn(fn, n, *args, **kw):
        seen.update(fn=fn, n=n, args=args, kw=kw)
        return [{"rank": r} for r in range(n)]
    monkeypatch.setattr(spmd, "spawn", fake_spawn)
    out = mod.main(["--bench", *argv, "--device", "cpu", "--backend",
                    "nccl"])
    assert out == {"rank": 0}
    assert json.loads(capsys.readouterr().out.strip()) == {"rank": 0}
    assert seen["fn"] is mod.run_bench and seen["n"] == mod.N_DEV == 4
    assert seen["kw"] == {"backend": "nccl", "device": "cpu", "threads": 1}
    want = {k: v for k, v in SHAPES[probe].items() if k != "reps"}
    got = dict(zip(("width", "nq", "max_range" if probe ==
                    "ordered_search_probe" else "reps", "routed"),
                   seen["args"]))
    for k, v in want.items():
        assert got[k] == v, (k, got)


def test_mains_need_bench():
    for mod, _ in MAINS.values():
        with pytest.raises(SystemExit):
            mod.main(["--device", "cpu"])


if __name__ == "__main__":
    jax_benches(sys.argv[1])
