"""PyTorch port, the paper's evaluation: the benchmark
modules of ``repro_torch.benchmarks`` against the JAX package's own
``benchmarks/*.py`` at tiny sizes, and the drift battery.

* Each sequential module (Tables 1-4, Figs. 11-13, App. C.3) prints the
  same CSV names and the same deterministic columns (mean paths,
  ``path_first``/``path_last`` and the gain, Spearman rho, mean heights
  and probe paths) as the reference's module, and returns the same
  deterministic values; the timing columns (``ops_s``, ``rel``,
  ``overhead`` and the us-per-call column) are not compared.
* ``concurrent_scaling`` (Figs. 3-5) on the CPU: its CSV columns, and
  every batch's path sum for both engines equal to the reference's
  engines replayed batch by batch (every answer True).
* The drift scenarios raced by the controller, static lanes and static
  mass on gloo worlds of 1 and 4 CPU ranks: every epoch's answers, path
  lengths, spill and occupancy, and the controller's state after each
  epoch, equal to the JAX package's ``run_serving_controlled`` and
  ``run_serving`` on ``jax.sharding.Mesh`` host meshes of 1 and 4
  devices (Auto axes; run in a subprocess under
  ``--xla_force_host_platform_device_count=4``, since the reference
  probe's ``jax.make_mesh`` gives Explicit axes here).
* ``python -m repro_torch.benchmarks.drift_probe --parity --device
  cpu``: the four battery properties on 4 ranks at the reference's
  parity shape.

Tolerance 0 throughout: the compared values are integers or exact
functions of them."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
# the reference's modules import ``benchmarks.common``
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import concurrent_scaling as rcs  # noqa: E402
from benchmarks import general_workloads as rgw  # noqa: E402
from benchmarks import height_correlation as rhc  # noqa: E402
from benchmarks import long_run as rlr  # noqa: E402
from benchmarks import seq_tables as rst  # noqa: E402
from benchmarks import uniform_zipf as ruz  # noqa: E402
from repro.core import skiplist as jskx  # noqa: E402
from repro.core import splaylist as jsx  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro_torch.benchmarks import concurrent_scaling as tcs  # noqa: E402
from repro_torch.benchmarks import drift_probe as tdp  # noqa: E402
from repro_torch.benchmarks import general_workloads as tgw  # noqa: E402
from repro_torch.benchmarks import height_correlation as thc  # noqa: E402
from repro_torch.benchmarks import long_run as tlr  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.benchmarks import seq_tables as tst  # noqa: E402
from repro_torch.benchmarks import uniform_zipf as tuz  # noqa: E402

TIMED = {"ops_s", "rel", "overhead"}


def _csv(text: str) -> dict:
    """``{name: {field: value}}`` of a module's CSV lines, the timed
    fields dropped."""
    rows = {}
    for line in text.splitlines():
        if line.startswith("#") or "," not in line:
            continue
        name, _, derived = line.split(",", 2)
        rows[name] = {k: v for k, v in (f.split("=", 1)
                                        for f in derived.split(";"))
                      if k not in TIMED}
    return rows


def _paths(results):
    return {k: v["avg_path"] for k, v in results.items()}


MODULES = {
    "seq_tables": (rst, tst, dict(n=300, ops=600), _paths),
    "uniform_zipf": (ruz, tuz, dict(n=300, ops=600), _paths),
    "general_workloads": (rgw, tgw, dict(n=300, ops=600), None),
    "long_run": (rlr, tlr, dict(n=300, ops=3000), lambda r: r),
    "height_correlation": (rhc, thc, dict(n=200, ops=20000), lambda r: r),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_sequential_module_matches_reference(name, capsys):
    ref, port, kw, det = MODULES[name]
    want = ref.run(**kw)
    ref_rows = _csv(capsys.readouterr().out)
    got = port.run(**kw)
    port_rows = _csv(capsys.readouterr().out)
    assert ref_rows and port_rows == ref_rows
    if det is not None:
        assert det(got) == det(want)


def _ref_batch_sums(n, T, tag, x, y, B):
    """The reference's Figs. 3-5 loop for one workload and B, replayed
    with its own engines: per-batch path sums of the splay-list and of
    the skip-list."""
    ml, cap = 20, 2 * n + 4
    w = jwl.xy_workload(n, x, y, T, seed=9)
    keys = np.sort(w.populate)
    ops_q = w.keys[:T].reshape(-1, B)
    st = rcs._populate_splay(n, ml, cap, keys)
    st, _, _ = jsx.run_contains_batch(st, jnp.asarray(ops_q[0]),
                                      jnp.zeros((B,), bool))
    rng = np.random.default_rng(1)
    splay = []
    for q in ops_q:
        coins = rng.random(B) < 0.01
        st, res, steps = jsx.run_contains_batch(st, jnp.asarray(q),
                                                jnp.asarray(coins))
        assert bool(res.all())
        splay.append(int(steps.sum()))
    stk = rcs._populate_skip(n, ml, cap, keys)
    skip = []
    for q in ops_q:
        _, res, steps = jskx.run_contains_batch(stk, jnp.asarray(q))
        assert bool(res.all())
        skip.append(int(steps.sum()))
    return splay, skip


def test_concurrent_scaling_matches_reference(capsys):
    n, T = 64, 512
    rcs.run(n=n, total_ops=T)
    ref_rows = _csv(capsys.readouterr().out)
    got = tcs.run(n=n, total_ops=T, device="cpu")
    assert _csv(capsys.readouterr().out) == ref_rows and ref_rows
    for x, y, tag in tcs.WORKLOADS:
        assert got[(tag, "populate")]["launches"] == {
            "splay_fold": 0, "skip_fold": 0, "splay_walk": 0,
            "skip_walk": 0}                        # plain versions
        for B in tcs.BATCHES:
            splay, skip = _ref_batch_sums(n, T, tag, x, y, B)
            for engine, sums in (("splay", splay), ("skip", skip)):
                r = got[(tag, engine, B)]
                assert r["batch_psums"] == sums, (tag, engine, B)
                assert r["psum"] == sum(sums) and r["all_found"]


def test_run_cli_writes_json_only_where_asked(tmp_path, monkeypatch,
                                              capsys):
    """``run.main`` runs the modules asked for (here concurrent_scaling
    at a tiny size on the CPU, and roofline_table, which reads the
    dry-run's JSONs under ``build/dryrun`` and finds none here) and
    writes one JSON file per module under ``--out``, and nothing
    without it; an unknown module is refused."""
    import json
    orig = tcs.run
    monkeypatch.setattr(tcs, "run", lambda quick, **kw: orig(
        n=64, total_ops=512, **kw))
    out = trun.main(["--only", "concurrent_scaling", "--device", "cpu",
                     "--out", str(tmp_path / "o")])
    assert set(out) == {"concurrent_scaling"}
    doc = json.loads((tmp_path / "o" / "concurrent_scaling.json")
                     .read_text())
    assert doc["module"] == "concurrent_scaling"
    assert doc["results"]["99-1/splay/256"]["batch_psums"] == \
        out["concurrent_scaling"][("99-1", "splay", 256)]["batch_psums"]
    monkeypatch.chdir(tmp_path)
    trun.main(["--only", "concurrent_scaling", "--device", "cpu"])
    assert trun.main(["--only", "roofline_table"]) == {"roofline_table": []}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["o"]
    with pytest.raises(SystemExit):
        trun.main(["--only", "no_such_module"])


# ---------------------------------------------------------------------------
# the drift scenarios, port on gloo CPU ranks vs JAX on host meshes
# ---------------------------------------------------------------------------

DRIFT_SHAPE = dict(width=512, batch=256, epochs=8, seed=7)
DRIFT_SHARDS = (1, 4)
SCENARIOS = ("rotating_hotset", "flash_crowd", "diurnal_zipf")
POLICIES = ("controller", "static_lanes", "static_mass")


def jax_trajectories(S, width, batch, epochs, seed) -> dict:
    """The JAX side of :func:`repro_torch.benchmarks.drift_probe.
    trajectories`, on a mesh of ``S`` forced host devices."""
    from repro.core import device_index as dix
    from repro.core import route_controller as rc
    from repro.parallel import sharding as shd
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:S]).reshape(1, S),
                             ("data", "model"))
    n = int(width * 0.75)
    out = {}
    for drift in (
            jwl.rotating_hotset_workload(n, epochs, batch, period=5,
                                         seed=seed),
            jwl.flash_crowd_workload(n, epochs, batch, onset=3,
                                     duration=5, seed=seed),
            jwl.diurnal_zipf_workload(n, epochs, batch, period=8,
                                      seed=seed)):
        pool = drift.populate
        st, _, _ = jsx.run_ops(
            jsx.make(capacity=width + 2, max_level=12),
            jnp.full((len(pool),), jsx.OP_INSERT, jnp.int32),
            jnp.asarray(pool), jnp.ones((len(pool),), bool))
        plane_r = dix.from_state_device(st, n_levels=12, width=width)
        plane_s = shd.shard_index_plane(plane_r, mesh)
        args = (st, plane_s, jnp.asarray(drift.kinds),
                jnp.asarray(drift.keys), jnp.asarray(drift.upd))
        common = dict(mesh=mesh, aggregate=True, plane_search=True)
        cfg, c0 = rc.init_controller(S)
        o = rc.run_serving_controlled(*args, cfg=cfg, state=c0, **common)
        runs = {"controller": o[:7]}
        for split in ("lanes", "mass"):
            runs[f"static_{split}"] = jsx.run_serving(*args, split=split,
                                                      **common)
        out[drift.name] = {
            tag: {k: np.asarray(r[i]) for k, i in (("res", 2), ("plen", 3),
                                                    ("spl", 5), ("occ", 6))}
            for tag, r in runs.items()}
        out[drift.name]["controller"]["states"] = [
            tdp.state_dict(s) for s in o[7]]
    return out


@pytest.fixture(scope="module")
def drift_both(tmp_path_factory):
    from repro_torch.launch import spmd
    tmp = tmp_path_factory.mktemp("drift")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]))
    procs = {S: subprocess.Popen(
        [sys.executable, __file__, str(S), str(tmp / f"jax-{S}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for S in DRIFT_SHARDS}
    try:
        port = {S: spmd.spawn(tdp.trajectories, S, *DRIFT_SHAPE.values(),
                              device="cpu", threads=1, timeout=600)
                for S in DRIFT_SHARDS}
        ref = {}
        for S, proc in procs.items():
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log
            with open(tmp / f"jax-{S}.pkl", "rb") as f:
                ref[S] = pickle.load(f)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


@pytest.mark.parametrize("S", DRIFT_SHARDS)
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("policy", POLICIES)
def test_drift_trajectory_matches_jax_mesh(drift_both, S, scenario,
                                           policy):
    ref, port = drift_both
    want = ref[S][scenario][policy]
    for r, rank in enumerate(port[S]):
        got = rank[scenario][policy]
        assert sorted(got) == sorted(want)
        for k in ("res", "plen", "spl", "occ"):
            assert got[k].dtype == want[k].dtype, (r, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {r} {k}")
        if policy == "controller":
            assert got["states"] == want["states"], r


def test_drift_scenarios_actuate_the_controller(drift_both):
    """The trajectories above are not trivial: on 4 shards every
    scenario spills under static lanes and the controller actuates."""
    _, port = drift_both
    for scenario in SCENARIOS:
        run = port[4][0][scenario]
        assert run["static_lanes"]["spl"].sum() > 0, scenario
        last = run["controller"]["states"][-1]
        assert last["retraces"] + last["escalations"] > 0, scenario


def test_drift_battery_holds_on_four_ranks():
    """The four properties of the reference's ``--parity`` battery at
    its shape (W 1024, B 512, 12 epochs, 4 shards): answers equal the
    meshless loop's, the controller recovers within K epochs of every
    transition, static lanes fails somewhere, a calm stream never
    actuates.  ``main`` raises on any violation."""
    out = tdp.main(["--parity", "--device", "cpu"])["parity"]
    k = out["recovery_bound_epochs"]
    assert out["shards"] == 4 and k == 5
    assert sorted(out["scenarios"]) == sorted(SCENARIOS)
    for s in out["scenarios"].values():
        assert all(0 <= d <= k for d in s["ttr_on"])
        assert any(d < 0 for d in s["ttr_off"])
    assert out["calm"]["retraces"] == out["calm"]["escalations"] == 0


if __name__ == "__main__":
    S, path = int(sys.argv[1]), sys.argv[2]
    res = jax_trajectories(S, **DRIFT_SHAPE)
    with open(path, "wb") as f:
        pickle.dump(res, f)
