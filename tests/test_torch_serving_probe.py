"""PyTorch port, the serving probe: ``repro_torch.benchmarks.
serving_probe`` on a gloo world of 4 CPU ranks against the reference's
``benchmarks/serving_probe.py`` on a host mesh of 4 devices, the model
being qwen2-0.5b's smoke config with the JAX package's weights from
``PRNGKey(0)`` (converted with ``core/convert.params_from_numpy``).

* ``run_parity``: every pool-trace replay record (host, meshless and
  1 x 4 pools on the four traces: each op's verdict, chain, range and
  predecessor answer, utilization, the live set and its verdicts) and
  every engine record (host, dev and dev-1x4 engines with the ample and
  the tight pool: results, latencies, stalls, preemptions, tokens out,
  the pool's stats) equal the reference's, in the order they ran.
* ``run_bench(n_requests=4, rates=(0.4, 1.0))``: every column but the
  timing ones (``tokens_per_sec``, ``wall_s``) and the execution-mode
  label, with tolerance 0.

The JAX side runs the reference's own functions under
``--xla_force_host_platform_device_count=4`` with ``jax.make_mesh``
building Auto-axes meshes in that process only, in two processes
(this file's ``__main__``), since ``run_parity`` alone takes about
160 s there: ``replays`` runs ``run_parity`` through its pool traces
and stops at its first engine; ``engines`` runs it with the trace
replays skipped (``_replay_trace`` returns one constant, so the host
and device records agree trivially) and then ``run_bench``."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import mesh_cases as mc
from repro.configs import registry
from repro.models import model_zoo as jzoo
from repro_torch.benchmarks import serving_probe as tsp
from repro_torch.benchmarks.kernels_bench import deterministic

ROOT = Path(__file__).resolve().parents[1]
BENCH = dict(n_requests=4, rates=(0.4, 1.0))


class _Stop(Exception):
    """Ends the ``replays`` role at the first engine."""


def jax_side(role: str, out_path: str) -> None:
    sys.path.insert(0, str(ROOT))
    mc.auto_axes_make_mesh()
    from benchmarks import serving_probe as svp
    replay, record = svp._replay_trace, svp._engine_record
    out = {"replays": [], "engines": []}
    if role == "replays":
        def recorded_replay(*args, **kw):
            out["replays"].append(replay(*args, **kw))
            return out["replays"][-1]

        def stop(*args, **kw):
            raise _Stop
        svp._replay_trace, svp._build_engine = recorded_replay, stop
        try:
            svp.run_parity()
        except _Stop:
            mc.write_pickle(out_path, out)
            return
        raise RuntimeError("run_parity built no engine")

    def recorded_engine(engine):
        rec = record(engine)
        out["engines"].append({k: v for k, v in rec.items()
                               if k != "wall_s"})
        return rec
    svp._replay_trace = lambda pool, trace: "skipped"
    svp._engine_record = recorded_engine
    svp.run_parity()
    svp._engine_record = record
    out["bench"] = svp.run_bench(**BENCH)
    mc.write_pickle(out_path, out)


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    from repro_torch.launch import spmd
    tmp = tmp_path_factory.mktemp("serving")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]))
    procs = {role: subprocess.Popen(
        [sys.executable, __file__, role, str(tmp / f"{role}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for role in ("replays", "engines")}
    try:
        params, _ = jzoo.build_params(registry.get_smoke(tsp.ARCH),
                                      jax.random.PRNGKey(0))
        params_np = jax.tree.map(np.asarray, params)
        port = spmd.spawn(mc.serving_probe_rank, 4, params_np, BENCH,
                          device="cpu", threads=1, timeout=600)
        ref = {}
        for role, proc in procs.items():
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log
            with open(tmp / f"{role}.pkl", "rb") as f:
                ref[role] = pickle.load(f)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return ref, port


def test_pool_trace_replays_match_reference(serving):
    ref, port = serving
    want = ref["replays"]["replays"]
    assert len(want) == 12
    for r, rank in enumerate(port):
        got = rank["parity"]["replays"]
        assert len(got) == len(want), r
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (r, i)


@pytest.mark.parametrize("i", range(6))
def test_engine_records_match_reference(serving, i):
    """Engine ``i`` of host, dev, dev-1x4 with the ample then the tight
    pool: every field of its record, on every rank."""
    ref, port = serving
    want = ref["engines"]["engines"]
    assert len(want) == 6
    for r, rank in enumerate(port):
        got = rank["parity"]["engines"]
        assert len(got) == 6, r
        assert sorted(got[i]) == sorted(want[i])
        for k in want[i]:
            assert got[i][k] == want[i][k], (r, i, k, got[i][k], want[i][k])


def test_bench_matches_reference(serving):
    ref, port = serving
    want = deterministic(ref["engines"]["bench"])
    assert want["parity_bit_identical"] is True
    for r, rank in enumerate(port):
        got = deterministic(rank["bench"])
        assert sorted(got) == sorted(want), r
        for k in want:
            assert got[k] == want[k], (r, k, got[k], want[k])


def test_tight_pool_exercises_backpressure(serving):
    """The tight pool's engines preempt or stall, and every request is
    served on every engine."""
    _, port = serving
    for rec in port[0]["parity"]["engines"][3:]:
        assert rec["stalls"] + rec["preemptions"] > 0
        assert len(rec["results"]) == 10


def test_main_refuses_without_a_mode():
    with pytest.raises(SystemExit):
        tsp.main(["--device", "cpu"])


def test_main_prints_the_bench_line(monkeypatch, capsys):
    """``main(["--bench", ...])`` prints rank 0's bench dict as its
    last line (the ranks' work replaced by a stub here: the fixture
    holds the real run)."""
    from repro_torch.launch import spmd
    seen = {}

    def fake_spawn(fn, n, *args, **kw):
        seen.update(fn=fn, n=n, args=args, kw=kw)
        return [{"bench": {"arch": tsp.ARCH, "rank": r}} for r in range(n)]
    monkeypatch.setattr(spmd, "spawn", fake_spawn)
    out = tsp.main(["--bench", "--requests", "5", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == {"arch": tsp.ARCH, "rank": 0}
    assert out == {"bench": {"arch": tsp.ARCH, "rank": 0}}
    assert seen["fn"] is tsp._rank and seen["n"] == tsp.N_DEV
    assert seen["args"] == (False, True, 5)
    assert seen["kw"]["device"] == "cpu"


if __name__ == "__main__":
    jax_side(sys.argv[1], sys.argv[2])
