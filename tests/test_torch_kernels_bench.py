"""PyTorch port, the kernel races: ``repro_torch.benchmarks.
kernels_bench`` against the reference's ``benchmarks/kernels_bench.py``
at small widths on the CPU, where every wrapper runs its kernel's plain
version.

Each helper's payload is compared key for key with tolerance 0, its
timing columns (``us_per_*``, ``*_per_sec``, ``speedup*``) dropped, and
so are its CSV lines (name and derived fields, the timed fields
dropped): ``_zipf_case`` (the level arrays and queries) with the B1
against B5 race of ``run`` on each alpha (``mean_level_found``, the
reference's float32 mean) and ``_bytes_model``; ``_aggregation_case``;
``_refresh_case`` with churn 16 and 0; ``_pipelined_case`` (B2's byte
counter per query block equal to the reference's
``splay_search_pipelined``'s); the hot-gather model.  The six mesh
cases are the probes' twins, held in ``test_torch_probes.py``,
``test_torch_chaos_probe.py``, ``test_torch_serving_probe.py`` and
``test_torch_paper_bench.py``; here ``run`` is driven whole on the CPU
with those cases stubbed, and two of them through the SPMD layer."""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import kernels_bench as rkb  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.benchmarks import kernels_bench as tkb  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402

TIMED_FIELDS = {"host_us", "speedup", "full_us", "tiered_us"}
W, NQ, QB = 512, 512, 256


def _csv(text: str) -> dict:
    """``{name: {field: value}}`` of the CSV lines, timed fields and the
    us-per-call column dropped."""
    rows = {}
    for line in text.splitlines():
        if line.startswith(("#", "{")) or line.count(",") < 2:
            continue
        name, _, derived = line.split(",", 2)
        rows[name] = {k: v for k, v in (f.split("=", 1)
                                        for f in derived.split(";"))
                      if k not in TIMED_FIELDS}
    return rows


def _same(got: dict, want: dict) -> None:
    got, want = tkb.deterministic(got), tkb.deterministic(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("alpha", tkb.ALPHAS)
def test_zipf_race_matches_reference(alpha, capsys):
    """The fixture, B1 == B5 on it, and the mean found level."""
    L_r, qs_r = rkb._zipf_case(W, alpha, NQ, seed=int(alpha * 10))
    L_t, qs_t = tkb._zipf_case(W, alpha, NQ, seed=int(alpha * 10))
    np.testing.assert_array_equal(qs_t, qs_r)
    for f in ("keys", "widths", "heights", "rank_map"):
        np.testing.assert_array_equal(getattr(L_t, f), getattr(L_r, f))
    _, _, lv = rops.splay_search(jnp.asarray(L_r.keys), jnp.asarray(qs_r),
                                 query_block=QB,
                                 rank_map=jnp.asarray(L_r.rank_map),
                                 widths=jnp.asarray(L_r.widths))
    want = float(jnp.mean(lv))
    capsys.readouterr()
    rows, L = tkb._zipf_races(W, NQ, QB, 1, "cpu")
    row = rows[tkb.ALPHAS.index(alpha)]
    assert row["alpha"] == alpha and row["mean_level_found"] == want
    line = _csv(capsys.readouterr().out)[
        f"kernel_splay_search_tiered_a{alpha}"]
    assert line == {"mean_level": f"{want:.2f}"}
    last, _ = rkb._zipf_case(W, tkb.ALPHAS[-1], NQ, seed=14)
    np.testing.assert_array_equal(L.keys, last.keys)   # the last alpha's


def test_bytes_model_matches_reference():
    for alpha in tkb.ALPHAS:
        L_r, _ = rkb._zipf_case(W, alpha, NQ, seed=int(alpha * 10))
        L_t, _ = tkb._zipf_case(W, alpha, NQ, seed=int(alpha * 10))
        for qb, nq in ((QB, NQ), (128, 1000), (256, 100)):
            assert tkb._bytes_model(L_t, qb, nq) == \
                rkb._bytes_model(L_r, qb, nq)


def test_aggregation_case_matches_reference(capsys):
    want = rkb._aggregation_case(quick=True)
    ref_rows = _csv(capsys.readouterr().out)
    got = tkb._aggregation_case(quick=True, device="cpu")
    assert _csv(capsys.readouterr().out) == ref_rows
    _same(got, want)
    assert got["folds_aggregated"] < got["folds_serialized"]


def test_synth_state_matches_reference():
    """``_synth_state`` (and the probes' shared ``synth_state``) makes
    the reference's state, every field."""
    from repro.core import splaylist as jsx
    from repro_torch.core import splaylist as tsx
    rng = np.random.default_rng(5)
    keys = rng.choice(1000, 40, replace=False).astype(np.int32)
    rel_h = rng.integers(0, 6, 40).astype(np.int32)
    for ml in (8, 12):
        want = jsx.to_numpy(rkb._synth_state(keys, rel_h, 50, max_level=ml))
        got = tsx.to_numpy(tkb._synth_state(keys, rel_h, 50, max_level=ml,
                                            device="cpu"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("churn", (16, 0))
def test_refresh_case_matches_reference(churn, capsys):
    want = rkb._refresh_case(256, churn=churn, epochs=3, reps=1)
    ref_rows = _csv(capsys.readouterr().out)
    got = tkb._refresh_case(256, churn=churn, epochs=3, reps=1,
                            device="cpu")
    assert _csv(capsys.readouterr().out) == ref_rows
    _same(got, want)


def test_pipelined_case_matches_reference(capsys):
    want = rkb._pipelined_case(W, NQ, QB, reps=1)
    ref_rows = _csv(capsys.readouterr().out)
    got = tkb._pipelined_case(W, NQ, QB, reps=1, device="cpu")
    assert _csv(capsys.readouterr().out) == ref_rows
    _same(got, want)
    assert got["bytes_per_block"] == want["bytes_per_block"]
    assert len(got["bytes_per_block"]) == NQ // QB


def jax_hot_gather_model(v: int, nq: int) -> dict:
    """The hot-gather model of the reference's ``run``, written out
    with its own ``zipf_token_ids``."""
    rng = np.random.default_rng(0)
    h, d = 2048, 512
    warm = jwl.zipf_token_ids(rng, v, (8 * nq,))
    counts = np.bincount(warm.ravel(), minlength=v)
    hot_rank = np.full(v, -1, np.int32)
    hot_rank[np.argsort(-counts)[:h]] = np.arange(h)
    ids = jwl.zipf_token_ids(rng, v, (nq,))
    hit = float(np.mean(hot_rank[ids] >= 0))
    return {"vocab": v, "hot_rows": h, "dim": d, "zipf_hot_hit": hit,
            "hbm_bytes_flat": nq * d * 2,
            "hbm_bytes_tiered": int((1 - hit) * nq * d * 2)}


@pytest.mark.parametrize("v,nq", ((4096, 1024), (8192, 4096), (3000, 64)))
def test_hot_gather_model_matches_reference(v, nq):
    assert tkb._hot_gather_model(v, nq) == jax_hot_gather_model(v, nq)


def test_deterministic_drops_only_timing_and_labels():
    payload = {"config": {"width": 4, "mode": "plain-cpu", "quick": True},
               "rows": [{"mode": "membership", "us_per_epoch_host": 1.0,
                         "epochs_per_sec_device": 2.0, "speedup": 3.0,
                         "ratio_sharded_over_replicated": 4.0,
                         "bytes_ratio_ours_over_naive": 0.25,
                         "assemble_overhead_ratio": 1.1,
                         "exec_mode": "cuda-kernels", "wall_s": 9.0,
                         "tokens_per_sec": 7.0, "ops_per_sec_seed": 1.0,
                         "spill_rate": 0.5}]}
    assert tkb.deterministic(payload) == {
        "config": {"width": 4, "quick": True},
        "rows": [{"mode": "membership", "bytes_ratio_ours_over_naive": 0.25,
                  "spill_rate": 0.5}]}


MESH_CASES = ("_sharded_refresh_case", "_sharded_search_case",
              "_ordered_case", "_drift_case", "_serving_case",
              "_chaos_case")


def test_run_assembles_the_reference_payload(monkeypatch, capsys):
    """``run(quick=True)`` on the CPU with the six mesh cases stubbed:
    the payload's keys and config are the reference's, its kernel races
    ran (B1 == B5, B2 == B1, the refresh planes equal), and the
    mesh cases got the reference's arguments and the run's device."""
    calls = {}
    for name in MESH_CASES:
        monkeypatch.setattr(tkb, name, lambda *a, _n=name, **kw: calls.
                            setdefault(_n, (a, kw)) and {"stub": _n})
    out = tkb.run(quick=True, device="cpu")
    assert list(out) == [
        "bench", "config", "zipf_search", "bytes_model", "aggregation",
        "refresh_path", "refresh_sharded", "search_sharded",
        "search_ordered", "search_pipelined", "routing_controller",
        "serving_engine", "chaos_recovery", "hot_gather_model"]
    assert out["config"] == {"width": 4096, "nq": 1024, "query_block": 256,
                             "alphas": [0.6, 1.0, 1.4], "quick": True,
                             "mode": "plain-cpu"}
    kw = {"device": "cpu", "backend": "gloo"}
    assert calls == {"_sharded_refresh_case": ((1024,), kw),
                     "_sharded_search_case": ((4096, 8192), kw),
                     "_ordered_case": ((1024, 1024), kw),
                     "_drift_case": ((4096, 8192), kw),
                     "_serving_case": ((8,), kw),
                     "_chaos_case": ((), kw)}
    assert [r["mode"] for r in out["refresh_path"]] == [
        "membership", "height_only"]
    assert out["bytes_model"]["width"] == 4096
    assert out["hot_gather_model"] == tkb._hot_gather_model(4096, 1024)
    assert out["search_pipelined"]["bit_identical"] is True
    rows = _csv(capsys.readouterr().out)
    assert "refresh_membership_w4096" in rows
    assert "kernel_splay_search_pipelined_a1.4" in rows


def test_mesh_cases_spawn_the_probe_twins(monkeypatch, capsys):
    """Each mesh case spawns ``N_DEV`` ranks of its probe twin's rank
    function with the case's arguments on the asked device and backend
    and takes rank 0's dict (the ranks' work stubbed here: the probes'
    own tests hold the real runs); the chaos case holds its gates."""
    from repro_torch.benchmarks import chaos_probe, drift_probe
    from repro_torch.benchmarks import ordered_search_probe as osp
    from repro_torch.benchmarks import serving_probe
    from repro_torch.benchmarks import sharded_refresh_probe as srp
    from repro_torch.benchmarks import sharded_search_probe as ssp
    from repro_torch.launch import spmd
    calls = []
    rank0 = {
        srp.run_bench: {"us_per_epoch_sharded": 2.0,
                        "us_per_epoch_replicated": 1.0, "shards": 4,
                        "bit_identical": True},
        ssp.run_bench: {"us_per_query_sharded": 2.0,
                        "us_per_query_replicated": 1.0, "shards": 4,
                        "bit_identical": True, "spill_rate_mass": 0.0,
                        "routing_max_share": 0.5,
                        "routing_max_share_mass": 0.25},
        osp.run_bench: {"us_per_scan_sharded": 2.0,
                        "us_per_scan_replicated": 1.0,
                        "bytes_ratio_ours_over_naive": 0.2,
                        "scans_truncated": 7, "bit_identical": True},
        drift_probe._rank: {"bench": {"scenarios": {}}},
        serving_probe._rank: {"bench": {
            "p99_latency_steps": 9, "p50_latency_steps": 5,
            "tokens_per_sec": 1.0, "index_plane_share": 1.0,
            "steady_state_spill_rate": 0.0,
            "parity_bit_identical": True}},
        chaos_probe.run_battery: {
            "detected": 3, "injected": 3, "wrong_verdicts": 0,
            "recovery_epochs_max": 0, "recovery_bound_epochs": 4,
            "restore_bit_identical": True, "replay_exactly_once": True,
            "restores": {}},
    }

    def fake_spawn(fn, n, *args, **kw):
        calls.append((fn, n, args, kw))
        return [rank0[fn]] + [None] * (n - 1)
    monkeypatch.setattr(spmd, "spawn", fake_spawn)
    kw = dict(device="cpu", backend="nccl")
    assert tkb._sharded_refresh_case(512, **kw) is rank0[srp.run_bench]
    assert tkb._sharded_search_case(512, 256, **kw) is rank0[ssp.run_bench]
    assert tkb._ordered_case(512, 256, **kw) is rank0[osp.run_bench]
    assert tkb._drift_case(512, 256, **kw) == {"scenarios": {}}
    assert tkb._serving_case(4, **kw)["p99_latency_steps"] == 9
    assert tkb._chaos_case(**kw) is rank0[chaos_probe.run_battery]
    spawned = [(fn, n, args[:-1] if fn is chaos_probe.run_battery else args)
               for fn, n, args, _ in calls]
    assert spawned == [(srp.run_bench, 4, (512,)),
                       (ssp.run_bench, 4, (512, 256, 4, True)),
                       (osp.run_bench, 4, (512, 256)),
                       (drift_probe._rank, 4, (False, True, 512, 256, 10)),
                       (serving_probe._rank, 4, (False, True, 4)),
                       (chaos_probe.run_battery, 4, ())]
    assert all(k == {"backend": "nccl", "device": "cpu", "threads": 1}
               for *_, k in calls)
    rows = _csv(capsys.readouterr().out)
    assert rows["refresh_sharded_w512"] == {
        "replicated_us": "1.0", "shards": "4", "bit_identical": "True"}
    assert rows["search_ordered_w512"]["truncated"] == "7"
    assert rows["chaos_recovery"] == {
        "detected": "3/3", "wrong": "0", "restore_ok": "True",
        "replay_once": "True"}
    rank0[chaos_probe.run_battery]["wrong_verdicts"] = 1
    with pytest.raises(AssertionError):
        tkb._chaos_case(**kw)


def test_main_prints_the_payload(monkeypatch, capsys):
    seen = {}

    def fake_run(quick, device, backend):
        seen.update(quick=quick, device=device, backend=backend)
        return {"bench": "kernels"}
    monkeypatch.setattr(tkb, "run", fake_run)
    assert tkb.main(["--device", "cpu"]) == {"bench": "kernels"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {"bench": "kernels"}
    assert seen == {"quick": True, "device": "cpu", "backend": "gloo"}
    tkb.main(["--full", "--device", "cpu", "--backend", "nccl"])
    assert seen == {"quick": False, "device": "cpu", "backend": "nccl"}


def test_run_cli_lists_kernels_bench(monkeypatch, tmp_path):
    """``benchmarks.run --only kernels_bench`` passes the device and
    writes JSON only under ``--out``."""
    monkeypatch.setattr(tkb, "run", lambda quick, device: {
        "quick": quick, "device": device})
    assert "kernels_bench" in trun.MODULES
    out = trun.main(["--only", "kernels_bench", "--device", "cpu",
                     "--out", str(tmp_path / "o")])
    assert out == {"kernels_bench": {"quick": True, "device": "cpu"}}
    doc = json.loads((tmp_path / "o" / "kernels_bench.json").read_text())
    assert doc["results"] == {"quick": True, "device": "cpu"}
