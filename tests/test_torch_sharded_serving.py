"""PyTorch port, sharded serving: the port on gloo worlds of 1, 2 and 4
CPU ranks against the JAX package on meshes of 1, 2 and 4 forced host
devices (``jax.sharding.Mesh``, Auto axes), on the same seeded streams
(``mesh_cases.serving_suite``).  Bit for bit: ``run_serving`` with a
mesh (plane search routed under lanes and mass, masked, with a forced
spill, ordered epochs, and mixed op epochs whose overflow schedules a
rebuild) — verdicts, path lengths, overflow, spill and occupancy per
epoch, the state and the gathered plane; the routing controller's
trajectory on a skewed stream; the ``PagedKVPool`` in mesh mode on
``kv_request_trace`` and ``kv_scan_trace`` (answers, chains, free list,
stats, controller), then with a telemetry blackout and a shard loss to
2 ranks, and a snapshot taken mid-trace and restored onto 2 ranks.
Every rank returns the same answers (after a shard loss, the
survivors)."""

import pytest

import mesh_cases as mc

SUITE = "serving"
CASES = mc.cases_of(SUITE)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return mc.run_both(SUITE, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("S,case", CASES,
                         ids=[f"S{S}-{c}" for S, c in CASES])
def test_sharded_serving_matches_jax_mesh(both, S, case):
    ref, port = both
    mc.assert_same(ref[S][case], port[S][0][case], f"S={S} {case}")
    ranks = range(1, min(S, 2) if case in mc.SURVIVOR_CASES else S)
    for r in ranks:
        mc.assert_same(port[S][0][case], port[S][r][case],
                       f"S={S} {case} rank {r}")


def test_sharded_splay_demo_on_two_ranks(capsys):
    """``launch.serve --splay-demo --ranks 2`` starts two gloo ranks on
    the CPU, and every piece of the sharded loop equals the replicated
    loop on each rank's own copy."""
    from repro_torch.launch import serve
    out = serve.main(["--splay-demo", "--device", "cpu", "--ranks", "2",
                      "--epochs", "2", "--batch", "64"])
    sh = out["sharded"]
    assert sh["shards"] == 2 and sh["backend"] == "gloo"
    for k in ("serving", "mass_split", "search", "refresh", "controller"):
        assert sh[f"{k}_bit_identical"] is True, k
    assert sh["overflow"] == 0


def test_snapshot_of_a_pool_on_one_row_of_a_grid(tmp_path):
    """A pool on a row of a 2 x 2 ``elastic.remesh`` grid snapshots
    through its own row: the row's first rank writes that row's pool,
    the barrier spans the row alone, and each row restores its own
    pool; a meshless pool that one rank snapshots joins no collective."""
    from repro_torch.launch import spmd
    out = spmd.spawn(mc.row_snapshot_rank, 4, str(tmp_path), device="cpu",
                     threads=1, timeout=300)
    for r, o in enumerate(out):
        row = [0, 1] if r < 2 else [2, 3]
        assert o["row"] == r // 2
        assert o["back"] == (o["chains"], True, row), (r, o["back"])
        assert o["log"] == out[row[0]]["log"]
    assert out[0]["log"] != out[2]["log"]
    assert out[3]["solo"] == (True, True)


def test_remesh_builds_the_survivors_rows():
    """``elastic.remesh`` on 4 gloo ranks: model parallel 2 gives each
    rank its row of a 2 x 2 grid (the ``data`` axis 2, a sum over the
    row), 3 survivors give one row of 2 and no mesh to rank 3, and 3
    survivors cannot host model parallel 4."""
    from repro_torch.launch import spmd
    out = spmd.spawn(mc.remesh_rank, 4, device="cpu", threads=1,
                     timeout=300)
    for r, o in enumerate(out):
        row = [0, 1] if r < 2 else [2, 3]
        assert o["grid"] == ({"data": 2, "model": 2}, row, r % 2,
                             [sum(row)]), o
        assert o["three"] == (None if r >= 2 else
                              ({"data": 1, "model": 2}, [0, 1])), o
        assert "cannot host model_parallel=4" in o["refused"], o
