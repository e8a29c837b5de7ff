"""PyTorch port, checkpoints and serving snapshots:
``repro_torch.train.checkpoint`` and ``repro_torch.serve.snapshot`` on
the CPU, against the JAX package.

The meshless cases of ``tests/test_checkpoint.py`` and
``tests/test_snapshot.py`` run on the port: round trip, corruption
caught and named, a partial write invisible, ``keep``, the idempotent
re-save, rapid saves serialised, pending ops replayed exactly once,
a snapshot between two audits (the restored pool's audit count starts
afresh), the engine state, the degradation state carried, a non-snapshot
checkpoint refused.  Then the two packages' formats, both ways: a JAX
checkpoint and JAX serving snapshots (host pool and device pool)
restore in the port, and the port's restore in the JAX package with its
SHA-256 check; a tree the port saves loads back bit for bit; verdicts
after each restore are bit-identical to both packages' uninterrupted
runs.  Last, ``launch/serve.main`` with ``--snapshot-dir`` and then
``--resume``."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workload as wl
from repro.serve import snapshot as jsnap
from repro.serve.kv_cache import PagedKVPool
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch.core import convert
from repro_torch.core import workload as twl
from repro_torch.launch import serve as tserve
from repro_torch.serve import snapshot as snap
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.kv_cache import PagedKVPool as TPagedKVPool
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as topt

W, B = 32, 8


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.float32)}}


# ---------------------------------------------------------------------------
# the checkpoint manager (tests/test_checkpoint.py, on the port)
# ---------------------------------------------------------------------------

def test_save_load_roundtrip(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(10, t, extra={"data_step": 10}, blocking=True)
    flat, extra = mgr.load()
    assert extra["data_step"] == 10
    np.testing.assert_array_equal(flat["params/a"], t["a"].numpy())
    np.testing.assert_array_equal(flat["params/b/c"], t["b"]["c"].numpy())
    rebuilt = ck.unflatten_into(
        {k: v for k, v in flat.items() if k.startswith("params/")}, t)
    assert torch.equal(rebuilt["a"], t["a"])
    assert torch.equal(rebuilt["b"]["c"], t["b"]["c"])


def _corrupt_last_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x13")


def test_integrity_check_names_array_and_path(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(4, _tree(), blocking=True)
    _corrupt_last_byte(os.path.join(str(tmp_path), "step_0000000004",
                                    "params__b__c.npy"))
    with pytest.raises(IOError, match=r"params/b/c.*step 4.*"
                                      r"params__b__c\.npy"):
        mgr.load()
    flat, _ = mgr.load(verify=False)       # unverified, it still loads
    assert flat["params/b/c"].shape == (5,)


def test_atomicity_partial_write_invisible(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000002.tmp"))
    assert mgr.latest_step() == 1
    flat, _ = mgr.load()
    assert "params/a" in flat


def test_gc_keeps_last_k(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.steps() == [3, 4]


def test_idempotent_resave(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(), blocking=True)
    mgr.save(5, {"a": torch.zeros(2)}, blocking=True)   # must not raise
    assert mgr.latest_step() == 5
    flat, _ = mgr.load()                   # the first write stands
    assert set(flat) == {"params/a", "params/b/c"}
    assert not [d for d in os.listdir(str(tmp_path)) if d.endswith(".tmp")]


def test_rapid_saves_serialize_and_all_publish(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=32)
    ts = [threading.Thread(
        target=mgr.save,
        args=(s, {"a": torch.full((64, 64), float(s))}),
        kwargs={"blocking": False}) for s in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    mgr.wait()
    assert mgr.steps() == list(range(8))
    assert not [d for d in os.listdir(str(tmp_path)) if d.endswith(".tmp")]
    for s in range(8):
        flat, _ = mgr.load(s)
        assert float(flat["params/a"][0, 0]) == float(s)


def test_save_copies_before_returning(tmp_path):
    """The host copy is taken before ``save`` returns: a change to the
    tensors while the writer runs does not reach the file."""
    mgr = ck.CheckpointManager(str(tmp_path))
    t = {"w": torch.ones(1 << 16)}
    mgr.save(1, t)
    t["w"].mul_(7.0)
    mgr.wait()
    flat, _ = mgr.load()
    assert (flat["params/w"] == 1.0).all()


def _bits(t):
    return convert.tensor_to_numpy(t).tobytes()


def test_port_tree_loads_back_bit_for_bit(tmp_path):
    """Parameters (float32, bfloat16, nested), the AdamW state (an
    int32 step and float32 moments) and the index state's int32 and
    bool arrays: loaded back equal to the saved tensors, bit for bit,
    under the reference's names."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(7, 3, generator=g),
              "bf": torch.randn(4, 5, generator=g).to(torch.bfloat16),
              "shared_attn": {"wq": torch.randn(3, 3, generator=g)}}
    state = topt.init(params)._replace(
        step=torch.tensor(3, dtype=torch.int32),
        mu={"embed": torch.randn(7, 3, generator=g),
            "bf": torch.randn(4, 5, generator=g),
            "shared_attn": {"wq": torch.randn(3, 3, generator=g)}})
    extra = {"flags": torch.tensor([True, False, True]),
             "keys": torch.tensor([5, -1, 2 ** 31 - 1], dtype=torch.int32)}
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(2, {**params, "extra": extra}, state, blocking=True)
    flat, _ = mgr.load()
    saved = ck._flatten({"params": {**params, "extra": extra},
                         "opt": state})
    assert set(flat) == set(saved)
    assert "opt/step" in flat and "opt/mu/shared_attn/wq" in flat
    for name, t in saved.items():
        got = ck.unflatten_into({"params/x": flat[name]}, {"x": t})["x"]
        assert got.dtype == t.dtype and got.shape == t.shape, name
        assert _bits(got) == _bits(t), name
    assert flat["opt/step"].dtype == np.int32 and flat["opt/step"].shape == ()
    assert flat["params/extra/flags"].dtype == np.bool_


# ---------------------------------------------------------------------------
# the checkpoint format across the two packages
# ---------------------------------------------------------------------------

def _jax_params():
    rng = np.random.default_rng(3)
    return {"embed": jnp.asarray(rng.standard_normal((6, 4)), jnp.float32),
            "w": {"q": jnp.asarray(rng.standard_normal((2, 4, 4)),
                                   jnp.float32)},
            "ln": jnp.ones((4,), jnp.float32)}


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jp = _jax_params()
    jstate = jopt.init(jp)
    g = jax.tree.map(lambda x: 0.5 * x, jp)
    jp2, jstate2 = jopt.update(g, jstate, jp)
    jck.CheckpointManager(str(tmp_path)).save(
        7, jp2, jstate2, extra={"data_step": 7}, blocking=True)
    flat, extra = ck.CheckpointManager(str(tmp_path)).load()
    assert extra == {"data_step": 7}
    want = jck._flatten({"params": jp2, "opt": jstate2})
    assert set(flat) == set(want)
    for k, v in want.items():
        a = np.asarray(v)
        assert flat[k].dtype == a.dtype and flat[k].shape == a.shape, k
        np.testing.assert_array_equal(flat[k], a, err_msg=k)
    tpl = {"embed": torch.zeros(6, 4), "w": {"q": torch.zeros(2, 4, 4)},
           "ln": torch.zeros(4)}
    got = ck.unflatten_into(
        {k: v for k, v in flat.items() if k.startswith("params/")}, tpl)
    for k, v in ck._flatten(got).items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(flat[f"params/{k}"]))


def test_port_checkpoint_loads_in_jax_with_its_checksums(tmp_path):
    tp = {"embed": torch.randn(6, 4), "w": {"q": torch.randn(2, 4, 4)},
          "ln": torch.ones(4)}
    tstate = topt.init(tp)
    ck.CheckpointManager(str(tmp_path)).save(
        3, tp, tstate, extra={"data_step": 3}, blocking=True)
    jm = jck.CheckpointManager(str(tmp_path))
    flat, extra = jm.load(verify=True)
    assert extra == {"data_step": 3}
    # the JAX package's own names for a JAX tree of this shape
    jtpl = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    assert set(flat) == set(jck._flatten({"params": jtpl,
                                          "opt": jopt.init(jtpl)}))
    back = jck.unflatten_into(
        {k: v for k, v in flat.items() if k.startswith("params/")}, jtpl)
    np.testing.assert_array_equal(np.asarray(back["w"]["q"]),
                                  tp["w"]["q"].numpy())
    assert flat["opt/step"].dtype == np.int32


# ---------------------------------------------------------------------------
# serving snapshots (tests/test_snapshot.py, on the port)
# ---------------------------------------------------------------------------

def _device_pool(**kw):
    return TPagedKVPool(48, 8, device=True, index_width=W, index_batch=B,
                        torch_device="cpu", **kw)


def _jax_device_pool(**kw):
    return PagedKVPool(48, 8, device=True, index_width=W, index_batch=B,
                       **kw)


def _drive(pool, trace, lo, hi, record=None):
    kinds = np.asarray(trace.kinds)
    sids = np.asarray(trace.seq_ids)
    for t in range(lo, hi):
        k, s = int(kinds[t]), int(sids[t])
        if k == wl.KV_CREATE:
            pool.create(s)
        elif k == wl.KV_RELEASE:
            pool.release(s)
        elif record is not None:
            record.append((t, bool(pool.lookup_batch([s])[0])))


def _cut(trace, lo):
    """The first point at or past ``lo`` where a device pool driven
    through ``trace`` holds a buffered op."""
    probe, t = _device_pool(), lo
    _drive(probe, trace, 0, lo, [])
    while not probe._pending:
        _drive(probe, trace, t, t + 1, [])
        t += 1
    return t


def _restore(mgr, **kw):
    return snap.restore_serving_snapshot(mgr, device="cpu", **kw)


def test_host_pool_roundtrip(tmp_path):
    trace = twl.kv_request_trace(60, 12, seed=1)
    pool = TPagedKVPool(48, 8, device=False)
    _drive(pool, trace, 0, 60)
    mgr = ck.CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, 60, pool)
    back, eng_state, summary = _restore(mgr)
    assert eng_state is None and "host-pool" in summary
    assert back.chains == pool.chains and back.free == pool.free
    for s in range(12):
        assert back.index.contains(s) == pool.index.contains(s)


def test_device_pool_roundtrip_verdicts_bit_identical(tmp_path):
    trace = twl.kv_request_trace(80, 12, seed=2)
    ref, pool = _device_pool(), _device_pool()
    ref_rec, rec = [], []
    _drive(ref, trace, 0, 80, ref_rec)
    _drive(pool, trace, 0, 40, rec)
    mgr = ck.CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, 40, pool)
    back, _, summary = _restore(mgr)
    assert "plane re-laid" in summary and "shards 1->1" in summary
    assert back._st.key.device.type == "cpu"
    _drive(back, trace, 40, 80, rec)
    assert rec == ref_rec
    assert back.chains == ref.chains and back.free == ref.free
    assert back.stats == ref.stats


def test_snapshot_between_audits_restarts_the_audit_count(tmp_path):
    """A snapshot taken between two audits: the format does not carry
    the lookups since the last audit, so a restored pool counts afresh
    and audits later than the uninterrupted one.  Verdicts, chains and
    free list are the uninterrupted run's; of the stats only ``audits``
    differs, by one (the run ends on an audit of the uninterrupted
    pool, which the restarted count has not reached); the JAX package's
    pool restored from the same snapshot does the same."""
    every = 4
    trace = twl.kv_request_trace(80, 12, seed=2)
    done = np.cumsum(np.asarray(trace.kinds) == wl.KV_LOOKUP)
    # end the run on an audit of the uninterrupted pool
    end = max(t + 1 for t in range(80) if done[t] % every == 0)
    ref, pool = _device_pool(audit_every=every), _device_pool(
        audit_every=every)
    ref_rec, rec = [], []
    _drive(ref, trace, 0, end, ref_rec)
    cut = 40
    _drive(pool, trace, 0, cut, rec)
    while pool._since_audit == 0:
        _drive(pool, trace, cut, cut + 1, rec)
        cut += 1
    snap.save_serving_snapshot(ck.CheckpointManager(str(tmp_path)), cut,
                               pool)
    back, _, _ = _restore(ck.CheckpointManager(str(tmp_path)))
    jback, _, _ = jsnap.restore_serving_snapshot(
        jck.CheckpointManager(str(tmp_path)))
    assert back.audit_every == jback.audit_every == every
    assert back._since_audit == jback._since_audit == 0
    j_rec = list(rec)
    _drive(back, trace, cut, end, rec)
    _drive(jback, trace, cut, end, j_rec)
    assert rec == j_rec == ref_rec
    assert back.chains == ref.chains and back.free == ref.free
    assert {k for k in ref.stats if back.stats[k] != ref.stats[k]} \
        == {"audits"}
    assert ref.stats["audits"] - back.stats["audits"] == 1
    assert back.stats == jback.stats


def test_pending_ops_replay_exactly_once(tmp_path):
    pool = _device_pool()
    for s in (3, 5, 9):
        pool.create(s)
    assert len(pool._pending) == 3
    mgr = ck.CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, 1, pool)
    back, _, summary = _restore(mgr)
    assert "3 pending ops" in summary
    assert back._pending == pool._pending
    got = [bool(back.lookup_batch([s])[0]) for s in (3, 5, 9, 4)]
    assert got == [True, True, True, False]
    assert back._pending == []
    snap.save_serving_snapshot(mgr, 2, back)
    again, _, summary2 = _restore(mgr)
    assert "0 pending ops" in summary2
    assert [bool(again.lookup_batch([s])[0]) for s in (3, 9, 4)] \
        == [True, True, False]


def test_engine_state_roundtrip():
    class Shell:
        clock = 37
        tokens_out = 11
        stalls = 2
        preemptions = 1
        degraded_retries = 3
        latencies = {4: 9, 7: 12}
        queue = [TRequest(seq_id=8, prompt=np.array([1, 2, 3], np.int32),
                          max_new=5, arrival=40)]

    state = snap._engine_state(Shell())
    assert json.loads(json.dumps(state)) == state
    fresh = Shell()
    fresh.clock = 0
    fresh.latencies = {}
    fresh.queue = []
    snap.apply_engine_state(fresh, state)
    assert fresh.clock == 37 and fresh.degraded_retries == 3
    assert fresh.latencies == {4: 9.0, 7: 12.0}
    assert all(isinstance(v, float) for v in fresh.latencies.values())
    q = fresh.queue[0]
    assert isinstance(q, TRequest)
    assert (q.seq_id, q.max_new, q.arrival) == (8, 5, 40)
    np.testing.assert_array_equal(q.prompt, [1, 2, 3])
    assert snap._engine_state(Shell()) == jsnap._engine_state(Shell())


def test_degradation_state_and_overrides_carry(tmp_path):
    pool = _device_pool(audit_every=2)
    pool.create(1)
    pool.lookup_batch([1])
    pool._rung = 1
    mgr = ck.CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, 5, pool)
    back, _, _ = _restore(mgr)
    assert back._rung == 1 and back.audit_every == 2
    assert back._lookup_no == pool._lookup_no
    assert back.ctrl == pool.ctrl and back.ctrl_cfg == pool.ctrl_cfg
    back2, _, _ = _restore(mgr, audit_every=1)
    assert back2.audit_every == 1 and back2.fault_plan is None


def test_non_snapshot_checkpoint_refused(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": np.ones(4)}, extra={"data_step": 3}, blocking=True)
    with pytest.raises(ValueError, match="not a serving snapshot"):
        _restore(mgr)
    with pytest.raises(FileNotFoundError):
        _restore(ck.CheckpointManager(str(tmp_path / "empty")))


def test_mesh_restore_raises_naming_a12(tmp_path):
    """Restoring onto a mesh is ported (``tests/test_torch_sharded_serving``
    restores onto 2 ranks); what still raises is a ``mesh`` that is not a
    ``parallel.sharding.Mesh``."""
    mgr = ck.CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, 1, _device_pool())
    with pytest.raises(TypeError, match="sharding.Mesh"):
        snap.restore_serving_snapshot(mgr, mesh=object(), device="cpu")


def test_multi_shard_snapshot_restores_meshless(tmp_path):
    """A snapshot of a sharded, segmented pool (its manifest says 2
    shards) restores meshless by the reference's rule: the plane is
    rebuilt from the state, the controller starts afresh, and the
    verdicts are the uninterrupted run's."""
    trace = twl.kv_request_trace(80, 12, seed=4)
    ref, pool = _device_pool(), _device_pool()
    ref_rec, rec = [], []
    _drive(ref, trace, 0, 80, ref_rec)
    _drive(pool, trace, 0, 40, rec)
    mgr = ck.CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, 40, pool)
    man = os.path.join(str(tmp_path), "step_0000000040", "manifest.json")
    with open(man) as f:
        m = json.load(f)
    m["extra"]["pool"].update(n_shards=2, segmented=True)
    with open(man, "w") as f:
        json.dump(m, f)
    back, _, summary = _restore(mgr)
    assert "shards 2->1" in summary and "plane rebuilt" in summary
    fresh = TPagedKVPool(48, 8, device=True, index_width=W, index_batch=B,
                         torch_device="cpu")
    assert back.ctrl == fresh.ctrl
    _drive(back, trace, 40, 80, rec)
    assert rec == ref_rec


# ---------------------------------------------------------------------------
# serving snapshots across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
def test_jax_snapshot_restores_in_the_port(tmp_path, device):
    trace = wl.kv_request_trace(80, 12, seed=5)
    jref = _jax_device_pool() if device else PagedKVPool(48, 8)
    tref = _device_pool() if device else TPagedKVPool(48, 8)
    jpool = _jax_device_pool() if device else PagedKVPool(48, 8)
    j_rec, t_rec, rec = [], [], []
    _drive(jref, trace, 0, 80, j_rec)
    _drive(tref, trace, 0, 80, t_rec)
    cut = _cut(trace, 40)
    _drive(jpool, trace, 0, cut, rec)
    if device:
        assert jpool._pending, "no op buffered at the snapshot"
    mgr = jck.CheckpointManager(str(tmp_path))
    jsnap.save_serving_snapshot(mgr, cut, jpool)
    back, _, summary = _restore(ck.CheckpointManager(str(tmp_path)))
    if device:
        assert back._pending == jpool._pending
        assert "plane re-laid" in summary
    _drive(back, trace, cut, 80, rec)
    assert rec == j_rec == t_rec
    assert back.chains == jref.chains and back.free == jref.free
    if device:
        assert back.stats == jref.stats


@pytest.mark.parametrize("device", [False, True])
def test_port_snapshot_restores_in_jax(tmp_path, device):
    trace = twl.kv_request_trace(80, 12, seed=6)
    jref = _jax_device_pool() if device else PagedKVPool(48, 8)
    tref = _device_pool() if device else TPagedKVPool(48, 8)
    tpool = _device_pool() if device else TPagedKVPool(48, 8)
    j_rec, t_rec, rec = [], [], []
    _drive(jref, trace, 0, 80, j_rec)
    _drive(tref, trace, 0, 80, t_rec)
    cut = _cut(trace, 40)
    _drive(tpool, trace, 0, cut, rec)
    if device:
        assert tpool._pending, "no op buffered at the snapshot"
    snap.save_serving_snapshot(ck.CheckpointManager(str(tmp_path)), cut,
                               tpool)
    jm = jck.CheckpointManager(str(tmp_path))
    jm.load(verify=True)                    # the JAX package's SHA-256
    back, _, summary = jsnap.restore_serving_snapshot(jm)
    if device:
        assert back._pending == tpool._pending
        assert "plane re-laid" in summary
    _drive(back, trace, cut, 80, rec)
    assert rec == j_rec == t_rec
    assert back.chains == tref.chains and back.free == tref.free


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_serve_main_snapshot_then_resume(tmp_path, capsys):
    d = str(tmp_path)
    args = ["--smoke", "--device", "cpu", "--device-index", "--requests",
            "3", "--max-new", "2", "--snapshot-dir", d]
    first = tserve.main(args)
    out = capsys.readouterr().out
    mgr = ck.CheckpointManager(d)
    step = mgr.latest_step()
    assert step is not None and f"saved serving snapshot step {step}" in out
    _, extra = mgr.load()
    assert extra["snapshot_format"] == snap.SNAPSHOT_FORMAT
    assert extra["engine"]["clock"] == step and extra["pool"]["device"]
    again = tserve.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert f"restored serving snapshot step {step}: 0 live sessions" in out
    assert again == first            # the same requests, the same ids
    assert mgr.latest_step() > step  # the resumed clock went on
