"""PyTorch port, paged KV pool: the port's ``serve/kv_cache.py`` (host
mode, and device mode on CPU tensors) against the JAX package's pools
on the same ``kv_request_trace``/``kv_scan_trace`` request traces
(seeds 0 and 3): every answer, the final chains and ``stats`` equal.
Then create-reject at the index width, batched verdicts, the fault
ladder (a bit-flip caught by the audit gate, the repair epoch, the rung
climb, a telemetry blackout, a one-survivor shard loss and
``InjectedCrash``), the rung-2 host oracle, and the KV traces
themselves against the JAX generators."""

import numpy as np
import pytest

from repro.core import faults as fl
from repro.core import workload as wl
from repro.serve.kv_cache import PagedKVPool
from repro_torch.core import faults as tfl
from repro_torch.core import workload as twl
from repro_torch.serve.kv_cache import PagedKVPool as TPagedKVPool


def _pools(**kw):
    """The JAX and the port pool with the same arguments (the port's on
    CPU tensors in device mode)."""
    tkw = dict(kw)
    if kw.get("fault_plan") is not None:
        plan = kw["fault_plan"]
        tkw["fault_plan"] = tfl.FaultPlan(
            seed=plan.seed, events=[tfl.FaultEvent(*e)
                                    for e in plan.events])
    if kw.get("device"):
        tkw["torch_device"] = "cpu"
    return PagedKVPool(**kw), TPagedKVPool(**tkw)


def _replay(pool, trace, max_range=4):
    log = []
    his = trace.hi_ids if trace.hi_ids is not None else trace.seq_ids
    for k, s, hi in zip(trace.kinds.tolist(), trace.seq_ids.tolist(),
                        his.tolist()):
        try:
            if k == wl.KV_CREATE:
                ok = pool.create(s)
                if ok:
                    ok = pool.append_tokens(s, 3) and ok
                log.append((k, s, ok))
            elif k == wl.KV_LOOKUP:
                c = pool.lookup(s)
                log.append((k, s, None if c is None else tuple(c)))
            elif k == wl.KV_RELEASE:
                pool.release(s)
                log.append((k, s, round(pool.utilization, 6)))
            elif k == wl.KV_SCAN:
                ids, cnt, tr = pool.lookup_range(s, hi, max_range=max_range)
                log.append((k, s, (tuple(ids.tolist()), cnt, tr)))
            else:
                log.append((k, s, pool.predecessor(s)))
        except (fl.InjectedCrash, tfl.InjectedCrash) as e:
            log.append((k, s, "crash", type(e).__name__))
    return log, sorted(pool.chains)


def _same(a, b):
    """Two replay logs, equal but for which package's crash class."""
    def norm(log):
        return [x[:3] for x in log[0]], log[1]
    assert norm(a) == norm(b)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_pools_match_jax_on_traces(seed, scan):
    if scan:
        trace = twl.kv_scan_trace(150, 12, seed=seed)
        ref = wl.kv_scan_trace(150, 12, seed=seed)
        np.testing.assert_array_equal(trace.hi_ids, ref.hi_ids)
    else:
        trace = twl.kv_request_trace(150, 12, seed=seed)
        ref = wl.kv_request_trace(150, 12, seed=seed)
        assert trace.hi_ids is None
    np.testing.assert_array_equal(trace.kinds, ref.kinds)
    np.testing.assert_array_equal(trace.seq_ids, ref.seq_ids)
    assert trace.kinds.dtype == ref.kinds.dtype
    host_j, host_t = _pools(n_pages=24, page_size=4)
    dev_j, dev_t = _pools(n_pages=24, page_size=4, device=True,
                          index_width=32, index_batch=8)
    logs = [_replay(p, trace) for p in (host_j, host_t, dev_j, dev_t)]
    assert logs[0] == logs[1] == logs[2] == logs[3]
    assert host_t.stats == host_j.stats
    assert dev_t.stats == dev_j.stats
    assert dev_t.spill_traj == dev_j.spill_traj
    assert dev_t.share_traj == dev_j.share_traj
    assert tuple(dev_t.ctrl) == tuple(dev_j.ctrl)
    np.testing.assert_array_equal(dev_t.last_occupancy, dev_j.last_occupancy)


def test_create_reject_and_batched_verdicts():
    pj, pt = _pools(n_pages=8, page_size=4, device=True, index_width=8,
                    index_batch=4)
    for p in (pj, pt):
        for s in range(8):
            assert p.create(s)
        assert not p.create(99)
        assert p.lookup_batch([0, 1, 99, 7, 8, 5]).tolist() == [
            True, True, False, True, False, True]
        p.release(0)
        assert p.create(99)
        assert p.append_tokens(99, 5)
    assert pt.stats == pj.stats and pt.stats["create_rejects"] == 1
    assert pt.stats["plane_epochs"] == 2 and pt.stats["spill"] == 0
    assert pt.last_occupancy.shape == (1,)
    assert pt.ctrl.retraces == 0 and pt.ctrl.escalations == 0
    assert tuple(pt.ctrl) == tuple(pj.ctrl)
    assert pt.page_table(99, 4).tolist() == pj.page_table(99, 4).tolist()
    # the state holds index_width + 2 slots and a released session's
    # slot comes back only with a rebuild: this flush inserts past the
    # capacity, which the port refuses before writing anything (the JAX
    # scan's insert past capacity does not return)
    with pytest.raises(RuntimeError, match="capacity"):
        pt.lookup_batch([99])


def test_fault_ladder_matches_jax():
    """A bit-flip at an audited lookup epoch is caught, repaired by one
    rebuild epoch and the pool climbs back a rung per clean pass; a
    telemetry blackout, a one-survivor shard loss and a crash fire once
    each.  A second flip lands between audits, where both packages serve
    from the corrupted plane alike until the next audit repairs it.
    Without that flip the pool answers as the host pool, which has no
    plane to corrupt, but for the crashed op."""
    plan = fl.FaultPlan(seed=5, events=[
        fl.FaultEvent(3, fl.FAULT_BITFLIP, 2),
        fl.FaultEvent(5, fl.FAULT_TELEMETRY, 3),
        fl.FaultEvent(9, fl.FAULT_SHARD_LOSS, 1),
        fl.FaultEvent(12, fl.FAULT_CRASH),
        fl.FaultEvent(15, fl.FAULT_BITFLIP, 1)])
    trace = twl.kv_scan_trace(160, 16, seed=1)
    pj, pt = _pools(n_pages=64, page_size=4, device=True, index_width=32,
                    index_batch=8, audit_every=4, fault_plan=plan)
    host, _ = _pools(n_pages=64, page_size=4)
    a, b, h = _replay(pj, trace), _replay(pt, trace), _replay(host, trace)
    _same(a, b)
    _, one_flip = _pools(n_pages=64, page_size=4, device=True,
                         index_width=32, index_batch=8, audit_every=4,
                         fault_plan=fl.FaultPlan(seed=5,
                                                 events=plan.events[:-1]))
    c = _replay(one_flip, trace)
    assert len(c[0]) == len(h[0]) and c[1] == h[1]
    kept = [i for i, x in enumerate(c[0]) if x[2] != "crash"]
    assert len(kept) == len(h[0]) - 1
    assert [c[0][i] for i in kept] == [h[0][i] for i in kept]
    assert ("crash", "InjectedCrash") in [x[2:] for x in b[0]]
    assert pt.stats == pj.stats
    st = pt.stats
    assert st["faults_injected"] == 5 and st["remeshes"] == 1
    assert st["audit_failures"] >= 1 and st["repairs"] >= 1
    assert st["telemetry_dropped"] >= 1 and st["degraded_masked"] > 0
    assert st["degraded_host"] == 0
    assert pt._rung == pj._rung == 0
    assert (tuple(pt.last_audit) == tuple(pj.last_audit)
            and tuple(pt.last_audit) == (0,) * 11)
    # meshless, a loss down to two survivors rebuilds meshless, as
    # the JAX pool does when there are no two devices to remesh onto
    pt.on_shard_loss(2)
    assert pt.mesh is None and not pt._sharded and pt._rung == 1
    assert pt.stats["remeshes"] == 2


def test_rung_two_host_oracle_matches_jax():
    """Pinned at rung 2 (a plane no repair could clean), every read is
    answered from the host: the SplayList mirror for membership, the
    live-session metadata for predecessor and range queries."""
    pj, pt = _pools(n_pages=64, page_size=4, device=True, index_width=32,
                    index_batch=8, audit_every=2)
    trace = twl.kv_scan_trace(60, 16, seed=2)
    for p in (pj, pt):
        for s in range(0, 16, 3):
            p.create(s)
        p._rung = 2
    a, b = _replay(pj, trace), _replay(pt, trace)
    assert a == b and pt.stats == pj.stats
    assert pt.stats["degraded_host"] > 0
    assert pt._rung == pj._rung
