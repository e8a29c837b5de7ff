"""The serving loop's spans and counters (``repro_torch.core.trace``) on
the CPU: nothing recorded with tracing off, the span tree of a read and
a read-write batch, the host waits by site (the same on and off), F's
plain walk and step counts, the event counters, the launch counters in
the registry, and the counts kept apart under a profiler session."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx
from repro_torch.core import trace
from repro_torch.kernels import fold, ops

N_KEYS, CAP, LEVELS, WIDTH, B = 300, 512, 12, 1024, 64


@pytest.fixture(autouse=True)
def _fresh():
    trace.enable(False)
    trace.reset_counts()
    yield
    trace.enable(False)
    trace.reset_counts()


def _served():
    rng = np.random.default_rng(7)
    pool = rng.permutation(2 * N_KEYS)[:N_KEYS].astype(np.int32)
    st = sx.make(CAP, LEVELS, device="cpu")
    st, _, _ = sx.run_ops(st, np.ones(N_KEYS, np.int32), pool,
                          np.ones(N_KEYS, bool))
    plane = dix.from_state_device(st, n_levels=LEVELS, width=WIDTH)
    return st, plane, pool, rng


def _batch(path, pool, rng):
    keys = rng.choice(pool, B).astype(np.int32)
    kinds = np.zeros(B, np.int32)
    if path == "rw":
        kinds[:4] = sx.OP_INSERT
        keys[:4] = np.arange(5000, 5004)
        kinds[4:8] = sx.OP_DELETE
    upd = rng.random(B) < 0.3
    return (torch.as_tensor(kinds[None]), torch.as_tensor(keys[None]),
            torch.as_tensor(upd[None]))


def _serve(path, st, plane, batch):
    read = path == "read"
    return sx.run_serving(st, plane, *batch, aggregate=read,
                          plane_search=read)


def _profiled(path):
    st, plane, pool, rng = _served()
    batch = _batch(path, pool, rng)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(path, st, plane, batch)
    return prof


def _splay_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("splay."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_off_records_no_span_and_no_walk_count():
    prof = _profiled("read")
    assert not [e for e in prof.events() if e.name.startswith("splay.")]
    c = trace.counts()
    assert c.get("fold.walks", 0) == 0 and c.get("fold.steps", 0) == 0
    assert c["epochs"] == 1                  # host counters are always on
    assert trace.span("splay.x") is trace.span("splay.y")


# each span's nearest splay.* ancestor, one batch of each path
TREE = {
    "read": {("splay.serving", None), ("splay.epoch", "splay.serving"),
             ("splay.search", "splay.epoch"), ("splay.walk", "splay.epoch"),
             ("splay.fold_list", "splay.epoch"),
             ("splay.clone", "splay.epoch"), ("splay.fold", "splay.epoch"),
             ("splay.refresh", "splay.epoch"),
             ("splay.overflow_step", "splay.serving")},
    "rw": {("splay.serving", None), ("splay.epoch", "splay.serving"),
           ("splay.clone", "splay.epoch"), ("splay.fold", "splay.epoch"),
           ("splay.refresh", "splay.epoch"),
           ("splay.overflow_step", "splay.serving")}}


@pytest.mark.parametrize("path", ["read", "rw"])
def test_on_gives_the_span_tree(path):
    trace.enable(True)
    prof = _profiled(path)
    spans = [e for e in prof.events() if e.name.startswith("splay.")]
    assert {(e.name, _splay_parent(e)) for e in spans} == TREE[path]
    for name, _ in TREE[path]:
        assert sum(e.name == name for e in spans) == 1


# host reads of device values in one batch, by site, on the CPU (the
# card reads W's and F's status words instead of the plain walk's key
# check: tests/test_torch_cuda.py holds its table)
CPU_WAITS = {
    "read": {"plane.live": 1, "plane.gap": 1, "search.live": 1,
             "search.gap": 1, "walk.keys": 1, "rebuild.m": 1,
             "rebuild.dhits": 1, "refresh.stale": 1, "refresh.new": 1,
             "refresh.old": 1, "refresh.width": 1, "refresh.overflow": 1,
             "serving.overflow": 1, "serving.size": 1},
    "rw": {"plane.live": 1, "plane.gap": 1, "run_ops.kinds": 1,
           "refresh.stale": 1, "refresh.new": 1, "refresh.old": 1,
           "refresh.overflow": 1, "serving.overflow": 1,
           "serving.size": 1}}


@pytest.mark.parametrize("path", ["read", "rw"])
def test_waits_by_site_are_the_same_on_and_off(path):
    st, plane, pool, rng = _served()
    batch = _batch(path, pool, rng)
    seen = []
    for on in (False, True):
        trace.enable(on)
        trace.reset_counts()
        _serve(path, st, plane, batch)
        seen.append({k[len("waits."):]: v for k, v in trace.counts().items()
                     if k.startswith("waits.")})
    assert seen[0] == seen[1] == CPU_WAITS[path]


def test_pure_reads_step_as_many_times_as_their_path_lengths():
    st, _, pool, rng = _served()
    n = 200
    keys = np.concatenate([rng.choice(pool, n - 20),
                           rng.integers(-5, 700, 20)]).astype(np.int32)
    trace.enable(True)
    trace.reset_counts()
    _, _, plen = sx.run_ops(st, np.zeros(n, np.int32), keys,
                            np.zeros(n, bool))
    c = trace.counts()
    assert c["fold.walks"] == n
    assert c["fold.steps"] == int(plen.sum())


def test_weighted_walks_are_the_positive_entries():
    st, _, pool, rng = _served()
    keys = torch.as_tensor(rng.choice(pool, 100).astype(np.int32))
    w = torch.as_tensor(rng.integers(0, 3, 100).astype(np.int32))
    trace.enable(True)
    before = sx.plain_steps()
    fold.fold_weighted(sx.clone(st), keys, w, torch.zeros_like(w))
    c = trace.counts()
    assert c["fold.walks"] == int((w > 0).sum())
    assert c["fold.steps"] == sx.plain_steps() - before > 0


def test_event_counters():
    st, plane, pool, rng = _served()
    trace.reset_counts()
    fresh = sx.rebuild(st)                  # compacts slots: a stale map
    dix.refresh_device(fresh, plane, return_overflow=True)
    c = trace.counts()
    assert c["rebuilds.state"] == 1 and c["refresh.stale"] == 1
    assert c["waits.rebuild.alive"] == c["waits.rebuild.mass"] == 1
    assert c["waits.rebuild.scalar"] == 4
    # a plane with no room for a batch more: the overflow machine arms
    # on the first epoch and the second rebuilds the plane
    small = dix.from_state_device(st, n_levels=LEVELS, width=N_KEYS + 8)
    kinds, keys, upd = _batch("read", pool, rng)
    trace.reset_counts()
    sx.run_serving(st, small, kinds.repeat(2, 1), keys.repeat(2, 1),
                   upd.repeat(2, 1))
    c = trace.counts()
    assert c["epochs"] == 2 and c["overflow.armed"] >= 1
    assert c["rebuilds.plane"] == 1


def test_launch_counters_are_in_the_registry():
    fold.LAUNCHES["splay_fold"] += 3
    c = trace.counts()
    assert c["launches.splay_fold"] == 3
    assert {f"launches.{k}" for k in ops.launch_counts()} <= set(c)
    trace.count("epochs")
    ops.reset_launch_counts()
    assert trace.counts()["launches.splay_fold"] == 0
    assert trace.counts()["epochs"] == 1
    fold.LAUNCHES["splay_fold"] += 1
    trace.reset_counts()
    assert ops.launch_counts()["splay_fold"] == 0


def test_profiled_counts_are_those_of_the_session():
    trace.enable(True)
    assert trace.span("splay.x") is trace.span("splay.y")   # no session
    trace.count("waits.x", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("waits.x")
        with trace.span("splay.y", 5):
            pass
    trace.count("waits.x")
    assert trace.counts()["waits.x"] == 4
    assert trace.counts(profiled=True) == {"waits.x": 1}
    trace.enable(False)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("waits.x")
    assert trace.counts(profiled=True) == {"waits.x": 1}
    assert trace.device_counter("fold", fold.COUNTED, "cpu") is None
