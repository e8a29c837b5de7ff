"""PyTorch port, the paper's baselines and workloads against the JAX
package, on the same numpy seeds:

* the generators (``xy_workload``, ``uniform_workload``,
  ``general_workload``, the drift scenarios): every array bit for bit;
* the sequential engines, op by op: ``CBTree`` (answers,
  ``last_path_len``, depths, ``check_weights``) and ``SkipList``
  (answers, ``last_path_len``, the nodes' heights);
* the skip-list state engine: ``make``, ``run_ops`` (kernel S's plain
  version on CPU tensors), ``find_batch``, ``run_contains_batch`` and
  ``sample_heights`` — every state array, answer and path length bit for
  bit, with revives, deletes of absent keys, keys at ``NEG_INF_32 + 1``
  and an empty batch, and on the streams of ``skip_streams.py`` that
  exercise S's fingers (ascending, descending and interleaved inserts,
  revives, duplicates, a capacity stop, max levels 1 and 33);
* the fingers themselves: every insert's predecessors from them equal
  the reference's top-down ones on random streams;
* the capacity fault: an insert past the capacity raises and leaves the
  state as it was (the JAX ``run_ops`` does not return there, so it is
  not called)."""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cbtree as jcb
from repro.core import skiplist as jskx
from repro.core import workload as jwl
from repro_torch.core import cbtree as tcb
from repro_torch.core import skiplist as tskx
from repro_torch.core import workload as twl
from repro_torch.kernels import skip_fold
from skip_streams import FINGER_SHAPES, FINGER_STREAMS

GENERATORS = [
    ("xy", dict(n=1000, x=0.9, y=0.1, ops=4000, p=1.0, seed=0)),
    ("xy", dict(n=777, x=0.99, y=0.01, ops=3000, p=0.01, seed=42)),
    ("xy", dict(n=500, x=0.95, y=0.05, ops=2000, p=0.1, seed=9,
                key_space=5000)),
    ("uniform", dict(n=1000, ops=3000, seed=11)),
    ("uniform", dict(n=300, ops=1000, p=0.2, seed=3)),
    ("general", dict(n=1000, r=0.98, x=0.9, y=0.1, s=0.25, ops=4000,
                     p=0.01, seed=21)),
    ("general", dict(n=600, r=0.5, x=0.99, y=0.01, s=1.0, ops=3000,
                     seed=5)),
    ("zipf", dict(n=2000, ops=3000, s=1.0, p=0.1, seed=12)),
    ("rotating_hotset", dict(n=768, epochs=12, batch=512, period=5,
                             seed=7)),
    ("rotating_hotset", dict(n=300, epochs=9, batch=64, seed=1,
                             key_space=4000)),
    ("flash_crowd", dict(n=768, epochs=12, batch=512, onset=3, duration=5,
                         seed=7)),
    ("flash_crowd", dict(n=500, epochs=6, batch=100, seed=2)),
    ("diurnal_zipf", dict(n=768, epochs=12, batch=512, period=8, seed=7)),
    ("diurnal_zipf", dict(n=400, epochs=7, batch=128, period=3, s_day=1.1,
                          seed=4)),
]


def _gen(pkg, name):
    if name in pkg.DRIFT_SCENARIOS:
        return pkg.DRIFT_SCENARIOS[name]
    return getattr(pkg, f"{name}_workload")


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATORS)])
def test_generator_matches_jax(name, kw):
    want = _gen(jwl, name)(**kw)
    got = _gen(twl, name)(**kw)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for f, a, b in zip(want._fields, want, got):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def _ops(seed, n_ops, key_hi):
    rng = random.Random(seed)
    return [(rng.choice("ccccidi"), rng.randrange(key_hi),
             rng.choice((None, True, False))) for _ in range(n_ops)]


@pytest.mark.parametrize("p,seed", [(1.0, 0), (0.3, 1), (0.01, 2)])
def test_cbtree_matches_jax(p, seed):
    a, b = jcb.CBTree(p=p), tcb.CBTree(p=p)
    for kind, k, upd in _ops(seed, 3000, 400):
        if kind == "c":
            ra, rb = a.contains(k, upd=upd), b.contains(k, upd=upd)
        elif kind == "i":
            ra, rb = a.insert(k), b.insert(k)
        else:
            ra, rb = a.delete(k), b.delete(k)
        assert (ra, a.last_path_len) == (rb, b.last_path_len), (kind, k)
    assert (a.size, a.m) == (b.size, b.m)
    assert b.check_weights() and a.check_weights()
    assert [a.depth(k) for k in range(-1, 401)] == \
        [b.depth(k) for k in range(-1, 401)]


def _skip_heights(sl):
    out, node = {}, sl.head.nxt[0]
    while node is not sl.tail:
        out[node.key] = (node.top, node.deleted)
        node = node.nxt[0]
    return out


@pytest.mark.parametrize("max_level,seed", [(32, 0), (6, 1), (2, 2)])
def test_python_skiplist_matches_jax(max_level, seed):
    a, b = jskx.SkipList(max_level), tskx.SkipList(max_level)
    for kind, k, _ in _ops(seed, 3000, 500):
        if kind == "c":
            ra, rb = a.contains(k), b.contains(k)
        elif kind == "i":
            ra, rb = a.insert(k), b.insert(k)
        else:
            ra, rb = a.delete(k), b.delete(k)
        assert (ra, a.last_path_len) == (rb, b.last_path_len), (kind, k)
        fa, fb = a.find(k), b.find(k)
        assert (fa[0] is None, fa[1]) == (fb[0] is None, fb[1])
    assert a.size == b.size
    assert _skip_heights(a) == _skip_heights(b)


# ---------------------------------------------------------------------------
# the state engine
# ---------------------------------------------------------------------------

CAP, ML, T = 320, 8, 400         # one JAX compile for every stream
NEG1 = tskx.NEG_INF_32 + 1


def _stream(seed, p_kinds, key_lo=-5, key_hi=250):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(3, T, p=p_kinds).astype(np.int32)
    keys = rng.integers(key_lo, key_hi, T).astype(np.int32)
    return kinds, keys


def _revives(seed):
    """Inserts, deletes of half of them (and of absent keys), then the
    same keys inserted again: every revive path, and keys at
    NEG_INF_32 + 1."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(1000)[:150].astype(np.int32)
    pool[:2] = (NEG1, NEG1 + 7)
    gone = pool[::2]
    absent = (2000 + np.arange(50)).astype(np.int32)
    kinds = np.concatenate([np.full(150, 1), np.full(75, 2), np.full(50, 2),
                            np.full(75, 1), np.full(50, 0)]).astype(np.int32)
    keys = np.concatenate([pool, gone, absent, gone,
                           rng.choice(pool, 50)]).astype(np.int32)
    return kinds, keys


STREAMS = {
    "mixed": lambda: _stream(1, [0.3, 0.5, 0.2]),
    "insert-heavy": lambda: _stream(2, [0.1, 0.8, 0.1], 0, 1000),
    "delete-heavy": lambda: _stream(3, [0.2, 0.3, 0.5], 0, 60),
    "revives": lambda: _revives(4),
    **FINGER_STREAMS,
}
# (capacity, max_level) of the streams not on (CAP, ML)
SHAPES = {name: shape(ML) for name, shape in FINGER_SHAPES.items()}


def _heights(seed, n, ml=ML):
    return (jskx.sample_heights(np.random.default_rng(seed), n, ml),
            tskx.sample_heights(np.random.default_rng(seed), n, ml,
                                device="cpu"))


def _assert_state_equal(js, ts):
    assert js._fields == ts._fields
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _eq(a, b, msg=""):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


def test_make_matches_jax():
    _assert_state_equal(jskx.make(CAP, ML),
                        tskx.make(CAP, ML, device="cpu"))


@pytest.mark.parametrize("seed,n,ml", [(0, 1000, 20), (1, 17, 8),
                                       (5, 0, 4), (9, 4096, 1)])
def test_sample_heights_matches_jax(seed, n, ml):
    a, b = _heights(seed, n, ml)
    _eq(a, b)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_run_ops_matches_jax(name):
    kinds, keys = STREAMS[name]()
    cap, ml = SHAPES.get(name, (CAP, ML))
    jh, th = _heights(len(name), kinds.shape[0], ml)
    t0 = tskx.make(cap, ml, device="cpu")
    before = tskx.to_numpy(t0)
    try:
        ts, tr, tp = tskx.run_ops(t0, kinds, keys, th)
        stop = None
    except RuntimeError as e:
        stop = int(re.search(r"exhausted at op (\d+)", str(e)).group(1))
    assert (stop is not None) == (name == "fingers-capacity-stop")
    if stop is not None:
        # the port stops before the insert that finds no slot; the JAX
        # run_ops does not return there, so it takes the ops before it
        assert int((kinds[:stop] == 1).sum()) > 2 * (cap - 2) // 3
        ts = tskx.clone(t0)
        res = torch.zeros(kinds.shape[0], dtype=torch.bool)
        plen = torch.zeros(kinds.shape[0], dtype=torch.int32)
        assert skip_fold.fold_ops(ts, *(torch.as_tensor(x) for x in (
            kinds, keys, th.numpy())), res, plen) == stop
        kinds, keys, jh = kinds[:stop], keys[:stop], jh[:stop]
        tr, tp = res[:stop], plen[:stop]
    js, jr, jp = jskx.run_ops(jskx.make(cap, ml), jnp.asarray(kinds),
                              jnp.asarray(keys), jh)
    _assert_state_equal(js, ts)
    _eq(jr, tr, "res")
    _eq(jp, tp, "plen")
    assert all(np.array_equal(before[f], v)
               for f, v in tskx.to_numpy(t0).items())    # functional
    # the searches on the folded state, hits and misses and the extremes
    q = np.concatenate([keys[:200], [NEG1, tskx.NEG_INF_32,
                                     -(2 ** 31), tskx.POS_INF_32 - 1,
                                     -1, 0, 999]]).astype(np.int32)
    a, b = jskx.find_batch(js, jnp.asarray(q)), tskx.find_batch(ts, q)
    _eq(a[0], b[0], "slot")
    _eq(a[1], b[1], "steps")
    a, b = jskx.run_contains_batch(js, jnp.asarray(q)), \
        tskx.run_contains_batch(ts, q)
    _eq(a[1], b[1], "live")
    _eq(a[2], b[2], "steps")
    for k in q[-7:]:
        _eq(jskx.find(js, jnp.int32(k))[1], tskx.find(ts, int(k))[1],
            "scalar find steps")


@pytest.mark.parametrize("seed,ml", [(0, 8), (1, 1), (2, 20), (3, 33),
                                     (4, 64)])
def test_finger_preds_equal_top_down(seed, ml):
    """On random streams (runs of rising and falling inserts, jumps,
    contains, deletes and revives), every insert's predecessors from
    the fingers equal the reference's top-down ``_find_preds`` at every
    level, on the state as the fold had it then."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(12):
        start, n = int(rng.integers(0, 5000)), int(rng.integers(5, 40))
        step = int(rng.choice([-7, -1, 1, 3, 50]))
        parts.append(start + step * np.arange(n))
        parts.append(rng.integers(-50, 5100, int(rng.integers(1, 10))))
    keys = np.concatenate(parts).astype(np.int32)
    kinds = rng.choice(3, keys.shape[0], p=[0.15, 0.7, 0.15]).astype(
        np.int32)
    heights = tskx.sample_heights(rng, keys.shape[0], ml, device="cpu")
    st = tskx.make(keys.shape[0] + 2, ml, device="cpu")
    res = torch.zeros(keys.shape[0], dtype=torch.bool)
    plen = torch.zeros(keys.shape[0], dtype=torch.int32)
    trace = []
    stop = tskx.fold_plain(st, torch.as_tensor(kinds), torch.as_tensor(keys),
                           heights, res, plen, trace)
    assert stop == keys.shape[0]
    assert len(trace) == int((kinds == 1).sum()) > 100
    for by_finger, top_down in trace:
        assert by_finger == top_down


def test_run_ops_on_a_populated_state_matches_jax():
    """A populate (as Figs. 3-5 make it: sorted keys, heights from
    ``default_rng(0)``), then a mixed stream on its result."""
    pool = np.sort(np.random.default_rng(6).permutation(5000)[:T]).astype(
        np.int32)
    jh, th = _heights(0, T)
    ins = np.ones(T, np.int32)
    js, jr, _ = jskx.run_ops(jskx.make(CAP + 200, ML), jnp.asarray(ins),
                             jnp.asarray(pool), jh)
    ts, tr, _ = tskx.run_ops(tskx.make(CAP + 200, ML, device="cpu"), ins,
                             pool, th)
    _assert_state_equal(js, ts)
    assert bool(tr.all())
    kinds, keys = _stream(7, [0.6, 0.2, 0.2], 0, 5000)
    jh, th = _heights(8, T)
    js, jr, jp = jskx.run_ops(js, jnp.asarray(kinds), jnp.asarray(keys), jh)
    ts, tr, tp = tskx.run_ops(ts, kinds, keys, th)
    _assert_state_equal(js, ts)
    _eq(jr, tr, "res")
    _eq(jp, tp, "plen")


def test_empty_batches_match_jax():
    kinds, keys = _stream(1, [0.3, 0.5, 0.2])
    jh, th = _heights(1, T)
    js, _, _ = jskx.run_ops(jskx.make(CAP, ML), jnp.asarray(kinds),
                            jnp.asarray(keys), jh)
    ts, _, _ = tskx.run_ops(tskx.make(CAP, ML, device="cpu"), kinds, keys,
                            th)
    e = np.zeros(0, np.int32)
    js2, jr, jp = jskx.run_ops(js, jnp.asarray(e), jnp.asarray(e),
                               jnp.asarray(e))
    ts2, tr, tp = tskx.run_ops(ts, e, e, e)
    _assert_state_equal(js2, ts2)
    _eq(jr, tr, "res")
    _eq(jp, tp, "plen")
    a, b = jskx.run_contains_batch(js, jnp.asarray(e)), \
        tskx.run_contains_batch(ts, e)
    _eq(a[1], b[1], "live")
    _eq(a[2], b[2], "steps")


@pytest.mark.parametrize("prefix", [0, 5])
def test_insert_past_capacity_raises(prefix):
    """The reference fault's input (``make(4, 4)``, inserts 10, 20, 30
    of heights 0, 1, 0): the third insert finds the capacity exhausted.
    Both the wrapper and the plain fold report it before writing the
    op; the caller's state is untouched.  With ``prefix`` contains
    first, the stop index moves with them."""
    st = tskx.make(4, 4, device="cpu")
    before = tskx.to_numpy(st)
    kinds = np.array([0] * prefix + [1, 1, 1, 0, 0], np.int32)
    keys = np.array([10] * prefix + [10, 20, 30, 30, 20], np.int32)
    heights = np.array([0] * prefix + [0, 1, 0, 0, 0], np.int32)
    with pytest.raises(RuntimeError, match="capacity 4 exhausted at op "
                       f"{prefix + 2}"):
        tskx.run_ops(st, kinds, keys, heights)
    assert all(np.array_equal(before[f], v)
               for f, v in tskx.to_numpy(st).items())
    work = tskx.clone(st)
    res = torch.zeros(kinds.shape[0], dtype=torch.bool)
    plen = torch.zeros(kinds.shape[0], dtype=torch.int32)
    stop = skip_fold.fold_ops(work, *(torch.as_tensor(x) for x in
                                      (kinds, keys, heights)), res, plen)
    assert stop == prefix + 2
    assert int(work.n_alloc) == 4 and int(work.size) == 2
    assert (work.nxt != -1).sum() == 4 + 2 + 1   # head's 4, 10's 1, 20's 2
    # a state with room takes the same ops
    ok, res, _ = tskx.run_ops(tskx.make(8, 4, device="cpu"), kinds, keys,
                              heights)
    assert res.tolist() == [False] * prefix + [True] * 5
    assert int(ok.size) == 3


def test_walk_keys_at_pos_inf_are_refused():
    st = tskx.make(8, 4, device="cpu")
    with pytest.raises(ValueError, match="POS_INF_32"):
        tskx.run_ops(st, [0], [tskx.POS_INF_32], [0])
    with pytest.raises(ValueError, match="POS_INF_32"):
        tskx.find_batch(st, [1, tskx.POS_INF_32])


def test_bad_op_streams_are_refused():
    st = tskx.make(8, 4, device="cpu")
    with pytest.raises(ValueError, match="op kinds"):
        tskx.run_ops(st, [3], [1], [0])
    with pytest.raises(ValueError, match="ragged"):
        tskx.run_ops(st, [0, 1], [1], [0, 0])
    with pytest.raises(ValueError, match="op tensor on"):
        tskx.run_ops(st, torch.zeros(1, dtype=torch.int32, device="meta"),
                     [1], [0])


def test_state_engine_refuses_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tskx.make(8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tskx.sample_heights(np.random.default_rng(0), 4, 4)
