"""PyTorch port, ordered operations: rank, predecessor, successor,
select, range count, range scan and top-k of the port's
``kernels/splay_search.py`` against the JAX package's (its Pallas
descents in interpret mode) on planes converted from the same state
(``core/convert.py``), bit-exact — empty and inverted ranges, int32
extremes, select past the live count, range-scan truncation, top-k
ties; a segmented plane and the sharded path refused.  Then the state
side: ``run_ops`` with all five op kinds (results, path lengths and
every state array, with rebuilds inside the stream), and ordered
``run_epoch``/``run_serving`` against the JAX loops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as dix
from repro.core import splaylist as sx
from repro.kernels import ops as kops
from repro_torch.core import convert
from repro_torch.core import device_index as tdix
from repro_torch.core import splaylist as tsx
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splay_search as tssk
from torch_parity import (assert_arrays_equal, assert_plane_equal,
                          assert_state_equal, to_jax_state)

PAD, NEG = tssk.PAD_KEY, tssk.NEG_INF_KEY
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1
CAP, L, W = 256, 10, 160
NQ = 64


def _state(seed=0, n=90, hot=()):
    """A port state of ``n`` unique keys in [0, 900), with extra
    update-contains hits on ``hot``."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(900)[:n].astype(np.int32)
    ts, _, _ = tsx.run_ops(tsx.make(CAP, L, device="cpu"),
                           np.full(n, tsx.OP_INSERT, np.int32), keys,
                           np.ones(n, bool))
    if len(hot):
        hot = np.asarray(hot, np.int32)
        ts, _, _ = tsx.run_ops(ts, np.zeros(hot.size, np.int32), hot,
                               np.ones(hot.size, bool))
    return ts, np.sort(keys)


@pytest.fixture(scope="module")
def case():
    """One state with a tied hit profile, its JAX plane and the same
    plane converted to the port, the query and range batches, and every
    JAX answer (computed once: each JAX descent shape compiles once)."""
    ts, live = _state(hot=[int(k) for k in
                           np.random.default_rng(9).permutation(900)[:6]])
    js = to_jax_state(ts)
    jp = dix.from_state_device(js, n_levels=L, width=W)
    tp = convert.plane_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(4)
    qs = np.concatenate([
        live[:12], live[:12] + 1, live[-6:] - 1,
        [I32_MIN, I32_MIN + 1, NEG, -5, 0, 899, 900, PAD - 1, PAD,
         I32_MAX - 1],
        rng.integers(-10, 910, NQ)])[:NQ].astype(np.int32)
    lo = rng.integers(-10, 910, NQ).astype(np.int32)
    hi = lo + rng.integers(-20, 60, NQ).astype(np.int32)   # some inverted
    lo[:8] = [I32_MIN, I32_MIN, 0, PAD, PAD - 1, 500, live[3], live[-1]]
    hi[:8] = [I32_MAX, -1, PAD, PAD, PAD, 499, live[3], I32_MAX]
    ranks = np.concatenate([np.arange(-4, 8), np.arange(len(live) - 4,
                                                        len(live) + 4),
                            [I32_MIN, I32_MAX, W, W - 1]]).astype(np.int32)
    j = {}
    j["rank"] = kops.splay_rank(jp, jnp.asarray(qs))
    j["predecessor"] = kops.splay_predecessor(jp, jnp.asarray(qs))
    j["successor"] = kops.splay_successor(jp, jnp.asarray(qs))
    j["select"] = kops.splay_select(jp, jnp.asarray(ranks))
    j["range_count"] = kops.splay_range_count(jp, jnp.asarray(lo),
                                              jnp.asarray(hi))
    j["range_scan"] = kops.splay_range_scan(jp, jnp.asarray(lo),
                                            jnp.asarray(hi), max_range=8)
    hits = jnp.asarray(np.asarray(js.selfhits))
    j["top_k"] = kops.splay_top_k(jp, hits, 12)
    j["top_k_all"] = kops.splay_top_k(jp, hits, W)
    return dict(ts=ts, js=js, jp=jp, tp=tp, live=live, qs=qs, lo=lo,
                hi=hi, ranks=ranks, jax=j)


def _port(c, op, pipelined):
    tp = c["tp"]
    t = lambda x: torch.as_tensor(x)          # noqa: E731
    kw = dict(pipelined=pipelined)
    if op == "rank":
        return tops.splay_rank(tp, t(c["qs"]), **kw)
    if op == "predecessor":
        return tops.splay_predecessor(tp, t(c["qs"]), **kw)
    if op == "successor":
        return tops.splay_successor(tp, t(c["qs"]), **kw)
    if op == "select":
        return tops.splay_select(tp, t(c["ranks"]))
    if op == "range_count":
        return tops.splay_range_count(tp, t(c["lo"]), t(c["hi"]), **kw)
    if op == "range_scan":
        return tops.splay_range_scan(tp, t(c["lo"]), t(c["hi"]),
                                     max_range=8, **kw)
    hits = c["ts"].selfhits
    return tops.splay_top_k(tp, hits, W if op == "top_k_all" else 12)


def _equal(a, b, msg):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_arrays_equal(x, y, f"{msg}[{i}]")
    else:
        assert_arrays_equal(a, b, msg)


@pytest.mark.parametrize("op,pipelined", [
    (op, p) for op in ("rank", "predecessor", "successor", "range_count",
                       "range_scan") for p in (False, True)]
    + [("select", None), ("top_k", None), ("top_k_all", None)])
def test_ordered_op_matches_jax(case, op, pipelined):
    """B1 (``pipelined=False``) and B2's plain versions both answer."""
    _equal(case["jax"][op], _port(case, op, pipelined), op)


def test_ordered_ops_against_sorted_oracle(case):
    """The answers the parity above pins are the right ones: the sorted
    live set's ranks, predecessors, successors, range members, and the
    top-k's tie order (equal hit mass by ascending rank)."""
    live, qs, lo, hi = case["live"], case["qs"], case["lo"], case["hi"]
    tp = case["tp"]
    r = tops.splay_rank(tp, torch.as_tensor(qs)).numpy()
    i = np.searchsorted(live, qs.astype(np.int64), side="right")
    np.testing.assert_array_equal(r, i)
    pk, pr = (x.numpy() for x in tops.splay_predecessor(
        tp, torch.as_tensor(qs)))
    np.testing.assert_array_equal(pk, np.where(i > 0, live[i - 1], NEG))
    np.testing.assert_array_equal(pr, i - 1)
    j = np.searchsorted(live, qs.astype(np.int64), side="left")
    sk, sr = (x.numpy() for x in tops.splay_successor(
        tp, torch.as_tensor(qs)))
    np.testing.assert_array_equal(
        sk, np.where(j < len(live), live[np.minimum(j, len(live) - 1)],
                     PAD))
    np.testing.assert_array_equal(sr, j)
    keys, cnt, tr = (x.numpy() for x in tops.splay_range_scan(
        tp, torch.as_tensor(lo), torch.as_tensor(hi), max_range=8))
    for n in range(NQ):
        want = live[(live >= lo[n]) & (live <= hi[n])]
        assert cnt[n] == want.size and tr[n] == max(want.size - 8, 0)
        np.testing.assert_array_equal(keys[n, :min(want.size, 8)],
                                      want[:8])
        assert (keys[n, want.size:] == PAD).all()
    assert (tr > 0).any() and (cnt == 0).any()
    tk, th, trk = (x.numpy() for x in tops.splay_top_k(
        tp, case["ts"].selfhits, W))
    n_live = len(live)
    assert (tk[:n_live] != PAD).all() and (tk[n_live:] == PAD).all()
    assert (trk[n_live:] == -1).all() and (th[n_live:] == 0).all()
    order = np.lexsort((trk[:n_live], -th[:n_live]))
    np.testing.assert_array_equal(order, np.arange(n_live))
    assert (np.diff(th[:n_live]) == 0).sum() > n_live // 2   # many ties


def test_empty_batches_and_argument_checks(case):
    tp = case["tp"]
    z = torch.zeros((0,), dtype=torch.int32)
    assert tops.splay_select(tp, z).shape == (0,)
    assert tops.splay_range_count(tp, z, z).shape == (0,)
    keys, cnt, tr = tops.splay_range_scan(tp, z, z, max_range=3)
    assert keys.shape == (0, 3) and cnt.shape == tr.shape == (0,)
    with pytest.raises(ValueError, match="max_range"):
        tops.splay_range_scan(tp, z, z, max_range=0)
    with pytest.raises(ValueError, match="shapes differ"):
        tops.splay_range_count(tp, torch.zeros(2, dtype=torch.int32), z)
    with pytest.raises(ValueError, match="exceeds the plane width"):
        tops.splay_top_k(tp, case["ts"].selfhits, W + 1)
    with pytest.raises(ValueError, match="positive int"):
        tops.splay_top_k(tp, case["ts"].selfhits, 0)
    with pytest.raises(TypeError, match="index plane struct"):
        tops.splay_rank(tp.keys, z)
    # sharded=True with no mesh to resolve takes the replicated path,
    # as in the reference; a mesh that is not a sharding.Mesh raises
    q = torch.as_tensor([-3, 0, 4, 7, 2 ** 31 - 1], dtype=torch.int32)
    for fn, args in ((tops.splay_rank, (q,)), (tops.splay_select, (q,)),
                     (tops.splay_range_count, (q, q + 9)),
                     (tops.splay_top_k, (case["ts"].selfhits, 4))):
        got, want = fn(tp, *args, sharded=True), fn(tp, *args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="sharding.Mesh"):
        tops.splay_select(tp, q, mesh=object())


def test_segmented_plane_refused(case):
    keys = case["tp"].keys.clone()
    keys[-1, 10:20] = PAD                       # interior pad run
    seg = case["tp"]._replace(keys=keys)
    qs = torch.as_tensor([0, 4], dtype=torch.int32)
    for call in (lambda: tops.splay_select(seg, qs),
                 lambda: tops.splay_predecessor(seg, qs),
                 lambda: tops.splay_successor(seg, qs),
                 lambda: tops.splay_range_scan(seg, qs, qs, max_range=2),
                 lambda: tops.splay_top_k(seg, case["ts"].selfhits, 2)):
        with pytest.raises(ValueError, match="segmented"):
            call()


def _mixed_ops(seed, n, live):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(5, n, p=[0.2, 0.1, 0.4, 0.15, 0.15]).astype(
        np.int32)
    keys = np.where(rng.random(n) < 0.7, rng.choice(live, n),
                    rng.integers(-5, 1000, n)).astype(np.int32)
    # the state walk's key domain ends below POS_INF_32 (the tail
    # sentinel's key): a walk for it never returns, in either package
    keys[:4] = [I32_MIN, PAD - 1, NEG, NEG + 1]
    kinds[:4] = [tsx.OP_PRED, tsx.OP_PRED, tsx.OP_RANGE, tsx.OP_RANGE]
    return kinds, keys, rng.random(n) < 0.6


@pytest.mark.parametrize("seed", [0, 1])
def test_run_ops_five_kinds(seed):
    """Results, path lengths and every state array equal the JAX scan's;
    the deletes make rebuilds fire inside the stream, between ordered
    ops."""
    ts, live = _state(seed)
    kinds, keys, upd = _mixed_ops(seed, 200, live)
    a = sx.run_ops(to_jax_state(ts), jnp.asarray(kinds), jnp.asarray(keys),
                   jnp.asarray(upd))
    b = tsx.run_ops(ts, kinds, keys, upd)
    assert_state_equal(a[0], b[0])
    assert_arrays_equal(a[1], b[1], "res")
    assert_arrays_equal(a[2], b[2], "plen")
    assert int(b[0].n_alloc) < int(ts.n_alloc)      # a rebuild compacted
    # the scalar entry points are the same ops
    st1, r1, p1 = tsx.predecessor(ts, int(live[5]) + 1)
    st2, r2, p2 = tsx.rank_count(ts, int(live[5]))
    assert (int(r1), int(r2)) == (int(live[5]), 6)
    assert_state_equal(to_jax_state(ts), st1)
    with pytest.raises(ValueError, match="op kinds"):
        tsx.run_ops(ts, [5], [1], [True])


def _ordered_batch(seed, shape, live):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([tsx.OP_CONTAINS, tsx.OP_PRED, tsx.OP_RANGE],
                       shape).astype(np.int32)
    keys = np.where(rng.random(shape) < 0.6, rng.choice(live, shape),
                    rng.integers(-5, 1000, shape)).astype(np.int32)
    return kinds, keys, rng.random(shape) < 0.5


def _oracle(kinds, keys, live):
    i = np.searchsorted(live, keys.astype(np.int64), side="right")
    pred = np.where(i > 0, live[np.maximum(i - 1, 0)], NEG)
    return np.where(kinds == tsx.OP_PRED, pred,
                    np.where(kinds == tsx.OP_RANGE, i,
                             np.isin(keys, live))).astype(np.int32)


def test_ordered_run_epoch_matches_jax():
    ts, live = _state(2)
    js = to_jax_state(ts)
    jp = dix.from_state_device(js, n_levels=L, width=W)
    tp = tdix.from_state_device(ts, n_levels=L, width=W)
    kinds, keys, upd = _ordered_batch(3, 48, live)
    kw = dict(aggregate=True, plane_search=True, ordered=True)
    a = sx.run_epoch(js, jp, jnp.asarray(kinds), jnp.asarray(keys),
                     jnp.asarray(upd), **kw)
    b = tsx.run_epoch(ts, tp, kinds, keys, upd, **kw)
    assert_state_equal(a[0], b[0])
    assert_plane_equal(a[1], b[1])
    for name, x, y in zip(("res", "plen", "ovf", "spill", "occ"), a[2:],
                          b[2:]):
        assert_arrays_equal(x, y, name)
    np.testing.assert_array_equal(b[2].numpy(), _oracle(kinds, keys, live))
    # ordered lanes are pure reads: the fold equals the contains-only one
    c = tsx.run_epoch(ts, tp, kinds, keys, upd & (kinds == tsx.OP_CONTAINS),
                      aggregate=True, plane_search=True)
    assert_state_equal(to_jax_state(c[0]), b[0])
    # off the plane-search path run_ops answers the ordered kinds
    d = tsx.run_epoch(ts, tp, kinds, keys, upd, ordered=True)
    np.testing.assert_array_equal(d[2].numpy(), _oracle(kinds, keys, live))


def test_ordered_run_serving_matches_jax():
    ts, live = _state(3)
    js = to_jax_state(ts)
    jp = dix.from_state_device(js, n_levels=L, width=W)
    tp = tdix.from_state_device(ts, n_levels=L, width=W)
    kinds, keys, upd = _ordered_batch(5, (3, 48), live)
    kw = dict(aggregate=True, plane_search=True, ordered=True)
    a = sx.run_serving(js, jp, jnp.asarray(kinds), jnp.asarray(keys),
                       jnp.asarray(upd), **kw)
    b = tsx.run_serving(ts, tp, kinds, keys, upd, **kw)
    assert_state_equal(a[0], b[0])
    assert_plane_equal(a[1], b[1])
    for name, x, y in zip(("res", "plen", "ovf", "spill", "occ"), a[2:],
                          b[2:]):
        assert_arrays_equal(x, y, name)
    np.testing.assert_array_equal(b[2].numpy(), _oracle(kinds, keys, live))
    # the same lanes through run_ops (kernel F's op list) answer the same
    r = tsx.run_ops(ts, kinds.ravel(), keys.ravel(),
                    (upd & (kinds == tsx.OP_CONTAINS)).ravel())
    np.testing.assert_array_equal(r[1].numpy(), b[2].numpy().ravel())
