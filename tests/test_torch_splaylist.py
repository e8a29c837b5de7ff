"""PyTorch port, state engine: ``repro_torch.core.splaylist`` against
the JAX engine on the same numpy-seeded op streams — all 12 state
fields, results and path lengths bit-exact — plus an int64-counter
stream against the pure-Python oracle.  CPU tensors, so the fold runs
its plain step-by-step version (kernel F's reference)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ref_py
from repro.core import splaylist as sx
from repro_torch.core import splaylist as tsx
from torch_parity import (assert_arrays_equal, assert_state_equal,
                          to_torch_state)

CAP, ML, N_OPS = 256, 12, 240        # one JAX compile for every stream


def _mixed(seed, p):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(3, N_OPS, p=[0.5, 0.3, 0.2]).astype(np.int32)
    keys = rng.integers(0, 120, N_OPS).astype(np.int32)
    return kinds, keys, rng.random(N_OPS) < p


def _delete_heavy(seed):
    """80 inserts, then a delete-heavy tail that crosses rebuilds."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(200)[:80].astype(np.int32)
    tail = N_OPS - len(pool)
    kinds = np.concatenate([
        np.full(len(pool), sx.OP_INSERT, np.int32),
        rng.choice(3, tail, p=[0.3, 0.1, 0.6]).astype(np.int32)])
    keys = np.concatenate([pool, rng.choice(pool, tail)]).astype(np.int32)
    return kinds, keys, np.ones(N_OPS, bool)


def _both(kinds, keys, upd, count_dtype=torch.int32):
    js, jr, jp = sx.run_ops(sx.make(CAP, ML), jnp.asarray(kinds),
                            jnp.asarray(keys), jnp.asarray(upd))
    ts, tr, tp = tsx.run_ops(
        tsx.make(CAP, ML, count_dtype=count_dtype, device="cpu"),
        kinds, keys, upd)
    return (js, jr, jp), (ts, tr, tp)


def _oracle(kinds, keys, upd, ml=ML):
    oracle = ref_py.SplayList(max_level=ml, p=0.5)
    ops = (oracle.contains, oracle.insert, oracle.delete)
    res, plen = [], []
    for kind, k, u in zip(kinds.tolist(), keys.tolist(), upd.tolist()):
        res.append(int(ops[kind](k, upd=u)))
        plen.append(oracle.last_path_len)
    return oracle, np.asarray(res, np.int32), np.asarray(plen, np.int32)


@pytest.mark.parametrize("stream", [
    pytest.param(lambda: _mixed(1, 1.0), id="coins-p1"),
    pytest.param(lambda: _mixed(2, 0.5), id="coins-p0.5"),
    pytest.param(lambda: _delete_heavy(3), id="delete-heavy-rebuild"),
])
def test_run_ops_matches_jax(stream):
    kinds, keys, upd = stream()
    (js, jr, jp), (ts, tr, tp) = _both(kinds, keys, upd)
    assert_state_equal(js, ts)
    assert_arrays_equal(jr, tr, "results")
    assert_arrays_equal(jp, tp, "path lengths")
    assert tsx.heights(ts) == sx.heights(js)


def test_delete_heavy_stream_rebuilds_mid_stream():
    """The delete-heavy stream really crosses a rebuild before its end
    (the oracle counts them), so the relaunch seam is exercised."""
    kinds, keys, upd = _delete_heavy(3)
    oracle, res, plen = _oracle(kinds, keys, upd)
    assert oracle.rebuilds >= 1
    ts, tr, tp = tsx.run_ops(tsx.make(CAP, ML, device="cpu"), kinds, keys,
                             upd)
    np.testing.assert_array_equal(tr.numpy(), res)
    np.testing.assert_array_equal(tp.numpy(), plen)


@pytest.mark.parametrize("aggregate", [False, True])
def test_run_contains_batch_matches_jax(aggregate):
    kinds, keys, upd = _mixed(4, 1.0)
    js, _, _ = sx.run_ops(sx.make(CAP, ML), jnp.asarray(kinds),
                          jnp.asarray(keys), jnp.asarray(upd))
    ts = to_torch_state(js)
    rng = np.random.default_rng(5)
    qs = rng.integers(0, 130, 64).astype(np.int32)      # dups + misses
    up = rng.random(64) < 0.7
    js2, jres, jsteps = sx.run_contains_batch(
        js, jnp.asarray(qs), jnp.asarray(up), aggregate=aggregate)
    ts2, tres, tsteps = tsx.run_contains_batch(ts, qs, up,
                                               aggregate=aggregate)
    assert_state_equal(js2, ts2)
    assert_arrays_equal(jres, tres, "results")
    assert_arrays_equal(jsteps, tsteps, "steps")
    assert_state_equal(js, ts, "input state untouched")


def test_find_batch_matches_jax():
    kinds, keys, upd = _mixed(6, 0.5)
    js, _, _ = sx.run_ops(sx.make(CAP, ML), jnp.asarray(kinds),
                          jnp.asarray(keys), jnp.asarray(upd))
    qs = np.concatenate([np.arange(-3, 130), [sx.NEG_INF_32,
                                              sx.POS_INF_32 - 1]])
    qs = qs.astype(np.int32)
    a = sx.find_batch(js, jnp.asarray(qs))
    b = tsx.find_batch(to_torch_state(js), torch.as_tensor(qs))
    assert_arrays_equal(a[0], b[0], "slots")
    assert_arrays_equal(a[1], b[1], "steps")
    slot, steps = tsx.find(to_torch_state(js), int(qs[5]))
    assert int(slot) == int(a[0][5]) and int(steps) == int(a[1][5])


def test_int64_counters_match_oracle():
    """int64 counts through the same fold, held against the pure-Python
    oracle: results, path lengths, heights and every counter."""
    rng = random.Random(9)
    pool = list(range(0, 160, 2))
    stream = [(sx.OP_INSERT, k, True) for k in pool]
    for _ in range(400):
        x = rng.random()
        kind = (sx.OP_CONTAINS if x < 0.4 else
                sx.OP_INSERT if x < 0.55 else sx.OP_DELETE)
        stream.append((kind, rng.choice(pool), rng.random() < 0.6))
    kinds, keys, upd = (np.asarray(c) for c in zip(*stream))
    kinds, keys = kinds.astype(np.int32), keys.astype(np.int32)
    oracle, res, plen = _oracle(kinds, keys, upd, ml=16)
    assert oracle.rebuilds >= 1
    ts, tr, tp = tsx.run_ops(
        tsx.make(512, 16, count_dtype=torch.int64, device="cpu"),
        kinds, keys, upd)
    assert ts.m.dtype == torch.int64 and ts.hits.dtype == torch.int64
    np.testing.assert_array_equal(tr.numpy(), res)
    np.testing.assert_array_equal(tp.numpy(), plen)
    assert tsx.heights(ts) == oracle.heights()
    assert int(ts.m) == oracle.m
    assert int(ts.dhits) == oracle.deleted_hits
    assert int(ts.zl) == oracle.zero_level
    assert int(ts.size) == oracle.size


def test_single_ops_and_make_guards():
    st = tsx.make(16, 4, device="cpu")
    st, r, _ = tsx.insert(st, 7)
    st, r2, _ = tsx.contains(st, 7)
    st, r3, _ = tsx.delete(st, 7)
    st, r4, _ = tsx.contains(st, 7)
    assert (int(r), int(r2), int(r3), int(r4)) == (1, 1, 1, 0)
    with pytest.raises(ValueError):
        tsx.make(16, 33, device="cpu")          # shift width of int32
    with pytest.raises(ValueError):
        tsx.make(16, 4, count_dtype=torch.int16, device="cpu")
    # the op kinds end at OP_RANGE (the ordered kinds run since they
    # were ported); anything past them is refused
    with pytest.raises(ValueError, match="op kinds"):
        tsx.run_ops(st, [sx.OP_RANGE + 1], [3], [True])
    full = tsx.make(4, 4, device="cpu")         # 2 data slots
    full, _, _ = tsx.run_ops(full, [1, 1], [1, 2], [True, True])
    with pytest.raises(RuntimeError, match="capacity"):
        tsx.run_ops(full, [1], [3], [True])


def test_pad_op_batch_matches_jax():
    args = ([1, 0, 2], [5, 9, 11], [True, False, True])
    for batch in (3, 8):
        a = sx.pad_op_batch(*args, batch)
        b = tsx.pad_op_batch(*args, batch)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]
    np.testing.assert_array_equal(sx.pad_op_batch([], [], [], 4)[1],
                                  tsx.pad_op_batch([], [], [], 4)[1])
