"""PyTorch port, index plane: ``repro_torch.core.device_index`` against
``repro.core.device_index`` on the same states — full builds and
epoch-by-epoch incremental refreshes over insert, delete, height-churn,
post-rebuild (stale slot map), overflow and transient-empty streams.
Every field bit-equal; ``slots`` on live lanes only.  The host level
arrays (``core/level_arrays.py``) against ``repro.core.level_arrays``:
builds, ``from_state`` and the shape-keeping ``refresh``."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as dix
from repro.core import level_arrays as jla
from repro.core import splaylist as sx
from repro_torch.core import convert
from repro_torch.core import device_index as tdix
from repro_torch.core import level_arrays as tla
from repro_torch.core import splaylist as tsx
from repro_torch.kernels import ops as tops
from torch_parity import (assert_arrays_equal, assert_plane_equal,
                          to_jax_state)

W, L = 254, 12


def _seed(pool, cap=256):
    st = tsx.make(cap, L, device="cpu")
    pool = np.asarray(pool, np.int32)
    st, _, _ = tsx.run_ops(st, np.full(len(pool), sx.OP_INSERT, np.int32),
                           pool, np.ones(len(pool), bool))
    return st


def _ops(st, kinds, keys, upd=None):
    kinds = np.broadcast_to(np.asarray(kinds, np.int32), np.shape(keys))
    upd = np.ones(len(keys), bool) if upd is None else upd
    return tsx.run_ops(st, kinds, np.asarray(keys, np.int32), upd)[0]


def _refresh_both(ts, jplane, tplane, max_new, msg=""):
    jp, jo = dix.refresh_device(to_jax_state(ts), jplane, max_new=max_new,
                                return_overflow=True)
    tp, to = tdix.refresh_device(ts, tplane, max_new=max_new,
                                 return_overflow=True)
    assert_plane_equal(jp, tp, msg)
    assert_arrays_equal(jo, to, f"{msg} overflow")
    return jp, tp, int(to)


def _fresh_both(ts, width=W):
    jp = dix.from_state_device(to_jax_state(ts), n_levels=L, width=width)
    tp = tdix.from_state_device(ts, n_levels=L, width=width)
    assert_plane_equal(jp, tp, "from_state_device")
    return jp, tp


@pytest.mark.parametrize("n,hmax,width,levels", [
    (100, 6, 128, 8), (128, 0, 128, 3), (0, 0, 64, 4), (37, 20, 48, 6)])
def test_build_device_matches_jax(n, hmax, width, levels):
    rng = np.random.default_rng(n + width)
    keys = np.full(width, tdix.PAD_KEY, np.int32)
    hs = np.zeros(width, np.int32)
    keys[:n] = rng.choice(10 ** 6, n, replace=False)
    hs[:n] = rng.integers(0, hmax + 1, n)
    perm = rng.permutation(width)              # unsorted, pads interleaved
    keys, hs = keys[perm], hs[perm]
    jp = dix.build_device(jnp.asarray(keys), jnp.asarray(hs), levels)
    tp = tdix.build_device(torch.as_tensor(keys), torch.as_tensor(hs),
                           levels)
    assert_plane_equal(jp, tp)
    np.testing.assert_array_equal(np.asarray(jp.slots), tp.slots.numpy())


def test_refresh_mixed_epochs_match_jax():
    """Insert / delete / height-churn epochs, each package carrying its
    own plane from epoch to epoch."""
    pool = list(range(0, 160, 2))
    ts = _seed(pool)
    jp, tp = _fresh_both(ts)
    rng = np.random.default_rng(1)
    for epoch in range(6):
        x = rng.random(48)
        kinds = np.where(x < 0.55, sx.OP_CONTAINS,
                         np.where(x < 0.75, sx.OP_INSERT, sx.OP_DELETE))
        keys = np.where(kinds == sx.OP_INSERT, rng.integers(0, 400, 48),
                        rng.choice(pool + list(range(1, 400, 7)), 48))
        ts = _ops(ts, kinds, keys, rng.random(48) < 0.7)
        jp, tp, ovf = _refresh_both(ts, jp, tp, 64, f"epoch {epoch}")
        assert ovf == 0
        w_bot = int(tp.widths[-1])
        assert (ts.key[tp.slots[:w_bot].long()] == tp.keys[-1, :w_bot]).all()


def test_refresh_height_only_epochs_match_jax():
    pool = list(range(0, 120, 2))
    ts = _seed(pool)
    jp, tp = _fresh_both(ts)
    for _ in range(3):
        qs = np.asarray(pool[:5] * 30, np.int32)
        ts = tsx.run_contains_batch(ts, qs, np.ones(len(qs), bool))[0]
        jp, tp, _ = _refresh_both(ts, jp, tp, 64)


def test_refresh_after_rebuild_stale_slot_map():
    """A delete-heavy epoch triggers rebuild, which compacts slots: the
    refresh must take the scatter fallback in both packages."""
    pool = list(range(0, 100, 2))
    ts = _seed(pool)
    jp, tp = _fresh_both(ts)
    ts = _ops(ts, sx.OP_DELETE, pool[:40])
    assert int(ts.n_alloc) < 2 + len(pool)        # rebuild compacted
    jp, tp, _ = _refresh_both(ts, jp, tp, 64, "post-rebuild")
    ts = _ops(ts, sx.OP_INSERT, [1, 3, 9])
    _refresh_both(ts, jp, tp, 64, "next epoch")
    # a build_device plane has no slot map either
    keys = np.full(W, tdix.PAD_KEY, np.int32)
    keys[:3] = [1, 3, 9]
    jb = dix.build_device(jnp.asarray(keys), jnp.zeros(W, jnp.int32), L)
    tb = tdix.build_device(torch.as_tensor(keys), torch.zeros(W), L)
    _refresh_both(ts, jb, tb, 64, "from build_device")


def test_refresh_overflow_counted():
    ts = _seed(list(range(0, 100, 2)), cap=512)
    jp, tp = _fresh_both(ts)
    burst = np.arange(1, 81, 2, dtype=np.int32)             # 40 inserts
    ts = _ops(ts, sx.OP_INSERT, burst)
    jp, tp, ovf = _refresh_both(ts, jp, tp, 16, "burst")
    assert ovf == len(burst) - 16
    _refresh_both(ts, jp, tp, 16, "stale plane refresh")
    jp, tp = _fresh_both(ts)
    jp, tp, ovf = _refresh_both(ts, jp, tp, 16, "after rebuild")
    assert ovf == 0


def test_refresh_width_overflow_counted():
    ts = _seed(list(range(0, 60, 2)))
    jp, tp = _fresh_both(ts, width=40)
    ts = _ops(ts, sx.OP_INSERT, np.arange(1, 41, 2))        # 50 alive
    jp, tp, ovf = _refresh_both(ts, jp, tp, 64, "width")
    assert ovf == 10


def test_refresh_transient_empty_keeps_shape():
    pool = list(range(0, 40, 2))
    ts = _seed(pool, cap=128)
    jp, tp = _fresh_both(ts, width=126)
    ts = _ops(ts, sx.OP_DELETE, pool)
    jp, tp, _ = _refresh_both(ts, jp, tp, 64, "empty")
    assert tp.keys.shape == (L, 126)
    assert int(tp.widths[-1]) == int(ts.size)
    ts = _ops(ts, sx.OP_INSERT, [5, 7, 11])
    _refresh_both(ts, jp, tp, 64, "refill")


def test_from_state_device_pads_small_states():
    ts = _seed([4, 8, 15], cap=64)
    jp, tp = _fresh_both(ts, width=256)
    assert tp.keys.shape == (L, 256)
    ts = _ops(ts, sx.OP_INSERT, [6])
    _refresh_both(ts, jp, tp, 8)


def test_plane_helpers():
    ts = _seed(list(range(0, 20, 2)))
    _, tp = _fresh_both(ts)
    assert not tdix.plane_is_segmented(tp)
    host = tdix.to_host(tp)
    np.testing.assert_array_equal(host.keys, tp.keys.numpy())
    seg = tp._replace(keys=tp.keys.clone())
    seg.keys[-1, 2] = tdix.PAD_KEY                 # interior pad run
    assert tdix.plane_is_segmented(seg)
    assert dix.plane_is_segmented(dix.DeviceLevelArrays(
        *(jnp.asarray(t.numpy()) for t in seg)))


# ---------------------------------------------------------------------------
# host level arrays (core/level_arrays.py)
# ---------------------------------------------------------------------------

def _assert_la_equal(a, b, msg=""):
    for f in jla.LevelArrays._fields:
        assert_arrays_equal(getattr(a, f), torch.as_tensor(getattr(b, f)),
                            f"{msg} {f}")


@pytest.mark.parametrize("n,hmax,min_levels", [
    (0, 1, 2), (1, 1, 2), (57, 4, 2), (300, 6, 3),
    (123, 1, 8),          # empty top rows (min_levels >> max height)
    (500, 7, 2),
])
def test_level_arrays_build_matches_jax(n, hmax, min_levels):
    rng = np.random.default_rng(n + hmax)
    keys = rng.choice(10 ** 6, n, replace=False).astype(np.int32)
    heights = rng.integers(0, hmax, n).astype(np.int32)
    a = jla.build(keys, heights, min_levels=min_levels)
    b = tla.build(keys, heights, min_levels=min_levels)
    _assert_la_equal(a, b)
    _assert_la_equal(jla.from_heights(keys, heights, width=n + 9),
                     tla.from_heights(keys, heights, width=n + 9), "width")
    c = convert.level_arrays_from_numpy(a)
    _assert_la_equal(a, c, "from_numpy")


def _la_state(pool, n_ops, seed, cap, ml=16):
    """The reference test's skewed stream, run through the port."""
    rng = random.Random(seed)
    stream = [(sx.OP_INSERT, k, True) for k in pool]
    for _ in range(n_ops):
        k = pool[0] if rng.random() < 0.4 else rng.choice(pool)
        stream.append((sx.OP_CONTAINS, k, True))
    st = tsx.make(cap, ml, device="cpu")
    kinds, keys, upd = (np.asarray(x) for x in zip(*stream))
    return tsx.run_ops(st, kinds.astype(np.int32), keys.astype(np.int32),
                       upd.astype(bool))[0]


def _refresh_la_both(ts, jprev, tprev, min_levels, msg):
    a = jla.refresh(to_jax_state(ts), jprev, min_levels=min_levels)
    b = tla.refresh(ts, tprev, min_levels=min_levels)
    _assert_la_equal(a, b, msg)
    return a, b


@pytest.mark.parametrize("case", ["heights_only", "membership",
                                  "transient_empty"])
def test_level_arrays_from_state_and_refresh_match_jax(case):
    """``from_state`` on the same state, then ``refresh`` after an epoch
    that moves heights only (no argsort, shape kept), one that inserts
    (full rebuild) and a delete-everything epoch (shape kept) and its
    refill — the cases of ``test_level_arrays.py``."""
    pool = list(range(0, {"heights_only": 160, "membership": 100,
                          "transient_empty": 50}[case], 2))
    ts = _la_state(pool, 800 if case == "heights_only" else 200,
                   {"heights_only": 11, "membership": 3,
                    "transient_empty": 5}[case],
                   128 if case == "transient_empty" else 512)
    ml = {"heights_only": 16, "membership": 4, "transient_empty": 6}[case]
    a = jla.from_state(to_jax_state(ts), min_levels=ml)
    b = tla.from_state(ts, min_levels=ml)
    _assert_la_equal(a, b, "from_state")
    if case == "heights_only":
        qs = np.asarray(pool[:5] * 40, np.int32)
        ts = tsx.run_contains_batch(ts, qs, np.ones(len(qs), bool))[0]
        a2, b2 = _refresh_la_both(ts, a, b, 16, "refresh")
        assert b2.keys.shape == b.keys.shape
    elif case == "membership":
        ts = _ops(ts, sx.OP_INSERT, [1, 3, 5])
        a2, b2 = _refresh_la_both(ts, a, b, 4, "refresh")
        assert {1, 3, 5} <= set(b2.keys[-1].tolist())
    else:
        ts = _ops(ts, sx.OP_DELETE, pool)
        a2, b2 = _refresh_la_both(ts, a, b, 2, "empty")
        assert b2.keys.shape == b.keys.shape and (b2.widths == 0).all()
        ts = _ops(ts, sx.OP_INSERT, pool[:4])
        _refresh_la_both(ts, a2, b2, 2, "refill")
    # the host plane searches like the device plane built from it
    qs = torch.as_tensor(np.asarray(pool, np.int32))
    for x, y in zip(tops.splay_search(b, qs),
                    tops.splay_search(torch.as_tensor(b.keys), qs)):
        assert torch.equal(x, y)
