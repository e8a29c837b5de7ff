"""PyTorch port, serving epochs: ``run_epoch`` epoch by epoch and
``run_serving`` against the JAX loop on Zipf ``[E, B]`` streams — the
7-tuple, the state and the plane at every epoch bit-exact — for the
plane-search epoch (``aggregate=True, plane_search=True``) and for
``aggregate=False`` epochs with inserts and deletes, including an
insert burst that overflows the refresh and is rebuilt on the next
epoch, and the near-full pressure edge."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import device_index as dix
from repro.core import splaylist as sx
from repro_torch.core import device_index as tdix
from repro_torch.core import splaylist as tsx
from repro_torch.core import workload as twl
from torch_parity import (assert_arrays_equal, assert_plane_equal,
                          assert_state_equal, to_jax_state)

CAP, L, W = 256, 12, 254
N_KEYS, E, B = 200, 5, 32


def _prefilled(seed):
    ops = twl.zipf_workload(N_KEYS, E * B, s=1.0, p=0.3, seed=seed)
    order = np.random.default_rng(seed).permutation(ops.populate)
    ts, _, _ = tsx.run_ops(tsx.make(CAP, L, device="cpu"),
                           np.full(N_KEYS, sx.OP_INSERT, np.int32), order,
                           np.ones(N_KEYS, bool))
    return ts, ops


def _membership_stream(seed):
    """Contains/insert/delete epochs; epoch 1 is a burst of 32 fresh
    inserts (past max_new=16), pushing the alive count into the
    near-full zone."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(3, (E, B), p=[0.6, 0.2, 0.2]).astype(np.int32)
    keys = rng.integers(0, N_KEYS + 60, (E, B)).astype(np.int32)
    kinds[1] = sx.OP_INSERT
    keys[1] = np.arange(1000, 1000 + 2 * B, 2)
    kinds[4] = sx.OP_DELETE
    return kinds, keys, rng.random((E, B)) < 0.5


def _epochs_both(ts, kinds, keys, upd, **kw):
    """Both packages' run_epoch loops, driven by the same pending-
    rebuild machine; compares every epoch's outputs, state and plane."""
    js = to_jax_state(ts)
    jp = dix.from_state_device(js, n_levels=L, width=W)
    tp = tdix.from_state_device(ts, n_levels=L, width=W)
    pending = pressed = False
    ovfs = []
    for e in range(E):
        a = sx.run_epoch(js, jp, jnp.asarray(kinds[e]),
                         jnp.asarray(keys[e]), jnp.asarray(upd[e]),
                         rebuild=pending, **kw)
        b = tsx.run_epoch(ts, tp, kinds[e], keys[e], upd[e],
                          rebuild=pending, **kw)
        (js, jp), (ts, tp) = a[:2], b[:2]
        assert_state_equal(js, ts, f"epoch {e}")
        assert_plane_equal(jp, tp, f"epoch {e}")
        for name, x, y in zip(("res", "plen", "ovf", "spill", "occ"),
                              a[2:], b[2:]):
            assert_arrays_equal(x, y, f"epoch {e} {name}")
        pressure = int(ts.size) + B > W
        pending = int(b[4]) > 0 or (pressure and not pressed)
        pressed = pressure
        ovfs.append(int(b[4]))
    return ovfs


def _serving_both(ts, kinds, keys, upd, **kw):
    js = to_jax_state(ts)
    jp = dix.from_state_device(js, n_levels=L, width=W)
    tp = tdix.from_state_device(ts, n_levels=L, width=W)
    a = sx.run_serving(js, jp, jnp.asarray(kinds), jnp.asarray(keys),
                       jnp.asarray(upd), **kw)
    b = tsx.run_serving(ts, tp, kinds, keys, upd, **kw)
    assert_state_equal(a[0], b[0])
    assert_plane_equal(a[1], b[1])
    for name, x, y in zip(("res", "plen", "ovf", "spill", "occ"),
                          a[2:], b[2:]):
        assert_arrays_equal(x, y, name)
    return b


PLANE_SEARCH = dict(aggregate=True, plane_search=True)
MEMBERSHIP = dict(aggregate=False, max_new=16)


def test_plane_search_epochs_match_jax():
    ts, ops = _prefilled(0)
    keys = ops.keys.reshape(E, B)
    kinds = np.zeros((E, B), np.int32)
    upd = ops.upd.reshape(E, B)
    assert _epochs_both(ts, kinds, keys, upd, **PLANE_SEARCH) == [0] * E


def test_plane_search_serving_matches_jax():
    ts, ops = _prefilled(1)
    keys = ops.keys.reshape(E, B)
    out = _serving_both(ts, np.zeros((E, B), np.int32), keys,
                        ops.upd.reshape(E, B), **PLANE_SEARCH)
    res, plen = out[2], out[3]
    assert (res == 1).all()                   # every Zipf key is present
    assert (plen < L).all()                   # level_found of a hit
    assert out[5].shape == (E,) and out[6].shape == (E, 1)


def test_membership_epochs_overflow_then_rebuild_match_jax():
    ts, _ = _prefilled(2)
    kinds, keys, upd = _membership_stream(3)
    ovfs = _epochs_both(ts, kinds, keys, upd, **MEMBERSHIP)
    assert ovfs[1] == B - 16                  # the burst overflows ...
    assert ovfs[2] == 0                       # ... and is rebuilt


def test_membership_serving_matches_jax():
    ts, _ = _prefilled(4)
    kinds, keys, upd = _membership_stream(5)
    out = _serving_both(ts, kinds, keys, upd, **MEMBERSHIP)
    ovf = out[4].numpy()
    assert ovf[1] == B - 16 and (ovf[2:] == 0).all()
    w_bot = int(out[1].widths[-1])
    final = set(out[1].keys[-1, :w_bot].tolist())
    assert set(keys[1].tolist()) <= final     # no dropped inserts


def test_epoch_guards():
    ts, ops = _prefilled(6)
    tp = tdix.from_state_device(ts, n_levels=L, width=W)
    args = (ts, tp, np.zeros(B, np.int32), ops.keys[:B], ops.upd[:B])
    with pytest.raises(ValueError, match="aggregate=True"):
        tsx.run_epoch(*args, plane_search=True)
    with pytest.raises(ValueError, match="route_capacity"):
        tsx.run_epoch(*args, route_capacity=0)
    with pytest.raises(ValueError, match="route_slack"):
        tsx.run_serving(*(a[None] if hasattr(a, "ndim") else a
                          for a in args), route_slack=0.5)
    for kw in (dict(mesh=object()),
               dict(mesh=object(), ordered=True, aggregate=True,
                    plane_search=True)):
        with pytest.raises(TypeError, match="sharding.Mesh"):
            tsx.run_epoch(*args, **kw)
    with pytest.raises(ValueError, match="split='mass' requires"):
        tsx.run_epoch(*args, split="mass")
    seg = tp._replace(keys=tp.keys.clone())
    seg.keys[-1, 3] = tdix.PAD_KEY
    with pytest.raises(ValueError, match="segmented"):
        tsx.run_epoch(ts, seg, *args[2:])
