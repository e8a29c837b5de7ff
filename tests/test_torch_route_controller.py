"""PyTorch port, routing controller: the port's
``core/route_controller.py`` against the JAX package's on the same
numpy inputs — the overflow state machine over random sequences, the
slack ladder and ``route_capacity``, the balance statistics, controller
trajectories under synthetic occupancies, the dict round trip, and the
meshless ``run_serving_controlled`` against both the JAX loop and the
port's own ``run_serving``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import device_index as dix
from repro.core import route_controller as rc
from repro.core import splaylist as sx
from repro.kernels import splay_search as ssk
from repro_torch.core import device_index as tdix
from repro_torch.core import route_controller as trc
from repro_torch.core import splaylist as tsx
from repro_torch.kernels import splay_search as tssk
from torch_parity import (assert_arrays_equal, assert_plane_equal,
                          assert_state_equal, to_jax_state)

NQ = 8192


@pytest.mark.parametrize("seed", range(4))
def test_overflow_machine_step_matches(seed):
    rng = np.random.default_rng(seed)
    pressed_a = pressed_b = False
    for _ in range(200):
        ovf = int(rng.integers(0, 3)) * int(rng.random() < 0.3)
        width = int(rng.integers(8, 64))
        batch = int(rng.integers(1, 16))
        size = int(rng.integers(0, width + 1))
        pend_a, pressed_a = rc.overflow_machine_step(ovf, size, batch,
                                                     width, pressed_a)
        pend_b, pressed_b = trc.overflow_machine_step(ovf, size, batch,
                                                      width, pressed_b)
        assert (pend_a, pressed_a) == (pend_b, pressed_b)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 64])
def test_slack_ladder_and_route_capacity(n_shards):
    for kw in ({}, {"base": 1.25, "growth": 2.0}, {"growth": 1.1}):
        assert (trc.default_slack_ladder(n_shards, **kw)
                == rc.default_slack_ladder(n_shards, **kw))
    assert tssk.DEFAULT_ROUTE_SLACK == ssk.DEFAULT_ROUTE_SLACK
    for nq in (1, 7, 256, 8191):
        for slack in (1.0, 1.5, 2.25, float(n_shards) + 0.5):
            assert (tssk.route_capacity(nq, n_shards, slack)
                    == ssk.route_capacity(nq, n_shards, slack))
    for args in ((0, n_shards), (4, 0), (4, n_shards, 0.5)):
        for fn in (ssk.route_capacity, tssk.route_capacity):
            with pytest.raises(ValueError):
                fn(*args)
    with pytest.raises(ValueError):
        trc.default_slack_ladder(0)


def test_balance_stats():
    rng = np.random.default_rng(0)
    occs = [rng.integers(0, 100, s) for s in (1, 2, 4, 8) * 8]
    occs += [np.zeros(4, np.int64), np.array([0, 0, 0, 100])]
    for occ in occs:
        assert trc.max_share(occ) == rc.max_share(occ)
        assert trc.routing_gini(occ) == rc.routing_gini(occ)


def _scenario(name, S, rng):
    """A sequence of (occupancy, spill) epochs for an S-way split."""
    if name == "balanced":
        return [(np.full(S, NQ // S), 0)] * 12
    if name == "hot":
        big = int(NQ * 0.8)
        rest = (NQ - big) // (S - 1)
        hot = np.asarray([big] + [rest] * (S - 1))
        return [(hot, 0)] * 6 + [(np.full(S, NQ // S), 0)] * 14
    out = []
    for _ in range(30):
        occ = rng.multinomial(NQ, rng.dirichlet(np.ones(S) * 0.4))
        out.append((occ, int(rng.integers(0, 3)) * int(rng.random() < 0.3)
                    * int(occ.max() - NQ // S)))
    return out


@pytest.mark.parametrize("name,S,overrides", [
    ("balanced", 4, {}), ("hot", 4, {}), ("hot", 8, {"calm_epochs": 1}),
    ("random", 4, {"ewma_alpha": 0.25, "calm_epochs": 2}),
    ("random", 8, {"rebuild_patience": 1}), ("random", 1, {})])
def test_controller_trajectory(name, S, overrides):
    rng = np.random.default_rng(len(name) + S)
    epochs = _scenario(name, S, rng)
    cfg_a, st_a = rc.init_controller(S, **dict(overrides))
    cfg_b, st_b = trc.init_controller(S, **dict(overrides))
    assert tuple(cfg_a) == tuple(cfg_b) and tuple(st_a) == tuple(st_b)
    assert st_b.slack_of(cfg_b) == st_a.slack_of(cfg_a)
    for occ, spill in epochs:
        st_a = rc.controller_step(cfg_a, st_a, spill, occ, NQ)
        st_b = trc.controller_step(cfg_b, st_b, spill, occ, NQ)
        assert tuple(st_a) == tuple(st_b)


def test_dict_round_trip():
    cfg, s = trc.init_controller(4)
    s = s._replace(slack_idx=2, split="mass", force_rebuild=True,
                   ewma=0.71, calm=1, backoff=4, mass_bad=2,
                   retraces=5, escalations=3, last_spill=17,
                   last_share=0.4, last_gini=0.2)
    d = trc.controller_to_dict(cfg, s)
    jcfg, js = rc.init_controller(4)
    js = rc.ControllerState(*s)
    assert d == rc.controller_to_dict(jcfg, js)
    cfg2, s2 = trc.controller_from_dict(json.loads(json.dumps(d)))
    assert cfg2 == cfg and s2 == s
    assert isinstance(cfg2.slack_ladder, tuple)
    jc, jst = rc.controller_from_dict(json.loads(json.dumps(d)))
    assert tuple(jc) == tuple(cfg2) and tuple(jst) == tuple(s2)


CAP, L, W = 128, 10, 96


def _state_plane():
    keys = np.random.default_rng(1).permutation(200)[:60].astype(np.int32)
    ts, _, _ = tsx.run_ops(tsx.make(CAP, L, device="cpu"),
                           np.full(keys.size, tsx.OP_INSERT, np.int32),
                           keys, np.ones(keys.size, bool))
    return ts, tdix.from_state_device(ts, n_levels=L, width=W)


@pytest.mark.parametrize("mode", ["plane_search", "mixed"])
def test_run_serving_controlled_meshless(mode):
    """The controlled loop equals the JAX one (outputs, state, plane and
    the controller's trajectory) and the port's ``run_serving``; the
    controller observes the [1] occupancy and never actuates.  The
    mixed stream's insert burst overflows and is rebuilt."""
    E, B = 3, 16
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 220, (E, B)).astype(np.int32)
    ups = rng.random((E, B)) < 0.5
    if mode == "plane_search":
        kinds = np.zeros((E, B), np.int32)
        kw = dict(aggregate=True, plane_search=True)
    else:
        kinds = rng.choice(3, (E, B)).astype(np.int32)
        kinds[1] = tsx.OP_INSERT
        keys[1] = np.arange(500, 500 + B)
        kw = dict(max_new=4)
    ts, tp = _state_plane()
    js = to_jax_state(ts)
    jp = dix.from_state_device(js, n_levels=L, width=W)
    a = rc.run_serving_controlled(js, jp, jnp.asarray(kinds),
                                  jnp.asarray(keys), jnp.asarray(ups), **kw)
    b = trc.run_serving_controlled(ts, tp, kinds, keys, ups, **kw)
    c = tsx.run_serving(ts, tp, kinds, keys, ups, **kw)
    assert_state_equal(a[0], b[0])
    assert_plane_equal(a[1], b[1])
    for name, x, y, z in zip(("res", "plen", "ovf", "spill", "occ"),
                             a[2:7], b[2:7], c[2:]):
        assert_arrays_equal(x, y, name)
        assert_arrays_equal(x, z, name)
    assert [tuple(s) for s in a[7]] == [tuple(s) for s in b[7]]
    assert b[6].shape == (E, 1)
    assert b[7][-1].retraces == 0 and b[7][-1].escalations == 0
    if mode == "mixed":
        assert int(b[4][1]) > 0          # the burst overflowed
    with pytest.raises(TypeError, match="sharding.Mesh"):
        trc.run_serving_controlled(ts, tp, kinds, keys, ups, mesh=object(),
                                   **kw)
    # a one-shot force_rebuild from a caller's state takes the rebuild
    # branch in the first epoch, as in the JAX loop
    cfg, s0 = rc.init_controller(1)
    cfg_t, s0_t = trc.init_controller(1)
    a = rc.run_serving_controlled(
        js, jp, jnp.asarray(kinds), jnp.asarray(keys), jnp.asarray(ups),
        cfg=cfg, state=s0._replace(force_rebuild=True), **kw)
    b = trc.run_serving_controlled(
        ts, tp, kinds, keys, ups, cfg=cfg_t,
        state=s0_t._replace(force_rebuild=True), **kw)
    assert_state_equal(a[0], b[0])
    assert_plane_equal(a[1], b[1])
    assert_arrays_equal(a[2], b[2])
