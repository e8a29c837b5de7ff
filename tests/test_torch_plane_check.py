"""PyTorch port, plane audit and fault injection: the port's
``core/plane_check.py`` and ``core/faults.py`` against the JAX
package's on the same state and planes — the ``PlaneAudit`` tuple and
its summary on clean, refreshed and hand-built two-segment planes, each
bit-flip family (the same flips from the same seeds, then the same
counts, also on the segmented layout), state/plane drift both ways,
counter violations and saturation; then ``FaultPlan``,
``rng_for`` and ``mangle_telemetry``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as dix
from repro.core import faults as fl
from repro.core import plane_check as pc
from repro.core import splaylist as sx
from repro_torch.core import convert
from repro_torch.core import faults as tfl
from repro_torch.core import plane_check as tpc
from repro_torch.core import splaylist as tsx
from torch_parity import assert_arrays_equal, to_jax_state

W, L = 64, 8
POOL = np.arange(10, 10 + 2 * 48, 2, dtype=np.int32)      # 48 live keys


def _ops(ts, kinds, keys):
    n = len(keys)
    return tsx.run_ops(ts, np.asarray(kinds, np.int32),
                       np.asarray(keys, np.int32), np.ones(n, bool))[0]


@pytest.fixture(scope="module")
def clean():
    ts = _ops(tsx.make(W + 2, L, device="cpu"),
              np.full(POOL.size, tsx.OP_INSERT), POOL)
    js = to_jax_state(ts)
    return ts, js, dix.from_state_device(js, n_levels=L, width=W)


def _two_segment_plane(plane):
    """The mass layout built by hand, meshless: the packed bottom row
    split into two per-block local assemblies, concatenated."""
    wl = W // 2
    bot = np.asarray(plane.keys[L - 1])
    h = np.asarray(plane.heights)
    sl = np.asarray(plane.slots)
    live = np.nonzero(bot != dix.PAD_KEY)[0]
    cut = (live.size + 1) // 2
    blocks = []
    for lanes in (live[:cut], live[cut:]):
        k = np.full(wl, dix.PAD_KEY, np.int32)
        hh = np.zeros(wl, np.int32)
        ss = np.full(wl, -1, np.int32)
        k[:lanes.size] = bot[lanes]
        hh[:lanes.size] = h[lanes]
        ss[:lanes.size] = sl[lanes]
        local = dix._assemble_device(jnp.asarray(k), jnp.asarray(hh),
                                     jnp.asarray(ss), L)
        blocks.append(local._replace(
            local_bot=jnp.asarray(k), local_heights=local.heights,
            local_live=(jnp.asarray(k) != dix.PAD_KEY).astype(jnp.int32),
            local_ok=jnp.ones((1,), jnp.int32)))
    a, b = blocks
    cat = lambda f: jnp.concatenate(    # noqa: E731
        [getattr(a, f), getattr(b, f)], axis=-1)
    return dix.DeviceLevelArrays(
        keys=cat("keys"), widths=a.widths + b.widths,
        heights=cat("heights"), rank_map=cat("rank_map"),
        slots=cat("slots"), bot_rank=cat("bot_rank"),
        local_bot=cat("local_bot"), local_heights=cat("local_heights"),
        local_live=cat("local_live"), local_ok=a.local_ok)


def _both(js, jp, ts, n_segments):
    """The JAX and the port audits of one (state, plane) pair; the port
    reads the plane converted from the JAX one."""
    a = pc.audit_plane(js, jp, n_segments=n_segments)
    b = tpc.audit_plane(ts, convert.plane_from_numpy(jp, device="cpu"),
                        n_segments=n_segments)
    assert tuple(a) == tuple(b), (a, b)
    assert pc.audit_summary(a) == tpc.audit_summary(b)
    assert pc.audit_ok(a) == tpc.audit_ok(b)
    return b


@pytest.mark.parametrize("layout", ["packed", "refreshed", "two_segment",
                                    "two_segment_as_one"])
def test_audit_matches_jax(clean, layout):
    ts, js, jp = clean
    n_seg = 1
    if layout == "refreshed":
        rng = np.random.default_rng(0)
        kinds = rng.choice([0, 1, 2], 16, p=[0.6, 0.3, 0.1]).astype(
            np.int32)
        keys = rng.choice(np.arange(0, 200, dtype=np.int32), 16)
        js, jp, *_ = sx.run_epoch(js, jp, jnp.asarray(kinds),
                                  jnp.asarray(keys), jnp.ones(16, bool))
        ts = convert.state_from_numpy(sx.to_numpy(js), device="cpu")
    elif layout.startswith("two_segment"):
        jp = _two_segment_plane(jp)
        n_seg = 2 if layout == "two_segment" else 1
    b = _both(js, jp, ts, n_seg)
    assert tpc.audit_ok(b) == (layout != "two_segment_as_one")
    if layout == "packed":
        assert b == tpc.PlaneAudit(*([0] * len(tpc.PlaneAudit._fields)))
        assert tpc.audit_summary(b) == "audit OK"


def _flip_both(jp, seed, **kw):
    bad_j, rec_j = fl.flip_plane_bits(jp, np.random.default_rng(seed),
                                      **kw)
    tp = convert.plane_from_numpy(jp, device="cpu")
    bad_t, rec_t = tfl.flip_plane_bits(tp, np.random.default_rng(seed),
                                       **kw)
    assert rec_j == rec_t
    for f in fl.BITFLIP_FIELDS:
        assert_arrays_equal(getattr(bad_j, f), getattr(bad_t, f), f)
        assert getattr(bad_t, f).dtype == getattr(tp, f).dtype
    # the plane handed in is left as it was
    for f in tp._fields:
        assert torch.equal(getattr(tp, f), getattr(
            convert.plane_from_numpy(jp, device="cpu"), f))
    return bad_j, rec_t


@pytest.mark.parametrize("field", fl.BITFLIP_FIELDS)
def test_bitflip_family_matches_jax(clean, field):
    ts, js, jp = clean
    for seed in range(8):
        bad, recs = _flip_both(jp, seed, n_flips=1, fields=(field,))
        assert recs, f"no flip landed for {field}"
        assert not tpc.audit_ok(_both(js, bad, ts, 1)), (field, seed)


def test_bitflips_on_segmented_layout_and_many_flips(clean):
    ts, js, jp = clean
    seg = _two_segment_plane(jp)
    for seed in range(6):
        bad, recs = _flip_both(seg, seed, n_flips=1)
        assert recs
        assert not tpc.audit_ok(_both(js, bad, ts, 2))
        bad, recs = _flip_both(jp, seed, n_flips=5)
        assert len(recs) == 5
        _both(js, bad, ts, 1)


def test_state_plane_drift_both_directions(clean):
    ts, js, jp = clean
    ts2 = _ops(ts, [tsx.OP_INSERT], [11])
    b = _both(to_jax_state(ts2), jp, ts2, 1)
    assert b.state_missing >= 1 and not tpc.audit_ok(b)
    ts3 = _ops(ts, [tsx.OP_DELETE], [int(POOL[0])])
    assert _both(to_jax_state(ts3), jp, ts3, 1).state_extra >= 1


@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
def test_counter_violations_and_saturation(clean, count_dtype):
    ts, _, jp = clean
    ts = ts._replace(**{f: getattr(ts, f).to(count_dtype) for f in
                        ("hits", "selfhits", "m", "dhits")})
    cases = {
        "dhits_over_m": ts._replace(dhits=ts.m + 1),
        "negative_hits": ts._replace(hits=ts.hits.clone().index_fill_(
            1, torch.tensor([3]), -1)),
        "negative_m": ts._replace(m=-ts.m),
        "saturated_m": ts._replace(m=torch.tensor(
            tpc.SATURATION_LIMIT + 1, dtype=count_dtype)),
        "saturated_selfhits": ts._replace(
            selfhits=ts.selfhits.clone().index_fill_(
                0, torch.tensor([5]), tpc.SATURATION_LIMIT + 2)),
    }
    for name, st in cases.items():
        b = _both(to_jax_state(st), jp, st, 1)
        if name.startswith("saturated"):
            assert b.counter_saturated == 1 and tpc.audit_ok(b)
            assert tpc.audit_summary(b).endswith("warn:counter_saturated")
        else:
            assert b.counter_bad >= 1 and not tpc.audit_ok(b), name


def test_summary_segments_and_validation(clean):
    ts, js, jp = clean
    bad, _ = fl.flip_plane_bits(jp, np.random.default_rng(0), 1,
                                fields=("heights",))
    s = tpc.audit_summary(_both(js, bad, ts, 1))
    assert s.startswith("audit FAIL[") and "heights_bad" in s
    tp = convert.plane_from_numpy(jp, device="cpu")
    assert tpc.infer_segments(tp) == 1
    assert tpc.audit_plane(ts, tp) == tpc.audit_plane(ts, tp, n_segments=1)
    with pytest.raises(ValueError, match="not divisible"):
        tpc.audit_plane(ts, tp, n_segments=7)
    seg = convert.plane_from_numpy(_two_segment_plane(jp), device="cpu")
    with pytest.raises(ValueError, match="n_segments explicitly"):
        tpc.infer_segments(seg)
    with pytest.raises(ValueError, match="n_segments explicitly"):
        tpc.audit_plane(ts, seg)


def test_fault_plan_and_telemetry_match_jax():
    events = [(9, fl.FAULT_CRASH), (2, fl.FAULT_BITFLIP, 2),
              (2, fl.FAULT_TELEMETRY, 4), (2, fl.FAULT_BITFLIP, 2),
              (5, fl.FAULT_SHARD_LOSS, 1)]
    pj = fl.FaultPlan(seed=3, events=[fl.FaultEvent(*e) for e in events])
    pt = tfl.FaultPlan(seed=3, events=[tfl.FaultEvent(*e) for e in events])
    assert [tuple(e) for e in pj.events] == [tuple(e) for e in pt.events]
    assert pj.families() == pt.families() and repr(pj) == repr(pt)
    for epoch in range(11):
        assert ([tuple(e) for e in pj.events_at(epoch)]
                == [tuple(e) for e in pt.events_at(epoch)])
    draws = [pt.rng_for(e).integers(1 << 30, size=4) for e in pt.events]
    for e, d in zip(pj.events, draws):
        np.testing.assert_array_equal(pj.rng_for(e).integers(1 << 30,
                                                             size=4), d)
    assert not np.array_equal(draws[0], draws[1])   # equal events differ
    np.testing.assert_array_equal(
        pt.rng_for(tfl.FaultEvent(2, tfl.FAULT_TELEMETRY, 4)).integers(
            9, size=3),
        pj.rng_for(fl.FaultEvent(2, fl.FAULT_TELEMETRY, 4)).integers(
            9, size=3))
    for bad in ([tfl.FaultEvent(0, "gamma_ray")],
                [tfl.FaultEvent(-1, tfl.FAULT_CRASH)]):
        with pytest.raises(ValueError):
            tfl.FaultPlan(events=bad)
    for args in ((17, np.array([5, 9]), np.array([3, 3])),
                 (17, np.array([5, 9]))):
        sj, oj = fl.mangle_telemetry(*args)
        st_, ot = tfl.mangle_telemetry(*args)
        assert sj == st_ == 0
        np.testing.assert_array_equal(oj, ot)
    assert issubclass(tfl.InjectedCrash, tfl.InjectedFault)
    assert issubclass(tfl.InjectedFault, RuntimeError)
    assert tfl.BITFLIP_FIELDS == fl.BITFLIP_FIELDS
    assert tfl.FAULT_FAMILIES == fl.FAULT_FAMILIES
