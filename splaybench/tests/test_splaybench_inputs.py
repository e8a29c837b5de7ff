"""The generator and the reference on their own: inputs that depend on
the seed alone, with the sizes every seed shares; the reference against
a brute-force set run in serial order, and against the program's plain
CPU versions bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx
from splaybench import checks, harness, reference
from splaybench.tests.small import READ, RW, sizes
from splaybench.traffic import (OP_CONTAINS, OP_DELETE, OP_INSERT, Traffic,
                                mix_seed, op_counts)


def _traffic(workload, seed):
    _, _, cfg, mix = harness.load_cell(workload)
    s = sizes(workload)
    return Traffic(dict(cfg, **s["config"]), dict(mix, **s["traffic"]),
                   seed, "cpu")


@pytest.mark.parametrize("workload", [READ, RW])
def test_inputs_follow_the_seed_alone(workload):
    big = 2 ** 33 + 11                      # past 32 signed bits
    a, b, c = (_traffic(workload, s) for s in (big, big, big + 1))
    assert torch.equal(a.populate_order, b.populate_order)
    for i in (0, 5, -2):
        for x, y in zip(a.batch(i), b.batch(i)):
            assert torch.equal(x, y)
    assert not torch.equal(a.batch(0)[1], c.batch(0)[1])
    assert not torch.equal(a.batch(0)[1], a.batch(1)[1])
    # a batch drawn again later is the same batch
    first = a.batch(3)
    a.batch(4)
    assert all(torch.equal(x, y) for x, y in zip(first, a.batch(3)))


@pytest.mark.parametrize("workload", [READ, RW])
def test_a_layout_seed_fixes_the_deployment_not_the_requests(workload):
    """With ``layout_seed`` every run holds the same keys, hot ranks and
    load order, and its own seed draws only the requests; without it the
    run's seed draws the layout too."""
    _, _, cfg, mix = harness.load_cell(workload)
    s = sizes(workload)
    cfg = dict(cfg, **s["config"])
    for layout in (None, 5):
        c = dict(cfg, layout_seed=layout) if layout else \
            {k: v for k, v in cfg.items() if k != "layout_seed"}
        a, b = (Traffic(c, dict(mix, **s["traffic"]), seed, "cpu")
                for seed in (3, 4))
        same = (torch.equal(a.keys, b.keys)
                and torch.equal(a.populate_order, b.populate_order))
        assert same == bool(layout)
        assert not torch.equal(a.batch(0)[1], b.batch(0)[1])


@pytest.mark.parametrize("workload", [READ, RW])
def test_every_seed_gets_the_same_sizes(workload):
    for seed in (1, 99):
        t = _traffic(workload, seed)
        pop = t.populate_order
        assert torch.equal(torch.sort(pop)[0], t.populated)
        assert bool(torch.isin(t.populated, t.keys).all())
        for i in range(3):
            kinds, keys, upd = t.batch(i)
            want = op_counts(t.mix["mix"], t.batch_size)
            assert int((kinds == OP_INSERT).sum()) == want.get("insert", 0)
            assert int((kinds == OP_DELETE).sum()) == want.get("delete", 0)
            assert int(upd.sum()) == t.n_coins
            assert bool(torch.isin(keys, t.keys).all())
            writes = (kinds == OP_INSERT) | (kinds == OP_DELETE)
            assert bool(torch.isin(keys[writes], t.write_keys).all())


def test_mix_seed_spreads_and_fits_a_generator():
    xs = {mix_seed(s, i) for s in (0, 1, 2 ** 40) for i in (-1, 0, 1)}
    assert len(xs) == 9 and all(0 <= x < 2 ** 63 for x in xs)
    with pytest.raises(ValueError):
        op_counts({"contains": 0.5, "scan": 0.5}, 8)


def _stream(seed, n_ops=400, space=90):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(3, n_ops, p=[0.3, 0.2, 0.5]).astype(np.int32)
    keys = rng.integers(0, space, n_ops).astype(np.int32)
    return kinds, keys, rng.random(n_ops) < 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_against_a_set_in_serial_order(seed):
    kinds, keys, upd = _stream(seed)
    ref = reference.SplayList(12)
    model = set()
    res, _ = ref.run_ops(kinds, keys, upd)
    for kind, k, r in zip(kinds.tolist(), keys.tolist(), res.tolist()):
        if kind == OP_CONTAINS:
            assert r == (k in model)
        elif kind == OP_INSERT:
            assert r == (k not in model)
            model.add(k)
        else:
            assert r == (k in model)
            model.discard(k)
    assert ref.size == len(model)
    assert ref.live_heights()[0].tolist() == sorted(model)
    assert ref.rebuilds >= 1            # the stream crosses rebuilds


@pytest.mark.parametrize("seed", [0, 1])
def test_serial_answers_from_membership_equal_the_reference(seed):
    """Past the replayed batches the check answers each op from the
    membership alone: the same answers as the reference in serial order,
    and the membership it leaves."""
    ref = reference.SplayList(12)
    present = np.zeros(60, bool)
    for b in range(6):
        kinds, keys, upd = _stream(20 * seed + b, 200, 60)
        res, _ = ref.run_ops(kinds, keys, upd)
        assert np.array_equal(harness.serial_answers(kinds, keys, present),
                              res)
        assert np.flatnonzero(present).tolist() == \
            ref.live_heights()[0].tolist()
    reads = np.zeros(50, np.int32)
    keys = np.arange(50) % 7
    assert np.array_equal(harness.serial_answers(reads, keys, present),
                          present[keys].astype(np.int32))


def test_skipped_pure_reads_change_nothing():
    kinds, keys, upd = _stream(3)
    a, b = reference.SplayList(12), reference.SplayList(12)
    skip = (kinds == OP_CONTAINS) & ~upd & (np.arange(len(kinds)) % 2 == 0)
    ra, pa = a.run_ops(kinds, keys, upd)
    rb, pb = b.run_ops(kinds, keys, upd, skip)
    assert np.array_equal(ra[~skip], rb[~skip])
    assert np.array_equal(pa[~skip], pb[~skip])
    assert checks.diff_count(a.canon(), b.canon()) == 0
    with pytest.raises(ValueError):
        a.run_ops(kinds, keys, upd, ~skip)


def test_reference_equals_the_programs_plain_versions():
    """The reference and the port's CPU path agree bit for bit: answers,
    path lengths, every state entry (canonical) and the plane, across op
    lists with rebuilds and weighted folds on marked keys."""
    rng = np.random.default_rng(5)
    pool = rng.permutation(400)[:150].astype(np.int32)
    st = sx.make(300, 12, device="cpu")
    ones = np.ones(len(pool), bool)
    ins = np.full(len(pool), OP_INSERT, np.int32)
    st, res, plen = sx.run_ops(st, ins, pool, ones)
    ref, rres, rplen = reference.populate(12, pool)
    assert np.array_equal(res.numpy(), rres)
    assert np.array_equal(plen.numpy(), rplen)
    for b in range(3):
        kinds, keys, upd = _stream(10 + b, 120, 400)
        keys = np.where(rng.random(120) < 0.8, rng.choice(pool, 120), keys)
        st, res, plen = sx.run_ops(st, kinds, keys, upd)
        r2, p2 = ref.run_ops(kinds, keys, upd)
        assert np.array_equal(res.numpy(), r2)
        assert np.array_equal(plen.numpy(), p2)
        ks = rng.choice(pool, 96).astype(np.int32)
        up = rng.random(96) < 0.6
        st, _, _ = sx.run_contains_batch(st, ks, up, aggregate=True)
        ref.fold_batch(ks, up)
    assert ref.rebuilds >= 1
    state = {f: getattr(st, f).numpy() for f in st._fields}
    assert checks.state_diff(state, ref) == 0
    plane = dix.from_state_device(st, n_levels=12, width=512)
    lk, lh = ref.live_heights()
    pl = {f: getattr(plane, f).numpy() for f in checks.PLANE_FIELDS}
    assert checks.plane_diff(pl, reference.plane(lk, lh, 12, 512),
                             state) == 0
    fk, fh = checks.live_heights(state)
    assert np.array_equal(fk, lk) and np.array_equal(fh, lh)
    # a single flipped entry is seen
    state["selfhits"] = state["selfhits"].copy()
    state["selfhits"][int(np.flatnonzero(state["key"] == lk[0])[0])] += 1
    assert checks.state_diff(state, ref) == 1


def test_levels_found_follow_heights():
    keys = np.array([3, 8, 20])
    h = np.array([0, 4, 1])
    q = np.array([8, 3, 20, 5, -1])
    assert reference.levels_found(keys, h, q, 6).tolist() == [1, 5, 4, 6, 6]
