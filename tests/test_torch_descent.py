"""PyTorch port, the descent engine of B1 and B2 held on the CPU.

The plain versions follow the kernel step by step: a row's window is
narrowed ``_FAN``-ary while it holds more than ``_LAST`` candidates, and
then its candidates are counted at once (on sorted rows the count is
the binary search's predecessor); B1 walks every row, B2's lanes each
stop once resolved (a hit, or a width-1 bottom-row projection) and its
byte counter is rebuilt from per-row unions of the unresolved lanes'
windows.  Against the JAX Pallas kernels in interpret mode on the same
numpy-seeded planes — ``_kernel_tiered`` for B1's triple,
``_kernel_pipelined`` for B2's triple and counter, bit-exact — on hot
batches whose lanes leave in the top rows, all-miss batches and the
int32 extremes, empty top rows, an all-empty plane and a single live
row, 16-lane tiles with 16-lane query blocks, wide windows that take
narrowing trips, and a block in which lanes never resolve.  Also the
entry points (a bare matrix derives its companions; a plane struct
brings its own) and the row step against a binary search."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as dix
from repro.kernels import splay_search as ssk
from repro_torch.core import convert
from repro_torch.core import level_arrays as tla
from repro_torch.core import workload as twl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splay_search as tssk
from torch_parity import assert_arrays_equal

EXTREMES = np.asarray([ssk.NEG_INF_KEY, -(2 ** 31), -1, 0, ssk.PAD_KEY - 1,
                       ssk.PAD_KEY, 2 ** 31 - 2], np.int64)


def _planes(keys, heights, width, n_levels):
    kk = np.full(width, ssk.PAD_KEY, np.int32)
    hh = np.zeros(width, np.int32)
    kk[:len(keys)] = keys
    hh[:len(keys)] = heights
    jp = dix.build_device(jnp.asarray(kk), jnp.asarray(hh), n_levels)
    return jp, convert.plane_from_numpy(jp, device="cpu")


def _zipf(width, n_levels, nq, seed, alpha=1.0):
    keys, heights, qs = twl.zipf_level_fixture(width, alpha, nq, seed=seed)
    n = width - width // 8
    jp, tp = _planes(keys[:n], heights[:n], width, n_levels)
    return jp, tp, qs


def _both(jp, tp, qs, qb, bot_rank=None):
    """B1 against ``_kernel_tiered`` and B2 against ``_kernel_pipelined``
    on the same plane and queries (``bot_rank``: a companion other than
    the plane's, given to both B2s)."""
    jbr = jp.bot_rank if bot_rank is None else jnp.asarray(bot_rank)
    tbr = tp.bot_rank if bot_rank is None else torch.as_tensor(bot_rank)
    q = np.asarray(qs, np.int32)
    a = ssk._splay_search_arrays(jp.keys, jnp.asarray(q), query_block=qb,
                                 interpret=True, rank_map=jp.rank_map,
                                 widths=jp.widths)
    b = tssk._splay_search_arrays(tp.keys, torch.as_tensor(q), qb,
                                  tp.rank_map, tp.widths)
    for name, x, y in zip(("found", "rank", "level"), a, b):
        assert_arrays_equal(x, y, f"B1 {name}")
    a = ssk._splay_search_pipelined_arrays(
        jp.keys, jnp.asarray(q), query_block=qb, interpret=True,
        rank_map=jp.rank_map, widths=jp.widths, bot_rank=jbr)
    c = tssk._splay_search_pipelined_arrays(
        tp.keys, torch.as_tensor(q), qb, tp.rank_map, tp.widths, tbr)
    for name, x, y in zip(("found", "rank", "level", "bytes"), a, c):
        assert_arrays_equal(x, y, f"B2 {name}")
    return b, c


def _live(tp, row):
    k = tp.keys[row].numpy()
    return k[k != ssk.PAD_KEY]


@pytest.mark.parametrize("width,n_levels,qb", [(1024, 14, 64),
                                               (4096, 16, 256)])
def test_hot_batch_leaves_in_the_top_rows(width, n_levels, qb):
    """Zipf batches of the top rows' keys: most lanes hit high up, and
    B2's blocks stop early, so the counter stays far below the
    whole-plane stream."""
    jp, tp, _ = _zipf(width, n_levels, 1, seed=width)
    widths = tp.widths.numpy()
    top = [r for r in range(n_levels) if widths[r] > 0][:3]
    pool = np.concatenate([_live(tp, r) for r in top])
    rng = np.random.default_rng(width)
    qs = pool[np.minimum(rng.zipf(1.5, 2 * qb) - 1, len(pool) - 1)]
    (f1, _, lv1), (f2, _, lv2, nbytes) = _both(jp, tp, qs, qb)
    assert bool(f1.all()) and bool(f2.all())
    assert int(lv1.max()) <= top[-1]
    assert int(nbytes.max()) < 3 * n_levels * width * 4 // 4


@pytest.mark.parametrize("seed", [0, 1])
def test_all_miss_batches_and_extremes(seed):
    """Every gap of the bottom row (a key between each pair of live
    keys, below the first and above the last) and the int32 extremes:
    no lane hits, each resolves by its projection or the bottom row."""
    jp, tp, _ = _zipf(2048, 12, 1, seed=seed + 20)
    live = _live(tp, -1).astype(np.int64)
    gaps = live[:-1][np.diff(live) > 1] + 1
    qs = np.concatenate([gaps, [live[0] - 1, live[-1] + 1], EXTREMES])
    qs = qs[(qs >= -(2 ** 31)) & (qs < 2 ** 31)]
    (f1, r1, lv1), (f2, _, _, _) = _both(jp, tp, qs, 128)
    n_gap = len(gaps) + 2
    assert not bool(f1[:n_gap].any()) and not bool(f2[:n_gap].any())
    assert bool((lv1[:n_gap] == 12).all())
    np.testing.assert_array_equal(
        r1[:n_gap].numpy(), np.searchsorted(live, qs[:n_gap], "right") - 1)


@pytest.mark.parametrize("shape", ["empty-top-rows", "all-empty",
                                   "single-live-row", "one-row-plane"])
def test_degenerate_planes(shape):
    if shape == "empty-top-rows":     # heights reach 3 of 9 rows
        rng = np.random.default_rng(4)
        keys = np.sort(rng.choice(5000, 300, replace=False))
        jp, tp = _planes(keys, rng.integers(0, 3, 300), 512, 9)
        assert (tp.widths.numpy()[:6] == 0).all()
    elif shape == "all-empty":
        jp, tp = _planes([], [], 64, 5)
    elif shape == "single-live-row":  # only the bottom row is live
        jp, tp = _planes(np.arange(0, 400, 7), np.zeros(58, np.int32), 64,
                         5)
    else:
        jp, tp = _planes(np.arange(0, 400, 7), np.zeros(58, np.int32), 64,
                         1)
    bottom = _live(tp, -1)
    qs = np.concatenate([bottom, bottom + 1, EXTREMES]) if bottom.size \
        else EXTREMES
    qs = qs[(qs >= -(2 ** 31)) & (qs < 2 ** 31)]
    _both(jp, tp, qs, 16)


@pytest.mark.parametrize("nq", [16, 100, 1001])
def test_16_lane_tiles_and_query_blocks(nq):
    """W = 1008 (tiles of gcd(1008, 256) = 16 lanes, 63 of them) with
    query blocks of 16 lanes, a partial last block included."""
    jp, tp, qs = _zipf(1008, 12, nq, seed=nq)
    _both(jp, tp, np.concatenate([qs, EXTREMES[:3]]), 16)


@pytest.mark.parametrize("n,levels", [(5000, 3), (3000, 2)])
def test_wide_windows_take_narrowing_trips(n, levels):
    """Random heights over few rows: the top row's window spans
    thousands of candidates, so lanes narrow 4-ary before their last
    trip (W = 8192: 32 tiles, so B2 runs its own descent)."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.choice(20 * n, n, replace=False))
    heights = rng.integers(0, levels, n)
    jp, tp = _planes(keys, heights, 8192, levels)
    assert int(tp.widths[0]) > 4 * (tssk._LAST + 1)
    qs = np.concatenate([rng.choice(keys, 300),
                         rng.integers(0, 20 * n, 300)])
    _both(jp, tp, qs, 128)


def test_block_with_lanes_that_never_resolve():
    """A bottom-row bot_rank with a gap after key j, a key of the bottom
    row alone: a lane whose predecessor is key j is pinned in no row, so
    its block walks every row (and B2's counter charges them all); B2
    keeps its rank 0, as the reference does, and B1 takes the bottom
    row's p, as the full walk does."""
    jp, tp, qs = _zipf(1024, 10, 200, seed=8)
    live = _live(tp, -1)
    heights = tp.heights.numpy()
    j = next(i for i in range(len(live) // 2, len(live) - 1)
             if heights[i] == 0 and live[i] + 1 < live[i + 1])
    br = tp.bot_rank.numpy().copy()
    br[-1, j] += 5
    qs = np.concatenate([qs, [live[j] + 1]])
    b1, (found, rank, level, _) = _both(jp, tp, qs, 64, bot_rank=br)
    assert not bool(found[-1]) and int(rank[-1]) == 0
    assert int(level[-1]) == 10
    assert int(b1[1][-1]) == j


@pytest.mark.parametrize("pipelined", [False, True])
def test_bare_matrix_equals_plane_struct(pipelined):
    """A bare matrix (companions and bot_rank derived) and the plane
    struct (its own bot_rank), and a host ``LevelArrays`` (bot_rank
    derived on the queries' device), through the public entry."""
    jp, tp, qs = _zipf(2048, 12, 500, seed=3)
    q = torch.as_tensor(qs)
    a = tops.splay_search(tp, q, pipelined=pipelined)
    b = tops.splay_search(tp.keys, q, pipelined=pipelined)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    keys, heights, _ = twl.zipf_level_fixture(2048, 1.0, 1, seed=3)
    host = tla.build(keys[:1500], heights[:1500], min_levels=6)
    c = tops.splay_search(host, q, pipelined=pipelined)
    d = tops.splay_search(torch.as_tensor(host.keys), q,
                          pipelined=pipelined)
    for x, y in zip(c, d):
        assert torch.equal(x, y)
    if pipelined:
        e = tssk.splay_search_pipelined(tp, q)
        f = tssk.splay_search_pipelined(tp.keys, q)
        for x, y in zip(e, f):
            assert torch.equal(x, y)


@pytest.mark.parametrize("span", [1, 4, 5, 9, 17, 300, 5000])
def test_row_step_equals_binary_search(span):
    """On a sorted row, the row step's predecessor (narrowing trips, then
    the count of at most ``_LAST`` candidates) equals the reference's
    binary search in every window of ``span - 1`` candidates, and so
    do its hit and next window."""
    rng = np.random.default_rng(span)
    width = 8192
    row = np.sort(rng.choice(10 ** 6, width, replace=False)).astype(np.int64)
    rm = np.arange(width, dtype=np.int64) * 2
    lo = rng.integers(-1, width - span, 400)
    hi = lo + span
    q = np.where(rng.random(400) < 0.3,
                 row[np.clip(lo + span // 2, 0, width - 1)],
                 rng.integers(row[np.clip(lo, 0, None)] - 2,
                              row[np.clip(hi, None, width - 1)] + 2))
    t = [torch.as_tensor(x) for x in (row, rm, lo, hi, q)]
    p, hit, lo_n, hi_n, _, _ = tssk._row_step(
        t[0], t[1], None, t[2], t[3], t[4], width, width, width, width,
        torch.ones(400, dtype=torch.bool))
    blo, bhi = lo.copy(), hi.copy()
    while (bhi - blo > 1).any():
        act = bhi - blo > 1
        mid = (blo + bhi) // 2
        le = row[np.clip(mid, 0, width - 1)] <= q
        blo, bhi = np.where(act & le, mid, blo), np.where(act & ~le, mid, bhi)
    np.testing.assert_array_equal(p.numpy(), blo)
    pc = np.clip(blo, 0, width - 1)
    np.testing.assert_array_equal(hit.numpy(), (blo >= 0) & (row[pc] == q))
    np.testing.assert_array_equal(lo_n.numpy(), np.where(blo >= 0, rm[pc],
                                                         -1))
    np.testing.assert_array_equal(
        hi_n.numpy(), np.where(blo + 1 >= width, width,
                               rm[np.clip(blo + 1, 0, width - 1)]))
