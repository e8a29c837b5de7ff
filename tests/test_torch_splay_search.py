"""PyTorch port, search kernels: the plain versions of B1 (tiered), B2
(pipelined) and B5 (the seed baseline's full-width count) against the
JAX Pallas kernels in interpret mode on the same planes and queries —
found, rank, level_found and the per-block byte counter bit-exact —
plus the window helpers, the query-block validation, the dispatch rules
and the torch oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as dix
from repro.core import workload as wl
from repro.kernels import ref as jref
from repro.kernels import splay_search as ssk
from repro_torch.core import convert
from repro_torch.core import level_arrays as tla
from repro_torch.core import workload as twl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import splay_search as tssk
from torch_parity import assert_arrays_equal


def _planes(keys, heights, width, n_levels):
    kk = np.full(width, ssk.PAD_KEY, np.int32)
    hh = np.zeros(width, np.int32)
    kk[:len(keys)] = keys
    hh[:len(keys)] = heights
    jp = dix.build_device(jnp.asarray(kk), jnp.asarray(hh), n_levels)
    return jp, convert.plane_from_numpy(jp, device="cpu")


def _fixture_planes(width, n_levels, nq, alpha=1.0, seed=0, n=None):
    keys, heights, qs = twl.zipf_level_fixture(width, alpha, nq, seed=seed)
    n = width - width // 8 if n is None else n     # leave pad lanes
    jp, tp = _planes(keys[:n], heights[:n], width, n_levels)
    return jp, tp, qs


def _queries(keys, qs):
    """Fixture queries plus misses, int32 extremes and the neighbours of
    the pad sentinel."""
    extra = np.asarray([ssk.NEG_INF_KEY, -(2 ** 31), -1, 0,
                        ssk.PAD_KEY - 1, ssk.PAD_KEY, 2 ** 31 - 2],
                       np.int64)
    live = keys[-1][keys[-1] != ssk.PAD_KEY].astype(np.int64)
    near = np.concatenate([live[:3] - 1, live[-3:] + 1]) if live.size else []
    return np.concatenate([qs, extra, near]).astype(np.int32)


def _tiered_both(jp, tp, qs, qb):
    a = ssk._splay_search_arrays(jp.keys, jnp.asarray(qs), query_block=qb,
                                 interpret=True, rank_map=jp.rank_map,
                                 widths=jp.widths)
    b = tssk._splay_search_arrays(tp.keys, torch.as_tensor(qs),
                                  query_block=qb, rank_map=tp.rank_map,
                                  widths=tp.widths)
    for name, x, y in zip(("found", "rank", "level"), a, b):
        assert_arrays_equal(x, y, name)
    return b


def _pipelined_both(jp, tp, qs, qb):
    a = ssk._splay_search_pipelined_arrays(
        jp.keys, jnp.asarray(qs), query_block=qb, interpret=True,
        rank_map=jp.rank_map, widths=jp.widths, bot_rank=jp.bot_rank)
    b = tssk._splay_search_pipelined_arrays(
        tp.keys, torch.as_tensor(qs), query_block=qb,
        rank_map=tp.rank_map, widths=tp.widths, bot_rank=tp.bot_rank)
    for name, x, y in zip(("found", "rank", "level", "bytes"), a, b):
        assert_arrays_equal(x, y, name)
    return b


def test_workload_copy_matches_jax():
    a = wl.zipf_level_fixture(512, 1.1, 100, seed=3)
    b = twl.zipf_level_fixture(512, 1.1, 100, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = wl.zipf_workload(1000, 500, s=1.0, p=0.01, seed=4)
    b = twl.zipf_workload(1000, 500, s=1.0, p=0.01, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("width,levels,nq,qb", [
    (1024, 14, 300, 64),          # zipf plane, pad batch
    (48, 6, 37, 16),              # 16-lane tiles, pad batch
    (1031, 8, 64, 64),            # untileable width
])
def test_tiered_plain_matches_pallas(width, levels, nq, qb):
    jp, tp, qs = _fixture_planes(width, levels, nq, seed=width)
    _tiered_both(jp, tp, _queries(np.asarray(jp.keys), qs), qb)


@pytest.mark.parametrize("width,levels,nq,qb", [
    (1024, 14, 300, 64),          # 4 tiles of 256
    (48, 6, 37, 16),              # 16-lane tiles, pad batch
    (208, 8, 129, 32),            # 13 tiles of 16, pad batch
    (1031, 8, 64, 64),            # untileable: tiered + whole-row bytes
])
def test_pipelined_plain_matches_pallas(width, levels, nq, qb):
    jp, tp, qs = _fixture_planes(width, levels, nq, seed=width + 1)
    _, _, _, nbytes = _pipelined_both(
        jp, tp, _queries(np.asarray(jp.keys), qs), qb)
    if width == 1031:
        assert (nbytes == 2 * levels * width * 4).all()
    else:
        assert (nbytes <= 3 * levels * width * 4).all()


def test_pipelined_early_exit_on_hot_batch():
    """A batch of the hottest keys resolves in the top rows: the byte
    counter stays far below the whole-plane stream, in both packages."""
    jp, tp, _ = _fixture_planes(1024, 14, 8, seed=5)
    top = np.asarray(jp.keys)[np.asarray(jp.widths) > 0][0]
    hot = top[top != ssk.PAD_KEY][:4].repeat(16).astype(np.int32)
    _, _, level, nbytes = _pipelined_both(jp, tp, hot, 64)
    assert (level < 14).all()
    assert int(nbytes[0]) < 3 * 14 * 1024 * 4 // 4


@pytest.mark.parametrize("shape", ["all-empty", "single-lane"])
def test_degenerate_planes(shape):
    if shape == "all-empty":
        jp, tp = _planes([], [], 64, 5)
    else:
        jp, tp = _planes([42], [3], 64, 5)
    qs = np.asarray([ssk.NEG_INF_KEY, 0, 41, 42, 43, ssk.PAD_KEY - 1],
                    np.int32)
    _tiered_both(jp, tp, qs, 4)
    _pipelined_both(jp, tp, qs, 4)


def test_empty_query_batch():
    jp, tp, _ = _fixture_planes(48, 6, 1, seed=2)
    for out in (_tiered_both(jp, tp, np.zeros(0, np.int32), 16),
                _pipelined_both(jp, tp, np.zeros(0, np.int32), 16)):
        assert all(t.shape[0] == 0 for t in out[:3])


def test_window_helpers_match_jax():
    jp, tp, _ = _fixture_planes(256, 9, 1, seed=7, n=200)
    jk = jp.keys
    for jf, tf in ((ssk.rank_windows, tssk.rank_windows),
                   (ssk.row_widths, tssk.row_widths),
                   (ssk.bottom_ranks, tssk.bottom_ranks)):
        assert_arrays_equal(jf(jk), tf(tp.keys), jf.__name__)
    assert_arrays_equal(ssk._fetch_schedule(jp.widths, 9),
                        tssk._fetch_schedule(tp.widths, 9), "fetch")
    # the bare-matrix path derives the same companions the plane holds
    qs = np.array(jp.keys)[-1][:50]
    a = tssk.splay_search(tp, torch.as_tensor(qs))
    b = tssk.splay_search(tp.keys, torch.as_tensor(qs))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", [0, -4, 2.5, True, "256"])
def test_bad_query_block_raises(bad):
    _, tp, qs = _fixture_planes(48, 6, 8, seed=1)
    with pytest.raises(ValueError):
        ssk._check_query_block(bad, 8)
    with pytest.raises(ValueError):
        tssk.splay_search(tp, torch.as_tensor(qs), query_block=bad)
    with pytest.raises(ValueError):
        tssk.splay_search_pipelined(tp, torch.as_tensor(qs),
                                    query_block=bad)


def test_ref_oracle_and_dispatch():
    jp, tp, qs = _fixture_planes(256, 9, 200, seed=11)
    qs = _queries(np.asarray(jp.keys), qs)
    a = jref.splay_search_ref(jp.keys, jnp.asarray(qs))
    b = tref.splay_search_ref(tp.keys, torch.as_tensor(qs))
    for name, x, y in zip(("found", "rank", "level"), a, b):
        assert_arrays_equal(x, y, name)
    # CPU dispatch: pipelined=None is the plain tiered descent and the
    # pipelined one agrees; off the pad sentinel (which the oracle's
    # equality test matches against pad lanes) all equal the oracle
    outs = [tops.splay_search(tp, torch.as_tensor(qs), pipelined=p)
            for p in (None, False, True)]
    real = torch.as_tensor(qs != ssk.PAD_KEY)
    for c in outs:
        for x, y, z in zip(outs[0], c, b):
            assert torch.equal(x, y)
            assert torch.equal(x[real], z[real])
    assert tops.exec_mode(tp.keys) == "plain-cpu"
    assert tops.exec_mode("cuda") == "cuda-kernels"
    # sharded=True with no mesh to resolve: the replicated search
    for x, y in zip(tops.splay_search(tp, torch.as_tensor(qs),
                                      sharded=True), outs[0]):
        assert torch.equal(x, y)
    seg = tp._replace(keys=tp.keys.clone())
    seg.keys[-1, 3] = tssk.PAD_KEY
    with pytest.raises(ValueError, match="segmented"):
        tops.splay_search(seg, torch.as_tensor(qs))


# ---------------------------------------------------------------------------
# B5: the seed baseline's full-width count
# ---------------------------------------------------------------------------

def _full_both(keys, qs, qb, plane=None):
    """The JAX ``_kernel_full`` in interpret mode against the port's
    plain B5 over the same matrix; ``plane`` (a port plane struct) is
    searched through the port's public entry point too."""
    a = ssk._splay_search_full_arrays(jnp.asarray(keys), jnp.asarray(qs),
                                      query_block=qb, interpret=True)
    b = tssk.splay_search_full(torch.as_tensor(np.array(keys)),
                               torch.as_tensor(qs), query_block=qb)
    for name, x, y in zip(("found", "rank", "level"), a, b):
        assert_arrays_equal(x, y, name)
    if plane is not None:
        for x, y in zip(b, tops.splay_search_full(
                plane, torch.as_tensor(qs), query_block=qb)):
            assert torch.equal(x, y)
    return b


def _sweep_matrix(n, levels, nq):
    """The random plane and half-hit batch of ``test_kernels.py``'s
    sweep, built by the port's host level arrays."""
    rng = np.random.default_rng(n + levels)
    keys = np.sort(rng.choice(10 * n, n, replace=False)).astype(np.int32)
    heights = rng.integers(0, levels, n).astype(np.int32)
    plane = tla.build(keys, heights, min_levels=levels)
    qs = np.concatenate([rng.choice(keys, nq // 2),
                         rng.integers(0, 10 * n, nq - nq // 2)])
    return plane, qs.astype(np.int32)


@pytest.mark.parametrize("n,levels,nq,qb", [
    (128, 2, 64, 32),
    (1000, 4, 256, 64),
    (5000, 6, 512, 256),
    (777, 3, 130, 64),          # non-divisible query count (padding)
])
def test_full_plain_matches_pallas_sweep(n, levels, nq, qb):
    plane, qs = _sweep_matrix(n, levels, nq)
    _full_both(plane.keys, _queries(plane.keys, qs), qb, plane)


@pytest.mark.parametrize("alpha", [0.6, 1.0, 1.4])
@pytest.mark.parametrize("nq", [512, 333])   # block multiple and not
def test_full_plain_matches_pallas_zipf(alpha, nq):
    """The splay-shaped Zipf fixture at W = 4096 with absent keys mixed
    in; the hot batch lets whole blocks resolve and skip rows."""
    keys, heights, qs = twl.zipf_level_fixture(4096, alpha, nq,
                                               seed=int(alpha * 10) + nq)
    rng = np.random.default_rng(int(alpha * 10) + nq + 1)
    qs[::17] = rng.integers(0, 20 * 4096, len(qs[::17])).astype(np.int32)
    plane = tla.build(keys, heights, min_levels=6)
    f, r, lv = _full_both(plane.keys, qs, 256, plane)
    # equal to the oracle and to the tiered descent (the reference's
    # test_tiered_matches_seed_baseline)
    for x, y in zip((f, r, lv), tref.splay_search_ref(
            torch.as_tensor(plane.keys), torch.as_tensor(qs))):
        assert torch.equal(x, y)
    for x, y in zip((f, r, lv), tops.splay_search(plane,
                                                  torch.as_tensor(qs))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("nq", [0, 1, 7, 255, 256, 257])
def test_full_unpadded_and_sentinel_queries(nq):
    """Any query count; the int32 extremes and the pad sentinel, which
    B5 (like the oracle) reports found."""
    plane, _ = _sweep_matrix(700, 3, 1)
    rng = np.random.default_rng(nq)
    qs = rng.choice(plane.keys[-1][:700], nq).astype(np.int32)
    f, r, lv = _full_both(plane.keys, qs, 256)
    assert f.shape == r.shape == lv.shape == (nq,)
    pad = np.asarray([ssk.PAD_KEY], np.int32)
    f, r, lv = _full_both(plane.keys, np.concatenate([qs, pad]), 64)
    assert bool(f[-1]) and int(r[-1]) == plane.keys.shape[1] - 1


def test_full_entry_points_and_degenerate_planes():
    jp, tp, qs = _fixture_planes(256, 9, 100, seed=13)
    qs = _queries(np.asarray(jp.keys), qs)
    a = ssk.splay_search_full(jp, jnp.asarray(qs), interpret=True)
    b = tssk.splay_search_full(tp, torch.as_tensor(qs))
    for name, x, y in zip(("found", "rank", "level"), a, b):
        assert_arrays_equal(x, y, name)
    for keys, heights in (([], []), ([42], [3])):
        jp, tp = _planes(keys, heights, 64, 5)
        _full_both(np.asarray(jp.keys),
                   np.asarray([ssk.NEG_INF_KEY, 0, 41, 42, 43,
                               ssk.PAD_KEY - 1], np.int32), 4)
    seg = tp._replace(keys=tp.keys.clone())
    seg.keys[-1, 0] = tssk.PAD_KEY
    seg.keys[-1, 1] = 5
    with pytest.raises(ValueError, match="segmented"):
        tops.splay_search_full(seg, torch.as_tensor(qs))
    with pytest.raises(ValueError):
        tops.splay_search_full(tp, torch.as_tensor(qs), query_block=0)
