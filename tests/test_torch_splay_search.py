"""PyTorch port, search kernels: the plain versions of B1 (tiered) and
B2 (pipelined) against the JAX Pallas kernels in interpret mode on the
same planes and queries — found, rank, level_found and the per-block
byte counter bit-exact — plus the window helpers, the query-block
validation, the dispatch rules and the torch oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_index as dix
from repro.core import workload as wl
from repro.kernels import ref as jref
from repro.kernels import splay_search as ssk
from repro_torch.core import convert
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
    with pytest.raises(NotImplementedError):
        tops.splay_search(tp, torch.as_tensor(qs), sharded=True)
    seg = tp._replace(keys=tp.keys.clone())
    seg.keys[-1, 3] = tssk.PAD_KEY
    with pytest.raises(ValueError, match="segmented"):
        tops.splay_search(seg, torch.as_tensor(qs))
