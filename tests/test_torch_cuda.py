"""PyTorch port on the card: each CUDA kernel (B1 tiered search, B2
pipelined search, F update fold) held against its plain PyTorch version
on the same inputs, bit-exact, and the epoch loop on the card against
the CPU loop.  Needs an NVIDIA GPU and nvcc; skips without a card.
Imports no JAX (the card's machine has none): run it with
``--noconftest``, as the README says."""

import numpy as np
import pytest
import torch

from repro_torch.core import device_index as tdix
from repro_torch.core import splaylist as tsx
from repro_torch.core import workload as twl
from repro_torch.kernels import fold
from repro_torch.kernels import splay_search as tssk

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _plane(width, n_levels, nq, seed=0, device="cuda"):
    keys, heights, qs = twl.zipf_level_fixture(width, 1.0, nq, seed=seed)
    n = width - width // 8
    kk = np.full(width, tssk.PAD_KEY, np.int32)
    hh = np.zeros(width, np.int32)
    kk[:n], hh[:n] = keys[:n], heights[:n]
    plane = tdix.build_device(torch.as_tensor(kk, device=device),
                              torch.as_tensor(hh, device=device), n_levels)
    miss = np.asarray([tssk.NEG_INF_KEY, -1, tssk.PAD_KEY - 1], np.int32)
    return plane, torch.as_tensor(np.concatenate([qs, miss]),
                                  device=device)


def _equal(a, b):
    """Bit-equality of tensors, or of (nested) tuples of tensors."""
    if torch.is_tensor(a):
        assert torch.equal(a.cpu(), b.cpu())
        return
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _equal(x, y)


@pytest.mark.parametrize("width,levels,nq", [
    (4096, 14, 3000), (1031, 8, 257), (64, 5, 1)])
def test_tiered_kernel_matches_plain(width, levels, nq):
    plane, qs = _plane(width, levels, nq)
    before = tssk.LAUNCHES["splay_search_tiered"]
    got = tssk._splay_search_arrays(plane.keys, qs, 256, plane.rank_map,
                                    plane.widths)
    assert tssk.LAUNCHES["splay_search_tiered"] == before + 1
    qp = tssk._pad_queries(qs, 256)
    want = tssk.splay_search_tiered_plain(plane.keys, plane.rank_map,
                                          plane.widths, qp)
    _equal(got, [t[:qs.shape[0]] for t in want])


@pytest.mark.parametrize("width,levels,nq,qb", [
    (16384, 10, 5000, 256), (1008, 8, 1001, 256), (48, 6, 37, 16)])
def test_pipelined_kernel_matches_plain(width, levels, nq, qb):
    plane, qs = _plane(width, levels, nq)
    before = tssk.LAUNCHES["splay_search_pipelined"]
    got = tssk._splay_search_pipelined_arrays(
        plane.keys, qs, qb, plane.rank_map, plane.widths, plane.bot_rank)
    assert tssk.LAUNCHES["splay_search_pipelined"] == before + 1
    want = tssk.splay_search_pipelined_plain(
        plane.keys, plane.rank_map, plane.widths, plane.bot_rank,
        tssk._pad_queries(qs, qb), qs.shape[0], qb)
    n = qs.shape[0]
    _equal(got, [*(t[:n] for t in want[:3]), want[3]])


def _cpu(st):
    return tsx.SplayState(*(t.cpu() for t in st))


@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
def test_fold_kernel_matches_plain(count_dtype):
    rng = np.random.default_rng(1)
    pool = rng.permutation(600)[:300].astype(np.int32)
    n = 900
    kinds = np.concatenate([np.full(300, 1, np.int32),
                            rng.choice(3, n - 300, p=[0.4, 0.1, 0.5])])
    keys = np.concatenate([pool, rng.choice(pool, n - 300)])
    upd = rng.random(n) < 0.6
    st0 = tsx.make(512, 16, count_dtype=count_dtype, device="cuda")
    before = fold.LAUNCHES["splay_fold"]
    g = tsx.run_ops(st0, kinds, keys, upd)
    assert fold.LAUNCHES["splay_fold"] > before
    w = tsx.run_ops(_cpu(st0), kinds, keys, upd)
    _equal(g, w)
    qs = rng.choice(700, 256).astype(np.int32)
    up = rng.random(256) < 0.5
    for aggregate in (False, True):
        _equal(tsx.run_contains_batch(g[0], qs, up, aggregate),
               tsx.run_contains_batch(_cpu(g[0]), qs, up, aggregate))


def test_serving_on_card_matches_cpu():
    ops = twl.zipf_workload(1500, 4 * 256, s=1.0, p=0.1, seed=2)
    st = tsx.make(2050, 16, device="cuda")
    st, _, _ = tsx.run_ops(st, np.ones(1500, np.int32), ops.populate,
                           np.ones(1500, bool))
    plane = tdix.from_state_device(st, n_levels=16, width=2048)
    args = (np.zeros((4, 256), np.int32), ops.keys.reshape(4, 256),
            ops.upd.reshape(4, 256))
    g = tsx.run_serving(st, plane, *args, aggregate=True,
                        plane_search=True)
    w = tsx.run_serving(_cpu(st), tdix.DeviceLevelArrays(
        *(t.cpu() for t in plane)), *args, aggregate=True,
        plane_search=True)
    _equal(g, w)
    assert (g[2] == 1).all()
