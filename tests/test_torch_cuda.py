"""PyTorch port on the card: each CUDA kernel (B1 tiered search, B2
pipelined search, B5 full-width search, F update fold, B3/B4 row
gathers and the fused two-tier gather) held against its plain PyTorch
version on the same inputs, bit-exact, and the epoch loop and the vocab
cache on the card against their CPU runs.  F's list handling (long,
mostly zero-weight lists over many of the warp's 128-entry ballots, a
rebuild stop deep inside an op list, an exhausted capacity, 33- and
65-row columns) and B5's cluster plan
(ragged and tiny widths, one row, ragged tiles, hot batches, row
panels, the pad sentinel) have cases of their own.  Needs an NVIDIA GPU and
nvcc; skips without a card.  Imports no JAX (the card's machine has
none): run it with ``--noconftest``, as the README says."""

import numpy as np
import pytest
import torch

from repro_torch.core import device_index as tdix
from repro_torch.core import splay_cache as tsc
from repro_torch.core import splaylist as tsx
from repro_torch.core import workload as twl
from repro_torch.kernels import fold
from repro_torch.kernels import hot_gather as thg
from repro_torch.kernels import ops as tops
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


@pytest.mark.parametrize("width,levels,nq", [
    (16384, 10, 2048), (1031, 8, 257), (64, 5, 1)])
def test_full_kernel_matches_plain(width, levels, nq):
    plane, qs = _plane(width, levels, nq)
    qs = torch.cat([qs, torch.as_tensor([tssk.PAD_KEY], device="cuda",
                                        dtype=torch.int32)])
    before = tssk.LAUNCHES["splay_search_full"]
    got = tssk._splay_search_full_arrays(plane.keys, qs, 256)
    assert tssk.LAUNCHES["splay_search_full"] == before + 1
    want = tssk.splay_search_full_plain(plane.keys,
                                        tssk._pad_queries(qs, 256), 256)
    _equal(got, [t[:qs.shape[0]] for t in want])
    assert bool(got[0][-1])                    # PAD_KEY: found, as the oracle


def _table(n, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn((n, d), generator=g, device="cuda").to(dtype)
    return torch.randint(-100, 100, (n, d), generator=g,
                         device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("n,d,q", [(500, 37, 333), (4096, 64, 8192),
                                   (97, 8, 1), (300, 4096, 257)])
def test_gather_kernels_match_plain(dtype, n, d, q):
    """B3 and B4 on both copy paths (TMA bulk copies when the row is a
    multiple of 16 bytes, else vector words down to single bytes: the row
    length in bytes sets it), out-of-range ids included, from int32 ids
    and from int64 ids with high bits set (they keep their low 32)."""
    table = _table(n, d, dtype, seed=n + d)
    rng = np.random.default_rng(q)
    ids = rng.integers(0, n, q).astype(np.int32)
    ids[:min(q, 4)] = [-1, n, -n - 5, 2 ** 31 - 1][:min(q, 4)]
    ids = torch.as_tensor(ids, device="cuda")
    ids64 = ids.long() + (torch.as_tensor(
        rng.integers(-2 ** 20, 2 ** 20, q), device="cuda") << 32)
    path = _expected_path(d * table.element_size())
    for entry, fn in (("gather_rows", thg.gather_rows),
                      ("gather_hot", thg.gather_hot)):
        want = thg.gather_rows_ref(table, ids)
        for idx in (ids, ids64):
            before = thg.LAUNCHES[entry]
            got = fn(table, idx)
            assert thg.LAUNCHES[entry] == before + 1
            assert thg.LAST_PATH[entry] == path, (entry, path)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want), entry


def _expected_path(row_bytes):
    """The copy path of rows of ``row_bytes`` between fresh (aligned)
    allocations."""
    if row_bytes % 16 == 0:
        return "bulk"
    return f"vector{8 if row_bytes % 8 == 0 else row_bytes & -row_bytes}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("n,d,q,nr", [
    (5000, 4096, 8192, 5000),       # bulk copies (minitron-8b width)
    (600, 1001, 333, 450),          # vector words, rank map shorter
    (300, 37, 1, 700),              # vector words, rank map longer
    (97, 4096, 0, 97),              # empty batch: no launch
    (800, 64, 257, 800)])           # bulk copies of short rows
def test_fused_gather_kernel_matches_plain(dtype, n, d, q, nr):
    """The fused two-tier gather (one launch) against its plain version
    on both copy paths: mixed, all-hot and all-cold batches, out-of-range
    ids, ranks past the hot buffer, int32 and int64 ids; and against
    ``table[ids]`` when the hot buffer holds the rank map's rows."""
    table = _table(n, d, dtype, seed=n + d)
    rng = np.random.default_rng(n + q)
    h = min(256, nr // 2)
    slots = rng.choice(nr, h, replace=False)
    hot_rank = np.full(nr, -1, np.int32)
    hot_rank[slots] = np.arange(h)
    rows = torch.as_tensor(np.minimum(slots, n - 1), device="cuda")
    buf = table[rows]
    consistent = nr == n
    if not consistent:            # a few ranks past the buffer: clamp
        free = np.nonzero(hot_rank < 0)[0][:3]
        hot_rank[free] = h + 5 * np.arange(len(free))
    rank = torch.as_tensor(hot_rank, device="cuda")
    hot = np.nonzero(hot_rank >= 0)[0]
    cases = {"mixed": rng.integers(0, max(n, nr), q),
             "all-hot": rng.choice(hot, q),
             "all-cold": rng.choice(np.nonzero(hot_rank < 0)[0], q)}
    cases["mixed"][:min(q, 4)] = [-1, n, -n - 5, 2 ** 31 - 1][:min(q, 4)]
    path = _expected_path(d * table.element_size())
    assert (path == "bulk") == (d in (4096, 64))
    for case, ids in cases.items():
        ids32 = torch.as_tensor(ids.astype(np.int32), device="cuda")
        want = thg.hot_gather_ref(table, buf, rank, ids32)
        ids64 = ids32.long() + (torch.as_tensor(
            rng.integers(-2 ** 20, 2 ** 20, q), device="cuda") << 32)
        for idx in (ids32, ids64):
            before = thg.LAUNCHES["hot_gather"]
            got = tops.hot_gather(table, buf, rank, idx)
            assert thg.LAUNCHES["hot_gather"] == before + (q > 0)
            if q:
                assert thg.LAST_PATH["hot_gather"] == path
            torch.cuda.synchronize()
            assert got.shape == (q, d) and got.dtype == dtype
            assert torch.equal(got, want), (case, idx.dtype)
            if consistent:
                assert torch.equal(got, thg.gather_rows_ref(table, ids32))


def test_hot_gather_matches_table():
    table = _table(3000, 129, torch.bfloat16, seed=3)
    rng = np.random.default_rng(4)
    hot_ids = rng.choice(3000, 256, replace=False)
    hot_rank = np.full(3000, -1, np.int32)
    hot_rank[hot_ids] = np.arange(256)
    buf = table[torch.as_tensor(hot_ids, device="cuda")]
    ids = torch.as_tensor(twl.zipf_token_ids(rng, 3000, (4096,)),
                          device="cuda")
    out = tops.hot_gather(table, buf, torch.as_tensor(hot_rank,
                                                      device="cuda"), ids)
    assert torch.equal(out, table[ids.long()])


def test_vocab_cache_on_card_matches_cpu():
    """observe_serving and lookup on the card against the CPU cache."""
    caches = [tsc.SplayVocabCache(700, hot_size=32, update_prob=0.2,
                                  refresh_every=8, seed=5, device=dev)
              for dev in ("cuda", "cpu")]
    rng = np.random.default_rng(6)
    for _ in range(4):
        toks = twl.zipf_token_ids(rng, 700, (4, 64))
        toks[rng.random((4, 64)) < 0.05] = -1
        for c in caches:
            c.observe_serving(toks)
        np.testing.assert_array_equal(caches[0].counts, caches[1].counts)
        np.testing.assert_array_equal(caches[0].hot_ids, caches[1].hot_ids)
        assert torch.equal(caches[0].hot_rank.cpu(), caches[1].hot_rank)
    table = _table(700, 64, torch.bfloat16, seed=7)
    ids = torch.as_tensor(twl.zipf_token_ids(rng, 700, (8, 256)),
                          device="cuda")
    assert torch.equal(caches[0].lookup(table, ids), table[ids.long()])


# ---------------------------------------------------------------------------
# kernel F redesigned: compacted weighted lists, stops inside op lists
# ---------------------------------------------------------------------------

def _prefilled(count_dtype, n_keys=600, cap=1024, ml=16, seed=0):
    rng = np.random.default_rng(seed)
    pool = rng.permutation(4 * n_keys)[:n_keys].astype(np.int32)
    st = tsx.make(cap, ml, count_dtype=count_dtype, device="cuda")
    st, _, _ = tsx.run_ops(st, np.ones(n_keys, np.int32), pool,
                           np.ones(n_keys, bool))
    return st, pool, rng


@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
def test_fold_sparse_weighted_lists(count_dtype):
    """Weighted lists of many 128-entry ballots, 95% zero weights: one
    launch, equal to the plain fold and to the fold of the w > 0 subset."""
    st, pool, rng = _prefilled(count_dtype)
    n = 3000
    keys = torch.as_tensor(rng.choice(pool, n), device="cuda")
    w = torch.as_tensor(np.where(rng.random(n) < 0.05,
                                 rng.integers(1, 4, n), 0),
                        device="cuda").to(count_dtype)
    wm = (torch.as_tensor(rng.integers(0, 2, n), device="cuda")
          * (w > 0)).to(count_dtype)
    full, sub, cpu = tsx.clone(st), tsx.clone(st), _cpu(st)
    before = fold.LAUNCHES["splay_fold"]
    fold.fold_weighted(full, keys, w, wm)
    assert fold.LAUNCHES["splay_fold"] == before + 1
    keep = w > 0
    fold.fold_weighted(sub, keys[keep], w[keep], wm[keep])
    fold.fold_weighted(cpu, keys.cpu(), w.cpu(), wm.cpu())
    _equal(full, sub)
    _equal(full, cpu)


def test_fold_rebuild_stop_inside_a_chunk():
    """600 pure reads, then a delete-heavy tail: the first rebuild stop
    falls between ops 512 and 1023.  The stop op is reported,
    nothing past it is written, and the whole run_ops (which rebuilds
    and relaunches) equals its CPU run."""
    st, pool, rng = _prefilled(torch.int32, n_keys=400, seed=3)
    n, reads = 1500, 600
    kinds = np.concatenate([np.zeros(reads, np.int32), rng.choice(
        3, n - reads, p=[0.2, 0.1, 0.7]).astype(np.int32)])
    keys = rng.choice(pool, n).astype(np.int32)
    upd = np.arange(n) >= reads
    g = tsx.clone(st)
    res = torch.full((n,), -7, dtype=torch.int32, device="cuda")
    plen = torch.full((n,), -7, dtype=torch.int32, device="cuda")
    args = [torch.as_tensor(x, device="cuda") for x in (kinds, keys, upd)]
    stop = fold.fold_ops(g, *args, res, plen)
    c = _cpu(st)
    res_c = torch.full((n,), -7, dtype=torch.int32)
    plen_c = torch.full((n,), -7, dtype=torch.int32)
    want = fold.fold_ops(c, *(a.cpu() for a in args), res_c, plen_c)
    assert stop == want and 512 < stop < 1023
    _equal((g, res, plen), (c, res_c, plen_c))
    assert bool((res[stop + 1:] == -7).all())
    _equal(tsx.run_ops(st, kinds, keys, upd),
           tsx.run_ops(_cpu(st), kinds, keys, upd))


def test_fold_capacity_exhausted():
    """An insert past the capacity stops the launch before it writes:
    the error names the op, earlier ops are written, later ones not."""
    st = tsx.make(40, 8, device="cuda")
    n = 700
    keys = np.arange(n, dtype=np.int32)[::-1].copy()
    kinds = np.ones(n, np.int32)
    args = [torch.as_tensor(x, device="cuda")
            for x in (kinds, keys, np.ones(n, bool))]
    res = torch.full((n,), -7, dtype=torch.int32, device="cuda")
    plen = torch.full((n,), -7, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="exhausted at op 38"):
        fold.fold_ops(tsx.clone(st), *args, res, plen)
    assert bool((res[:38] == 1).all()) and bool((res[38:] == -7).all())
    assert bool((plen[38:] == -7).all())
    with pytest.raises(RuntimeError, match="exhausted"):
        tsx.run_ops(_cpu(st), kinds, keys, np.ones(n, bool))


@pytest.mark.parametrize("count_dtype,max_level", [(torch.int32, 32),
                                                   (torch.int64, 64)])
def test_fold_widest_levels(count_dtype, max_level):
    """The widest columns (33 and 65 rows: two and three rows a lane)."""
    rng = np.random.default_rng(max_level)
    pool = rng.permutation(3000)[:900].astype(np.int32)
    n = 2500
    kinds = np.concatenate([np.ones(900, np.int32),
                            rng.choice(3, n - 900, p=[0.6, 0.2, 0.2])])
    keys = np.concatenate([pool, rng.choice(pool, n - 900)]).astype(np.int32)
    upd = rng.random(n) < 0.7
    st = tsx.make(1200, max_level, count_dtype=count_dtype, device="cuda")
    g = tsx.run_ops(st, kinds, keys, upd)
    _equal(g, tsx.run_ops(_cpu(st), kinds, keys, upd))
    qs = rng.choice(pool, 2048).astype(np.int32)
    up = rng.random(2048) < 0.3
    _equal(tsx.run_contains_batch(g[0], qs, up, True),
           tsx.run_contains_batch(_cpu(g[0]), qs, up, True))


# ---------------------------------------------------------------------------
# kernel B5 redesigned: the width over a thread-block cluster
# ---------------------------------------------------------------------------

def _hot_batch(plane, nq, seed):
    """Queries drawn from the top live rows: whole blocks found early."""
    rng = np.random.default_rng(seed)
    keys = plane.keys.cpu().numpy()
    top = next(r for r in range(keys.shape[0])
               if (keys[r] != tssk.PAD_KEY).sum() >= 8)
    live = keys[top][keys[top] != tssk.PAD_KEY]
    return torch.as_tensor(rng.choice(live, nq).astype(np.int32),
                           device="cuda")


@pytest.mark.parametrize("width,levels,nq,qb,batch", [
    (1031, 8, 333, 64, "zipf"),      # W not a multiple of S; q % tile
    (20, 4, 100, 32, "zipf"),        # W < 4 * S
    (4096, 1, 257, 256, "zipf"),     # L = 1
    (16384, 24, 2048, 256, "hot"),   # an all-found hot batch
    (16384, 24, 2048, 256, "zipf"),  # the main path's shape
    (131072, 24, 512, 256, "zipf"),  # a slice staged in row panels
    (4092, 6, 300, 128, "zipf")])    # 16-byte rows, W % 8 != 0
def test_full_cluster_kernel_matches_plain(width, levels, nq, qb, batch):
    plane, qs = _plane(width, levels, nq, seed=width + levels)
    if batch == "hot":
        qs = _hot_batch(plane, nq, width)
    qs = torch.cat([qs, torch.as_tensor([tssk.PAD_KEY, tssk.NEG_INF_KEY],
                                        device="cuda", dtype=torch.int32)])
    before = tssk.LAUNCHES["splay_search_full"]
    got = tssk._splay_search_full_arrays(plane.keys, qs, qb)
    assert tssk.LAUNCHES["splay_search_full"] == before + 1
    want = tssk.splay_search_full_plain(plane.keys,
                                        tssk._pad_queries(qs, qb), qb)
    _equal(got, [t[:qs.shape[0]] for t in want])
    assert bool(got[0][-2])                    # PAD_KEY: found
    if batch == "hot":
        assert bool(got[0][:nq].all())
