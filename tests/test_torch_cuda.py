"""PyTorch port on the card: each CUDA kernel (B1 tiered search, B2
pipelined search, B5 full-width search, F update fold, B3/B4 row
gathers and the fused two-tier gather) held against its plain PyTorch
version on the same inputs, bit-exact, and the epoch loop and the vocab
cache on the card against their CPU runs.  The ordered, audited KV page
index: F's op list with all five kinds against its plain fold, the
ordered ops against a numpy oracle and their CPU runs, the plane audit
of flipped planes against its CPU run, and a device pool on the card
under faults against a host pool.  The model zoo (one smoke
architecture of each family, card against CPU) and the serving engine
(device index on the card against the host index).  A serving snapshot
of a device pool restored onto the card, and one train step of a smoke
architecture on the card against the CPU.  F's list handling (long,
mostly zero-weight lists over many of the warp's 128-entry ballots, a
rebuild stop deep inside an op list, an exhausted capacity, 33- and
65-row columns), B5's cluster plan
(ragged and tiny widths, one row, ragged tiles, hot batches, row
panels, the pad sentinel) and the descent engine of B1 and B2 (B1 at
every block size and B2 on clusters of 1 to 8 CTAs, 16-byte and
unaligned rows, a lane that never resolves, the plane entry against
the bare matrix) have cases of their own.  Needs an NVIDIA GPU and
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


# ---------------------------------------------------------------------------
# B1 and B2: the descent engine's launch shapes and read paths
# ---------------------------------------------------------------------------

def _unaligned(t):
    """A copy of ``t`` whose base is 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:t.numel() + 1].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("width,levels,nq", [
    (4096, 14, 3000),          # 16-byte rows: 16-byte reads
    (1031, 8, 257),            # ragged width: 4-byte reads
    (1008, 24, 1001),          # 16-lane tiles
    (64, 5, 1)])
def test_tiered_descent_shapes(width, levels, nq, layout):
    """B1 at every block size, on 16-byte and unaligned rows: equal to
    its plain version, one launch per call."""
    plane, qs = _plane(width, levels, nq, seed=width + nq)
    keys, rm = plane.keys, plane.rank_map
    if layout == "unaligned":
        keys, rm = _unaligned(keys), _unaligned(rm)
    want = tssk.splay_search_tiered_plain(keys, rm, plane.widths,
                                          tssk._pad_queries(qs, 256))
    for block in (32, 64, 128, 256):
        before = tssk.LAUNCHES["splay_search_tiered"]
        got = tssk._splay_search_arrays(keys, qs, 256, rm, plane.widths,
                                        _block=block)
        assert tssk.LAUNCHES["splay_search_tiered"] == before + 1
        _equal(got, [t[:qs.shape[0]] for t in want])


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("width,levels,nq,qb", [
    (16384, 24, 2048, 256), (1008, 8, 1001, 256), (48, 6, 37, 16),
    (1008, 24, 300, 16), (4096, 12, 999, 1024)])
def test_pipelined_descent_shapes(width, levels, nq, qb, layout):
    """B2 on 16-byte and unaligned rows, query blocks of 16 to 1024
    lanes, each on a cluster of 1 to 8 CTAs: the triple and the byte
    counter equal to its plain version, one launch per call."""
    plane, qs = _plane(width, levels, nq, seed=width + levels)
    keys, rm, br = plane.keys, plane.rank_map, plane.bot_rank
    if layout == "unaligned":
        keys, rm, br = (_unaligned(t) for t in (keys, rm, br))
    want = tssk.splay_search_pipelined_plain(
        keys, rm, plane.widths, br, tssk._pad_queries(qs, qb), qs.shape[0],
        qb)
    n = qs.shape[0]
    for cluster in (None, 1, 2, 4, 8):
        if cluster and qb % cluster:
            continue
        before = tssk.LAUNCHES["splay_search_pipelined"]
        got = tssk._splay_search_pipelined_arrays(
            keys, qs, qb, rm, plane.widths, br, _cluster=cluster)
        assert tssk.LAUNCHES["splay_search_pipelined"] == before + 1
        _equal(got, [*(t[:n] for t in want[:3]), want[3]])


def test_descent_lane_that_never_resolves():
    """A bottom-row bot_rank with a gap after key j, a key of the bottom
    row alone: a lane whose predecessor is key j is pinned in no row, so
    B2 walks its block through every row (counted) and keeps its rank 0;
    equal to its plain version."""
    plane, qs = _plane(1024, 8, 300, seed=3)
    live = plane.keys[-1][:int(plane.widths[-1])].cpu().numpy()
    heights = plane.heights.cpu().numpy()
    j = next(i for i in range(len(live) // 2, len(live) - 1)
             if heights[i] == 0 and live[i] + 1 < live[i + 1])
    br = plane.bot_rank.clone()
    br[-1, j] += 5
    qs = torch.cat([qs, torch.as_tensor([live[j] + 1], device="cuda",
                                        dtype=torch.int32)])
    got = tssk._splay_search_pipelined_arrays(
        plane.keys, qs, 64, plane.rank_map, plane.widths, br)
    want = tssk.splay_search_pipelined_plain(
        plane.keys, plane.rank_map, plane.widths, br,
        tssk._pad_queries(qs, 64), qs.shape[0], 64)
    n = qs.shape[0]
    _equal(got, [*(t[:n] for t in want[:3]), want[3]])
    assert not bool(got[0][-1]) and int(got[1][-1]) == 0
    assert int(got[2][-1]) == 8


def test_descent_plane_entry_equals_bare_matrix():
    """The public entry on a plane struct (its bot_rank) and on the bare
    matrix (bot_rank derived on the card) give the same triple, on both
    descents."""
    plane, qs = _plane(4096, 14, 1000, seed=9)
    for pipelined in (False, True):
        a = tops.splay_search(plane, qs, pipelined=pipelined)
        b = tops.splay_search(plane.keys, qs, pipelined=pipelined)
        _equal(a, b)


# ---------------------------------------------------------------------------
# the ordered, audited KV page index
# ---------------------------------------------------------------------------

def _ordered_state(n=1500, cap=2050, ml=16, seed=3):
    rng = np.random.default_rng(seed)
    pool = rng.permutation(6000)[:n].astype(np.int32)
    st = tsx.make(cap, ml, device="cuda")
    st, _, _ = tsx.run_ops(st, np.ones(n, np.int32), pool, np.ones(n, bool))
    return st, np.sort(pool), rng


@pytest.mark.parametrize("count_dtype", [torch.int32, torch.int64])
def test_fold_ordered_kinds_match_plain(count_dtype):
    """F's op list with all five kinds (a rebuild fires inside it, and
    ordered ops read slots lane 0 wrote earlier in the same launch)
    against the plain fold: answers, path lengths and every state
    array."""
    rng = np.random.default_rng(4)
    pool = rng.permutation(3000)[:700].astype(np.int32)
    n = 1500
    kinds = np.concatenate([np.full(700, 1, np.int32),
                            rng.choice(5, n - 700,
                                       p=[0.1, 0.05, 0.55, 0.15, 0.15])])
    keys = np.concatenate([pool, np.where(rng.random(n - 700) < 0.8,
                                          rng.choice(pool, n - 700),
                                          rng.integers(-9, 3100, n - 700))])
    keys = keys.astype(np.int32)
    upd = rng.random(n) < 0.6
    st0 = tsx.make(1024, 16, count_dtype=count_dtype, device="cuda")
    before = fold.LAUNCHES["splay_fold"]
    g = tsx.run_ops(st0, kinds, keys, upd)
    torch.cuda.synchronize()
    assert fold.LAUNCHES["splay_fold"] > before + 1     # a rebuild stop
    _equal(g, tsx.run_ops(_cpu(st0), kinds, keys, upd))


def test_ordered_ops_on_card_match_oracle():
    st, live, rng = _ordered_state()
    plane = tdix.from_state_device(st, n_levels=16, width=2048)
    q = np.concatenate([rng.choice(live, 300), rng.integers(-10, 6010, 300),
                        [-(2 ** 31), tssk.PAD_KEY, tssk.PAD_KEY - 1]]
                       ).astype(np.int32)
    qd = torch.as_tensor(q, device="cuda")
    i = np.searchsorted(live, q.astype(np.int64), side="right")
    j = np.searchsorted(live, q.astype(np.int64), side="left")
    assert np.array_equal(tops.splay_rank(plane, qd).cpu().numpy(), i)
    pk, pr = tops.splay_predecessor(plane, qd)
    assert np.array_equal(pk.cpu().numpy(),
                          np.where(i > 0, live[i - 1], tssk.NEG_INF_KEY))
    sk, sr = tops.splay_successor(plane, qd)
    assert np.array_equal(sr.cpu().numpy(), j)
    assert np.array_equal(sk.cpu().numpy(), np.where(
        j < live.size, live[np.minimum(j, live.size - 1)], tssk.PAD_KEY))
    hi = qd + 40
    keys, cnt, tr = tops.splay_range_scan(plane, qd[:600], hi[:600], 16)
    for n in range(0, 600, 7):
        want = live[(live >= q[n]) & (live <= q[n] + 40)]
        assert int(cnt[n]) == want.size
        assert np.array_equal(keys[n, :min(want.size, 16)].cpu().numpy(),
                              want[:16])
    cpu_plane = plane._replace(**{f: getattr(plane, f).cpu()
                                  for f in plane._fields})
    _equal(tops.splay_top_k(plane, st.selfhits, 64),
           tops.splay_top_k(cpu_plane, st.selfhits.cpu(), 64))
    _equal(tops.splay_select(plane, qd),
           tops.splay_select(cpu_plane, qd.cpu()))
    _equal(tops.splay_range_count(plane, qd, hi),
           tops.splay_range_count(cpu_plane, qd.cpu(), hi.cpu()))


def test_audit_on_card_matches_cpu():
    from repro_torch.core import faults as tfl
    from repro_torch.core import plane_check as tpc
    st, _, _ = _ordered_state()
    plane = tdix.from_state_device(st, n_levels=16, width=2048)
    assert tpc.audit_summary(tpc.audit_plane(st, plane)) == "audit OK"
    cst = _cpu(st)
    for field in tfl.BITFLIP_FIELDS:
        for seed in range(3):
            bad, recs = tfl.flip_plane_bits(
                plane, np.random.default_rng(seed), 1, fields=(field,))
            assert recs and bad.keys.is_cuda
            a = tpc.audit_plane(st, bad)
            assert not tpc.audit_ok(a)
            cbad = bad._replace(**{f: getattr(bad, f).cpu()
                                   for f in bad._fields})
            assert a == tpc.audit_plane(cst, cbad)


def test_kv_pool_on_card_matches_host():
    from repro_torch.core import faults as tfl
    from repro_torch.core import workload as tw
    from repro_torch.serve.kv_cache import PagedKVPool
    plan = tfl.FaultPlan(seed=1, events=[
        tfl.FaultEvent(3, tfl.FAULT_BITFLIP, 1),
        tfl.FaultEvent(6, tfl.FAULT_TELEMETRY, 2)])
    dev = PagedKVPool(256, 4, device=True, index_width=256, index_batch=16,
                      audit_every=4, fault_plan=plan)
    host = PagedKVPool(256, 4)
    trace = tw.kv_scan_trace(300, 40, seed=0)
    logs = []
    for pool in (dev, host):
        log = []
        for k, s, h in zip(trace.kinds.tolist(), trace.seq_ids.tolist(),
                           trace.hi_ids.tolist()):
            if k == tw.KV_CREATE:
                log.append(pool.create(s) and pool.append_tokens(s, 3))
            elif k == tw.KV_LOOKUP:
                log.append(pool.lookup(s))
            elif k == tw.KV_RELEASE:
                pool.release(s)
                log.append(pool.utilization)
            elif k == tw.KV_SCAN:
                ids, cnt, tr = pool.lookup_range(s, h, max_range=8)
                log.append((ids.tolist(), cnt, tr))
            else:
                log.append(pool.predecessor(s))
        logs.append((log, sorted(pool.chains)))
    assert logs[0] == logs[1]
    assert dev._st.key.is_cuda and dev._plane.keys.is_cuda
    assert dev.stats["audit_failures"] >= 1 and dev.stats["repairs"] >= 1


# ---------------------------------------------------------------------------
# the model zoo and the serving engine on the card
# ---------------------------------------------------------------------------

def _card_checks():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import card_checks
    return card_checks


def _smoke_pair(arch):
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.models import model_zoo as zoo
    cfg = registry.get_smoke(arch)
    p_cpu = zoo.build_params(cfg, seed=0, device="cpu")
    return cfg, p_cpu, convert.params_from_numpy(
        convert.params_to_numpy(p_cpu), device="cuda")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "arctic-480b", "mamba2-1.3b",
                                  "zamba2-7b", "whisper-large-v3",
                                  "paligemma-3b"])
def test_models_on_card_match_cpu(arch):
    """One smoke architecture of each family, float32, through the smoke
    run's phase-5e check (``card_checks.smoke_arch_check``, the same
    seeded inputs): ``forward`` stage by stage (each stage from the
    CPU's state, read through the model's head), ``prefill_loop`` and
    three decode steps (each from the CPU's cache) allclose to the
    CPU's (rtol 1e-4, atol 1e-5), the greedy tokens equal; at the
    builder's scale with the float64 witness for a miss, at trained
    scale with no miss."""
    from repro_torch.configs import registry
    seed = 17 + list(registry.ARCHS).index(arch)
    _, trained = _card_checks().smoke_arch_check(torch, arch, "cuda", seed)
    assert not trained.witnessed


def test_models_on_card_where_float32_first_missed():
    """whisper-large-v3 on the inputs where the card's float32 first
    missed the CPU's at the builder's scale (stage layer0): the card
    lies no more than twice as far from the CPU's float64 result as the
    CPU's own float32 result does."""
    ref, trained = _card_checks().smoke_arch_check(
        torch, "whisper-large-v3", "cuda", 3)
    assert all(e_card <= 2 * e_cpu for _, _, e_card, e_cpu in ref.witnessed)
    assert not trained.witnessed


def test_engine_device_index_on_card_matches_host_index():
    """The reference's parity contract on the card: a device-indexed
    engine (its index plane, model and caches on the card) and a
    host-indexed one on the same arrivals emit the same ids, latencies,
    stalls, preemptions and chains; the descent and F launch."""
    from repro_torch.core import workload as tw
    from repro_torch.serve.engine import Engine, Request
    cfg, _, p_dev = _smoke_pair("qwen2-0.5b")
    arr = tw.poisson_zipf_arrivals(6, float("inf"), 64, prompt_len=(3, 6),
                                   max_new=6, seed=4)
    out = []
    for device_index in (True, False):
        eng = Engine(cfg, p_dev, max_batch=3, max_seq=48, n_pages=7,
                     page_size=4, stream_epochs=2,
                     device_index=device_index)
        for i in range(len(arr.seq_ids)):
            n = int(arr.prompt_lens[i])
            eng.submit(Request(seq_id=int(arr.seq_ids[i]),
                               prompt=arr.prompts[i, :n].copy(),
                               max_new=int(arr.max_new[i])))
        tops.reset_launch_counts()
        res = eng.run()
        counts = tops.launch_counts()
        out.append((res, eng.latencies, eng.stalls, eng.preemptions,
                    eng.tokens_out, dict(eng.pool.chains)))
        if device_index:
            assert eng.pool._plane.keys.is_cuda
            assert counts["splay_fold"] > 0
            assert counts["splay_search_tiered"] + \
                counts["splay_search_pipelined"] > 0
    assert out[0] == out[1]
    assert out[0][2] + out[0][3] > 0


# ---------------------------------------------------------------------------
# serving snapshots and training on the card
# ---------------------------------------------------------------------------

def test_device_pool_snapshot_round_trip_on_card(tmp_path):
    """A device pool on the card snapshotted with an op buffered,
    restored onto the card, and driven through the rest of a request
    trace: every verdict, the chains, the free list and the stats equal
    the uninterrupted pool's; the restored state and plane lie on the
    card, and its lookups launch the descent and F."""
    from repro_torch.serve import snapshot as snap
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.train.checkpoint import CheckpointManager
    trace = twl.kv_request_trace(160, 24, seed=3)
    kinds, sids = trace.kinds.tolist(), trace.seq_ids.tolist()

    def drive(pool, lo, hi, rec):
        for k, s in zip(kinds[lo:hi], sids[lo:hi]):
            if k == twl.KV_CREATE:
                pool.create(s)
            elif k == twl.KV_RELEASE:
                pool.release(s)
            else:
                rec.append(bool(pool.lookup_batch([s])[0]))

    def make():
        return PagedKVPool(96, 8, device=True, index_width=64,
                           index_batch=16, audit_every=4)

    ref, pool = make(), make()
    want, got = [], []
    drive(ref, 0, 160, want)
    cut = 80
    drive(pool, 0, cut, got)
    while not pool._pending:
        drive(pool, cut, cut + 1, got)
        cut += 1
    mgr = CheckpointManager(str(tmp_path))
    snap.save_serving_snapshot(mgr, cut, pool)
    back, _, summary = snap.restore_serving_snapshot(mgr)
    assert back._st.key.is_cuda and back._plane.keys.is_cuda
    assert f"{len(pool._pending)} pending ops" in summary
    tops.reset_launch_counts()
    drive(back, cut, 160, got)
    counts = tops.launch_counts()
    assert got == want
    assert back.chains == ref.chains and back.free == ref.free
    assert back.stats == ref.stats
    assert counts["splay_fold"] > 0
    assert counts["splay_search_tiered"] + \
        counts["splay_search_pipelined"] > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_train_step_on_card_matches_cpu(arch):
    """One ``make_train_step`` step of a smoke architecture on the card
    against the CPU from the same parameters and batch, through the
    smoke run's phase-5f check (``card_checks.train_step_check``): loss,
    grad_norm and every gradient leaf allclose (rtol 1e-4, atol 1e-5),
    a miss settled by the CPU's float64 run (the card no more than
    twice as far from it as the CPU's float32); the updated
    parameters' largest relative difference finite."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo as zoo
    cc = _card_checks()
    cfg = registry.get_smoke(arch)
    agree = cc.Agreement(torch, arch)
    share, leaf = cc.train_step_check(
        torch, cfg, zoo.build_params(cfg, seed=0, device="cpu"),
        cc.train_batch(cfg, np.random.default_rng(17), 2, 16), "cuda",
        agree)
    assert all(e_card <= 2 * e_cpu
               for _, _, e_card, e_cpu in agree.witnessed)
    assert np.isfinite(share), leaf


def _sharded_rank(mesh, seed):
    """One rank of the 2-rank gloo group on the card: the sharded
    searches against the replicated one, and B2 on this rank's local
    sub-plane against its plain version."""
    from repro_torch.parallel import sharding as tshd
    plane, qs = _plane(4096, 12, 1001, seed=seed, device=mesh.device)
    ps = tshd.shard_index_plane(plane, mesh)
    want = tssk.splay_search(plane, qs, sharded=False)
    tops.reset_launch_counts()
    routed = tssk.splay_search_sharded(ps, qs, mesh=mesh, return_stats=True)
    masked = tssk.splay_search_sharded(ps, qs, mesh=mesh, routed=False,
                                       return_stats=True)
    launches = tops.launch_counts()["splay_search_pipelined"]
    local, _ = tssk._local_subplane(ps)
    card = tssk._splay_search_pipelined_arrays(
        local.keys, qs, rank_map=local.rank_map, widths=local.widths,
        bot_rank=local.bot_rank)
    plain = tssk._splay_search_pipelined_arrays(
        *(t.cpu() for t in (local.keys, qs)), rank_map=local.rank_map.cpu(),
        widths=local.widths.cpu(), bot_rank=local.bot_rank.cpu())
    same = lambda a, b: all(torch.equal(x.cpu(), y.cpu())  # noqa: E731
                            for x, y in zip(a, b))
    return {"routed": same(routed[:3], want), "masked": same(masked, want),
            "b2_local": same(card, plain), "launches": launches,
            "occupancy": routed[3].occupancy.tolist(),
            "device": str(local.keys.device)}


def test_sharded_search_on_two_card_ranks():
    """Two gloo ranks on the one card (``launch.spmd``): the routed and
    the masked sharded search equal the replicated search, each rank's
    B2 launches and equals its plain version on its local
    ``[L, W/2]`` sub-plane (the byte counter included)."""
    from repro_torch.launch import spmd
    out = spmd.spawn(_sharded_rank, 2, 3, backend="gloo", device="cuda",
                     timeout=600)
    for r in out:
        assert r["routed"] and r["masked"] and r["b2_local"], r
        assert r["launches"] > 0 and r["device"].startswith("cuda"), r
        assert sum(r["occupancy"]) == 1001 + 3, r
