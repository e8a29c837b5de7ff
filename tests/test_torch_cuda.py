"""PyTorch port on the card: each CUDA kernel (B1 tiered search, B2
pipelined search, B5 full-width search, F update fold, B3/B4 row
gathers and the fused two-tier gather) held against its plain PyTorch
version on the same inputs, bit-exact (W, the state walk of both
engines, too), and the epoch loop and the vocab
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
the bare matrix) have cases of their own, and so do S on the streams
of ``skip_streams.py`` at max levels 1 to 64, W's refusal of a
``POS_INF_32`` key inside a batch and ``find_batch``'s one wait on the
card.  Needs an NVIDIA GPU and
nvcc; skips without a card.  Imports no JAX (the card's machine has
none): run it with ``--noconftest``, as the README says."""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import device_index as tdix
from repro_torch.core import splay_cache as tsc
from repro_torch.core import skiplist as tskx
from repro_torch.core import splaylist as tsx
from repro_torch.core import workload as twl
from repro_torch.kernels import fold
from repro_torch.kernels import hot_gather as thg
from repro_torch.kernels import skip_fold
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splay_search as tssk
from repro_torch.kernels import state_walk
from skip_streams import FINGER_SHAPES, FINGER_STREAMS

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


@pytest.fixture
def _tracing():
    from repro_torch.core import trace
    trace.enable(True)
    trace.reset_counts()
    yield trace
    trace.enable(False)
    trace.reset_counts()


def _walk_counts(trace):
    c = trace.counts()
    return c.get("fold.walks", 0), c.get("fold.steps", 0)


@pytest.mark.parametrize("path", ["weighted", "ops"])
def test_fold_counts_walks_and_steps_as_plain(path, _tracing):
    """While tracing is on, F and the plain fold count the same walks
    (entries visited, ops run) and steps, on a weighted list and on an
    op list of all five kinds with a rebuild stop inside it."""
    if path == "weighted":
        st, pool, rng = _prefilled(torch.int32)
        n = 3000
        keys = torch.as_tensor(rng.choice(pool, n), device="cuda")
        w = torch.as_tensor(np.where(rng.random(n) < 0.1,
                                     rng.integers(1, 4, n), 0),
                            device="cuda").to(torch.int32)
        wm = torch.zeros_like(w)
        card, cpu = tsx.clone(st), _cpu(st)
        _tracing.reset_counts()
        fold.fold_weighted(card, keys, w, wm)
        got = _walk_counts(_tracing)
        _tracing.reset_counts()
        fold.fold_weighted(cpu, keys.cpu(), w.cpu(), wm.cpu())
        assert got == _walk_counts(_tracing)
        assert got[0] == int((w > 0).sum())
        _equal(card, cpu)
        return
    rng = np.random.default_rng(4)
    pool = rng.permutation(3000)[:700].astype(np.int32)
    n = 1500
    kinds = np.concatenate([np.full(700, 1, np.int32),
                            rng.choice(5, n - 700,
                                       p=[0.1, 0.05, 0.55, 0.15, 0.15])])
    keys = np.concatenate([pool, rng.choice(pool, n - 700)]).astype(np.int32)
    upd = rng.random(n) < 0.6
    st0 = tsx.make(1024, 16, device="cuda")
    before = fold.LAUNCHES["splay_fold"]
    g = tsx.run_ops(st0, kinds, keys, upd)
    assert fold.LAUNCHES["splay_fold"] > before + 1     # a rebuild stop
    got = _walk_counts(_tracing)
    _tracing.reset_counts()
    _equal(g, tsx.run_ops(_cpu(st0), kinds, keys, upd))
    assert got == _walk_counts(_tracing) and got[0] == n


# host waits of one serving batch on the card, by site: the read path
# (plane search, state walk, weighted fold, a height-only refresh) and
# the op-list path (inserts merged by the refresh)
CARD_WAITS = {
    "read": {"plane.live": 1, "plane.gap": 1, "search.live": 1,
             "search.gap": 1, "walk.status": 1, "rebuild.m": 1,
             "rebuild.dhits": 1, "refresh.stale": 1, "refresh.new": 1,
             "refresh.old": 1, "refresh.width": 1, "refresh.overflow": 1,
             "serving.overflow": 1, "serving.size": 1},
    "ops": {"plane.live": 1, "plane.gap": 1, "run_ops.kinds": 1,
            "fold.status": 1, "refresh.stale": 1, "refresh.new": 1,
            "refresh.old": 1, "refresh.overflow": 1, "serving.overflow": 1,
            "serving.size": 1}}


@pytest.mark.parametrize("path", ["read", "ops"])
def test_serving_waits_and_launches_with_tracing_on_and_off(path):
    """One ``run_serving`` batch on the card makes the same waits (the
    table above) and the same launches with tracing on as off."""
    from repro_torch.core import trace
    st, pool, rng = _prefilled(torch.int32, n_keys=2000, cap=4096)
    plane = tdix.from_state_device(st, n_levels=16, width=4096)
    B = 512
    keys = torch.as_tensor(rng.choice(pool, B).astype(np.int32)[None],
                           device="cuda")
    kinds = torch.zeros((1, B), dtype=torch.int32, device="cuda")
    if path == "ops":
        kinds[0, :8] = 1
        keys[0, :8] = torch.arange(8000, 8008, dtype=torch.int32)
    upd = torch.as_tensor(rng.random((1, B)) < 0.3, device="cuda")
    seen = []
    try:
        for on in (False, True):
            trace.enable(on)
            tsx.run_serving(st, plane, kinds, keys, upd,
                            aggregate=path == "read",
                            plane_search=path == "read")    # warm
            trace.reset_counts()
            tsx.run_serving(st, plane, kinds, keys, upd,
                            aggregate=path == "read",
                            plane_search=path == "read")
            c = trace.counts()
            seen.append(({k[6:]: v for k, v in c.items()
                          if k.startswith("waits.")},
                         {k: v for k, v in c.items()
                          if k.startswith("launches.")}))
    finally:
        trace.enable(False)
        trace.reset_counts()
    assert seen[0] == seen[1]
    assert seen[0][0] == CARD_WAITS[path]


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


def _skip_cpu(st):
    return tskx.SkipState(*(t.cpu() for t in st))


@pytest.mark.parametrize("max_level", [20, 1, 33, 64])
def test_skip_fold_kernel_matches_plain(max_level):
    """Kernel S against its plain fold: inserts of heights from
    ``sample_heights``, then contains, deletes of present and absent
    keys and revives; every state array, answer and path length, then
    the batched searches on the result."""
    rng = np.random.default_rng(max_level)
    pool = rng.permutation(3000)[:1000].astype(np.int32)
    pool[0] = tskx.NEG_INF_32 + 1
    n = 3000
    kinds = np.concatenate([np.full(1000, 1, np.int32),
                            rng.choice(3, n - 1000, p=[0.4, 0.3, 0.3])])
    keys = np.concatenate([pool, rng.choice(pool, n - 1000)]).astype(
        np.int32)
    keys[-50:] = rng.integers(5000, 6000, 50)
    heights = tskx.sample_heights(np.random.default_rng(0), n, max_level,
                                  device="cpu").numpy()
    st0 = tskx.make(1200, max_level, device="cuda")
    before = skip_fold.LAUNCHES["skip_fold"]
    g = tskx.run_ops(st0, kinds, keys, heights)
    assert skip_fold.LAUNCHES["skip_fold"] == before + 1
    w = tskx.run_ops(_skip_cpu(st0), kinds, keys, heights)
    _equal(g, w)
    qs = np.concatenate([rng.choice(pool, 500), rng.integers(-9, 7000, 100)
                         ]).astype(np.int32)
    _equal(tskx.run_contains_batch(g[0], qs)[1:],
           tskx.run_contains_batch(_skip_cpu(g[0]), qs)[1:])


FINGER_CASES = [(name, ml) for name in sorted(FINGER_STREAMS)
                for ml in (1, 20, 33, 64)
                if FINGER_SHAPES[name](ml)[1] == ml]


@pytest.mark.parametrize("name,max_level", FINGER_CASES)
def test_skip_fold_finger_streams_match_plain(name, max_level):
    """Kernel S against its plain fold on the streams that exercise its
    fingers (ascending, descending and interleaved inserts, revives,
    duplicates, a capacity stop with every finger set): every state
    array, answer and path length, and the stop."""
    kinds, keys = FINGER_STREAMS[name]()
    cap, ml = FINGER_SHAPES[name](max_level)
    heights = tskx.sample_heights(np.random.default_rng(len(name)),
                                  kinds.shape[0], ml, device="cpu").numpy()
    n = kinds.shape[0]
    st0 = tskx.make(cap, ml, device="cuda")
    args = [torch.as_tensor(x, dtype=torch.int32, device="cuda")
            for x in (kinds, keys, heights)]
    got = (tskx.clone(st0), torch.zeros(n, dtype=torch.bool, device="cuda"),
           torch.full((n,), -7, dtype=torch.int32, device="cuda"))
    want = (tskx.clone(_skip_cpu(st0)), torch.zeros(n, dtype=torch.bool),
            torch.full((n,), -7, dtype=torch.int32))
    before = skip_fold.LAUNCHES["skip_fold"]
    stop = skip_fold.fold_ops(got[0], *args, *got[1:])
    assert skip_fold.LAUNCHES["skip_fold"] == before + 1
    assert skip_fold.fold_ops(want[0], *(a.cpu() for a in args),
                              *want[1:]) == stop
    assert (stop < n) == (name == "fingers-capacity-stop")
    _equal(got[0], want[0])
    # the kernel writes the answers of the ops before the stop only (the
    # plain fold writes the whole list, zeros after the stop)
    _equal((got[1][:stop], got[2][:stop]), (want[1][:stop], want[2][:stop]))
    assert bool((got[2][stop:] == -7).all())


def test_skip_fold_capacity_exhausted():
    """An insert past the capacity stops the launch before it writes
    that op: the wrapper reports its index, run_ops raises, and the
    caller's state is untouched."""
    st = tskx.make(4, 4, device="cuda")
    kinds, keys, hts = ([1, 1, 1, 0, 0], [10, 20, 30, 30, 20],
                        [0, 1, 0, 0, 0])
    with pytest.raises(RuntimeError, match="capacity 4 exhausted at op 2"):
        tskx.run_ops(st, kinds, keys, hts)
    assert int(st.n_alloc) == 2 and bool((st.nxt[:, 2:] == -1).all())
    work = tskx.clone(st)
    args = [torch.as_tensor(x, dtype=torch.int32, device="cuda")
            for x in (kinds, keys, hts)]
    res = torch.zeros(5, dtype=torch.bool, device="cuda")
    plen = torch.full((5,), -7, dtype=torch.int32, device="cuda")
    assert skip_fold.fold_ops(work, *args, res, plen) == 2
    assert plen.tolist() == [0, 0, -7, -7, -7]
    want = tskx.clone(_skip_cpu(st))
    assert skip_fold.fold_ops(want, *(a.cpu() for a in args),
                              torch.zeros(5, dtype=torch.bool),
                              torch.zeros(5, dtype=torch.int32)) == 2
    _equal(work, want)


def test_concurrent_scaling_on_card_matches_cpu():
    """Figs. 3-5 at a small size on the card and on the CPU: the same
    per-batch path sums for both engines, every answer True, F and S
    launched on the card's populates and F once a splay batch."""
    from repro_torch.benchmarks import concurrent_scaling as tcs
    g = tcs.run(n=1000, total_ops=1024, device="cuda")
    w = tcs.run(n=1000, total_ops=1024, device="cpu")
    for key, r in g.items():
        if key[1] == "populate":
            assert r["launches"] == {"splay_fold": 1, "skip_fold": 1,
                                     "splay_walk": 0, "skip_walk": 0}
            continue
        assert r["batch_psums"] == w[key]["batch_psums"], key
        assert r["all_found"], key
        if key[1] == "splay":
            assert r["launches"]["splay_fold"] == 1024 // key[2], key
        walk = "splay_walk" if key[1] == "splay" else "skip_walk"
        assert r["launches"][walk] == 1024 // key[2], key


def _walk_states(n_keys, seed):
    """A splay and a skip state of ``n_keys`` keys built on the card by
    F and S, a tenth of them deleted (marked); the splay state also
    takes two contains batches with update coins."""
    rng = np.random.default_rng(seed)
    pool = np.sort(rng.choice(4 * n_keys, n_keys, replace=False)).astype(
        np.int32)
    cap = n_keys + 4
    ins = np.full(n_keys, 1, np.int32)
    gone = rng.choice(pool, n_keys // 10, replace=False)
    dels = np.full(len(gone), 2, np.int32)
    sp = tsx.make(cap, 20, device="cuda")
    sp, _, _ = tsx.run_ops(sp, ins, pool, np.ones(n_keys, bool))
    sp, _, _ = tsx.run_ops(sp, dels, gone, np.zeros(len(gone), bool))
    for _ in range(2):
        live = rng.choice(np.setdiff1d(pool, gone), 1024)
        sp, _, _ = tsx.run_contains_batch(sp, live, rng.random(1024) < 0.5,
                                          aggregate=True)
    hts = tskx.sample_heights(rng, n_keys, 20, device="cpu").numpy()
    sk = tskx.make(cap, 20, device="cuda")
    sk, _, _ = tskx.run_ops(sk, ins, pool, hts)
    sk, _, _ = tskx.run_ops(sk, dels, gone, np.zeros(len(gone), np.int32))
    return sp, sk, pool


@pytest.mark.parametrize("n_keys,nq", [(1000, 333), (20000, 1024),
                                       (100000, 4096)])
def test_state_walk_kernel_matches_plain(n_keys, nq):
    """Kernel W against its plain loop on the card and on the CPU, for
    both engines: present, absent, negative and NEG_INF_32 keys; one
    launch a batch, none for an empty batch; the POS_INF_32 refusal, one
    launch that refuses the batch in its status word."""
    sp, sk, pool = _walk_states(n_keys, n_keys)
    rng = np.random.default_rng(nq)
    eighth = nq // 8
    qs = np.concatenate([
        rng.choice(pool, nq - 2 * eighth - 3),
        rng.integers(0, 4 * n_keys, eighth),
        rng.integers(-10 ** 6, 0, eighth),
        [tsx.NEG_INF_32, tsx.NEG_INF_32 + 1, tsx.POS_INF_32 - 1]]).astype(
        np.int32)
    assert qs.shape[0] == nq
    q = torch.as_tensor(qs, device="cuda")
    assert int(sp.zl) > 0 and bool(sp.deleted.any())
    for st, name, mod, plain in (
            (sp, "splay_walk", tsx, state_walk.splay_walk_plain),
            (sk, "skip_walk", tskx, state_walk.skip_walk_plain)):
        before = state_walk.LAUNCHES[name]
        got = mod.find_batch(st, q)
        assert state_walk.LAUNCHES[name] == before + 1
        _equal(got, plain(st, q))
        cpu_st = type(st)(*(t.cpu() for t in st))
        _equal(got, plain(cpu_st, q.cpu()))
        slot, steps = mod.find_batch(st, q[:0])
        assert slot.shape == (0,) and steps.shape == (0,)
        assert state_walk.LAUNCHES[name] == before + 1
        with pytest.raises(ValueError, match="POS_INF_32"):
            mod.find_batch(st, [3, tsx.POS_INF_32])
        # the kernel refuses the key itself: it launches once more
        assert state_walk.LAUNCHES[name] == before + 2


@pytest.mark.parametrize("engine", ["splay", "skip"])
def test_state_walk_step_bound_on_card(engine):
    """A hand-made cycle through the head: the kernel stops every lane
    at C + L + 1 steps and the wrapper raises, as the plain loop does;
    a key that descends before the cycle still walks."""
    mod = tsx if engine == "splay" else tskx
    st = mod.make(8, 4, device="cuda")
    if engine == "splay":
        st.nzero[2] = 0
        st.top[2] = 3
    st.key[2] = 5
    st.nxt[:, 0] = 2
    st.nxt[:, 2] = 0
    with pytest.raises(RuntimeError, match="step bound"):
        mod.find_batch(st, [3, 10])
    torch.cuda.synchronize()
    plain = (state_walk.splay_walk_plain if engine == "splay"
             else state_walk.skip_walk_plain)
    q = torch.as_tensor([3], dtype=torch.int32, device="cuda")
    _equal(mod.find_batch(st, q), plain(st, q))


@pytest.mark.parametrize("engine", ["splay", "skip"])
def test_state_walk_refusal_on_card(engine):
    """A POS_INF_32 key first, last or among 4096 keys: W launches,
    refuses the batch in its status word, and find_batch raises
    ValueError; the state is as it was."""
    sp, sk, pool = _walk_states(20000, 7)
    st, mod = (sp, tsx) if engine == "splay" else (sk, tskx)
    rng = np.random.default_rng(8)
    before = [t.clone() for t in st]
    for at in (0, 4095, 1777):
        q = rng.choice(pool, 4096).astype(np.int32)
        q[at] = tsx.POS_INF_32
        q = torch.as_tensor(q, device="cuda")
        with pytest.raises(ValueError, match="POS_INF_32"):
            mod.find_batch(st, q)
        assert all(torch.equal(a, b) for a, b in zip(before, st))
    q[1777] = tsx.POS_INF_32 - 1
    plain = (state_walk.splay_walk_plain if engine == "splay"
             else state_walk.skip_walk_plain)
    _equal(mod.find_batch(st, q), plain(st, q))


def test_find_batch_synchronises_once():
    """A find_batch call on CUDA tensors waits on the card once: the
    read of W's status word (no host check of the keys)."""
    sp, sk, pool = _walk_states(1000, 9)
    q = torch.as_tensor(pool[::3], device="cuda")
    for st, mod in ((sp, tsx), (sk, tskx)):
        mod.find_batch(st, q)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                mod.find_batch(st, q)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in caught]


@pytest.mark.parametrize("engine", ["splay", "skip"])
def test_state_walk_drops_bad_speculative_links(engine):
    """Every link of the slot holding 30 lies outside [-C, C).  A walk
    that stops before 30 loads such a link ahead of its branch and drops
    it: no status, the plain loop's answers.  A walk that passes 30
    takes one and raises."""
    mod = tsx if engine == "splay" else tskx
    st = mod.make(16, 4, device="cuda")
    third = [True] * 3 if engine == "splay" else [0, 1, 0]
    st, _, _ = mod.run_ops(st, [1, 1, 1], [10, 20, 30], third)
    st.nxt[:, int((st.key == 30).nonzero()[0])] = 10 * 16
    q = torch.as_tensor([25, 5, 15, 20, 29], dtype=torch.int32,
                        device="cuda")
    plain = (state_walk.splay_walk_plain if engine == "splay"
             else state_walk.skip_walk_plain)
    _equal(mod.find_batch(st, q), plain(st, q))
    with pytest.raises(RuntimeError, match="slot index outside"):
        mod.find_batch(st, [35])


def _model_mesh_rank(mesh, params_np, toks):
    """One rank of a 2-rank gloo group on the card: ``ppermute`` by a
    ring, a partial permutation and on bfloat16; then the minitron-8b
    smoke model (float32, at trained scale) laid out over the two ranks
    (whole heads, a split cache): ``forward`` and three decode steps,
    the logits gathered whole, and the greedy ids."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.models import layers as tly
    from repro_torch.models import model_zoo as tzoo
    from repro_torch.parallel import collectives as tcl
    from repro_torch.parallel import sharding as tshd
    from repro_torch.serve import serve_step as tss
    dev = mesh.device
    me = mesh.coords["model"]
    v = torch.full((5,), float(me + 1), device=dev)
    out = {"device": str(dev),
           "ring": tcl.ppermute(v, mesh, "model", [(0, 1), (1, 0)]).tolist(),
           "partial": tcl.ppermute(v, mesh, "model", [(0, 1)]).tolist(),
           "bf16": tcl.ppermute((v + 0.5).bfloat16(), mesh, "model",
                                [(0, 1), (1, 0)]).float().tolist()}
    cfg = registry.get_smoke("minitron-8b")
    params = convert.params_from_numpy(params_np, device=dev)
    _, axes = tzoo.param_axes(cfg)
    specs = tly.axes_to_specs(params, axes, mesh, tshd.default_rules())
    tree = tshd.lay_out(params, specs, mesh)
    whole = (None, None, "model")
    t = torch.as_tensor(toks, device=dev)
    out["fwd"] = tshd.relayout(tzoo.forward(tree, cfg, t), whole, (),
                               mesh).cpu().numpy()
    cache = tzoo.init_cache(cfg, t.shape[0], 8, dev, mesh=mesh)
    out["cache_kv_heads"] = int(cache["k"].shape[3])
    out["dec"] = []
    for i in range(3):
        logits, cache = tzoo.decode_step(tree, cfg, t[:, i:i + 1], cache, i)
        out["dec"].append(tshd.relayout(logits, whole, (), mesh).cpu()
                          .numpy())
    last, _, _ = tss.prefill_loop(
        tss.make_decode_step(cfg), tree, toks[:, :3],
        tzoo.init_cache(cfg, t.shape[0], 8, dev, mesh=mesh))
    out["greedy"] = last[:, 0].tolist()
    return out


def test_sharded_model_and_ppermute_on_two_card_ranks():
    """Two gloo ranks on the one card: ``ppermute`` moves CUDA tensors
    (an all-to-all with split sizes, never a point-to-point call), and
    the minitron-8b smoke model laid out over the ranks gives the
    forward's and three decode steps' logits and the greedy ids of its
    CPU run (meshless, the same parameters at trained scale; rtol 1e-4,
    atol 1e-5)."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.launch import spmd
    from repro_torch.models import model_zoo as tzoo
    from repro_torch.serve import serve_step as tss
    cc = _card_checks()
    cfg = registry.get_smoke("minitron-8b")
    p_cpu = cc.trained_scale(tzoo.build_params(cfg, seed=5, device="cpu"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 6))
    out = spmd.spawn(_model_mesh_rank, 2, convert.params_to_numpy(p_cpu),
                     toks, backend="gloo", device="cuda", timeout=600)
    t = torch.as_tensor(toks)
    fwd = tzoo.forward(p_cpu, cfg, t).numpy()
    cache = tzoo.init_cache(cfg, 2, 8, "cpu")
    dec = []
    for i in range(3):
        logits, cache = tzoo.decode_step(p_cpu, cfg, t[:, i:i + 1], cache, i)
        dec.append(logits.numpy())
    last, _, _ = tss.prefill_loop(tss.make_decode_step(cfg), p_cpu,
                                  toks[:, :3], tzoo.init_cache(cfg, 2, 8,
                                                               "cpu"))
    for r, o in enumerate(out):
        assert o["device"].startswith("cuda")
        assert o["ring"] == [float(2 - r)] * 5
        assert o["partial"] == [float(r)] * 5      # rank 1 gets rank 0's 1
        assert o["bf16"] == [2.5 - r] * 5
        assert o["cache_kv_heads"] == 1
        np.testing.assert_allclose(o["fwd"], fwd, rtol=1e-4, atol=1e-5)
        for got, want in zip(o["dec"], dec):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert o["greedy"] == last[:, 0].tolist()


def _moe_mesh_rank(mesh, params_np, toks, x):
    """One rank of a 2-rank gloo group on the card: the phi3.5-moe smoke
    model (float32, trained scale) laid out over the two ranks (2
    experts a rank): its first MoE layer alone on ``x`` with its
    routing, ``forward`` and three decode steps, the logits gathered
    whole."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.models import layers as tly
    from repro_torch.models import model_zoo as tzoo
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import sharding as tshd
    dev = mesh.device
    cfg = registry.get_smoke("phi3.5-moe-42b-a6.6b")
    params = convert.params_from_numpy(params_np, device=dev)
    _, axes = tzoo.param_axes(cfg)
    rules = tshd.default_rules()
    tree = tshd.lay_out(params, tly.axes_to_specs(params, axes, mesh,
                                                  rules), mesh, rules)
    lp = tzoo._layer(tree, tzoo._layer_keys(tree, cfg), 0)
    xt = torch.as_tensor(x, device=dev)
    with tshd.use_mesh(mesh, rules):
        y = tmoe.moe_block(xt, lp, cfg, torch.float32)
        plan = tmoe.route(xt, lp, cfg, torch.float32)
    out = {"device": str(dev), "experts": int(lp["w_gate"].shape[0]),
           "y": y.cpu().numpy(), "top_e": plan.top_e.cpu().numpy(),
           "keep": plan.keep.cpu().numpy()}
    whole = (None, None, "model")
    t = torch.as_tensor(toks, device=dev)
    out["fwd"] = tshd.relayout(tzoo.forward(tree, cfg, t), whole, (),
                               mesh).cpu().numpy()
    cache = tzoo.init_cache(cfg, t.shape[0], 8, dev, mesh=mesh)
    out["dec"] = []
    for i in range(3):
        logits, cache = tzoo.decode_step(tree, cfg, t[:, i:i + 1], cache, i)
        out["dec"].append(tshd.relayout(logits, whole, (), mesh).cpu()
                          .numpy())
    return out


def test_laid_out_moe_on_two_card_ranks():
    """Two gloo ranks on the one card: the phi3.5-moe smoke model laid
    out with 2 experts a rank.  Its first MoE layer alone routes and
    keeps exactly as its CPU run (meshless, the same parameters at
    trained scale) and gives its output; ``forward`` and three decode
    steps give the CPU run's logits (rtol 1e-4, atol 1e-5)."""
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.launch import spmd
    from repro_torch.models import model_zoo as tzoo
    from repro_torch.models import moe as tmoe
    cc = _card_checks()
    cfg = registry.get_smoke("phi3.5-moe-42b-a6.6b")
    p_cpu = cc.trained_scale(tzoo.build_params(cfg, seed=5, device="cpu"))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 6))
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    out = spmd.spawn(_moe_mesh_rank, 2, convert.params_to_numpy(p_cpu),
                     toks, x, backend="gloo", device="cuda", timeout=600)
    lp = tzoo._layer(p_cpu, tzoo._layer_keys(p_cpu, cfg), 0)
    xt = torch.as_tensor(x)
    y = tmoe.moe_block(xt, lp, cfg, torch.float32).numpy()
    plan = tmoe.route(xt, lp, cfg, torch.float32)
    t = torch.as_tensor(toks)
    fwd = tzoo.forward(p_cpu, cfg, t).numpy()
    cache = tzoo.init_cache(cfg, 2, 8, "cpu")
    dec = []
    for i in range(3):
        logits, cache = tzoo.decode_step(p_cpu, cfg, t[:, i:i + 1], cache, i)
        dec.append(logits.numpy())
    for o in out:
        assert o["device"].startswith("cuda") and o["experts"] == 2
        np.testing.assert_array_equal(o["top_e"], plan.top_e.numpy())
        np.testing.assert_array_equal(o["keep"], plan.keep.numpy())
        np.testing.assert_allclose(o["y"], y, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["fwd"], fwd, rtol=1e-4, atol=1e-5)
        for got, want in zip(o["dec"], dec):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_phase14_at_smoke_size():
    """``chip_smoke.py``'s phase 14 with the smoke variants of its four
    models in bf16 (phi3.5-moe, zamba2-7b, whisper-large-v3,
    paligemma-3b) on 4 gloo ranks of the card: phi's host tree and
    digests, its sharded step under the float32 witness on 1 x 4 and
    2 x 2, ``Engine(mesh=...)`` equal to the meshless engine with B2, F
    and W launched on every rank, and the other families' prefill and
    decode step under the witness (a failed check exits nonzero)."""
    import dataclasses
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import registry
    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    phi = dataclasses.replace(registry.get_smoke("phi3.5-moe-42b-a6.6b"),
                              **bf)
    others = {a: dataclasses.replace(registry.get_smoke(a), **bf)
              for a in chip_smoke.FAMILY_ARCHS}
    dev = torch.device("cuda")
    job = chip_smoke.family_job(torch, dev, phi, others, "test")
    by_rank = chip_smoke.family_phase(torch, dev, job, "gloo")
    assert all(n > 0 for n in by_rank["splay_fold"].values())
    assert not (Path(chip_smoke.HERE) / "build" /
                chip_smoke.FAMILY_DIR).exists()


TWIN_MAINS = {
    "sharded_refresh_probe": ["--bench", "--width", "512"],
    "sharded_search_probe": ["--bench", "--routed", "--width", "1024",
                             "--nq", "1024"],
    "ordered_search_probe": ["--bench", "--width", "1024", "--nq", "1024"],
    "chaos_probe": ["--bench"],
    "serving_probe": ["--bench", "--requests", "4"],
}


@pytest.mark.parametrize("name", sorted(TWIN_MAINS))
def test_benchmark_twin_main_on_card_matches_cpu(name):
    """Each probe twin's ``main`` at small shapes on 4 gloo ranks of the
    card: every column but the timing ones equals its run on 4 CPU
    ranks (the probe's inline assertions hold on both)."""
    import importlib

    from repro_torch.benchmarks.kernels_bench import deterministic
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    card = mod.main(TWIN_MAINS[name])
    cpu = mod.main(TWIN_MAINS[name] + ["--device", "cpu"])
    if name == "serving_probe":
        card, cpu = card["bench"], cpu["bench"]
        assert card["parity_bit_identical"] is True
    assert card.get("exec_mode", "cuda-kernels") == "cuda-kernels"
    assert deterministic(card) == deterministic(cpu)


def test_kernels_bench_races_on_card_match_cpu():
    """The kernel races of ``kernels_bench`` (B1 against B5, B2 against
    B1 with its byte counter, the aggregation, the refresh paths) at
    the quick profile's widths, on the card against the CPU: each race
    asserts its outputs equal inline, and their deterministic columns
    agree."""
    from repro_torch.benchmarks import kernels_bench as kb
    for dev in ("cuda", "cpu"):
        tops.reset_launch_counts()
        rows, L = kb._zipf_races(4096, 1024, 256, 1, dev)
        got = {"zipf": rows, "bytes": kb._bytes_model(L, 256, 1024),
               "agg": kb._aggregation_case(True, device=dev),
               "refresh": [kb._refresh_case(4096, c, 4, 1, device=dev)
                           for c in (64, 0)],
               "pipe": kb._pipelined_case(4096, 1024, 256, 1, device=dev)}
        counts = tops.launch_counts()
        if dev == "cuda":
            card = got
            for k in ("splay_search_tiered", "splay_search_full",
                      "splay_search_pipelined", "splay_fold", "splay_walk"):
                assert counts[k] > 0, k
    assert kb.deterministic(card) == kb.deterministic(got)
