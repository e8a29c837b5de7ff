"""Batched splay-list search over the level-array plane: the twin of
``repro.kernels.splay_search``.

Each splay level is a dense sorted row; a query descends rows top-down
(row 0 = hottest), searching the rank window its predecessor in the row
above bounds (rows are nested).  Two descents compute the same
``(found, rank, level_found)`` triple on one CUDA kernel, the descent
engine (``csrc/splay_search.cu``), each beside its plain PyTorch
version:

* tiered (B1): one thread per query, every row, every query —
  :func:`splay_search_tiered_plain`;
* pipelined (B2): query blocks whose lanes each stop once resolved (a
  hit answered through ``bot_rank``, or a width-1 bottom-row
  projection), plus the reference's per-block issue-time byte counter
  of its ``gcd(W, 256)``-lane tile fetches, rebuilt from per-row unions
  of the unresolved lanes' windows — :func:`splay_search_pipelined_plain`.
  Widths whose tile count exceeds 64 take the tiered descent and report
  its whole-row byte model, exactly as the reference does.

Within a row a lane reads its window's few candidates at once, with the
rank-map entries its predecessor and successor can take, so a row is
one dependent trip (wide windows first narrow ``_FAN``-ary).  On sorted
rows the count of candidates ``<= q`` is the reference's binary-search
predecessor, so the answers are the reference's.

A third, the seed baseline (B5), counts ``row <= q`` across every row's
full width instead of descending — :func:`splay_search_full_plain`.
Its kernel spreads the width over a thread-block cluster
(:func:`full_plan`) and counts every row; the plain version keeps the
reference's per-block row skip, which changes the work, not the
answers.

The ordered operations (rank, predecessor, successor, select, range
count, range scan, top-k) are one descent each plus plain torch
gathers of the packed bottom row.

Width-sharded (:func:`splay_search_sharded`, one rank per shard of a
``parallel.sharding.Mesh``): each shard owns the key range of its plane
block and descends its local ``[L, W/S]`` sub-plane with B1 or B2; the
queries reach their owners through one all-to-all (the routed
exchange, sized by ``route_capacity``) or every shard descends them all
and a masked sum composes the answers.  A laid-out plane dispatches
there from :func:`splay_search` and the ordered ops.

The internal entry points pick by the tensors' device: CUDA tensors
launch the kernel, CPU tensors run the plain version.  ``splay_search``
with ``pipelined=None`` takes the pipelined descent on CUDA tensors and
the plain tiered one on CPU tensors, as the reference takes the
pipelined kernel exactly when it compiles.  Queries of any length are
padded to the query-block multiple with ``PAD_KEY - 1`` and sliced
back.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.parallel import collectives as cl
from repro_torch.parallel import sharding as shd

PAD_KEY = 2 ** 31 - 1
NEG_INF_KEY = -(2 ** 31) + 1        # splaylist.NEG_INF_32 (head sentinel)
DEFAULT_QUERY_BLOCK = 256

# Tile length of the pipelined fetches: the largest divisor of the width
# that is <= 256.  Widths with more tiles than this take the tiered
# descent (the reference's rule, kept with its byte model).
_MAX_PIPE_TILES = 64

# The descent engine (B1 and B2): a narrowing trip reads _FAN - 1 pivots
# at once; a window of at most _LAST candidates takes one last trip that
# reads them with the rank-map (and B2's bot-rank) entries p and p + 1
# can take.  B1 runs _TIERED_BLOCK queries a block.
_FAN, _LAST = 4, 3
_TIERED_BLOCK = 64
# B2 runs a query block on a cluster of CTAs of at least this many
# threads (at most 8 CTAs, the portable cluster size)
_PIPE_CTA = 64

# launches of the CUDA kernels (plain CPU runs do not count)
LAUNCHES = {"splay_search_tiered": 0, "splay_search_pipelined": 0,
            "splay_search_full": 0}


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def rank_windows(level_keys: torch.Tensor) -> torch.Tensor:
    """rank_map[r, j] = index of level_keys[r, j] in row r+1 (identity
    on the bottom row; pad entries map to the next row's live width)."""
    n_levels, width = level_keys.shape
    ident = torch.arange(width, dtype=torch.int32,
                         device=level_keys.device)[None, :]
    if n_levels == 1:
        return ident
    rm = torch.searchsorted(level_keys[1:].contiguous(),
                            level_keys[:-1].contiguous(), out_int32=True)
    return torch.cat([rm, ident], 0)


def row_widths(level_keys: torch.Tensor) -> torch.Tensor:
    """Live entries per row (rows are +INF padded)."""
    return (level_keys != PAD_KEY).sum(1).to(torch.int32)


def bottom_ranks(level_keys: torch.Tensor) -> torch.Tensor:
    """bot_rank[r, j] = index of level_keys[r, j] in the bottom row —
    the pipelined descent's hit short-circuit companion (identity on
    the bottom row; assumes a packed sorted bottom row)."""
    n_levels, width = level_keys.shape
    ident = torch.arange(width, dtype=torch.int32,
                         device=level_keys.device)[None, :]
    if n_levels == 1:
        return ident
    bottom = level_keys[n_levels - 1].contiguous()
    br = torch.searchsorted(bottom, level_keys[:-1].contiguous(),
                            out_int32=True)
    return torch.cat([br, ident], 0)


def _check_query_block(query_block, nq):
    """The query block must be a positive int: the wrappers pad the
    batch up to its multiple."""
    if not isinstance(query_block, int) or isinstance(query_block, bool):
        raise ValueError(
            f"query_block must be an int, got {type(query_block).__name__}")
    if query_block < 1:
        raise ValueError(f"query_block must be >= 1, got {query_block}")
    padded = nq + ((-nq) % query_block)
    if padded % query_block:            # unreachable by construction
        raise ValueError(
            f"query_block={query_block} does not divide the padded "
            f"batch {padded} (batch {nq})")


def _reject_segmented(level_keys: torch.Tensor) -> None:
    """Refuse a segmented (mass-split) plane: its bottom row has
    interior +INF runs, which break the sorted-row invariant of the
    single-device descent (wrong answers, not slower ones)."""
    live = level_keys[-1] != PAD_KEY
    if bool(live[int(live.sum()):].any()):   # live lanes not a prefix
        raise ValueError(
            "segmented (mass-split) plane on the replicated search "
            "path: interior pad runs break the packed sorted-row "
            "invariant — refresh it with split='lanes' to repack first")


def _fetch_schedule(widths: torch.Tensor, n_levels: int) -> torch.Tensor:
    """fetch[r] = r if row r is live else the next live row below it
    (the reference's row-aliasing schedule; empty rows do no work)."""
    rows = torch.arange(n_levels, dtype=torch.int32, device=widths.device)
    cand = torch.where(widths > 0, rows, n_levels - 1)
    return torch.flip(torch.cummin(torch.flip(cand, (0,)), 0)[0], (0,))


def _pad_queries(queries: torch.Tensor, query_block: int) -> torch.Tensor:
    pad = (-queries.shape[0]) % query_block
    if not pad:
        return queries
    return torch.nn.functional.pad(queries, (0, pad), value=PAD_KEY - 1)


# ---------------------------------------------------------------------------
# B1 and B2: one descent engine (csrc/splay_search.cu descent_kernel)
# ---------------------------------------------------------------------------

def _row_step(row, rm_row, br_row, lo, hi, q, width: int, w_r: int,
              next_w: int, bot_w: int, active):
    """One row of the descent for the ``active`` lanes, as the kernel
    runs it: narrowing trips of ``_FAN - 1`` pivots while the window
    ``(lo, hi)`` holds more than ``_LAST`` candidates, then the count of
    the candidates ``<= q`` (on a sorted row, the binary search's
    predecessor).  Returns ``(p, hit, lo_n, hi_n, bl, bh)``: the
    predecessor, its hit, the next row's window and, given ``br_row``,
    the bottom-row projection ``[bl, bh)`` (int64)."""
    def at(t, j):
        return t[torch.clamp(j, 0, width - 1)].long()

    while True:
        nar = active & (hi - lo - 1 > _LAST)
        if not bool(nar.any()):
            break
        span = hi - lo
        c = sum((at(row, lo + k * span // _FAN) <= q).long()
                for k in range(1, _FAN))
        lo, hi = (torch.where(nar, lo + c * span // _FAN, lo),
                  torch.where(nar, lo + (c + 1) * span // _FAN, hi))
    c = sum(((lo + k < hi) & (at(row, lo + k) <= q)).long()
            for k in range(1, _LAST + 1))
    p = lo + c
    edge = (p + 1 >= width) | (w_r == 0)
    hit = (p >= 0) & (at(row, p) == q)
    lo_n = torch.where(p >= 0, at(rm_row, p), -1)
    hi_n = torch.where(edge, next_w, at(rm_row, p + 1))
    if br_row is None:
        return p, hit, lo_n, hi_n, None, None
    bl = torch.where(p >= 0, at(br_row, p), -1)
    bh = torch.where(edge, bot_w, at(br_row, p + 1))
    return p, hit, lo_n, hi_n, bl, bh


def splay_search_tiered_plain(level_keys, rank_map, widths, queries):
    """Plain version of B1, all queries at once, row by row: every lane
    walks every row (its window's candidates read at once, after
    narrowing trips when it holds more than ``_LAST``); ``level_found``
    is the first row with a hit, the rank the bottom row's ``p``.
    Returns ``(found bool, rank int32, level_found int32)``."""
    n_levels, width = level_keys.shape
    dev = level_keys.device
    w = widths.tolist()
    nq = queries.shape[0]
    q = queries.long()
    lo = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    hi = torch.full((nq,), w[0], dtype=torch.int64, device=dev)
    found = torch.zeros((nq,), dtype=torch.bool, device=dev)
    level = torch.full((nq,), n_levels, dtype=torch.int64, device=dev)
    everyone = torch.ones((nq,), dtype=torch.bool, device=dev)
    for r in range(n_levels):
        p, hit, lo, hi, _, _ = _row_step(
            level_keys[r], rank_map[r], None, lo, hi, q, width, w[r],
            w[min(r + 1, n_levels - 1)], w[-1], everyone)
        level = torch.where(hit & ~found, r, level)
        found = found | hit
    return found, p.to(torch.int32), level.to(torch.int32)


def pipe_cluster(query_block: int) -> int:
    """CTAs of B2's cluster for a query block: the most (8, 4 or 2)
    that split it into CTAs of at least ``_PIPE_CTA`` threads, else 1."""
    for c in (8, 4, 2):
        if query_block % c == 0 and query_block // c >= _PIPE_CTA:
            return c
    return 1


def _descent_kernel(pipelined: bool, level_keys, rank_map, widths,
                    bot_rank, queries, n_live: int, block: int,
                    cluster: int = None):
    """One launch of the descent engine: B1 (``pipelined=False``, one
    thread per query, ``block`` threads a block; ``bot_rank`` unused) or
    B2 (one block per query block of ``block`` lanes, with its byte
    counter)."""
    if block > 1024:
        raise ValueError(f"a block of {block} exceeds the 1024 threads of "
                         "a CUDA block")
    lib = build.load("splay_search")
    fn = lib.splay_descent
    if fn.argtypes is None:   # once per process: a wrapper call is host-bound
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    n_levels, width = level_keys.shape
    nq_p = queries.shape[0]
    n_blocks = -(-nq_p // block)
    dev = level_keys.device
    found = torch.empty((nq_p,), dtype=torch.bool, device=dev)
    rank = torch.empty((nq_p,), dtype=torch.int32, device=dev)
    level = torch.empty((nq_p,), dtype=torch.int32, device=dev)
    nbytes = (torch.empty((n_blocks,), dtype=torch.int32, device=dev)
              if pipelined else None)
    aligned = width % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (level_keys, rank_map, bot_rank))
    p = build.ptr
    name = "splay_search_pipelined" if pipelined else "splay_search_tiered"
    code = fn(int(pipelined), p(level_keys), p(rank_map), p(bot_rank),
              p(widths), p(queries), n_levels, width, n_blocks, block,
              pipe_cluster(block) if cluster is None else cluster,
              n_live, math.gcd(width, 256), int(aligned), p(found), p(rank),
              p(level), p(nbytes), build.stream_of(level_keys))
    build.check(lib, code, f"{name} launch")
    LAUNCHES[name] += 1
    return found, rank, level, nbytes


def _operands(level_keys, queries, *companions):
    """Validate and normalise the search operands: int32, contiguous,
    all on the plane's device (never moved between devices)."""
    dev = level_keys.device
    out = []
    for t in (level_keys, queries, *companions):
        if t.device != dev:
            raise ValueError(f"search operands on {t.device} and {dev}")
        out.append(t.to(torch.int32).contiguous())
    return out


def _splay_search_arrays(level_keys, queries, query_block: int =
                         DEFAULT_QUERY_BLOCK, rank_map=None, widths=None, *,
                         _block: int = None):
    """B1 over a bare matrix (companions derived when absent): CUDA
    tensors launch the kernel, CPU tensors run the plain version.
    ``_block`` overrides the kernel's block size (measurements)."""
    n_levels, width = level_keys.shape
    nq = queries.shape[0]
    dev = level_keys.device
    if nq == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.zeros((0,), dtype=torch.bool, device=dev), z, z
    if rank_map is None:
        rank_map = rank_windows(level_keys)
    if widths is None:
        widths = row_widths(level_keys)
    level_keys, queries, rank_map, widths = _operands(
        level_keys, queries, rank_map, widths)
    qp = _pad_queries(queries, query_block)
    if dev.type == "cpu":
        f, r, lv = splay_search_tiered_plain(level_keys, rank_map, widths,
                                             qp)
    else:
        f, r, lv, _ = _descent_kernel(
            False, level_keys, rank_map, widths, rank_map, qp, qp.shape[0],
            _TIERED_BLOCK if _block is None else _block)
    return f[:nq], r[:nq], lv[:nq]


def _cover(lo, hi, width: int, tile: int):
    """Tile-aligned cover [base, base + nt*tile) of a window [lo, hi]:
    reads reach index min(hi, width - 1) at most."""
    base = torch.div(torch.clamp(lo, 0, width - 1), tile,
                     rounding_mode="floor") * tile
    end = torch.clamp(hi, 0, width - 1)
    nt = torch.clamp(-torch.div(base - (end + 1), tile,
                                rounding_mode="floor"), min=1)
    return base, nt


def splay_search_pipelined_plain(level_keys, rank_map, widths, bot_rank,
                                 queries, n_live: int, query_block: int):
    """Plain version of B2 (``queries`` padded to the block multiple;
    lanes at or past ``n_live`` are batch padding, resolved from the
    start).  Each lane walks on its own until it resolves (a hit, rank
    ``bot_rank[r, p]``; or a width-1 bottom-row projection); a lane that
    never does keeps rank 0.  On entry to each row the unresolved lanes
    fold their windows into the block's union for that row.  The
    reference's per-block issue-time byte counter is then rebuilt from
    the unions: the cover of the first union, and for every row below
    the top that some lane entered unresolved — exactly the rows the
    reference's block runs — the foresight cover of row r+1 bounded
    through row r's rank map, ``3 * nt * tile * 4`` bytes each.  Returns
    ``(found, rank, level_found, bytes [n_blocks])``."""
    n_levels, width = level_keys.shape
    dev = level_keys.device
    nq_p = queries.shape[0]
    nb = nq_p // query_block
    tile = math.gcd(width, 256)
    w = widths.tolist()
    q = queries.long()
    resolved = torch.arange(nq_p, device=dev) >= n_live
    lo = torch.full((nq_p,), -1, dtype=torch.int64, device=dev)
    hi = torch.full((nq_p,), w[0], dtype=torch.int64, device=dev)
    found = torch.zeros((nq_p,), dtype=torch.bool, device=dev)
    rank = torch.zeros((nq_p,), dtype=torch.int64, device=dev)
    level = torch.full((nq_p,), n_levels, dtype=torch.int64, device=dev)
    runs, ulos, uhis = [], [], []
    for r in range(n_levels):
        act = ~resolved
        runs.append(act.view(nb, query_block).any(1))
        ulos.append(torch.where(act, lo, width).view(nb, query_block)
                    .amin(1))
        uhis.append(torch.where(act, hi, 0).view(nb, query_block).amax(1))
        if not bool(act.any()):
            break
        p, hit, lo_n, hi_n, bl, bh = _row_step(
            level_keys[r], rank_map[r], bot_rank[r], lo, hi, q, width, w[r],
            w[min(r + 1, n_levels - 1)], w[-1], act)
        hit = act & hit
        pinned = act & ~hit & (bh - bl == 1)
        level = torch.where(hit, r, level)
        rank = torch.where(hit | pinned, bl, rank)
        found = found | hit
        resolved = resolved | hit | pinned
        lo, hi = torch.where(act, lo_n, lo), torch.where(act, hi_n, hi)

    _, nt = _cover(ulos[0], uhis[0], width, tile)
    fetched = torch.where(runs[0], 3 * nt * tile, 0)
    for r in range(min(len(runs), n_levels - 1)):
        rm_row = rank_map[r].long()
        ulo, uhi = ulos[r], uhis[r]
        l1 = torch.where(ulo < 0, -1,
                         rm_row[torch.clamp(ulo, 0, width - 1)])
        h1 = torch.where((uhi >= width) | (w[r] == 0), w[r + 1],
                         rm_row[torch.clamp(uhi, 0, width - 1)])
        _, nt = _cover(l1, h1, width, tile)
        fetched = fetched + torch.where(runs[r], 3 * nt * tile, 0)
    return (found, rank.to(torch.int32), level.to(torch.int32),
            (fetched * 4).to(torch.int32))


def _splay_search_pipelined_arrays(level_keys, queries, query_block: int =
                                   DEFAULT_QUERY_BLOCK, rank_map=None,
                                   widths=None, bot_rank=None, *,
                                   _cluster: int = None):
    """B2 over a bare matrix: ``(found, rank, level_found, bytes)``."""
    n_levels, width = level_keys.shape
    nq = queries.shape[0]
    dev = level_keys.device
    if nq == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.zeros((0,), dtype=torch.bool, device=dev), z, z, z
    if rank_map is None:
        rank_map = rank_windows(level_keys)
    if widths is None:
        widths = row_widths(level_keys)
    n_blocks = (nq + (-nq) % query_block) // query_block
    if width // math.gcd(width, 256) > _MAX_PIPE_TILES:
        # no divisor near 256: take the tiered descent and report its
        # whole-row byte model (keys + rank-map rows, 4 bytes a lane)
        f, r, lv = _splay_search_arrays(level_keys, queries, query_block,
                                        rank_map=rank_map, widths=widths)
        return f, r, lv, torch.full((n_blocks,), 2 * n_levels * width * 4,
                                    dtype=torch.int32, device=dev)
    if bot_rank is None:
        bot_rank = bottom_ranks(level_keys)
    level_keys, queries, rank_map, widths, bot_rank = _operands(
        level_keys, queries, rank_map, widths, bot_rank)
    qp = _pad_queries(queries, query_block)
    if dev.type == "cpu":
        f, r, lv, nb = splay_search_pipelined_plain(
            level_keys, rank_map, widths, bot_rank, qp, nq, query_block)
    else:
        f, r, lv, nb = _descent_kernel(True, level_keys, rank_map, widths,
                                       bot_rank, qp, nq, query_block,
                                       _cluster)
    return f[:nq], r[:nq], lv[:nq], nb


# ---------------------------------------------------------------------------
# B5: seed baseline, full-width count per row
# ---------------------------------------------------------------------------

def splay_search_full_plain(level_keys, queries, query_block: int):
    """Plain version of B5 (``queries`` padded to the block multiple).
    Row by row, top-down: ``cnt = #(row <= q)``; a hit when
    ``row[cnt - 1] == q``; the bottom row's ``cnt - 1`` is the rank.  A
    block whose lanes are all found skips its remaining rows except the
    bottom one.  Returns ``(found bool, rank int32, level_found
    int32)``."""
    n_levels, width = level_keys.shape
    dev = level_keys.device
    nq_p = queries.shape[0]
    found = torch.zeros((nq_p,), dtype=torch.bool, device=dev)
    level = torch.full((nq_p,), n_levels, dtype=torch.int32, device=dev)
    rank = torch.zeros((nq_p,), dtype=torch.int32, device=dev)
    for r in range(n_levels):
        bottom = r == n_levels - 1
        run = found.view(-1, query_block).all(1).logical_not() | bottom
        run = run.repeat_interleave(query_block)
        row = level_keys[r]
        cnt = (row[None, :] <= queries[:, None]).sum(1).to(torch.int32)
        pred = row[torch.clamp(cnt - 1, min=0).long()]
        hit = run & (cnt > 0) & (pred == queries)
        level = torch.where(hit & ~found, r, level)
        found = found | hit
        if bottom:
            rank = cnt - 1
    return found, rank, level


# B5's launch plan: a cluster of at most _FULL_CLUSTER CTAs per tile of
# _FULL_TILE queries, each CTA staging a column slice of every row in
# the shared memory a block may hold (csrc/splay_search.cu full_kernel)
_FULL_TILE = 128
_FULL_CLUSTER = 8                  # the portable cluster size
_SMEM_BLOCK = 232448               # 227 KB of shared memory a block


class FullPlan(NamedTuple):
    cluster: int      # CTAs per query tile
    slice: int        # columns a CTA owns (the last one ragged)
    pcols: int        # panel columns staged at a time (multiple of 4)
    prows: int        # panel rows staged at a time
    bulk: bool        # TMA bulk copies (16-byte rows), else plain loads
    smem: int         # dynamic shared memory bytes a CTA asks for


def _full_fixed_smem(n_levels: int) -> int:
    """mbarrier + queries + counts [L, tile] + hit flags [L, tile]."""
    return 16 + 4 * _FULL_TILE * (n_levels + 1) + n_levels * _FULL_TILE


def full_plan(width: int, n_levels: int, aligned: bool = True) -> FullPlan:
    """B5's cluster size, column slices and staging panel for an
    ``[n_levels, width]`` plane.  Every CTA owns at least 4 columns (a
    16-byte word), so narrow planes take smaller clusters; a slice that
    does not fit the block's shared memory is staged in panels of rows
    (or, wider still, of columns).  ``aligned``: the plane's base is a
    16-byte multiple, which with ``width % 4 == 0`` lets the rows go by
    TMA bulk copies."""
    if width < 1 or n_levels < 1:
        raise ValueError(f"plane [{n_levels}, {width}] is empty")
    budget = _SMEM_BLOCK - _full_fixed_smem(n_levels)
    if budget < 16:
        raise ValueError(f"{n_levels} rows leave no shared memory for "
                         "B5's panel")
    slice_ = 4 * -(-(-(-width // _FULL_CLUSTER)) // 4)
    cluster = -(-width // slice_)
    pcols = min(slice_, budget // 16 * 4)
    prows = max(1, min(n_levels, budget // (4 * pcols)))
    return FullPlan(cluster, slice_, pcols, prows,
                    bool(aligned and width % 4 == 0),
                    _full_fixed_smem(n_levels) + 4 * prows * pcols)


def _full_kernel(level_keys, queries):
    lib = build.load("splay_search")
    fn = lib.splay_search_full
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    n_levels, width = level_keys.shape
    nq_p = queries.shape[0]
    dev = level_keys.device
    plan = full_plan(width, n_levels, level_keys.data_ptr() % 16 == 0)
    found = torch.empty((nq_p,), dtype=torch.bool, device=dev)
    rank = torch.empty((nq_p,), dtype=torch.int32, device=dev)
    level = torch.empty((nq_p,), dtype=torch.int32, device=dev)
    p = build.ptr
    code = fn(p(level_keys), p(queries), n_levels, width, nq_p,
              plan.cluster, plan.slice, plan.pcols, plan.prows,
              int(plan.bulk), plan.smem, p(found), p(rank), p(level),
              build.stream_of(level_keys))
    build.check(lib, code, "splay_search_full launch")
    LAUNCHES["splay_search_full"] += 1
    return found, rank, level


def _splay_search_full_arrays(level_keys, queries, query_block: int =
                              DEFAULT_QUERY_BLOCK):
    """B5 over a bare matrix: CUDA tensors launch the kernel, CPU
    tensors run the plain version.  Only the plain version pads the
    queries to ``query_block`` (its per-block row skip); the kernel
    tiles them its own way and masks its last tile."""
    nq = queries.shape[0]
    dev = level_keys.device
    if nq == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return torch.zeros((0,), dtype=torch.bool, device=dev), z, z
    level_keys, queries = _operands(level_keys, queries)
    if dev.type != "cpu":
        return _full_kernel(level_keys, queries)
    f, r, lv = splay_search_full_plain(
        level_keys, _pad_queries(queries, query_block), query_block)
    return f[:nq], r[:nq], lv[:nq]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _plane_tensors(plane, queries):
    """An index plane struct with torch fields as it is (a laid-out
    plane gathered whole: the replicated path); a host one
    (``level_arrays.LevelArrays``, numpy fields) moved to the queries'
    device, or to the card when the queries are not a tensor."""
    if torch.is_tensor(plane.keys):
        return shd.gather_index_plane(plane)
    dev = queries.device if torch.is_tensor(queries) else _cuda()
    return plane._replace(**{
        f: torch.as_tensor(getattr(plane, f), device=dev)
        for f in ("keys", "rank_map", "widths")})


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass CPU query "
                           "tensors to search a host plane on the CPU")
    return torch.device("cuda")


def _unpack(level_keys, rank_map, widths, bot_rank, queries=None):
    """A bare matrix passes through; an index plane struct contributes
    its keys and whichever companions the caller did not pass."""
    if not hasattr(level_keys, "rank_map"):
        return level_keys, rank_map, widths, bot_rank
    plane = _plane_tensors(level_keys, queries)
    _reject_segmented(plane.keys)
    return (plane.keys,
            plane.rank_map if rank_map is None else rank_map,
            plane.widths if widths is None else widths,
            getattr(plane, "bot_rank", None) if bot_rank is None
            else bot_rank)


def _as_queries(queries, device) -> torch.Tensor:
    if torch.is_tensor(queries):
        if queries.device != device:
            raise ValueError(f"queries on {queries.device}, plane on "
                             f"{device}")
        return queries.to(torch.int32)
    return torch.as_tensor(np.asarray(queries, np.int32), device=device)


def splay_search(level_keys, queries, query_block: int =
                 DEFAULT_QUERY_BLOCK, rank_map=None, widths=None,
                 sharded=None, pipelined: bool = None):
    """Batched search.  ``level_keys``: int32 ``[n_levels, width]``
    (sorted rows, +INF padded, nested) or an index plane struct, whose
    ``rank_map``/``widths``/``bot_rank`` are used directly.  Queries of
    any length.  Returns ``(found [q] bool, rank [q] int32,
    level_found [q] int32)``.

    ``pipelined``: True takes B2, False B1, None B2 on CUDA tensors and
    B1 on CPU tensors.

    Dispatch: ``sharded=None`` sends a plane laid out width-sharded on
    more than one shard (``sharding.plane_width_mesh``) to
    :func:`splay_search_sharded`; ``sharded=True`` forces that path
    (replicated when no mesh resolves); ``sharded=False`` gathers a
    laid-out plane whole and searches it on this rank."""
    if hasattr(level_keys, "rank_map"):
        if sharded is None:
            sharded = shd.plane_width_mesh(level_keys) is not None
        if sharded:
            return splay_search_sharded(level_keys, queries,
                                        query_block=query_block,
                                        pipelined=pipelined)
    level_keys, rank_map, widths, bot_rank = _unpack(level_keys, rank_map,
                                                     widths, None, queries)
    queries = _as_queries(queries, level_keys.device)
    _check_query_block(query_block, queries.shape[0])
    if pipelined is None:
        pipelined = level_keys.is_cuda
    if pipelined:
        f, r, lv, _ = _splay_search_pipelined_arrays(
            level_keys, queries, query_block=query_block,
            rank_map=rank_map, widths=widths, bot_rank=bot_rank)
        return f, r, lv
    return _splay_search_arrays(level_keys, queries,
                                query_block=query_block,
                                rank_map=rank_map, widths=widths)


def splay_search_pipelined(level_keys, queries, query_block: int =
                           DEFAULT_QUERY_BLOCK, rank_map=None, widths=None,
                           bot_rank=None):
    """The pipelined search: the :func:`splay_search` triple plus the
    per-block byte counter, ``(found [q], rank [q], level_found [q],
    bytes [q_blocks] int32)``.  Widths with no divisor <= 256 within a
    64-tile budget take the tiered descent (bytes then report its
    whole-row model)."""
    level_keys, rank_map, widths, bot_rank = _unpack(level_keys, rank_map,
                                                     widths, bot_rank,
                                                     queries)
    queries = _as_queries(queries, level_keys.device)
    _check_query_block(query_block, queries.shape[0])
    return _splay_search_pipelined_arrays(
        level_keys, queries, query_block=query_block, rank_map=rank_map,
        widths=widths, bot_rank=bot_rank)


def splay_search_full(level_keys, queries, query_block: int =
                      DEFAULT_QUERY_BLOCK):
    """The seed baseline search (B5): the same triple as
    :func:`splay_search` from a full-width count of every row (O(L·W)
    compares per query), over a bare ``[n_levels, width]`` matrix or an
    index plane struct (``DeviceLevelArrays``, or a host
    ``LevelArrays``, moved to the queries' device or the card).  Queries
    of any length.  Unlike the descents it reports a query equal to
    ``PAD_KEY`` as found (it equals the pad lanes), as the reference's
    baseline and oracle do.  A segmented plane raises."""
    if hasattr(level_keys, "rank_map"):
        level_keys = _plane_tensors(level_keys, queries).keys
        _reject_segmented(level_keys)
    queries = _as_queries(queries, level_keys.device)
    _check_query_block(query_block, queries.shape[0])
    return _splay_search_full_arrays(level_keys, queries,
                                     query_block=query_block)


# ---------------------------------------------------------------------------
# route sizing of the width-sharded exchange (integer arithmetic; the
# routing controller sizes its slack ladder with it on every path)
# ---------------------------------------------------------------------------

DEFAULT_ROUTE_SLACK = 1.5


def route_capacity(nq: int, n_shards: int,
                   slack: float = DEFAULT_ROUTE_SLACK) -> int:
    """The default per-shard receive capacity of the routed exchange:
    ``ceil(q/S) · slack``, clamped into ``[1, q]``.  ``slack >= S`` makes
    spill impossible (a shard never receives more than ``q`` queries).
    Raises ``ValueError`` on non-positive ``nq``/``n_shards`` and on
    ``slack < 1.0``."""
    if nq <= 0:
        raise ValueError(f"route_capacity: nq must be positive, got {nq}")
    if n_shards <= 0:
        raise ValueError(
            f"route_capacity: n_shards must be positive, got {n_shards}")
    if slack < 1.0:
        raise ValueError(
            f"route_capacity: slack must be >= 1.0, got {slack} "
            "(sub-1 slack guarantees spill on a balanced batch)")
    qs = -(-nq // n_shards)
    return max(1, min(nq, int(-(-qs * slack // 1))))


# ---------------------------------------------------------------------------
# width-sharded search: ownership routing and each shard's descent (B1 or
# B2) on its local [L, W/S] sub-plane, one rank per shard.  The routed
# all-to-all query exchange is the default; the replicate-and-mask trace
# is kept as the spill target and as routed=False.
# ---------------------------------------------------------------------------

class RouteStats(NamedTuple):
    """Routing balance of one routed batch, equal on every rank.

    ``spill`` (0-d int32): queries answered through the
    replicate-and-mask spill path because their owner's received block,
    or their source bucket, exceeded ``capacity``.  ``occupancy`` (int32
    ``[S]``): live queries each shard received, before the capacity
    clamp; it sums to ``q`` (batch-padding lanes are never routed).  On
    the replicated fallback ``spill`` is 0 and ``occupancy`` the one
    pseudo-shard's whole batch.  ``assembled`` (0-d int32): shards that
    re-derived their local sub-plane this batch (``S`` on a lanes-split
    or rebuilt plane, 0 on a resident mass-split one; 0 on the
    fallback)."""
    spill: torch.Tensor
    occupancy: torch.Tensor
    assembled: torch.Tensor


def _as_device_plane(plane, device):
    """A plane struct with every ``DeviceLevelArrays`` field: a host
    ``LevelArrays`` (numpy fields) gets tensors on ``device``, an unknown
    (-1) slot map, a derived ``bot_rank`` and stale residency, so the
    per-batch assemble path serves it."""
    if hasattr(plane, "local_ok"):
        return plane
    from repro_torch.core import device_index as dix
    keys = torch.as_tensor(np.asarray(plane.keys, np.int32), device=device)
    n_levels, width = keys.shape
    heights = torch.as_tensor(np.asarray(plane.heights, np.int32),
                              device=device)
    bot = keys[n_levels - 1]
    return dix.DeviceLevelArrays(
        keys=keys,
        widths=torch.as_tensor(np.asarray(plane.widths, np.int32),
                               device=device),
        heights=heights,
        rank_map=torch.as_tensor(np.asarray(plane.rank_map, np.int32),
                                 device=device),
        slots=torch.full((width,), -1, dtype=torch.int32, device=device),
        bot_rank=bottom_ranks(keys), local_bot=bot, local_heights=heights,
        local_live=(bot != PAD_KEY).to(torch.int32),
        local_ok=torch.zeros((1,), dtype=torch.int32, device=device))


def _route_tables(bot, mesh):
    """``(bounds [S], lifts [S])`` from one all-gather of two scalars a
    shard.  ``bounds``: the suffix-min of the block-first bottom-row
    keys, shard 0's forced to the -inf sentinel, so every query has one
    owner (an empty interior block of a segmented plane owns nothing).
    ``lifts``: the exclusive prefix of the blocks' live counts, the lift
    from a shard's local predecessor index to the packed global one."""
    dev = bot.device
    lo = (bot[0] if mesh.index else
          torch.tensor(NEG_INF_KEY, dtype=torch.int32, device=dev))
    cnt = (bot != PAD_KEY).sum().to(torch.int32)
    both = cl.all_gather(torch.stack([lo, cnt]), mesh)     # [S, 2]
    counts = both[:, 1]
    return (shd.suffix_min_bounds(both[:, 0].contiguous()),
            torch.cumsum(counts, 0, dtype=torch.int32) - counts)


def _owner_of(bounds, queries):
    """Owner shard of each query: the s with ``bounds[s] <= clip(q) <
    bounds[s+1]``.  Queries clamp into (-inf sentinel, PAD_KEY - 1) for
    routing only, so a ``PAD_KEY`` query routes to the last live range
    and one below the sentinel to shard 0."""
    q = torch.clamp(queries, NEG_INF_KEY, PAD_KEY - 1)
    return torch.searchsorted(bounds, q, right=True, out_int32=True) - 1


def _descend_local(local, queries, query_block: int, pipelined: bool):
    """One descent over a shard's ``[L, W/S]`` sub-plane: B2 when
    ``pipelined`` (its byte counter dropped), else B1; the plain
    versions on CPU tensors."""
    if pipelined:
        f, r, lv, _ = _splay_search_pipelined_arrays(
            local.keys, queries, query_block=query_block,
            rank_map=local.rank_map, widths=local.widths,
            bot_rank=local.bot_rank)
        return f, r, lv
    return _splay_search_arrays(local.keys, queries, query_block=query_block,
                                rank_map=local.rank_map,
                                widths=local.widths)


def _local_subplane(plane):
    """This shard's local sub-plane and an int32 0/1 flag of whether it
    was assembled.  With the residency bit ``local_ok`` set (only the
    mass-split refresh sets it; it is equal on every rank) the blocks
    already are the local sub-plane and only ``widths`` is re-derived,
    by one mask-sum; otherwise the block's bottom keys and heights are
    re-layered through ``_assemble_device`` for this batch."""
    from repro_torch.core import device_index as dix
    n_levels = plane.keys.shape[0]
    dev = plane.keys.device
    if int(plane.local_ok[0]) > 0:
        row_min_h = n_levels - 1 - torch.arange(n_levels, dtype=torch.int32,
                                                device=dev)
        live = (plane.local_live > 0)[None, :]
        lw = (live & (plane.local_heights[None, :] >= row_min_h[:, None])
              ).sum(1).to(torch.int32)
        return plane._replace(widths=lw), 0
    wl = plane.local_bot.shape[0]
    local = dix._assemble_device(
        plane.local_bot, plane.local_heights,
        torch.full((wl,), -1, dtype=torch.int32, device=dev), n_levels)
    return local, 1


def _masked_descent(local, bounds, lift, queries, mesh, query_block: int,
                    pipelined: bool):
    """The replicate-and-mask trace: every shard descends the whole
    batch on its sub-plane, keeps the lanes it owns, and one ``[3, q]``
    sum over the shards composes the answers."""
    mine = _owner_of(bounds, queries) == mesh.index
    f, r, lv = _descend_local(local, queries, query_block, pipelined)
    rank_g = torch.where(r >= 0, r + lift, -1)
    stacked = torch.where(mine[None, :],
                          torch.stack([f.to(torch.int32), rank_g, lv]), 0)
    f_o, r_o, l_o = cl.psum(stacked, mesh)
    return f_o > 0, r_o, l_o


def _search_shard_body(plane, queries, mesh, query_block: int,
                       pipelined: bool):
    """One rank's part of the ``routed=False`` search: route by the
    boundary table, descend the whole batch on the local sub-plane, and
    compose by a masked sum.  Returns the global triple and the number
    of shards that assembled."""
    bot = plane.keys[plane.keys.shape[0] - 1]
    bounds, lifts = _route_tables(bot, mesh)
    local, assembled = _local_subplane(plane)
    f, r, lv = _masked_descent(local, bounds, lifts[mesh.index], queries,
                               mesh, query_block, pipelined)
    # ``local_ok`` is replicated, so every shard assembled alike: the
    # reference's psum of the flag is ``S`` times it
    asm = torch.tensor(mesh.size * assembled, dtype=torch.int32,
                       device=queries.device)
    return f, r, lv, asm


def _routed_shard_body(plane, q_loc, mesh, capacity: int, query_block: int,
                       n_live: int, pipelined: bool):
    """One rank's part of the routed query exchange; ``q_loc`` is its
    ``[q/S]`` slice of the batch.

      1. *bucket*: route the slice by the boundary table and compact
         each destination's queries into its row of the ``[S,
         capacity]`` send block (per-destination prefix sums and one
         inverse-prefix take); a position past ``capacity`` spills at
         the source.  Batch-padding lanes (global index ``>= n_live``)
         get owner -1 and are never bucketed or counted.
      2. *exchange*: one all-to-all of the send block; the ``[S, S]``
         pair counts ride one all-gather.  Received rows compact
         source-major into the kernel batch ``[capacity]``; a query
         whose compacted rank passes ``capacity`` spills at the
         destination.
      3. *descend* the compacted block on the local sub-plane.
      4. *return*: answers and a validity flag go back into the
         ``[S, capacity]`` layout by the same positions, the inverse
         all-to-all ships them home, and each source reads its lanes at
         (owner, bucket position).  Pad lanes read an in-bounds slot
         whose value is dropped.
      5. *spill*: lanes without a valid routed answer are answered by
         the masked trace over the all-gathered batch, entered only when
         the spill count, a function of the replicated pair counts, is
         nonzero (so every rank enters it alike).

    Returns this rank's slice of the triple, the spill count, the
    occupancy and the number of shards that assembled."""
    S, ax = mesh.size, mesh.index
    qs = q_loc.shape[0]
    dev = q_loc.device
    fill = PAD_KEY - 1                                # inert query value

    bot = plane.keys[plane.keys.shape[0] - 1]
    bounds, lifts = _route_tables(bot, mesh)
    lift = lifts[ax]
    local, assembled = _local_subplane(plane)

    # ---- 1. owner-bucket the local slice
    gidx = ax * qs + torch.arange(qs, dtype=torch.int32, device=dev)
    owner = torch.where(gidx < n_live, _owner_of(bounds, q_loc), -1)
    onehot = owner[:, None] == torch.arange(S, dtype=torch.int32,
                                            device=dev)[None, :]
    cs = torch.cumsum(onehot, 0, dtype=torch.int32)   # [qs, S]
    cnt = cs[qs - 1]                                  # [S] per destination
    own_c = torch.clamp(owner, 0, S - 1).long()
    pos = torch.gather(cs, 1, own_c[:, None])[:, 0] - 1   # bucket position
    lane = torch.arange(capacity, dtype=torch.int32, device=dev)
    take = torch.clamp(torch.searchsorted(
        cs.t().contiguous(),
        (lane + 1)[None, :].expand(S, capacity).contiguous(),
        out_int32=True), max=qs - 1).long()           # [S, capacity]
    send = torch.where(
        lane[None, :] < torch.clamp(cnt, max=capacity)[:, None],
        q_loc[take], fill)

    # ---- 2. exchange and destination-side compaction
    recv = cl.all_to_all(send, mesh)                  # [S, cap] by source
    pair_cnt = cl.all_gather(cnt, mesh)               # [S_src, S_dst]
    rcv_cnt = torch.clamp(pair_cnt[:, ax], max=capacity)
    cum_r = torch.cumsum(rcv_cnt, 0, dtype=torch.int32)
    occ = cum_r[S - 1]
    src_c = torch.clamp(torch.searchsorted(cum_r, lane, right=True,
                                           out_int32=True), max=S - 1).long()
    lane_of = lane - (cum_r[src_c] - rcv_cnt[src_c])
    kq = torch.where(lane < torch.clamp(occ, max=capacity),
                     recv[src_c, torch.clamp(lane_of, 0,
                                             capacity - 1).long()],
                     fill)                            # [cap] kernel batch

    # ---- 3. the descent over the compacted block
    f, r, lv = _descend_local(local, kq, query_block, pipelined)
    rank_g = torch.where(r >= 0, r + lift, -1)

    # ---- 4. positional un-exchange
    off_r = cum_r - rcv_cnt
    gpos = off_r[:, None] + lane[None, :]             # [S, cap]
    valid = (lane[None, :] < rcv_cnt[:, None]) & (gpos < capacity)
    gp = torch.clamp(gpos, 0, capacity - 1).long()
    back = torch.stack([f.to(torch.int32)[gp], rank_g[gp], lv[gp],
                        valid.to(torch.int32)], 1)    # [S, 4, cap] by dest
    home = cl.all_to_all(back, mesh)                  # [S, 4, cap] by owner
    idx = (own_c * capacity
           + torch.clamp(pos, 0, capacity - 1)).long()
    flat = home.transpose(0, 1).reshape(4, S * capacity)
    ok = (pos < capacity) & (flat[3][idx] > 0)
    f_rt = flat[0][idx] > 0
    r_rt = flat[1][idx]
    l_rt = flat[2][idx]

    # ---- 5. spill, from the replicated pair counts: source-side
    # truncation plus destination-side overflow
    occupancy = pair_cnt.sum(0, dtype=torch.int32)    # [S] per destination
    clamped = torch.clamp(pair_cnt, max=capacity)
    n_spill = (int((pair_cnt - clamped).sum())
               + int(torch.clamp(clamped.sum(0) - capacity, min=0).sum()))
    if n_spill > 0:
        q_all = cl.all_gather_tiled(q_loc, mesh)      # [S * qs]
        fa, ra, la = _masked_descent(local, bounds, lift, q_all, mesh,
                                     query_block, pipelined)
        cut = slice(ax * qs, (ax + 1) * qs)
        f_sp, r_sp, l_sp = fa[cut], ra[cut], la[cut]
    else:
        f_sp = torch.zeros((qs,), dtype=torch.bool, device=dev)
        r_sp = l_sp = torch.zeros((qs,), dtype=torch.int32, device=dev)
    asm = torch.tensor(mesh.size * assembled, dtype=torch.int32,
                       device=dev)
    return (torch.where(ok, f_rt, f_sp), torch.where(ok, r_rt, r_sp),
            torch.where(ok, l_rt, l_sp), n_spill, occupancy, asm)


def _resolve_mesh(plane, axis: str, mesh):
    """The mesh a sharded path runs on, or ``None`` for the replicated
    fallback: the ``mesh`` argument, else the plane's own layout, else
    the active mesh; ``None`` when ``axis`` is not its axis or ``S``
    does not divide the width."""
    shd.check_mesh(mesh)
    mesh = mesh or shd.plane_width_mesh(plane, axis) or shd.active_mesh()
    if (mesh is None or axis not in mesh.shape or axis != mesh.axis
            or shd.plane_width(plane) % mesh.size):
        return None
    return mesh


def splay_search_sharded(level_keys, queries, query_block: int =
                         DEFAULT_QUERY_BLOCK, mesh=None, axis: str = "model",
                         routed: bool = True, capacity: int = None,
                         slack: float = DEFAULT_ROUTE_SLACK,
                         return_stats: bool = False, pipelined: bool = None):
    """Width-sharded search: each rank of the mesh owns the contiguous
    key range of its plane block.  By default (``routed=True``) the
    batch is exchanged: each rank buckets its ``q/S`` slice by owner,
    one all-to-all ships the static-capacity buckets, the owner descends
    only its received block on its local sub-plane, and the inverse
    exchange returns the answers (:func:`_routed_shard_body`).
    ``routed=False`` takes the replicate-and-mask trace, where queries
    also *spill* when a shard receives more than ``capacity``: counted,
    never dropped, the same answers either way.

    ``capacity`` is the per-shard receive block (default
    :func:`route_capacity` of ``slack``; clamped at ``q``).
    ``return_stats=True`` appends a :class:`RouteStats`.  ``pipelined``
    picks each shard's descent: B2 (True), B1 (False), or B2 on CUDA
    tensors and B1 on CPU tensors (None).

    ``level_keys`` is a plane struct; every rank passes the same global
    query batch and gets the same global triple back.  The mesh is the
    ``mesh`` argument, else the plane's layout, else the active one; a
    global plane is laid out on it first.  Bit-identical to the
    replicated search on every plane and batch, and on a segmented
    (mass-split) plane the only correct search.  No mesh, another axis,
    or an indivisible width: the replicated search, with stats (0,
    ``[q]``, 0)."""
    if not hasattr(level_keys, "rank_map"):
        raise TypeError("splay_search_sharded takes an index plane struct "
                        "(DeviceLevelArrays/LevelArrays), got "
                        f"{type(level_keys).__name__}")
    if capacity is not None and int(capacity) < 1:
        raise ValueError(
            f"splay_search_sharded: capacity must be >= 1, got {capacity}")
    if capacity is None and slack < 1.0:
        raise ValueError(
            f"splay_search_sharded: slack must be >= 1.0, got {slack}")
    plane = level_keys
    dev = (plane.keys.device if torch.is_tensor(plane.keys) else
           queries.device if torch.is_tensor(queries) else _cuda())
    queries = _as_queries(queries, dev)
    nq = queries.shape[0]
    _check_query_block(query_block, nq)
    plane = _as_device_plane(plane, dev)
    if pipelined is None:
        pipelined = plane.keys.is_cuda
    pipelined = bool(pipelined)
    mesh = _resolve_mesh(plane, axis, mesh)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    if mesh is None:
        out = splay_search(plane, queries, query_block=query_block,
                           sharded=False, pipelined=pipelined)
        if return_stats:
            out += (RouteStats(z, torch.full((1,), nq, dtype=torch.int32,
                                             device=dev), z),)
        return out
    S = mesh.size
    plane = shd.shard_index_plane(plane, mesh, axis)
    if nq == 0:
        e = torch.zeros((0,), dtype=torch.int32, device=dev)
        out = (torch.zeros((0,), dtype=torch.bool, device=dev), e, e)
        if return_stats:
            out += (RouteStats(z, torch.zeros((S,), dtype=torch.int32,
                                              device=dev), z),)
        return out
    if not routed:
        f, r, lv, asm = _search_shard_body(plane, queries, mesh,
                                           query_block, pipelined)
        out = (f, r, lv)
        if return_stats:
            out += (RouteStats(z, torch.full((S,), nq, dtype=torch.int32,
                                             device=dev), asm),)
        return out
    qs = -(-nq // S)
    if capacity is None:
        capacity = route_capacity(nq, S, slack)
    else:
        # a shard never receives more than the whole batch
        capacity = min(int(capacity), nq)
    qp = torch.nn.functional.pad(queries, (0, qs * S - nq),
                                 value=PAD_KEY - 1)
    q_loc = qp[mesh.index * qs:(mesh.index + 1) * qs]
    f, r, lv, spill, occ, asm = _routed_shard_body(
        plane, q_loc, mesh, int(capacity), query_block, nq, pipelined)
    # the answers leave the exchange batch-sharded: gather the slices
    got = cl.all_gather(torch.stack([f.to(torch.int32), r, lv]), mesh)
    f, r, lv = got.permute(1, 0, 2).reshape(3, S * qs)[:, :nq]
    f = f > 0
    out = (f, r, lv)
    if return_stats:
        out += (RouteStats(torch.tensor(spill, dtype=torch.int32,
                                        device=dev), occ, asm),)
    return out


# ---------------------------------------------------------------------------
# ordered operations: predecessor / successor / rank / select / range
# count / range scan / top-k.  Each is one descent (B1 or B2 by the
# tensors' device, through splay_search, replicated or routed sharded by
# the same dispatch) plus gathers of the packed bottom row; sharded, a
# select is one masked sum over the shards and a top-k one all-gather of
# each shard's candidates.  The gathers and sorts are plain torch.
# ---------------------------------------------------------------------------

def _require_plane(level_keys, op: str):
    """Ordered ops are defined on packed global ranks, a plane-level
    concept: they take an index plane struct, never a bare matrix."""
    if not hasattr(level_keys, "rank_map"):
        raise TypeError(
            f"{op} takes an index plane struct "
            "(DeviceLevelArrays/LevelArrays), got "
            f"{type(level_keys).__name__}")
    return level_keys


def _ordered_operands(plane, op: str, *xs):
    """The plane (torch fields, on the first operand's device or the
    card; a laid-out plane stays as it is) and each operand as int32 on
    the plane's device."""
    plane = _require_plane(plane, op)
    if not torch.is_tensor(plane.keys):
        plane = _plane_tensors(plane, xs[0])
    return (plane, *(_as_queries(x, plane.keys.device) for x in xs))


def _sharded_mesh(plane, sharded, axis: str = "model", mesh=None):
    """The mesh of an ordered op's sharded path (``sharded=None``:
    exactly when the plane is laid out on more than one shard, as
    :func:`splay_search` dispatches), or ``None`` for the replicated
    one."""
    if sharded is None:
        sharded = shd.plane_width_mesh(plane, axis) is not None
    if mesh is None and not sharded:
        return None
    return _resolve_mesh(plane, axis, mesh)


def _select_shard_body(plane, ranks, mesh):
    """One rank's part of the sharded select: the shard owns the packed
    global ranks ``[lift, lift + cnt)`` (every block, packed or
    segmented, holds its live keys from lane 0), gathers those from its
    bottom row, and one ``[2, q]`` sum stitches values and ownership;
    unowned ranks answer ``PAD_KEY``."""
    bot = plane.keys[plane.keys.shape[0] - 1]
    wl = bot.shape[0]
    _, lifts = _route_tables(bot, mesh)
    lift = lifts[mesh.index]
    cnt = (bot != PAD_KEY).sum()
    mine = (ranks >= lift) & (ranks < lift + cnt)
    loc = torch.clamp(ranks - lift, 0, wl - 1).long()
    vals = torch.where(mine, bot[loc], 0)
    v_o, owned = cl.psum(torch.stack([vals, mine.to(torch.int32)]), mesh)
    return torch.where(owned > 0, v_o, PAD_KEY)


def _select(plane, ranks, sharded=None, axis: str = "model", mesh=None):
    mesh = _sharded_mesh(plane, sharded, axis, mesh)
    if mesh is not None:
        return _select_shard_body(shd.shard_index_plane(plane, mesh, axis),
                                  ranks, mesh)
    keys = shd.gather_index_plane(plane).keys
    _reject_segmented(keys)
    n_levels, width = keys.shape
    bot = keys[n_levels - 1]
    total = plane.widths[n_levels - 1]
    ok = (ranks >= 0) & (ranks < total)
    return torch.where(ok, bot[torch.clamp(ranks, 0, width - 1).long()],
                       PAD_KEY)


def splay_select(level_keys, ranks, sharded=None, axis: str = "model",
                 mesh=None):
    """``select(r)``: the live key at packed-global rank ``r`` (0-based
    over the sorted live bottom row); ``PAD_KEY`` for any rank outside
    ``[0, live_count)``.  ``ranks`` int32 [q] -> keys int32 [q].
    Sharded (a ``mesh``, ``sharded=True``, or a laid-out plane): each
    rank is read from the one shard whose live interval holds it, exact
    on segmented planes too.  The replicated path refuses a segmented
    plane (``ValueError``)."""
    plane, ranks = _ordered_operands(level_keys, "splay_select", ranks)
    if ranks.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32,
                           device=plane.keys.device)
    return _select(plane, ranks, sharded, axis, mesh)


def _descend(plane, queries, query_block, pipelined, sharded):
    """The descent's triple for queries clamped below ``PAD_KEY``."""
    q_eff = torch.clamp(queries, max=PAD_KEY - 1)
    return splay_search(plane, q_eff, query_block=query_block,
                        sharded=sharded, pipelined=pipelined)


def splay_rank(level_keys, queries, query_block: int =
               DEFAULT_QUERY_BLOCK, sharded=None, pipelined: bool = None):
    """``rank(q)``: the number of live keys ``<= q``, the descent's
    bottom-row predecessor index plus one: int32 [q] in ``[0,
    live_count]``.  Queries may be any int32."""
    plane, q = _ordered_operands(level_keys, "splay_rank", queries)
    _, r, _ = _descend(plane, q, query_block, pipelined, sharded)
    return r + 1


def splay_predecessor(level_keys, queries, query_block: int =
                      DEFAULT_QUERY_BLOCK, sharded=None,
                      pipelined: bool = None):
    """``predecessor(q)``: the largest live key ``<= q`` and its
    packed-global rank, ``(keys [q], ranks [q])`` int32;
    ``(NEG_INF_KEY, -1)`` when none.  One descent and one select."""
    plane, q = _ordered_operands(level_keys, "splay_predecessor", queries)
    _, r, _ = _descend(plane, q, query_block, pipelined, sharded)
    keys = _select(plane, r, sharded)
    return torch.where(r >= 0, keys, NEG_INF_KEY), r


def splay_successor(level_keys, queries, query_block: int =
                    DEFAULT_QUERY_BLOCK, sharded=None,
                    pipelined: bool = None):
    """``successor(q)``: the smallest live key ``>= q`` and its
    packed-global rank; a hit answers ``(q, rank)``, a miss the key one
    past the predecessor rank; ``(PAD_KEY, live_count)`` when none."""
    plane, q = _ordered_operands(level_keys, "splay_successor", queries)
    none = q >= PAD_KEY                   # no key >= PAD_KEY
    q_eff = torch.clamp(q, max=PAD_KEY - 1)
    f, r, _ = _descend(plane, q_eff, query_block, pipelined, sharded)
    hit = f & ~none
    r_succ = torch.where(hit, r, r + 1)
    keys = torch.where(hit, q_eff, _select(plane, r_succ, sharded))
    return torch.where(none, PAD_KEY, keys), r_succ


def _range_ranks(plane, lo, hi, query_block, pipelined, sharded):
    """(start rank, in-range count) of the inclusive ranges ``[lo,
    hi]``: one descent over the concatenated endpoints (sharded, one
    exchange for both ends), then ``count = rank(hi) - |{k < lo}|``,
    clamped at 0."""
    n = lo.shape[0]
    f, r, _ = _descend(plane, torch.cat([lo, hi]), query_block, pipelined,
                       sharded)
    f_lo, r_lo, r_hi = f[:n], r[:n], r[n:]
    start = torch.where(f_lo, r_lo, r_lo + 1)      # |{live k < lo}|
    count = torch.clamp(r_hi + 1 - start, min=0)
    count = torch.where(lo >= PAD_KEY, 0, count)
    return start, count


def _range_operands(level_keys, op, lo, hi):
    plane, lo, hi = _ordered_operands(level_keys, op, lo, hi)
    if lo.shape != hi.shape:
        raise ValueError(f"{op}: lo/hi shapes differ: {tuple(lo.shape)} "
                         f"vs {tuple(hi.shape)}")
    return plane, lo, hi


def splay_range_count(level_keys, lo, hi, query_block: int =
                      DEFAULT_QUERY_BLOCK, sharded=None,
                      pipelined: bool = None):
    """Live keys in the inclusive range ``[lo, hi]``: int32 [q], 0 for
    empty or inverted ranges.  Sharded, each endpoint routes to its own
    owner and the packed-global ranks subtract."""
    plane, lo, hi = _range_operands(level_keys, "splay_range_count", lo,
                                    hi)
    if lo.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=lo.device)
    return _range_ranks(plane, lo, hi, query_block, pipelined, sharded)[1]


def splay_range_scan(level_keys, lo, hi, max_range: int,
                     query_block: int = DEFAULT_QUERY_BLOCK,
                     sharded=None, pipelined: bool = None):
    """The live keys of each inclusive range ``[lo, hi]`` in key order:
    ``(keys [q, max_range], count [q], truncated [q])`` int32.  ``keys``
    holds the first ``min(count, max_range)`` members and ``PAD_KEY``
    after them; ``count`` is the full population and ``truncated =
    max(count - max_range, 0)`` what the capacity cut.  Sharded, the
    ``q * max_range`` rank window is read by one sharded select."""
    if not isinstance(max_range, int) or isinstance(max_range, bool) \
            or max_range < 1:
        raise ValueError(
            f"splay_range_scan: max_range must be a positive int, got "
            f"{max_range!r}")
    plane, lo, hi = _range_operands(level_keys, "splay_range_scan", lo, hi)
    n = lo.shape[0]
    dev = lo.device
    if n == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return (torch.zeros((0, max_range), dtype=torch.int32, device=dev),
                z, z)
    start, count = _range_ranks(plane, lo, hi, query_block, pipelined,
                                sharded)
    offs = torch.arange(max_range, dtype=torch.int32, device=dev)[None, :]
    want = offs < torch.clamp(count, max=max_range)[:, None]
    ranks = torch.where(want, start[:, None] + offs, -1)
    keys = _select(plane, ranks.reshape(-1), sharded).reshape(n, max_range)
    return keys, count, torch.clamp(count - max_range, min=0)


def _top_k(h: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, lower index first on ties (a
    stable descending sort)."""
    hv, idx = torch.sort(h, descending=True, stable=True)
    return hv[:k], idx[:k]


def _topk_shard_body(plane, hits, mesh, k: int):
    """One rank's part of the sharded top-k: the shard's own top
    ``min(k, W/S)`` live lanes by hit mass (any global top-k key is in
    its owner's), one all-gather of the ``[3, k_local]`` candidates, and
    a merge on (hits descending, packed-global rank ascending): the tie
    order of ``lax.top_k`` over the packed row.  Missing lanes carry hit
    -1."""
    bot = plane.keys[plane.keys.shape[0] - 1]
    wl = bot.shape[0]
    _, lifts = _route_tables(bot, mesh)
    live = (bot != PAD_KEY) & (plane.slots >= 0)
    h = torch.where(live, hits[torch.clamp(plane.slots, 0,
                                           hits.shape[0] - 1).long()], -1)
    hv, idx = _top_k(h, min(k, wl))
    valid = hv >= 0
    grank = torch.where(valid, _i32(idx) + lifts[mesh.index], PAD_KEY)
    kcand = torch.where(valid, bot[idx], PAD_KEY)
    cand = cl.all_gather(torch.stack([hv, kcand, grank]), mesh)  # [S, 3, kk]
    hv_a = cand[:, 0].reshape(-1)
    key_a = cand[:, 1].reshape(-1)
    gr_a = cand[:, 2].reshape(-1)
    # lexsort on (-hits, rank): a stable sort by the secondary key, then
    # by the primary
    o = torch.sort(gr_a, stable=True)[1]
    o = o[torch.sort(-hv_a[o], stable=True)[1]][:k]
    return key_a[o], hv_a[o], gr_a[o]


def splay_top_k(level_keys, hits, k: int, sharded=None,
                axis: str = "model", mesh=None):
    """The ``k`` hottest live keys by hit mass: ``hits`` is a
    slot-indexed counter array (the state's ``selfhits``, taken as
    int32), gathered onto the bottom row through the plane's ``slots``
    (a host plane has none and reports every lane missing).  Returns
    ``(keys [k], hits [k], ranks [k])`` in descending hit order, ties by
    ascending rank (``lax.top_k``'s order, from a stable descending
    sort); lanes past the live count answer ``(PAD_KEY, 0, -1)``.
    Sharded: per-shard candidates and one all-gather, bit-identical to
    the replicated answer."""
    plane, hits = _ordered_operands(level_keys, "splay_top_k", hits)
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(f"splay_top_k: k must be a positive int, got "
                         f"{k!r}")
    width = shd.plane_width(plane)
    if k > width:
        raise ValueError(
            f"splay_top_k: k={k} exceeds the plane width {width}")
    m = _sharded_mesh(plane, sharded, axis, mesh)
    if m is not None:
        dplane = shd.shard_index_plane(
            _as_device_plane(plane, plane.keys.device), m, axis)
        keys, hv, ranks = _topk_shard_body(dplane, hits, m, k)
        valid = hv >= 0
        return (torch.where(valid, keys, PAD_KEY), torch.clamp(hv, min=0),
                torch.where(valid, ranks, -1))
    plane = shd.gather_index_plane(plane)
    keys = plane.keys
    _reject_segmented(keys)
    bot = keys[keys.shape[0] - 1]
    slots = getattr(plane, "slots", None)
    if not torch.is_tensor(slots):
        slots = torch.full((width,), -1, dtype=torch.int32,
                           device=bot.device)
    live = (bot != PAD_KEY) & (slots >= 0)
    h = torch.where(live, hits[torch.clamp(slots, 0, hits.shape[0] - 1)
                               .long()], -1)
    hv, idx = _top_k(h, k)
    valid = hv >= 0
    return (torch.where(valid, bot[idx], PAD_KEY),
            torch.clamp(hv, min=0),
            torch.where(valid, _i32(idx), -1))
