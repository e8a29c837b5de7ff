"""Batched splay-list search over the level-array plane: the twin of
the replicated half of ``repro.kernels.splay_search``.

Each splay level is a dense sorted row; a query descends rows top-down
(row 0 = hottest), binary-searching the rank window its predecessor in
the row above bounds (rows are nested).  Two descents compute the same
``(found, rank, level_found)`` triple, each as a CUDA kernel
(``csrc/splay_search.cu``) beside its plain PyTorch version:

* tiered (B1): every row, every query — :func:`splay_search_tiered_plain`;
* pipelined (B2): query blocks that stop once every lane has resolved
  (a hit answered through ``bot_rank``, or a width-1 bottom-row
  projection), plus the reference's per-block issue-time byte counter
  of its ``gcd(W, 256)``-lane tile fetches —
  :func:`splay_search_pipelined_plain`.  Widths whose tile count
  exceeds 64 take the tiered descent and report its whole-row byte
  model, exactly as the reference does.

A third, the seed baseline (B5), counts ``row <= q`` across every row's
full width instead of descending — :func:`splay_search_full_plain`.
Its kernel spreads the width over a thread-block cluster
(:func:`full_plan`) and counts every row; the plain version keeps the
reference's per-block row skip, which changes the work, not the
answers.

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

PAD_KEY = 2 ** 31 - 1
NEG_INF_KEY = -(2 ** 31) + 1        # splaylist.NEG_INF_32 (head sentinel)
DEFAULT_QUERY_BLOCK = 256

# Tile length of the pipelined fetches: the largest divisor of the width
# that is <= 256.  Widths with more tiles than this take the tiered
# descent (the reference's rule, kept with its byte model).
_MAX_PIPE_TILES = 64
_TIERED_BLOCK = 256

# launches of the CUDA kernels (plain CPU runs do not count)
LAUNCHES = {"splay_search_tiered": 0, "splay_search_pipelined": 0,
            "splay_search_full": 0}


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


def _n_steps(width: int) -> int:
    return max(int(width + 1).bit_length(), 1)


def _pad_queries(queries: torch.Tensor, query_block: int) -> torch.Tensor:
    pad = (-queries.shape[0]) % query_block
    if not pad:
        return queries
    return torch.nn.functional.pad(queries, (0, pad), value=PAD_KEY - 1)


# ---------------------------------------------------------------------------
# B1: tiered descent
# ---------------------------------------------------------------------------

def splay_search_tiered_plain(level_keys, rank_map, widths, queries):
    """Plain version of B1: the rank-windowed descent, all queries at
    once, row by row, with the reference's fixed probe count.  Returns
    ``(found bool, rank int32, level_found int32)``."""
    n_levels, width = level_keys.shape
    dev = level_keys.device
    q = queries
    nq = q.shape[0]
    w = widths.tolist()
    lo = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    hi = torch.full((nq,), w[0], dtype=torch.int32, device=dev)
    found = torch.zeros((nq,), dtype=torch.bool, device=dev)
    level = torch.full((nq,), n_levels, dtype=torch.int32, device=dev)
    p = lo
    for r in range(n_levels):
        row = level_keys[r]
        for _ in range(_n_steps(width)):
            active = hi - lo > 1
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            le = row[torch.clamp(mid, 0, width - 1).long()] <= q
            lo, hi = (torch.where(active & le, mid, lo),
                      torch.where(active & ~le, mid, hi))
        p = lo
        pc = torch.clamp(p, 0, width - 1).long()
        hit = (p >= 0) & (row[pc] == q)
        level = torch.where(hit & ~found, r, level)
        found = found | hit
        if r < n_levels - 1:
            rm = rank_map[r]
            pc1 = torch.clamp(p + 1, 0, width - 1).long()
            edge = (p + 1 >= width) | (w[r] == 0)
            lo = torch.where(p >= 0, rm[pc], -1)
            hi = torch.where(edge, w[r + 1], rm[pc1])
    return found, p.to(torch.int32), level


def _tiered_kernel(level_keys, rank_map, widths, queries):
    lib = build.load("splay_search")
    fn = lib.splay_search_tiered
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    n_levels, width = level_keys.shape
    nq = queries.shape[0]
    dev = level_keys.device
    found = torch.empty((nq,), dtype=torch.bool, device=dev)
    rank = torch.empty((nq,), dtype=torch.int32, device=dev)
    level = torch.empty((nq,), dtype=torch.int32, device=dev)
    p = build.ptr
    code = fn(p(level_keys), p(rank_map), p(widths), p(queries), n_levels,
              width, nq, _TIERED_BLOCK, p(found), p(rank), p(level),
              build.stream_of(level_keys))
    build.check(lib, code, "splay_search_tiered launch")
    LAUNCHES["splay_search_tiered"] += 1
    return found, rank, level


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
                         DEFAULT_QUERY_BLOCK, rank_map=None, widths=None):
    """B1 over a bare matrix (companions derived when absent): CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
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
        f, r, lv = _tiered_kernel(level_keys, rank_map, widths, qp)
    return f[:nq], r[:nq], lv[:nq]


# ---------------------------------------------------------------------------
# B2: pipelined descent with block-level early exit
# ---------------------------------------------------------------------------

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
    start).  Every block runs the reference's row loop: the union window
    of its unresolved lanes, the foresight cover of the next row (whose
    tiles the byte counter charges while the block still runs), then
    the row's binary refinement.  Reads come straight from the rows —
    within the cover, which is all an unresolved lane ever reads, they
    equal the reference's buffered tiles.  Returns ``(found, rank,
    level_found, bytes [n_blocks])``."""
    n_levels, width = level_keys.shape
    dev = level_keys.device
    nq_p = queries.shape[0]
    nb = nq_p // query_block
    tile = math.gcd(width, 256)
    w = widths.tolist()
    bot_w = w[n_levels - 1]
    q = queries.view(nb, query_block)
    gidx = torch.arange(nq_p, device=dev).view(nb, query_block)
    is_pad = gidx >= n_live

    def i32(v):
        return torch.full((nb, query_block), v, dtype=torch.int32,
                          device=dev)

    lo = torch.where(is_pad, 0, i32(-1))
    hi = torch.where(is_pad, 0, i32(w[0]))
    found = torch.zeros((nb, query_block), dtype=torch.bool, device=dev)
    rank = i32(0)
    level = i32(n_levels)
    resolved = is_pad.clone()
    done = resolved.all(1)

    def union_window(lo_, hi_, res):
        return (torch.where(res, width, lo_).amin(1),
                torch.where(res, 0, hi_).amax(1))

    base, nt = _cover(*union_window(lo, hi, resolved), width, tile)
    fetched = torch.where(done, 0, 3 * nt * tile)
    for r in range(n_levels):
        run = ~done
        next_w = w[min(r + 1, n_levels - 1)]
        row, rm_row, br_row = level_keys[r], rank_map[r], bot_rank[r]
        ulo, uhi = union_window(lo, hi, resolved)
        l1 = torch.where(ulo < 0, -1,
                         rm_row[torch.clamp(ulo, 0, width - 1).long()])
        h1 = torch.where((uhi >= width) | (w[r] == 0), next_w,
                         rm_row[torch.clamp(uhi, 0, width - 1).long()])
        base, nt = _cover(l1, h1, width, tile)
        if r < n_levels - 1:
            fetched = fetched + torch.where(run, 3 * nt * tile, 0)

        lo_, hi_ = lo, hi
        for _ in range(_n_steps(width)):
            active = hi_ - lo_ > 1
            mid = torch.div(lo_ + hi_, 2, rounding_mode="floor")
            le = row[torch.clamp(mid, 0, width - 1).long()] <= q
            lo_, hi_ = (torch.where(active & le, mid, lo_),
                        torch.where(active & ~le, mid, hi_))
        p = lo_
        pc = torch.clamp(p, 0, width - 1).long()
        pc1 = torch.clamp(p + 1, 0, width - 1).long()
        edge = (p + 1 >= width) | (w[r] == 0)
        runl = run[:, None]
        hit = runl & (p >= 0) & (row[pc] == q)
        bl = torch.where(runl, torch.where(p >= 0, br_row[pc], -1), 0)
        bh = torch.where(runl, torch.where(edge, bot_w, br_row[pc1]), 0)
        lo_n = torch.where(runl, torch.where(p >= 0, rm_row[pc], -1), 0)
        hi_n = torch.where(runl, torch.where(edge, next_w, rm_row[pc1]), 0)

        hitn = hit & ~resolved
        pinned = runl & ~hit & ~resolved & (bh - bl == 1)
        level = torch.where(hitn, r, level)
        rank = torch.where(hitn | pinned, bl, rank)
        found = found | hitn
        resolved = resolved | hitn | pinned
        lo = torch.where(resolved, 0, lo_n)
        hi = torch.where(resolved, 0, hi_n)
        done = done | resolved.all(1)
    return (found.view(-1), rank.view(-1).to(torch.int32),
            level.view(-1).to(torch.int32), (fetched * 4).to(torch.int32))


def _pipelined_kernel(level_keys, rank_map, widths, bot_rank, queries,
                      n_live: int, query_block: int):
    if query_block > 1024:
        raise ValueError(f"query_block {query_block} exceeds the 1024 "
                         "threads of a CUDA block")
    lib = build.load("splay_search")
    fn = lib.splay_search_pipelined
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    n_levels, width = level_keys.shape
    nq_p = queries.shape[0]
    nb = nq_p // query_block
    dev = level_keys.device
    found = torch.empty((nq_p,), dtype=torch.bool, device=dev)
    rank = torch.empty((nq_p,), dtype=torch.int32, device=dev)
    level = torch.empty((nq_p,), dtype=torch.int32, device=dev)
    nbytes = torch.empty((nb,), dtype=torch.int32, device=dev)
    p = build.ptr
    code = fn(p(level_keys), p(rank_map), p(bot_rank), p(widths),
              p(queries), n_levels, width, nb, query_block, n_live,
              math.gcd(width, 256), p(found), p(rank), p(level), p(nbytes),
              build.stream_of(level_keys))
    build.check(lib, code, "splay_search_pipelined launch")
    LAUNCHES["splay_search_pipelined"] += 1
    return found, rank, level, nbytes


def _splay_search_pipelined_arrays(level_keys, queries, query_block: int =
                                   DEFAULT_QUERY_BLOCK, rank_map=None,
                                   widths=None, bot_rank=None):
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
    if bot_rank is None:
        bot_rank = bottom_ranks(level_keys)
    n_blocks = (nq + (-nq) % query_block) // query_block
    if width // math.gcd(width, 256) > _MAX_PIPE_TILES:
        # no divisor near 256: take the tiered descent and report its
        # whole-row byte model (keys + rank-map rows, 4 bytes a lane)
        f, r, lv = _splay_search_arrays(level_keys, queries, query_block,
                                        rank_map=rank_map, widths=widths)
        return f, r, lv, torch.full((n_blocks,), 2 * n_levels * width * 4,
                                    dtype=torch.int32, device=dev)
    level_keys, queries, rank_map, widths, bot_rank = _operands(
        level_keys, queries, rank_map, widths, bot_rank)
    qp = _pad_queries(queries, query_block)
    if dev.type == "cpu":
        f, r, lv, nb = splay_search_pipelined_plain(
            level_keys, rank_map, widths, bot_rank, qp, nq, query_block)
    else:
        f, r, lv, nb = _pipelined_kernel(level_keys, rank_map, widths,
                                         bot_rank, qp, nq, query_block)
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
    """An index plane struct with torch fields as it is; a host one
    (``level_arrays.LevelArrays``, numpy fields) moved to the queries'
    device, or to the card when the queries are not a tensor."""
    if torch.is_tensor(plane.keys):
        return plane
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
    B1 on CPU tensors.  ``sharded=True`` raises ``NotImplementedError``
    until the multi-device slice."""
    if sharded:
        raise NotImplementedError("the width-sharded search arrives with "
                                  "the multi-device slice")
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
