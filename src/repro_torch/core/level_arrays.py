"""Level-array export on the host: the plane layout the search kernels
read, built with numpy from a torch splay-list state (the twin of
``repro.core.level_arrays``).

The splay-list becomes a dense rectangle ``level_keys[n_levels, width]``:
row r holds (sorted, +INF padded) the keys whose splay height is at
least (top - r) — row 0 is the hottest, the last row is the full key
set.  ``rank_map[r, j]`` is the index of ``keys[r, j]`` in row r + 1
(rows are nested), which bounds the rank-windowed descent's window one
row down; pad entries map to ``widths[r + 1]``.  :func:`refresh`
rebuilds after an epoch that moved heights but not membership without
the argsort, and keeps the previous shape whenever it still fits.

This module is the host oracle; the serving loop keeps its plane on the
device (``core/device_index.py``).  The fields are numpy arrays, so
the JAX package's tests and this package's build the same planes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import splaylist as sx

PAD_KEY = np.int32(2 ** 31 - 1)


class LevelArrays(NamedTuple):
    keys: np.ndarray        # int32 [n_levels, width], +INF padded, sorted
    widths: np.ndarray      # int32 [n_levels], live entries per row
    heights: np.ndarray     # int32 [width]: splay height of bottom row keys
    rank_map: np.ndarray    # int32 [n_levels, width]: index of keys[r, j]
    #                         in row r+1 (identity on the bottom row; pad
    #                         entries hold widths[r + 1])


def _extract(st: sx.SplayState) -> Tuple[np.ndarray, np.ndarray]:
    """Alive (keys, relative heights) of a splay-list state, slot order
    (host-side)."""
    s = sx.to_numpy(st)
    zl = int(s["zl"])
    idx = np.arange(st.capacity)
    alive = (idx >= 2) & (idx < int(s["n_alloc"]))
    alive &= ~s["deleted"] & (s["key"] < PAD_KEY)
    keys = s["key"][alive].astype(np.int32)
    rel_h = (s["top"][alive] - zl).astype(np.int32)
    return keys, rel_h


def from_state(st: sx.SplayState, min_levels: int = 2,
               width: Optional[int] = None) -> LevelArrays:
    """Build level arrays from a splay-list state (host-side)."""
    keys, rel_h = _extract(st)
    return build(keys, rel_h, min_levels=min_levels, width=width)


def from_heights(keys: np.ndarray, rel_heights: np.ndarray,
                 **kw) -> "LevelArrays":
    return build(np.asarray(keys, np.int32),
                 np.asarray(rel_heights, np.int32), **kw)


def build(keys: np.ndarray, rel_h: np.ndarray, min_levels: int = 2,
          width: Optional[int] = None) -> LevelArrays:
    keys = np.asarray(keys, np.int32)
    rel_h = np.asarray(rel_h, np.int32)
    order = np.argsort(keys, kind="stable")
    return _assemble(keys[order], rel_h[order], min_levels, width)


def _assemble(keys_sorted: np.ndarray, rel_h: np.ndarray,
              min_levels: int, width: Optional[int]) -> LevelArrays:
    """Vectorized construction from already-sorted keys: one [L, n]
    membership mask, one prefix-sum for in-row positions, and the rank
    maps read off the same prefix sums one row down."""
    n = len(keys_sorted)
    max_h = int(rel_h.max()) if n else 0
    n_levels = max(max_h + 1, min_levels)
    width = width or (n if n else 1)
    assert width >= n, (width, n)

    row_min_h = (n_levels - 1 - np.arange(n_levels)).astype(np.int32)
    mask = rel_h[None, :] >= row_min_h[:, None]            # [L, n]
    pos = np.cumsum(mask, axis=1, dtype=np.int64) - 1      # [L, n]
    widths = mask.sum(axis=1).astype(np.int32)

    rows = np.full((n_levels, width), PAD_KEY, np.int32)
    rank_map = np.empty((n_levels, width), np.int32)
    rank_map[-1] = np.arange(width, dtype=np.int32)        # bottom: identity
    if n_levels > 1:
        rank_map[:-1] = widths[1:, None]                   # pad default
    if n:
        rr, ii = np.nonzero(mask)
        rows[rr, pos[rr, ii]] = keys_sorted[ii]
        if n_levels > 1:
            rr2, ii2 = np.nonzero(mask[:-1])
            # nested rows: every key of row r sits in row r+1, at the
            # next row's prefix position
            rank_map[rr2, pos[rr2, ii2]] = pos[rr2 + 1, ii2]

    hb = np.zeros((width,), np.int32)
    hb[:n] = rel_h
    return LevelArrays(keys=rows, widths=widths, heights=hb,
                       rank_map=rank_map)


def refresh(st: sx.SplayState, prev: LevelArrays,
            min_levels: int = 2) -> LevelArrays:
    """Incremental rebuild after a rebalance epoch.

    The common serving-loop case is that an epoch of updates moved
    *heights* but not *membership*: the sorted bottom row of ``prev`` is
    still the key set.  Then the O(n log n) argsort is skipped — the new
    heights are permuted into the previous sorted order via one
    searchsorted — and the (cheap, vectorized) mask/prefix pass reruns.
    The previous (n_levels, width) shape is kept whenever it still fits,
    so downstream consumers see stable shapes.

    Falls back to a full :func:`build` when keys were inserted/deleted
    or the new heights outgrow the previous level count.  A transient
    empty preserves the previous shape exactly.  Device serving loops
    use ``device_index.refresh_device`` instead, which additionally
    folds membership changes without the argsort.
    """
    keys, rel_h = _extract(st)
    width = prev.keys.shape[1]
    prev_levels = prev.keys.shape[0]
    w_bot = int(prev.widths[-1])
    if len(keys) == w_bot and w_bot > 0:
        bottom = prev.keys[-1][:w_bot]
        p = np.searchsorted(bottom, keys)
        p = np.clip(p, 0, w_bot - 1)
        if np.array_equal(bottom[p], keys):
            rel_sorted = np.empty((w_bot,), np.int32)
            rel_sorted[p] = rel_h
            lv = max(min_levels, prev_levels)
            if (int(rel_sorted.max()) + 1) <= lv:
                return _assemble(bottom, rel_sorted, lv, width)
    if len(keys) <= width:
        # keep shapes stable across epochs when capacity allows —
        # including the transient-empty epoch (len(keys) == 0), which
        # must preserve (n_levels, width) exactly
        lv, width_keep = prev_levels, width
        if len(keys) and int(rel_h.max()) + 1 > lv:
            lv = int(rel_h.max()) + 1
        return build(keys, rel_h, min_levels=max(lv, min_levels),
                     width=width_keep)
    return build(keys, rel_h, min_levels=min_levels)
