"""Plain torch oracles: the batched level-array search and the
(two-tier) row gathers."""

from __future__ import annotations

import torch


def splay_search_ref(level_keys: torch.Tensor, queries: torch.Tensor):
    """Oracle for the batched level-array search.

    level_keys: int32 [n_levels, width] (+INF padded, each row sorted,
                rows nested: row r+1 contains row r's keys).
    queries:    int32 [q].

    Returns (found [q] bool, rank [q] int32, level_found [q] int32):
      rank        — predecessor index in the bottom row (count of keys
                    <= q minus 1; -1 if q is below the smallest key);
      level_found — first row index containing the key, n_levels if
                    absent.
    """
    n_levels = level_keys.shape[0]
    bottom = level_keys[-1]
    rank = (bottom[None, :] <= queries[:, None]).sum(1) - 1
    hit = (level_keys[:, None, :] == queries[None, :, None]).any(2)
    found = hit.any(0)
    first = torch.argmax(hit.to(torch.int32), 0)
    level_found = torch.where(found, first, n_levels)
    return found, rank.to(torch.int32), level_found.to(torch.int32)


def take_index(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Row indices as the reference's gathers resolve them: a negative
    id wraps once (``-1 -> n - 1``), and what is still outside
    ``[0, n - 1]`` clamps to it.  int64, on ``ids``' device."""
    i = ids.to(torch.int64)
    return torch.clamp(torch.where(i < 0, i + n, i), 0, max(n - 1, 0))


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Oracle for the row gather: ``out[i] = table[ids[i]]``."""
    return table[take_index(ids, table.shape[0])]


def hot_gather_ref(table, hot_buf, hot_rank, ids):
    """Oracle for the two-tier gather: rows with ``hot_rank >= 0`` come
    from the hot buffer, the rest from the full table."""
    r = hot_rank[take_index(ids, hot_rank.shape[0])]
    hot = r >= 0
    return torch.where(hot[:, None],
                       hot_buf[take_index(torch.clamp(r, min=0),
                                          hot_buf.shape[0])],
                       gather_rows_ref(table, ids))
