"""Plain torch oracle for the batched level-array search."""

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
