"""Plane helpers of the width-sharded layout: the twin of
``repro.parallel.sharding``, so far only what the meshless plane audit
needs.  The shard layout itself, the mass split and the routed exchange
arrive with the multi-device slice."""

from __future__ import annotations

import torch


def suffix_min_bounds(block_firsts: torch.Tensor) -> torch.Tensor:
    """Monotonize per-block first bottom-row keys into the ownership
    boundary table: entry s becomes ``min(block_firsts[s:])``, so an
    empty block's +INF first key never shadows the live blocks to its
    right (on a packed plane only trailing blocks are empty and this is
    the identity)."""
    rev = torch.flip(block_firsts, (0,))
    return torch.flip(torch.cummin(rev, 0)[0], (0,))
