"""Entry points over the port's kernels (the searches, replicated and
width-sharded, the ordered operations over the plane, each one descent plus bottom-row gathers,
and the two-tier ``hot_gather``, one launch of the fused gather on the
card), plus the execution-mode label and the kernels' launch
counters."""

from __future__ import annotations

import torch

from repro_torch.kernels import fold
from repro_torch.kernels import hot_gather as hg
from repro_torch.kernels import splay_search as ssk
from repro_torch.kernels.hot_gather import hot_gather  # noqa: F401
from repro_torch.kernels.splay_search import (  # noqa: F401
    RouteStats, route_capacity, splay_predecessor, splay_range_count,
    splay_range_scan, splay_rank, splay_search, splay_search_full,
    splay_search_pipelined, splay_search_sharded, splay_select,
    splay_successor, splay_top_k)

_COUNTERS = (ssk.LAUNCHES, fold.LAUNCHES, hg.LAUNCHES)


def exec_mode(x) -> str:
    """``"cuda-kernels"`` when ``x`` (a tensor or a device) is on the
    card, where the CUDA kernels run; ``"plain-cpu"`` otherwise."""
    dev = x.device if torch.is_tensor(x) else torch.device(x)
    return "cuda-kernels" if dev.type == "cuda" else "plain-cpu"


def launch_counts() -> dict:
    """Kernel name -> CUDA launches since the last reset."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0

