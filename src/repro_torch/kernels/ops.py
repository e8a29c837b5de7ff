"""Entry points over the port's kernels (the searches and the composed
two-tier ``hot_gather``), plus the execution-mode label and the
kernels' launch counters."""

from __future__ import annotations

import torch

from repro_torch.kernels import fold
from repro_torch.kernels import hot_gather as hg
from repro_torch.kernels import splay_search as ssk
from repro_torch.kernels.ref import take_index
from repro_torch.kernels.splay_search import (  # noqa: F401
    splay_search, splay_search_full, splay_search_pipelined)

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


def hot_gather(table, hot_buf, hot_rank, ids):
    """Two-tier gather: ``out[i] = hot_buf[hot_rank[ids[i]]]`` where that
    rank is >= 0, else ``table[ids[i]]``.  Composed as the reference
    composes it: B3 over every id's clamped rank, B4 over the cold ids
    (hot ones read row 0), and a merge."""
    r = hot_rank[take_index(ids, hot_rank.shape[0])]
    is_hot = r >= 0
    hot_out = hg.gather_hot(hot_buf, torch.clamp(r, min=0))
    cold_out = hg.gather_rows(table, torch.where(is_hot, 0, ids))
    return torch.where(is_hot[:, None], hot_out, cold_out)
