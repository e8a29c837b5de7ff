"""GPipe pipeline parallelism over a mesh axis (``pod`` by default): the
twin of ``repro.parallel.pipeline``.

The layers split into ``S`` contiguous stages, one a rank along the
axis (:func:`split_stages`), and microbatches stream through them:
``S + M - 1`` ticks, in each of which stage 0 takes its next
microbatch, every other stage the buffer its predecessor handed on
(``collectives.ppermute``), and the last stage records each finished
microbatch.  A masked sum broadcasts the last stage's outputs to every
rank (a permutation cannot fan one rank out to all).  The bubble is
``(S - 1) / (S - 1 + M)`` of the ticks.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree import tree_map
from repro_torch.parallel import collectives as cl


def pipeline_forward(x: torch.Tensor, stage_params, stage_fn: Callable,
                     mesh, n_microbatches: int, axis: str = "pod"
                     ) -> torch.Tensor:
    """``stage_fn(params_i, h)`` over the pipeline stages laid on
    ``axis`` of ``mesh``; every rank of the axis must call this.

    ``x``: the global batch ``[B, ...]`` (``B % n_microbatches == 0``),
    the same on every rank.  ``stage_params``: a tree whose leaves lead
    with the stage axis: this rank's block ``[1, ...]`` of it (the
    layout ``(axis,)``, as ``elastic.reshard`` cuts it) or the whole
    ``[S, ...]`` stack.  Returns the last stage's output, the same on
    every rank, in ``x``'s layout.  A stage computes only in the ticks
    where it holds a microbatch (the reference computes every tick and
    masks: the values are the same)."""
    n_stages = mesh.shape[axis]
    stage = mesh.coords[axis]
    M = int(n_microbatches)
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not split into {M} "
                         f"microbatches")

    def mine(a):
        if a.shape[0] == n_stages:
            return a[stage]
        if a.shape[0] == 1:
            return a[0]
        raise ValueError(f"a stage leaf leads with {a.shape[0]}, not 1 or "
                         f"{n_stages} stages")
    params_i = tree_map(mine, stage_params)
    mb = x.reshape(M, x.shape[0] // M, *x.shape[1:])
    outputs = torch.zeros_like(mb)
    buf = torch.zeros_like(mb[0])
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(n_stages + M - 1):
        inp = mb[min(max(t - stage, 0), M - 1)] if stage == 0 else buf
        active = stage <= t < stage + M
        out = stage_fn(params_i, inp) if active else inp
        buf = cl.ppermute(out, mesh, axis, ring)
        if stage == n_stages - 1 and active:
            outputs[t - (n_stages - 1)] = out
    if stage != n_stages - 1:
        outputs = torch.zeros_like(outputs)
    return cl.psum(outputs, mesh, axis).reshape(x.shape)


def split_stages(stacked_params, n_stages: int):
    """Per-layer stacked params ``[L, ...]`` -> ``[S, L // S, ...]``
    (views; tensors or numpy arrays)."""
    def f(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return tree_map(f, stacked_params)
