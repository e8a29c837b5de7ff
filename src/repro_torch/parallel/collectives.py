"""The collectives of the width-sharded paths, over ``torch.distributed``.

Each is the twin of the ``jax.lax`` collective the reference's
``shard_map`` bodies use, for one rank of an SPMD program (one process
per shard) on a :class:`repro_torch.parallel.sharding.Mesh`:

==============================================  ===========================
reference                                       here
==============================================  ===========================
``jax.lax.all_gather(x, axis)``                 :func:`all_gather` (stacked)
``jax.lax.all_gather(x, axis, tiled=True)``     :func:`all_gather_tiled`
``jax.lax.psum(x, axis)``                       :func:`psum`
``jax.lax.all_to_all(x, axis, 0, 0, tiled)``    :func:`all_to_all`
``jax.lax.axis_index(axis)``                    ``mesh.index``
==============================================  ===========================

The reference's one-element ``ppermute`` halo of the sharded refresh is
an all-gather of each block's first key (the boundary table needs every
block's, not only the neighbour's).

Every rank must make the same sequence of calls: a branch around a
collective has to be taken on every rank alike, so it is decided on a
value every rank holds equally (a replicated input, or the result of a
collective), as the reference's ``lax.cond`` guards are.

Tensors stay on their device: NCCL takes CUDA tensors, and gloo takes
CPU tensors and, in the torch builds this port runs on, CUDA tensors for
each of these four collectives, so nothing is staged through the host.
Booleans travel as int32.
"""

from __future__ import annotations

import torch


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32) if x.dtype == torch.bool else x
    return x.contiguous()


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x``, in rank order."""
    import torch.distributed as dist
    x = _wire(x)
    if mesh.size == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.stack(parts)


def all_gather_tiled(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    return all_gather(x, mesh).reshape(-1, *x.shape[1:])


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (a new tensor)."""
    import torch.distributed as dist
    out = _wire(x).clone()
    if mesh.size > 1:
        dist.all_reduce(out, group=mesh.group)
    return out


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Tiled all-to-all over dim 0: ``x`` is ``[S * k, ...]``; block j
    (rows ``j*k .. j*k+k``) goes to rank j, and block i of the result
    came from rank i."""
    import torch.distributed as dist
    x = _wire(x)
    if mesh.size == 1:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out
