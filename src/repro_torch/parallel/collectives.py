"""The collectives of the sharded paths, over ``torch.distributed``.

Each is the twin of the ``jax.lax`` collective the reference's
``shard_map`` bodies use, for one rank of an SPMD program (one process
per rank) on a :class:`repro_torch.parallel.sharding.Mesh`, over one
named mesh axis (``axis``; the mesh's main axis when omitted):

==============================================  ===========================
reference                                       here
==============================================  ===========================
``jax.lax.all_gather(x, axis)``                 :func:`all_gather` (stacked)
``jax.lax.all_gather(x, axis, tiled=True)``     :func:`all_gather_tiled`
``jax.lax.psum(x, axis)``                       :func:`psum`
``jax.lax.all_to_all(x, axis, 0, 0, tiled)``    :func:`all_to_all`
``jax.lax.ppermute(x, axis, perm)``             :func:`ppermute`
``jax.lax.axis_index(axis)``                    ``mesh.coords[axis]``
==============================================  ===========================

The reference's one-element ``ppermute`` halo of the sharded refresh is
an all-gather of each block's first key (the boundary table needs every
block's, not only the neighbour's).

Every rank must make the same sequence of calls: a branch around a
collective has to be taken on every rank alike, so it is decided on a
value every rank holds equally (a replicated input, or the result of a
collective), as the reference's ``lax.cond`` guards are.  A collective
over an axis of one rank is the identity and calls nothing.

Tensors stay on their device: NCCL takes CUDA tensors, and gloo takes
CPU tensors and, in the torch builds this port runs on, CUDA tensors for
the all-gather, the all-reduce and the all-to-all, so nothing is staged
through the host.  :func:`ppermute` is an all-to-all with split sizes,
never a point-to-point call (gloo's ``send``/``recv`` take CPU tensors
only).  Booleans travel as int32; the moving collectives carry 16-bit
floats as their bytes, and :func:`psum` sums them in float32 and rounds
the sum once.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32) if x.dtype == torch.bool else x
    return x.contiguous()


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the wire of a collective that only moves it: 16-bit
    floats as their bytes."""
    x = _wire(x)
    return x.view(torch.uint8) if x.dtype in _HALF and x.dim() else x


def _unbytes(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.view(like.dtype) if y.dtype != like.dtype else y


def _axis(mesh, axis):
    axis = mesh.axis if axis is None else axis
    return mesh.shape[axis], mesh.axis_group(axis) if mesh.shape[
        axis] > 1 else None


def all_gather(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` along ``axis``, in axis
    order."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis)
    x = _wire(x)
    if n == 1:
        return x[None]
    w = _bytes(x)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.stack([_unbytes(p, x) for p in parts])


def all_gather_tiled(x: torch.Tensor, mesh, axis: str = None
                     ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in axis order."""
    return all_gather(x, mesh, axis).reshape(-1, *x.shape[1:])


def psum(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` along ``axis`` (a new
    tensor; 16-bit floats summed in float32, then rounded once)."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis)
    x = _wire(x)
    out = x.float() if x.dtype in _HALF else x.clone()
    if n > 1:
        dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def all_to_all(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """Tiled all-to-all over dim 0: ``x`` is ``[S * k, ...]``; block j
    (rows ``j*k .. j*k+k``) goes to rank j, and block i of the result
    came from rank i."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis)
    x = _wire(x)
    if n == 1:
        return x.clone()
    w = _bytes(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _unbytes(out, x)


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Each rank's ``x`` sent along ``axis`` by the ``(source,
    destination)`` index pairs ``perm``: a rank receives its source's
    ``x``, or zeros when no pair names it as a destination (each index
    at most once a side, as ``jax.lax.ppermute`` requires).  One
    all-to-all with split sizes: a rank sends all of ``x`` to its
    destination and nothing to the others."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis)
    axis = mesh.axis if axis is None else axis
    me = mesh.coords[axis]
    dest = dict(perm)
    src = {d: s for s, d in perm}
    if len(dest) != len(perm) or len(src) != len(perm) or any(
            not (0 <= i < n) for p in perm for i in p):
        raise ValueError(f"perm {perm} is not a partial permutation of "
                         f"range({n})")
    x = _wire(x)
    if n == 1:
        return x.clone() if dest.get(0) == 0 else torch.zeros_like(x)
    w = _bytes(x).reshape(-1)
    k = w.numel()
    out = w.new_empty(k if me in src else 0)
    dist.all_to_all_single(
        out, w if me in dest else w[:0],
        output_split_sizes=[k if j == src.get(me) else 0
                            for j in range(n)],
        input_split_sizes=[k if j == dest.get(me) else 0
                           for j in range(n)], group=group)
    if me not in src:
        return torch.zeros_like(x)
    return _unbytes(out, x).reshape(x.shape)
