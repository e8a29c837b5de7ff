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
``jax.lax.pmax(x, axis)``                       :func:`pmax`
``jax.lax.psum_scatter(x, axis, dim, tiled)``   :func:`reduce_scatter`
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

Inside :func:`recording` every collective over more than one rank
appends ``(kind, bytes, group size)`` to the recorder's list (the
kinds and byte counts of the reference's HLO collectives: an
all-gather's result, a reduce-scatter's scattered result, the other
kinds' operand; ``launch.roofline`` prices them).  A collective on
``meta`` tensors calls no process group: it returns a ``meta`` result
of the right shape, so the dry-run counts a rank's step without a world
(``launch/dryrun.py``); a tensor on a real device over a mesh of no
process group (``sharding.AbstractMesh``) is refused.

**Gradients.**  :func:`all_gather`, :func:`all_gather_tiled`,
:func:`psum`, :func:`reduce_scatter`, :func:`all_to_all` and
:func:`ppermute` are differentiable: each is a
``torch.autograd.Function`` whose backward is its linear transpose,
over the same axis and through the same recorder (on ``meta`` tensors
the dry-run counts the backward's collectives too):

==================  ==============================================
forward             backward (of the cotangent ``g``)
==================  ==============================================
``all_gather``      ``reduce_scatter`` of ``g`` along the stack
``reduce_scatter``  ``all_gather`` of ``g``, tiled along ``dim``
``psum``            ``psum`` of ``g``
``all_to_all``      ``all_to_all`` of ``g`` (a permutation's inverse
                    is the same exchange)
``ppermute``        ``ppermute`` of ``g`` by the inverse pairs
==================  ==============================================

So a rank's backward pass gives, for each value it holds, its share of
the gradient of the sum over ranks of what each rank's loss was seeded
with: seeded with ``1/N`` on each of ``N`` ranks that hold the same
replicated loss, the gradient of a value every rank holds alike is the
sum of the ranks' shares, and that of a block is the sum over the axes
the block is not split over (``train.train_step`` takes these sums).
:func:`pmax` carries no gradient: its uses (the softmax's shift, the
flash-decoding combine's max) are shifts the result does not depend
on.
"""

from __future__ import annotations

import contextlib

import torch

_HALF = (torch.bfloat16, torch.float16)


class _Rec:
    """The list :func:`recording` collects into, for the whole process:
    the autograd engine runs a CUDA backward pass on threads of its own,
    and their collectives belong to the recording the step runs in."""
    log = None


_REC = _Rec()


@contextlib.contextmanager
def recording():
    """Within it, each collective over more than one rank appends
    ``(kind, bytes, group size)`` to the list it yields: ``kind`` the
    reference's HLO name (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``),
    ``bytes`` what moves as that op's sized type (an all-gather's
    gathered result, a reduce-scatter's scattered result, the operand
    of the others).  Reentrant; process-wide (a backward pass's
    collectives on the autograd engine's threads are recorded too)."""
    old, _REC.log = _REC.log, []
    try:
        yield _REC.log
    finally:
        _REC.log = old


def _record(kind: str, x: torch.Tensor, n: int, scale: float = 1) -> None:
    """Log ``kind`` moving ``scale`` times ``x``'s bytes over ``n``
    ranks, inside :func:`recording`."""
    if _REC.log is not None and n > 1:
        _REC.log.append((kind, int(x.numel() * x.element_size() * scale),
                         n))


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


def _axis(mesh, axis, x: torch.Tensor):
    """The size of ``axis`` and its process group: none over one rank
    or for a ``meta`` ``x`` (its collective calls nothing).  A tensor on
    a real device over a mesh of no process group (an ``AbstractMesh``)
    raises ``ValueError``: it has no ranks to meet."""
    axis = mesh.axis if axis is None else axis
    n = mesh.shape[axis]
    if n == 1 or x.is_meta:
        return n, None
    if mesh.backend == "meta":
        raise ValueError(f"a tensor on {x.device} over {mesh!r}, which "
                         f"has no process group: only meta tensors")
    return n, mesh.axis_group(axis)


def _all_gather(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """The plain :func:`all_gather`: no gradient."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis, x)
    x = _wire(x)
    if n == 1:
        return x[None]
    _record("all-gather", x, n, n)
    if x.is_meta:
        return x.expand(n, *x.shape).clone()
    w = _bytes(x)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.stack([_unbytes(p, x) for p in parts])


def _psum(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """The plain :func:`psum`: no gradient."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis, x)
    x = _wire(x)
    out = x.float() if x.dtype in _HALF else x.clone()
    if n > 1:
        _record("all-reduce", out, n)
        if not out.is_meta:
            dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def pmax(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` along ``axis`` (a new
    tensor; exact in any dtype).  It carries no gradient."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis, x)
    out = _wire(x.detach()).clone()
    if n > 1:
        _record("all-reduce", out, n)
        if not out.is_meta:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, mesh, axis: str = None,
                   dim: int = 0) -> torch.Tensor:
    """The plain :func:`reduce_scatter`: no gradient."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis, x)
    x = _wire(x)
    acc = x.float() if x.dtype in _HALF else x
    if n == 1:
        return acc.clone().to(x.dtype)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"divide into {n} blocks")
    size = x.shape[dim] // n
    me = mesh.coords[mesh.axis if axis is None else axis]
    _record("reduce-scatter", acc, n, 1 / n)
    if x.is_meta:
        shape = list(x.shape)
        shape[dim] = size
        return x.new_empty(shape)
    if mesh.backend == "gloo" and x.device.type != "cpu":
        whole = acc.clone()
        dist.all_reduce(whole, group=group)
        return whole.narrow(dim, me * size, size).contiguous().to(x.dtype)
    parts = [p.contiguous() for p in acc.movedim(dim, 0).chunk(n)]
    res = torch.empty_like(parts[0])
    dist.reduce_scatter(res, parts, group=group)
    return res.movedim(0, dim).contiguous().to(x.dtype)


def _all_to_all(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """The plain :func:`all_to_all`: no gradient."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis, x)
    x = _wire(x)
    if n == 1:
        return x.clone()
    _record("all-to-all", x, n)
    if x.is_meta:
        return x.clone()
    w = _bytes(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _unbytes(out, x)


def _ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """The plain :func:`ppermute`: no gradient."""
    import torch.distributed as dist
    n, group = _axis(mesh, axis, x)
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
    _record("collective-permute", x, n)
    if x.is_meta:
        return torch.zeros_like(x)
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


# -- the differentiable collectives -------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, 0)[0], None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        parts = _all_gather(g, ctx.mesh, ctx.axis)
        return torch.cat(list(parts), ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axis), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.back = [(d, s) for s, d in perm]
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.mesh, ctx.axis, ctx.back), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` along ``axis``, in axis
    order.  Its backward is :func:`reduce_scatter` along the stack."""
    return _AllGather.apply(x, mesh, axis)


def all_gather_tiled(x: torch.Tensor, mesh, axis: str = None
                     ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in axis order."""
    return all_gather(x, mesh, axis).reshape(-1, *x.shape[1:])


def psum(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` along ``axis`` (a new
    tensor; 16-bit floats summed in float32, then rounded once).  Its
    backward is the same sum of the cotangents."""
    return _Psum.apply(x, mesh, axis)


def reduce_scatter(x: torch.Tensor, mesh, axis: str = None,
                   dim: int = 0) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` along ``axis``, cut
    into ``S`` blocks along ``dim`` (which ``S`` must divide), this
    rank's block: the tiled ``psum_scatter``.  16-bit floats are summed
    in float32 and rounded once, as :func:`psum`.  NCCL and gloo on CPU
    tensors reduce-scatter; gloo on CUDA tensors, whose reduce-scatter
    the port does not rely on, sums whole (one all-reduce) and takes
    the block.  Its backward all-gathers the cotangents along ``dim``."""
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str = None) -> torch.Tensor:
    """Tiled all-to-all over dim 0: ``x`` is ``[S * k, ...]``; block j
    (rows ``j*k .. j*k+k``) goes to rank j, and block i of the result
    came from rank i.  The exchange is its own inverse, and so its
    backward."""
    return _AllToAll.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Each rank's ``x`` sent along ``axis`` by the ``(source,
    destination)`` index pairs ``perm``: a rank receives its source's
    ``x``, or zeros when no pair names it as a destination (each index
    at most once a side, as ``jax.lax.ppermute`` requires).  One
    all-to-all with split sizes: a rank sends all of ``x`` to its
    destination and nothing to the others.  Its backward sends the
    cotangents back by the inverse pairs."""
    return _Ppermute.apply(x, mesh, axis, perm)
