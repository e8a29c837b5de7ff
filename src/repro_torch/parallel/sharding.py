"""The width-sharded layout of the splay index plane: the twin of the
plane half of ``repro.parallel.sharding``, for SPMD over
``torch.distributed`` (one process per shard).

The reference lays one global plane out over a ``jax.sharding.Mesh``
and runs ``shard_map`` bodies over its ``"model"`` axis.  Here each
rank is one shard: a :class:`Mesh` is that rank's view of the mesh (its
process group, the axis name, the shard count ``S``, its own index and
its device), the ``mesh=`` arguments of the port take it, and a
width-sharded plane is this rank's block of the global plane:

* ``keys``/``rank_map``/``bot_rank``: the column block ``[L, W/S]``
  (the reference's ``P(None, axis)``);
* ``heights``/``slots``/``local_bot``/``local_heights``/``local_live``:
  the block ``[W/S]`` (``P(axis)``);
* ``widths`` and ``local_ok``: whole on every rank (``P()``).

Such a plane is an instance of a subclass of its plane class that
carries the mesh (:func:`plane_mesh`), so the search and the ordered ops
find the layout on the plane itself, as the reference reads it off the
arrays' sharding.  :func:`gather_index_plane` is the inverse of
:func:`shard_index_plane`; every rank of the mesh must call it.

The reference's fallbacks hold: a plane whose width ``S`` does not
divide stays replicated, and so does any plane when no mesh is given or
active (``use_mesh``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.parallel import collectives as cl



class Mesh:
    """One rank's view of a ``("data", axis)`` mesh of ``1 × S`` shards:
    the process group ``group`` (``None``: the default group), its size
    ``S`` and this rank's index in it, and the device this rank computes
    on.  ``shape`` maps axis names to sizes as ``jax.sharding.Mesh.shape``
    does (``data`` is 1 unless :func:`repro_torch.train.elastic.remesh`
    builds a larger grid; the group is then this rank's row along
    ``axis``).  ``device`` is the card unless the caller asks for the
    CPU."""

    def __init__(self, group=None, axis: str = "model", device="cuda",
                 shape: Optional[dict] = None):
        import torch.distributed as dist
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.shape = dict(shape) if shape else {"data": 1}
        self.shape[axis] = self.size
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        self.ranks = (dist.get_process_group_ranks(group)
                      if group is not None
                      else list(range(dist.get_world_size())))
        self._plane_classes = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, index={self.index}, "
                f"backend={self.backend}, device={self.device})")


def check_mesh(mesh) -> None:
    """Refuse a ``mesh=`` argument that is not a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a repro_torch.parallel.sharding.Mesh,"
                        f" got {type(mesh).__name__}")


def world_mesh(device="cuda", axis: str = "model") -> Mesh:
    """The mesh of every rank of the default process group."""
    return Mesh(None, axis=axis, device=device)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh (``None``: none) for the sharded
    entry points that resolve one; thread-local and reentrant, the
    previous one restored on exit."""
    old = _CTX.mesh
    _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.mesh = old


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def index_plane_specs(plane_cls, axis: str = "model"):
    """The layout of a width-sharded plane in the shape of ``plane_cls``,
    a ``PartitionSpec``-like tuple per field: ``(None, axis)`` for the
    ``[L, W]`` fields, ``(axis,)`` for the ``[W]`` ones, ``()`` for the
    replicated ``widths``/``local_ok``."""
    spec = {"keys": (None, axis), "rank_map": (None, axis),
            "bot_rank": (None, axis), "heights": (axis,), "slots": (axis,),
            "local_bot": (axis,), "local_heights": (axis,),
            "local_live": (axis,), "widths": (), "local_ok": ()}
    return plane_cls(**{f: spec[f] for f in plane_cls._fields})


def plane_mesh(plane) -> Optional[Mesh]:
    """The mesh a plane is laid out on by :func:`shard_index_plane`, or
    ``None`` for a global (replicated) plane."""
    return getattr(type(plane), "mesh", None)


def plane_width(plane) -> int:
    """The global width ``W`` of a plane, laid out or not."""
    mesh = plane_mesh(plane)
    return plane.keys.shape[1] * (mesh.size if mesh is not None else 1)


def plane_width_mesh(plane, axis: str = "model") -> Optional[Mesh]:
    """The mesh of a plane laid out width-sharded over ``axis`` on more
    than one shard, else ``None`` (replicated planes, single-shard
    meshes): the dispatch seam of ``splay_search``, as in the
    reference."""
    mesh = plane_mesh(plane)
    if mesh is None or mesh.axis != axis or mesh.size <= 1:
        return None
    return mesh


def _sharded_cls(plane_cls, mesh: Mesh):
    base = getattr(plane_cls, "_global_cls", plane_cls)
    cls = mesh._plane_classes.get(base)
    if cls is None:
        cls = type(base.__name__, (base,),
                   {"__slots__": (), "mesh": mesh, "_global_cls": base})
        mesh._plane_classes[base] = cls
    return cls


def shard_index_plane(plane, mesh: Optional[Mesh] = None,
                      axis: str = "model"):
    """This rank's block of a global plane on ``mesh`` (the active mesh
    when omitted).  Returns the plane unchanged when no mesh is
    available, ``axis`` is not the mesh's, the width does not divide
    into ``S`` blocks, or it already lies on ``mesh``; a plane laid out
    on another mesh raises ``ValueError`` (gather it on its own mesh
    first)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None or axis not in mesh.shape or axis != mesh.axis:
        return plane
    on = plane_mesh(plane)
    if on is mesh:
        return plane
    if on is not None:
        raise ValueError("the plane is laid out on another mesh")
    width = plane.keys.shape[1]
    if width % mesh.size:
        return plane
    wl = width // mesh.size
    cut = slice(mesh.index * wl, (mesh.index + 1) * wl)
    blocks = []
    for x, spec in zip(plane, index_plane_specs(type(plane), axis)):
        if spec:                      # the width is the last dimension
            x = x[(slice(None),) * (len(spec) - 1) + (cut,)].contiguous()
        blocks.append(x)
    return _sharded_cls(type(plane), mesh)(*blocks)


def gather_index_plane(plane):
    """The global plane of a laid-out one (every rank of its mesh must
    call this); a global plane is returned as it is."""
    mesh = plane_mesh(plane)
    if mesh is None:
        return plane
    cls = type(plane)._global_cls
    return cls(*(torch.cat(list(cl.all_gather(x, mesh)), len(spec) - 1)
                 if spec else x
                 for x, spec in zip(plane, index_plane_specs(cls,
                                                             mesh.axis))))


def suffix_min_bounds(block_firsts: torch.Tensor) -> torch.Tensor:
    """Monotonize per-block first bottom-row keys into the ownership
    boundary table: entry s becomes ``min(block_firsts[s:])``, so an
    empty block's +INF first key never shadows the live blocks to its
    right (on a packed plane only trailing blocks are empty and this is
    the identity).  The sharded refresh routes keys and the sharded
    search routes queries through this one table."""
    rev = torch.flip(block_firsts, (0,))
    return torch.flip(torch.cummin(rev, 0)[0], (0,))


def mass_split_bounds(cum_mass: torch.Tensor, total, n_shards: int,
                      lane_cap: int) -> torch.Tensor:
    """Mass-balanced shard boundaries over a packed sorted row: int32
    ranks ``b[0..S]`` with ``b[0] = 0``, ``b[S] = total``, each segment
    ``[b[s], b[s+1])`` holding at most ``lane_cap`` keys, and the
    interior boundaries at the access-mass quantiles of ``cum_mass``
    (the inclusive prefix sum of per-key mass over the packed row,
    constant past ``total``) as far as the lane cap allows.

    With ``M = cum_mass[-1]``, for ``s = 1 .. S-1`` in turn, in exact
    int32 arithmetic (no product exceeds ``max(M, S*S, S*lane_cap)``):

    * target ``t = (M // S) * s + ((M % S) * s) // S``, which is
      ``floor(s * M / S)`` without the overflow of ``s * M``;
    * ideal ``i = searchsorted(cum_mass, t, side="right")``: the count
      of keys whose inclusive prefix mass stays ``<= t``;
    * ``lo = max(b[s-1], total - (S - s) * lane_cap)`` (the shards
      right of s can still hold the rest) and
      ``hi = min(b[s-1] + lane_cap, total)`` (this segment fits);
    * ``b[s] = min(max(i, lo), hi)``.

    Every rank computes the same table from replicated inputs.  Uniform
    mass puts the boundaries at the equal-lane split."""
    cum_mass = cum_mass.to(torch.int32).contiguous()
    dev = cum_mass.device
    total = torch.as_tensor(total, dtype=torch.int32, device=dev)
    S = int(n_shards)
    M = cum_mass[-1]
    s = torch.arange(1, S, dtype=torch.int32, device=dev)
    tgt = (M // S) * s + ((M % S) * s) // S
    ideal = torch.searchsorted(cum_mass, tgt, right=True, out_int32=True)
    out = [torch.zeros((), dtype=torch.int32, device=dev)]
    for j in range(S - 1):
        b_prev = out[-1]
        lo = torch.maximum(b_prev, total - (S - 1 - j) * lane_cap)
        hi = torch.minimum(b_prev + lane_cap, total)
        out.append(torch.minimum(torch.maximum(ideal[j], lo), hi))
    out.append(total)
    return torch.stack(out).to(torch.int32)
