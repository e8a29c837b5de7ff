"""Logical-axis sharding and the width-sharded index plane, for SPMD
over ``torch.distributed`` (one process per rank): the twin of
``repro.parallel.sharding``.

**Logical axes.**  Model code names each tensor dimension with a
*logical* axis (``"batch"``, ``"heads"``, ``"mlp"``, ...).  A rule table
(:func:`default_rules`) maps the names to mesh axes, and
:func:`resolve_spec` turns a shape and its names into a ``PartitionSpec``
twin: a tuple with one entry per dimension (``None``, an axis name, or
a tuple of names), trailing ``None`` entries dropped.  Resolution never
raises: an unknown name, a rule axis absent from the mesh, a dimension
the axis product does not divide, and an axis an earlier dimension
already took each resolve to replication for that dimension, as in the
reference.

In the reference a spec is a placement of one global array; here each
rank holds its *block*.  :func:`shard_tensor` cuts a global tensor into
this rank's block (the twin of ``device_put(x, NamedSharding(mesh,
spec))``); :func:`relayout` moves a block from one spec to another
(all-gathers where a dimension loses an axis, slices where it gains
one); :func:`constrain` is the reference's layout constraint on a
replicated tensor (this rank's view of it), and :func:`gather_param`
its ZeRO-3 gather of the ``fsdp`` axes.  A :class:`LaidOutTree` is a
parameter tree (or a decode cache) of blocks that carries its mesh,
spec tree and rules (:func:`tree_mesh`), as a laid-out plane carries
its mesh.  A :class:`SeqBlock` is this rank's block of a sequence
dimension, decided by :func:`resolve_spec` on the tensor's own shape
(:func:`seq_block`: the divisibility fallback keeps a length whole
where the axes do not divide it); :func:`seq_take`, :func:`seq_gather`
and :func:`seq_move` cut, gather and re-lay such a block.

**The index plane.**  A :class:`Mesh` is one rank's view of the mesh:
its axis sizes (``shape``), its coordinate on each axis (``coords``),
a process group per axis of more than one rank (``groups``), the main
axis (``axis``, ``"model"`` unless the caller names another) with its
group ``group``, size ``size`` and this rank's index ``index``, and
its device.  The ``mesh=`` arguments of the port take it, and a
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
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import collectives as cl

Rules = Dict[Optional[str], Optional[Tuple[str, ...]]]
Spec = Tuple              # one entry a dimension: None, a name, a tuple


class Mesh:
    """One rank's view of a mesh of ranks: ``shape`` maps axis names to
    sizes as ``jax.sharding.Mesh.shape`` does, ``coords`` gives this
    rank's index on each axis, and ``groups`` the process group of each
    axis of more than one rank (the ranks that differ from this one on
    that axis only; ``None`` is the default group).  ``axis`` is the
    main axis (``group``, ``size`` and ``index`` are its), the one the
    index plane is width-sharded over.  Without ``shape`` the mesh is
    ``{"data": 1, axis: S}``.  ``device`` is the card unless the caller
    asks for the CPU."""

    def __init__(self, group=None, axis: str = "model", device="cuda",
                 shape: Optional[dict] = None,
                 coords: Optional[dict] = None,
                 groups: Optional[dict] = None):
        import torch.distributed as dist
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.shape = dict(shape) if shape else {"data": 1}
        self.shape[axis] = self.size
        self.coords = {a: 0 for a in self.shape}
        self.coords.update(coords or {})
        self.coords[axis] = self.index
        self.groups = dict(groups or {})
        self.groups[axis] = group
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        self.ranks = (dist.get_process_group_ranks(group)
                      if group is not None
                      else list(range(dist.get_world_size())))
        self._plane_classes = {}

    def axis_group(self, axis: str):
        """The process group of ``axis`` (``None``: the default group).
        Raises ``ValueError`` for an axis of more than one rank whose
        group this mesh was not given."""
        if axis not in self.groups:
            raise ValueError(f"{self!r} has no process group for axis "
                             f"{axis!r}")
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"backend={self.backend}, device={self.device})")


class AbstractMesh:
    """A mesh's axis names and sizes, the twin of
    ``jax.sharding.AbstractMesh``: enough to resolve specs
    (:func:`resolve_spec`, ``layers.axes_to_specs``) for a mesh no rank
    belongs to.  It also stands for its rank 0, on the ``meta`` device
    and in no process group: a pass over ``meta`` blocks laid out on it
    computes shapes only, and its collectives call nothing
    (``collectives``; a tensor on a real device is refused there), which
    is how the dry-run counts a rank's step."""

    backend = "meta"
    axis = "model"

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.coords = {a: 0 for a in self.shape}
        self.device = torch.device("meta")

    def axis_group(self, axis: str):
        raise ValueError(f"{self!r} has no process group (axis {axis!r}): "
                         f"it computes on meta tensors only")

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def check_mesh(mesh) -> None:
    """Refuse a ``mesh=`` argument that is not a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a repro_torch.parallel.sharding.Mesh,"
                        f" got {type(mesh).__name__}")


def world_mesh(device="cuda", axis: str = "model") -> Mesh:
    """The mesh of every rank of the default process group, all on
    ``axis``."""
    return Mesh(None, axis=axis, device=device)


# -- default rule tables -----------------------------------------------------

def default_rules(multi_pod: bool = False,
                  seq_sharded: bool = False,
                  fsdp: bool = True) -> Rules:
    """The reference's rule table, name for name: data parallel over
    ``data`` (and ``pod`` on a multi-pod mesh), tensor parallel over
    ``model``, ``fsdp`` the ZeRO-style second axis of a weight."""
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": ("data",) if seq_sharded else None,
        "kvseq": ("data",) if seq_sharded else None,
        "cp_seq": None,   # sequence-parallel residual stream
        "cp_q": None,     # context-parallel attention q
        "embed": None,
        "heads": ("model",),
        "kv": ("model",),
        "head_dim": None,
        "mlp": ("model",),
        "expert": ("model",),
        "expert_cap": None,
        "vocab": ("model",),
        "fsdp": dp if fsdp else None,
        "layers": None,
        "ssm_heads": ("model",),
        "ssm_proj": ("model",),
        "state": None,
        "conv": None,
        "frames": None,
        # the splay index plane: levels replicated, width over model
        "splay_level": None,
        "splay_width": ("model",),
        None: None,
    }


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Rules = {}


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[Rules] = None):
    """Make ``(mesh, rules)`` the active pair (``mesh=None``: none, and
    every constraint is the identity) for logical-axis resolution and
    the sharded entry points that resolve a mesh; thread-local and
    reentrant, the previous pair restored on exit even when the body
    raises.  Without ``rules`` the table is empty: every name resolves
    to replication, as in the reference."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, (rules or {})
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def active_rules() -> Rules:
    return _CTX.rules


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name, or a tuple of
    names) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, axes: Sequence[str]) -> int:
    """The number of blocks a dimension split over ``axes`` has."""
    return math.prod(mesh.shape[a] for a in axes)


def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 mesh=None, rules: Optional[Rules] = None) -> Spec:
    """Logical names -> the spec of ``shape`` on ``mesh`` (the active
    mesh and rules when omitted; ``()`` without a mesh).  ``mesh`` is
    anything with a ``shape`` dict (:class:`Mesh`,
    :class:`AbstractMesh`).  A mesh axis is used once (the first
    dimension wins); unknown names, rule axes absent from the mesh and
    indivisible dimensions resolve to ``None``."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    if mesh is None:
        return ()
    used = set()
    out = []
    for dim, name in zip(shape, names):
        axes = rules.get(name) if name is not None else None
        if not axes:
            out.append(None)
            continue
        axes = tuple(a for a in axes if a in mesh.shape and a not in used)
        if not axes or dim % axes_size(mesh, axes) != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the twin of ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: Spec


def named_sharding(shape: Sequence[int],
                   names: Sequence[Optional[str]]
                   ) -> Optional[NamedSharding]:
    """The active mesh with the spec ``names`` resolve to, or ``None``
    without an active mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve_spec(shape, names))


def block_index(axes: Sequence[str], mesh) -> int:
    """This rank's block along a dimension split over ``axes``: its
    coordinates on them, row-major (the last axis fastest), as a
    ``NamedSharding`` numbers a dimension's blocks."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def block_slices(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The index of this rank's block of a global ``shape`` laid out by
    ``spec`` on ``mesh``: one slice a dimension."""
    out = []
    for d, n in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        if not axes:
            out.append(slice(None))
            continue
        k = axes_size(mesh, axes)
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide into {k} blocks over {axes}")
        size = n // k
        i = block_index(axes, mesh)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def global_shape(local_shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The global shape of a block laid out by ``spec``."""
    return tuple(n * (axes_size(mesh, entry_axes(spec[d]))
                      if d < len(spec) else 1)
                 for d, n in enumerate(local_shape))


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """The shape of a rank's block of a global ``shape`` laid out by
    ``spec`` (the inverse of :func:`global_shape`)."""
    return tuple(n // (axes_size(mesh, entry_axes(spec[d]))
                       if d < len(spec) else 1)
                 for d, n in enumerate(shape))


class SeqBlock(NamedTuple):
    """This rank's block of a sequence of ``length`` positions (a
    tensor's dimension) laid out over the mesh ``axes`` (``()``: whole
    on every rank): positions ``start .. start + size``."""
    axes: Tuple[str, ...]
    length: int
    start: int
    size: int


def whole_seq(length: int) -> SeqBlock:
    return SeqBlock((), int(length), 0, int(length))


def seq_block(shape: Sequence[int], names: Sequence[Optional[str]],
              dim: int = 1, mesh=None, rules: Optional[Rules] = None
              ) -> SeqBlock:
    """This rank's block of dimension ``dim`` of a tensor of global
    ``shape`` whose dimensions ``names`` name, laid out as
    :func:`resolve_spec` resolves them on that shape under ``(mesh,
    rules)`` (the active pair when omitted): the divisibility fallback
    keeps a sequence whole where its length does not divide."""
    mesh = mesh if mesh is not None else _CTX.mesh
    n = int(shape[dim])
    if mesh is None:
        return whole_seq(n)
    spec = resolve_spec(shape, names, mesh, rules)
    axes = entry_axes(spec[dim]) if dim < len(spec) else ()
    if not axes:
        return whole_seq(n)
    size = n // axes_size(mesh, axes)
    return SeqBlock(axes, n, block_index(axes, mesh) * size, size)


def seq_take(x: torch.Tensor, blk: SeqBlock, dim: int = 1) -> torch.Tensor:
    """This rank's block ``blk`` of the whole sequence ``x`` (a view)."""
    if not blk.axes:
        return x
    return x.narrow(dim, blk.start, blk.size)


def gather_dim(x: torch.Tensor, axes: Sequence[str], dim: int,
               mesh=None) -> torch.Tensor:
    """Dimension ``dim`` of ``x``, split over ``axes`` (of the active
    mesh when ``mesh`` is omitted), gathered whole: one all-gather an
    axis (a collective over them)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    for a in reversed(axes):           # the last axis is the fastest
        x = torch.cat(list(cl.all_gather(x, mesh, axis=a)), dim)
    return x


def seq_gather(x: torch.Tensor, blk: SeqBlock, dim: int = 1,
               mesh=None) -> torch.Tensor:
    """The whole sequence from every rank's block ``x`` laid out as
    ``blk`` (:func:`gather_dim` over its axes)."""
    return gather_dim(x, blk.axes, dim, mesh)


def seq_move(x: torch.Tensor, src: SeqBlock, dst: SeqBlock, dim: int = 1,
             mesh=None) -> torch.Tensor:
    """This rank's block ``x`` of a sequence laid out as ``src``, laid
    out as ``dst`` instead (the same sequence)."""
    if src.axes == dst.axes:
        return x
    return seq_take(seq_gather(x, src, dim, mesh), dst, dim)


def shard_tensor(x, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` (a tensor on any device or
    a numpy array) laid out by ``spec``, a new contiguous tensor on
    ``mesh.device``: the twin of ``jax.device_put(x,
    NamedSharding(mesh, spec))``.  Only the block is copied."""
    block = x[block_slices(x.shape, spec, mesh)]
    if not isinstance(block, torch.Tensor):
        import numpy as np
        block = torch.from_numpy(np.array(block))
    out = torch.empty(block.shape, dtype=block.dtype, device=mesh.device)
    out.copy_(block)
    return out


def relayout(x: torch.Tensor, spec_in: Spec, spec_out: Spec,
             mesh=None) -> torch.Tensor:
    """This rank's block ``x`` of a tensor laid out by ``spec_in``, in
    the layout ``spec_out`` (the active mesh when omitted): a dimension
    that loses mesh axes is all-gathered over them, one that gains axes
    is sliced.  A collective over every axis gathered: each rank of
    those axes' groups must call it."""
    mesh = mesh if mesh is not None else _CTX.mesh
    for d in range(x.dim()):
        a_in = entry_axes(spec_in[d]) if d < len(spec_in) else ()
        a_out = entry_axes(spec_out[d]) if d < len(spec_out) else ()
        if a_in == a_out:
            continue
        for a in reversed(a_in):       # the last axis is the fastest
            x = torch.cat(list(cl.all_gather(x, mesh, axis=a)), d)
        if a_out:
            k = axes_size(mesh, a_out)
            size = x.shape[d] // k
            x = x.narrow(d, block_index(a_out, mesh) * size, size)
    return x.contiguous()


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's layout constraint on a replicated ``x`` (every
    rank holds all of it): this rank's view of ``x`` in the layout
    ``names`` resolve to under the active (mesh, rules).  A layout,
    never a value; the identity without an active mesh.  One name per
    dimension (trailing ones may be left out)."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    sl = block_slices(x.shape, resolve_spec(x.shape, names), mesh)
    return x[sl]


def gather_param(w: torch.Tensor, *storage_names: Optional[str],
                 spec: Spec) -> torch.Tensor:
    """ZeRO-3: this rank's block ``w`` of a weight stored in the layout
    ``spec`` (what ``storage_names`` resolved to when it was laid out),
    with its ``fsdp`` dimension all-gathered: the block of the layout
    ``storage_names`` resolve to with ``fsdp`` replaced by ``None``
    (the tensor-parallel axes kept), under the active (mesh, rules).
    The identity without an active mesh.  A collective over the
    gathered axes when they hold more than one rank."""
    mesh = _CTX.mesh
    if mesh is None:
        return w
    names = [None if n == "fsdp" else n for n in storage_names]
    out = resolve_spec(global_shape(w.shape, spec, mesh), names)
    if tuple(spec) == out:
        return w
    return relayout(w, spec, out, mesh)


class LaidOutTree(dict):
    """A parameter tree of this rank's blocks: a dict of the leaves'
    blocks (nested dicts for nested trees) that also carries the
    ``mesh``, the spec tree ``specs`` (the same keys) and the ``rules``
    it was laid out by.  The model and the engine find the layout on the
    tree (:func:`tree_mesh`), as the search finds a plane's."""

    def __init__(self, blocks: dict, specs: dict, mesh: Mesh,
                 rules: Optional[Rules] = None):
        super().__init__(blocks)
        self.specs = specs
        self.mesh = mesh
        self.rules = rules if rules is not None else default_rules()

    def with_blocks(self, blocks: dict) -> "LaidOutTree":
        """Other blocks of the same keys in this tree's layout (the
        gradients, the optimizer's moments): ``core.tree``'s maps keep
        the layout through it."""
        return LaidOutTree(blocks, self.specs, self.mesh, self.rules)


def spec_leaves(specs) -> list:
    """The specs of a spec tree (nested dicts of specs, the keys of a
    parameter tree) in ``core.tree.leaves`` order: sorted keys."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [tuple(specs)]


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits its tensor over, in dimension
    order."""
    return tuple(a for e in spec for a in entry_axes(e))


def psum_grouped(tensors: Sequence[torch.Tensor], axes: Sequence[tuple],
                 mesh) -> list:
    """``tensors[i]`` summed over the mesh axes ``axes[i]`` (none for an
    empty tuple).  The tensors that sum over the same axes in one dtype
    go in one float32 buffer, summed an axis at a time and rounded once
    to their dtype."""
    groups: Dict[tuple, list] = {}
    for i, (t, ax) in enumerate(zip(tensors, axes)):
        if ax:
            groups.setdefault((tuple(ax), t.dtype), []).append(i)
    out = list(tensors)
    for (ax, dtype), idx in groups.items():
        buf = torch.cat([tensors[i].reshape(-1).float() for i in idx])
        for a in ax:
            buf = cl.psum(buf, mesh, a)
        sizes = [tensors[i].numel() for i in idx]
        for i, part in zip(idx, buf.split(sizes)):
            out[i] = part.reshape(tensors[i].shape).to(dtype)
    return out


def tree_mesh(tree) -> Optional[Mesh]:
    """The mesh a parameter tree is laid out on, or ``None`` for a
    global tree."""
    return tree.mesh if isinstance(tree, LaidOutTree) else None


def lay_out(tree: dict, specs: dict, mesh: Mesh,
            rules: Optional[Rules] = None) -> LaidOutTree:
    """This rank's blocks of a global parameter tree (leaves on any
    device, or numpy), laid out by the spec tree ``specs``
    (``layers.axes_to_specs``) on ``mesh``, on ``mesh.device``."""
    def cut(t, s):
        return {k: cut(v, s[k]) if isinstance(v, dict)
                else shard_tensor(v, s[k], mesh) for k, v in t.items()}
    return LaidOutTree(cut(tree, specs), specs, mesh, rules)


def constrain_index_plane(plane):
    """The splay index plane in the layout its rules give under the
    active mesh: width-sharded over the mesh's axis
    (:func:`shard_index_plane`) when ``"splay_width"`` resolves to it,
    the plane as it is otherwise and without an active mesh, so serving
    loops can call it unconditionally.  An indivisible width stays
    replicated."""
    mesh = _CTX.mesh
    if mesh is None:
        return plane
    axes = _CTX.rules.get("splay_width") or ()
    if tuple(axes) != (getattr(mesh, "axis", None),):
        return plane
    return shard_index_plane(plane, mesh, mesh.axis)


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
