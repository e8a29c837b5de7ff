"""Elastic scaling and failure handling: the twin of
``repro.train.elastic``.

On a fleet a lost node surfaces as a collective that does not return.
Recovery rebuilds the mesh from the survivors, re-lays the latest
checkpoint onto it, and resumes:

    mesh   = remesh(survivors, model_parallel)   # largest valid grid
    params = reshard(flat_ckpt, specs, mesh)     # this rank's blocks
    # resume: the same step, on the new mesh

Here a mesh is a process group of ranks per axis
(``parallel.sharding.Mesh``), so :func:`remesh` builds the survivors'
groups with ``dist.new_group``, and :func:`reshard` cuts each rank's
blocks out of the full host arrays, so it works across a change of mesh
shape.  The model-parallel degree stays fixed by the weight shapes;
elasticity comes from the data (and pod) axes, and
:func:`scale_microbatch` keeps the global batch when the data axis
shrinks.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple


def viable_grid(n_devices: int, model_parallel: int,
                multi_pod: bool = False) -> Optional[Tuple[int, ...]]:
    """Largest (pod, data, model) grid fitting n_devices, keeping the
    model axis intact (TP degree is fixed by weight shapes — elasticity
    comes from the data/pod axes)."""
    if n_devices < model_parallel:
        return None
    data = n_devices // model_parallel
    if multi_pod and data % 2 == 0:
        return (2, data // 2, model_parallel)
    return (data, model_parallel)


def remesh(ranks: Optional[Sequence[int]] = None, model_parallel: int = 16,
           multi_pod: bool = False, device="cuda", axis: str = "model"):
    """The mesh of the surviving ``ranks`` (global ranks of the default
    process group; all of them when omitted): the largest
    :func:`viable_grid`, filled in rank order (row-major, ``axis`` the
    fastest).  Each axis of more than one rank gets a process group per
    line of the grid along it: the rows of ``model_parallel`` ranks
    along ``axis``, and the columns along ``data`` (and ``pod``).

    ``dist.new_group`` is collective over the default group, so every
    rank of it must call this with the same arguments, survivors or
    not.  Returns this rank's :class:`~repro_torch.parallel.sharding.Mesh`
    (on ``device``: the card unless the caller passes ``"cpu"``), or
    ``None`` on a rank outside the grid.  Raises ``RuntimeError`` when
    the survivors cannot host ``model_parallel``."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import Mesh
    ranks = list(ranks) if ranks is not None else list(
        range(dist.get_world_size()))
    grid = viable_grid(len(ranks), model_parallel, multi_pod)
    if grid is None:
        raise RuntimeError(
            f"{len(ranks)} devices cannot host model_parallel="
            f"{model_parallel}")
    names = (("pod", "data") if len(grid) == 3 else ("data",)) + (axis,)
    used = ranks[:math.prod(grid)]
    pos = {r: _coords(i, grid) for i, r in enumerate(used)}
    me = dist.get_rank()
    groups = {}
    for k, name in enumerate(names):
        if grid[k] == 1 and name != axis:
            continue
        # one group per line of the grid along this axis, in a fixed
        # order (the rows along ``axis`` even of one rank each: the mesh
        # needs its own group)
        for rest in itertools.product(*(range(n) for j, n in
                                        enumerate(grid) if j != k)):
            members = [r for r in used
                       if pos[r][:k] + pos[r][k + 1:] == rest]
            group = dist.new_group(members)
            if me in members:
                groups[name] = group
    if me not in pos:
        return None
    return Mesh(groups.pop(axis), axis=axis, device=device,
                shape=dict(zip(names[:-1], grid[:-1])),
                coords=dict(zip(names[:-1], pos[me][:-1])), groups=groups)


def _coords(i: int, grid: Sequence[int]) -> Tuple[int, ...]:
    """The row-major coordinates of the ``i``-th cell of ``grid``."""
    out = []
    for n in reversed(grid):
        i, c = divmod(i, n)
        out.append(c)
    return tuple(reversed(out))


def reshard(flat_host: Dict[str, object], spec_tree_flat: Dict,
            mesh) -> Dict[str, "torch.Tensor"]:
    """This rank's blocks of a flat host tree (numpy arrays or CPU
    tensors, memory-mapped ones included) laid out by their specs
    (replicated where ``spec_tree_flat`` has none) on ``mesh``, on the
    mesh's device: the twin of the reference's ``device_put`` of each
    array.  Each block is cut from the full host array, so this works
    across a change of mesh shape, and only the block is copied."""
    from repro_torch.parallel import sharding as shd
    return {name: shd.shard_tensor(arr, spec_tree_flat.get(name, ()), mesh)
            for name, arr in flat_host.items()}


def scale_microbatch(global_batch: int, old_data: int, new_data: int,
                     microbatch: int) -> int:
    """Preserve the global batch across a data-axis shrink by
    accumulating more microbatches: losing data-parallel ranks changes
    throughput, not the optimization."""
    if new_data >= old_data:
        return microbatch
    factor = math.ceil(old_data / new_data)
    return microbatch * factor
