"""Elastic re-meshing after a failure: the twin of the mesh half of
``repro.train.elastic`` (``viable_grid`` and ``remesh``).

On a fleet a lost node surfaces as a collective that does not return;
recovery rebuilds the mesh from the survivors and re-lays what lived on
it.  Here a mesh is a process group of ranks (``parallel.sharding.Mesh``),
so :func:`remesh` builds the survivors' groups with ``dist.new_group``.
The model-parallel degree stays fixed by the weight shapes; elasticity
comes from the data (and pod) axes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple


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
    :func:`viable_grid`, filled in rank order, each row of
    ``model_parallel`` ranks one process group along ``axis``.

    ``dist.new_group`` is collective over the default group, so every
    rank of it must call this with the same arguments, survivors or
    not.  Returns this rank's :class:`~repro_torch.parallel.sharding.Mesh`
    (its row, on ``device``: the card unless the caller passes
    ``"cpu"``), or ``None`` on a rank outside the grid.
    Raises ``RuntimeError`` when the survivors cannot host
    ``model_parallel``."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import Mesh
    ranks = list(ranks) if ranks is not None else list(
        range(dist.get_world_size()))
    grid = viable_grid(len(ranks), model_parallel, multi_pod)
    if grid is None:
        raise RuntimeError(
            f"{len(ranks)} devices cannot host model_parallel="
            f"{model_parallel}")
    used = ranks[:math.prod(grid)]
    names = ("pod", "data") if len(grid) == 3 else ("data",)
    shape = dict(zip(names, grid[:-1]))
    me = dist.get_rank()
    mesh = None
    for row in range(0, len(used), model_parallel):
        members = used[row:row + model_parallel]
        group = dist.new_group(members)
        if me in members:
            mesh = Mesh(group, axis=axis, device=device,
                        shape=shape)
    return mesh
