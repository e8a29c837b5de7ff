"""Crash-consistent serving snapshots: the twin of
``repro.serve.snapshot`` (meshless), in the same format, so a snapshot
written by either package restores in the other.

One snapshot serializes the whole serving state: the splay
``SplayState``, the device index plane, the route controller's config
and carry, the ``PagedKVPool``'s page metadata and **pending-op
buffer**, and the ``Engine``'s request queue, through
``train.checkpoint.CheckpointManager`` (atomic tmp+rename publish,
per-array SHA-256).  Array leaves ride the manager's npy path; the
host-side rest (controller, chains, pending ops, queue, stats) rides
the manifest's ``extra`` JSON, so one ``step_N/`` directory is one
self-contained, integrity-checked snapshot.

Crash-replay contract: mutations buffer in ``pool._pending`` until the
next lookup's flush.  A snapshot taken between ops captures that
buffer verbatim, and restore re-injects it into a fresh ``_pending``:
the buffered ops apply on the next flush exactly once (the flush that
applies them empties the buffer before its epoch runs, so a later
snapshot sees them gone).  Verdicts after a restore are bit-identical
to the uninterrupted run's, because membership is a function of the
live-key set alone, which the state arrays and the replayed buffer
reproduce exactly.

A pool on a mesh has its plane gathered whole into the snapshot, which
the mesh's first rank writes while the mesh's other ranks wait (every
rank of the pool's mesh calls :func:`save_serving_snapshot`, and no
other rank takes part); a pool without a mesh writes its own snapshot
with no collective.  The restored pool's
tensors live on ``device`` (the mesh's device, else the card).  A
snapshot restores onto any mesh by the reference's rule: the saved
plane is laid out again when the target is meshless and it is packed,
or the target is sharded and it is packed or segmented over as many
shards; anything else (a segmented plane onto another shard count) is
rebuilt from the restored state.  The controller continues when the
shard count is the same and starts afresh otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager

SNAPSHOT_FORMAT = 1


def _engine_state(engine) -> Dict[str, Any]:
    """JSON-safe dump of the engine's serving position: clock,
    counters, latency ledger, and the waiting request queue (prompts
    as int lists)."""
    return {
        "clock": int(engine.clock),
        "tokens_out": int(engine.tokens_out),
        "stalls": int(engine.stalls),
        "preemptions": int(engine.preemptions),
        "degraded_retries": int(getattr(engine, "degraded_retries", 0)),
        "latencies": {str(k): float(v)
                      for k, v in engine.latencies.items()},
        "queue": [{
            "seq_id": int(r.seq_id),
            "prompt": [int(t) for t in np.asarray(r.prompt).ravel()],
            "max_new": int(r.max_new),
            "arrival": int(r.arrival),
        } for r in engine.queue],
    }


def apply_engine_state(engine, state: Optional[Dict[str, Any]]) -> None:
    """Rehydrate an ``Engine`` from :func:`_engine_state` output: the
    restored engine resumes admission from the same clock with the
    same waiting queue (requests re-enter in order)."""
    if not state:
        return
    from repro_torch.serve.engine import Request
    engine.clock = int(state["clock"])
    engine.tokens_out = int(state["tokens_out"])
    engine.stalls = int(state["stalls"])
    engine.preemptions = int(state["preemptions"])
    engine.degraded_retries = int(state.get("degraded_retries", 0))
    engine.latencies = {int(k): float(v)
                        for k, v in state["latencies"].items()}
    engine.queue.clear()
    for q in state["queue"]:
        engine.queue.append(Request(
            seq_id=int(q["seq_id"]),
            prompt=np.asarray(q["prompt"], np.int32),
            max_new=int(q["max_new"]), arrival=int(q["arrival"])))


def save_serving_snapshot(mgr: CheckpointManager, step: int, pool,
                          engine=None, user_extra: Optional[dict] = None,
                          blocking: bool = True) -> None:
    """Publish one crash-consistent snapshot of the serving stack at
    ``step``.  Device pools snapshot their state + plane tensors;
    host pools are metadata-only (the host index is rebuilt from
    ``chains`` on restore).  ``user_extra`` rides along verbatim.
    With ``blocking=False`` this returns once the tensors are on the
    host, and ``mgr.wait()`` waits for the write.  For a pool on a mesh
    every rank of ``pool.mesh`` calls this and the mesh's first rank
    writes; with ``blocking`` the call returns on each of them once the
    write is complete (a barrier over the mesh's group)."""
    pool_meta: Dict[str, Any] = {
        "device": bool(pool.device),
        "n_pages": int(pool.n_pages),
        "page_size": int(pool.page_size),
        "max_level": int(pool._max_level),
        "p": float(pool._p),
        "free": [int(x) for x in pool.free],
        "chains": {str(k): [int(x) for x in v]
                   for k, v in pool.chains.items()},
        "lengths": {str(k): int(v) for k, v in pool.lengths.items()},
        "stats": {k: int(v) for k, v in pool.stats.items()},
    }
    params: Dict[str, Any] = {}
    controller = None
    if pool.device:
        from repro_torch.core import device_index as dix
        from repro_torch.core import route_controller as rc
        from repro_torch.parallel import sharding as shd
        params = {"splay": pool._st,
                  "plane": shd.gather_index_plane(pool._plane)}
        controller = rc.controller_to_dict(pool.ctrl_cfg, pool.ctrl)
        pool_meta.update({
            "index_width": int(pool.index_width),
            "index_batch": int(pool.index_batch),
            "axis": pool.axis,
            "pending": [[int(op), int(key)]
                        for op, key in pool._pending],
            "rebuild_pending": bool(pool._rebuild_pending),
            "pressed": bool(pool._pressed),
            "rung": int(pool._rung),
            "audit_every": int(pool.audit_every),
            "lookup_no": int(pool._lookup_no),
            "segmented": bool(dix.plane_is_segmented(pool._plane)),
            "n_shards": (int(pool.mesh.shape[pool.axis])
                         if pool.mesh is not None else 1),
        })
    extra = {
        "snapshot_format": SNAPSHOT_FORMAT,
        "pool": pool_meta,
        "controller": controller,
        "engine": _engine_state(engine) if engine is not None else None,
        "user": user_extra or {},
    }
    mesh = getattr(pool, "mesh", None)
    if mesh is None:
        mgr.save(step, params, extra=extra, blocking=blocking)
        return
    import torch.distributed as dist
    if dist.get_rank() == mesh.ranks[0]:
        mgr.save(step, params, extra=extra, blocking=blocking)
    if blocking:
        dist.barrier(group=mesh.group)


def restore_serving_snapshot(mgr: CheckpointManager,
                             step: Optional[int] = None, mesh=None,
                             axis: Optional[str] = None,
                             audit_every: Optional[int] = None,
                             fault_plan=None, device=None
                             ) -> Tuple[Any, Optional[dict], str]:
    """Load the latest (or ``step``) snapshot and rebuild the pool on
    ``mesh`` (``None``: meshless; a shrunk ``train.elastic.remesh`` mesh
    re-lays or rebuilds the plane as the module docstring says; every
    rank of the mesh calls this), its tensors on ``device`` (default: the
    mesh's device, else the card).  Returns ``(pool,
    engine_state, summary)``: feed ``engine_state`` to
    :func:`apply_engine_state` after constructing the engine around the
    restored pool, and print ``summary`` so restores are visible in
    logs.  ``audit_every``/``fault_plan`` override the restored pool's
    fault-tolerance knobs (a restored machine usually wants auditing on
    and the crashed plan off)."""
    from repro_torch.core import convert
    from repro_torch.core import device_index as dix
    from repro_torch.core import route_controller as rc
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.kv_cache import PagedKVPool

    shd.check_mesh(mesh)
    if device is None:
        device = mesh.device if mesh is not None else "cuda"

    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no serving snapshot in {mgr.dir}")
    flat, extra = mgr.load(step)
    if extra.get("snapshot_format") != SNAPSHOT_FORMAT:
        raise ValueError(
            f"step {step} is not a serving snapshot "
            f"(format={extra.get('snapshot_format')!r})")
    p = extra["pool"]
    audit_every = (int(p.get("audit_every", 0))
                   if audit_every is None else int(audit_every))
    if not p["device"]:
        pool = PagedKVPool(p["n_pages"], p["page_size"],
                           max_level=p["max_level"], p=p["p"],
                           device=False)
        _apply_pool_meta(pool, p)
        for sid in sorted(pool.chains):
            pool.index.insert(int(sid))
        summary = (f"restored host-pool snapshot step {step}: "
                   f"{len(pool.chains)} live sessions")
        return pool, extra.get("engine"), summary

    axis = axis if axis is not None else p.get("axis", "model")
    width = int(p["index_width"])
    s_saved = int(p.get("n_shards", 1))
    s_new = (int(mesh.shape[axis])
             if mesh is not None and axis in mesh.shape else 1)
    if mesh is not None and width % s_new:
        # indivisible target: restore replicated (rebuilt below)
        mesh, s_new = None, 1
    pool = PagedKVPool(p["n_pages"], p["page_size"],
                       max_level=p["max_level"], p=p["p"], device=True,
                       index_width=width,
                       index_batch=int(p["index_batch"]), mesh=mesh,
                       axis=axis, audit_every=audit_every,
                       fault_plan=fault_plan, torch_device=device)
    _apply_pool_meta(pool, p)
    pool._st = convert.state_from_numpy(
        {f: flat[f"params/splay/{f}"] for f in pool._st._fields},
        device=device)
    # the saved arrays are laid out again when the target is meshless
    # and the plane packed, or the target sharded and the plane packed
    # or segmented over as many shards; anything else is rebuilt from
    # the just restored, authoritative state
    segmented = bool(p.get("segmented", False))
    relay = ((s_new == 1 and not segmented)
             or (s_new > 1 and (not segmented or s_new == s_saved)))
    if relay:
        pool._plane = convert.plane_from_numpy(
            {f: flat[f"params/plane/{f}"]
             for f in dix.DeviceLevelArrays._fields}, device=device)
    else:
        pool._plane = dix.from_state_device(
            pool._st, n_levels=p["max_level"], width=width)
    if s_new > 1:
        pool._plane = shd.shard_index_plane(pool._plane, mesh, axis)
    pool._pending = [(int(op), int(key)) for op, key in p["pending"]]
    pool._rebuild_pending = bool(p["rebuild_pending"])
    pool._pressed = bool(p["pressed"])
    pool._rung = int(p.get("rung", 0))
    pool._lookup_no = int(p.get("lookup_no", 0))
    ctrl = extra.get("controller")
    if ctrl is not None and s_new == s_saved:
        # same shard count: the controller continues its ladder and
        # backoff streaks bit-identically
        pool.ctrl_cfg, pool.ctrl = rc.controller_from_dict(ctrl)
    # else: __init__ already initialized it for the new shard count
    summary = (f"restored serving snapshot step {step}: "
               f"{len(pool.chains)} live sessions, "
               f"{len(pool._pending)} pending ops, "
               f"shards {s_saved}->{s_new}, "
               f"plane {'re-laid' if relay else 'rebuilt'}")
    return pool, extra.get("engine"), summary


def _apply_pool_meta(pool, p: Dict[str, Any]) -> None:
    pool.free = [int(x) for x in p["free"]]
    pool.chains = {int(k): [int(x) for x in v]
                   for k, v in p["chains"].items()}
    pool.lengths = {int(k): int(v) for k, v in p["lengths"].items()}
    pool.stats.update({k: int(v) for k, v in p["stats"].items()})


__all__ = [
    "SNAPSHOT_FORMAT", "save_serving_snapshot",
    "restore_serving_snapshot", "apply_engine_state",
]
