"""Seeded fault plans for the serving stack: the twin of
``repro.core.faults``.

A :class:`FaultPlan` is a seeded schedule of :class:`FaultEvent`\\ s
keyed by the pool's lookup-epoch counter; ``serve.kv_cache.PagedKVPool``
consults it between the mutation flush and the lookup answer and fires
each event once.  Four families:

``FAULT_BITFLIP``     flip ``arg`` random low bits in live lanes of the
                      device plane (keys / heights / rank_map /
                      bot_rank), leaving the state alone: the plane
                      audit must catch the divergence;
``FAULT_SHARD_LOSS``  shrink the serving mesh to ``arg`` shards; the pool
                      rebuilds the plane from the state;
``FAULT_TELEMETRY``   starve the routing controller of its feedback for
                      ``arg`` epochs (zero spill, stale occupancy);
``FAULT_CRASH``       raise :class:`InjectedCrash` between flush and
                      lookup.

Every event draws from ``numpy.random.default_rng`` seeded by
``(plan.seed, epoch, event index)``, so a plan replayed against the same
trace injects the same corruption, bit for bit, in either package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.device_index import PAD_KEY

FAULT_BITFLIP = "bitflip"
FAULT_SHARD_LOSS = "shard_loss"
FAULT_TELEMETRY = "telemetry"
FAULT_CRASH = "crash"

FAULT_FAMILIES = (FAULT_BITFLIP, FAULT_SHARD_LOSS, FAULT_TELEMETRY,
                  FAULT_CRASH)

# plane fields a bit-flip may target (the descent arrays and the bottom
# height vector)
BITFLIP_FIELDS = ("keys", "heights", "rank_map", "bot_rank")


class InjectedFault(RuntimeError):
    """Base class of the faults a ``FaultPlan`` raises on purpose."""


class InjectedCrash(InjectedFault):
    """Mid-epoch kill between mutation flush and lookup answer."""


class FaultEvent(NamedTuple):
    """One scheduled fault, fired when the pool's lookup-epoch counter
    reaches ``epoch``.  ``arg``: bit-flip count, surviving shard count
    or blackout epochs; unused for ``crash``."""
    epoch: int
    family: str
    arg: int = 1


class FaultPlan:
    """A deterministic, seeded, immutable schedule of fault events.
    ``events_at(epoch)`` returns that epoch's events in schedule order;
    ``rng_for(event)`` hands each its own generator."""

    def __init__(self, seed: int = 0,
                 events: Sequence[FaultEvent] = ()):
        self.seed = int(seed)
        evs = []
        for ev in events:
            ev = FaultEvent(int(ev[0]), str(ev[1]), int(ev[2])
                            if len(ev) > 2 else 1)
            if ev.family not in FAULT_FAMILIES:
                raise ValueError(f"unknown fault family {ev.family!r} "
                                 f"(choose from {FAULT_FAMILIES})")
            if ev.epoch < 0:
                raise ValueError(f"fault epoch must be >= 0: {ev}")
            evs.append(ev)
        self.events: List[FaultEvent] = sorted(
            evs, key=lambda e: e.epoch)

    def events_at(self, epoch: int) -> List[FaultEvent]:
        return [e for e in self.events if e.epoch == int(epoch)]

    def rng_for(self, event: FaultEvent) -> np.random.Generator:
        # by identity first: two equal events (two bitflips at one
        # epoch) must still draw distinct streams
        for i, e in enumerate(self.events):
            if e is event:
                return np.random.default_rng([self.seed, event.epoch, i])
        idx = self.events.index(event)
        return np.random.default_rng([self.seed, event.epoch, idx])

    def families(self) -> List[str]:
        return sorted({e.family for e in self.events})

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, "
                f"events={len(self.events)})")


def flip_plane_bits(plane, rng: np.random.Generator, n_flips: int = 1,
                    fields: Sequence[str] = BITFLIP_FIELDS):
    """Return ``(corrupted_plane, records)``: ``n_flips`` single-bit
    XORs into live lanes of the plane, each logged as ``(field,
    index_tuple, bit)``.  Only live lanes (pad entries of ``bot_rank``
    are unspecified) and bits 0..15 (a flipped key stays in range); a
    height flip targets a lane below the top row when there is one.
    The flips are made on numpy copies and the corrupted fields go back
    to the plane's device with their dtype; the plane passed in is left
    as it was.  A plane laid out on a mesh is flipped whole (every rank
    of the mesh gathers it, draws the same flips from its copy of
    ``rng`` and keeps its own block of the result)."""
    from repro_torch.parallel import sharding as shd
    mesh = shd.plane_mesh(plane)
    if mesh is not None:
        flipped, records = flip_plane_bits(shd.gather_index_plane(plane),
                                           rng, n_flips, fields)
        return shd.shard_index_plane(flipped, mesh, mesh.axis), records
    plane_np = {f: getattr(plane, f).cpu().numpy().copy() for f in fields}
    keys = plane.keys.cpu().numpy()
    L, _ = keys.shape
    live = keys != PAD_KEY
    records = []
    for _ in range(int(n_flips)):
        field = fields[int(rng.integers(len(fields)))]
        arr = plane_np[field]
        if arr.ndim == 2:
            rows, cols = np.nonzero(live if field != "rank_map"
                                    else live[:-1])
            if rows.size == 0:
                continue
            pick = int(rng.integers(rows.size))
            idx = (int(rows[pick]), int(cols[pick]))
        else:
            cols = np.nonzero(live[L - 1])[0]
            if field == "heights":
                h = plane.heights.cpu().numpy()
                unsat = cols[h[cols] < L - 1]
                cols = unsat if unsat.size else cols
            if cols.size == 0:
                continue
            idx = (int(cols[int(rng.integers(cols.size))]),)
        bit = int(rng.integers(16))
        arr[idx] ^= np.array(1 << bit, arr.dtype)
        records.append((field, idx, bit))
    repl = {}
    for f, arr in plane_np.items():
        orig = getattr(plane, f)
        repl[f] = torch.as_tensor(arr, dtype=orig.dtype, device=orig.device)
    return plane._replace(**repl), records


def mangle_telemetry(spill, occupancy, last_occupancy=None):
    """The controller's view of a telemetry blackout: spill reads zero,
    occupancy freezes at the last delivered sample (zeros when none)."""
    occ = np.asarray(occupancy)
    stale = (np.asarray(last_occupancy)
             if last_occupancy is not None else np.zeros_like(occ))
    return 0, stale


__all__ = [
    "FAULT_BITFLIP", "FAULT_SHARD_LOSS", "FAULT_TELEMETRY",
    "FAULT_CRASH", "FAULT_FAMILIES", "BITFLIP_FIELDS",
    "InjectedFault", "InjectedCrash", "FaultEvent", "FaultPlan",
    "flip_plane_bits", "mangle_telemetry",
]
