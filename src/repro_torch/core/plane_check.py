"""Plane audit: the twin of ``repro.core.plane_check``.

The descents and the refresh never validate their inputs; they assume
the structural invariants that ``device_index._assemble_device`` sets
up and the refresh keeps.  A bit-flip or a faulty refresh breaks them
silently and the descent starts answering wrongly.  :func:`audit_plane`
re-derives every invariant from ``(SplayState, DeviceLevelArrays)`` with
torch ops on the plane's device and returns a :class:`PlaneAudit` of
violation counts:

====================  ====================================================
``row_unsorted``      every row is, per segment, a packed live prefix of
                      strictly ascending keys
``block_order``       every live bottom key lies inside its block's
                      ownership range (``sharding.suffix_min_bounds``)
``widths_bad``        ``widths[r]`` is row r's live count, widths nested
``heights_bad``       per segment and row, the live count equals the
                      bottom lanes with ``heights >= L-1-r``; live
                      heights non-negative
``rank_map_bad``      live lanes recover their key in the next row; pad
                      lanes hold the next row's live count; the bottom
                      row is the identity
``bot_rank_bad``      live lanes recover their key in the bottom row
``local_bad``         with ``local_ok == 1`` the ``local_*`` fields copy
                      the bottom row; ``local_ok`` is 0 or 1
``state_missing``     alive state keys absent from the bottom row
``state_extra``       bottom-row keys not alive in the state
``counter_bad``       negative counters, or ``dhits > m``
``counter_saturated`` ``m`` or a ``selfhits`` lane above ``2**30``: a
                      warning, not a fatal violation
====================  ====================================================

``n_segments`` is 1 for the packed layout and S for a mass-split layout
of S blocks of ``W/S`` lanes, each an independent local assembly.
:func:`infer_segments` reads it off a plane laid out on a mesh
(``parallel.sharding.shard_index_plane``) and refuses a segmented plane
that carries no layout.  A laid-out plane is audited whole: every rank
of its mesh gathers it and audits it, and all get the same counts.

The searches over unsorted rows (``state_missing``/``state_extra`` on a
corrupted bottom row) follow the JAX package's binary search step for
step (fixed ``ceil(log2(n + 1))`` halvings), so a corrupted plane gives
the same counts in both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import suffix_min_bounds

PAD_KEY = dix.PAD_KEY

# exact-count headroom: counters are exact integers up to 2**30 with a
# 2x margin before int32 overflow
SATURATION_LIMIT = 2 ** 30


class PlaneAudit(NamedTuple):
    """Violation counts of one :func:`audit_plane` pass (all int).  A
    clean plane is all zero, except possibly ``counter_saturated``, a
    headroom warning that :func:`audit_ok` treats as non-fatal."""
    row_unsorted: int
    block_order: int
    widths_bad: int
    heights_bad: int
    rank_map_bad: int
    bot_rank_bad: int
    local_bad: int
    state_missing: int
    state_extra: int
    counter_bad: int
    counter_saturated: int


# the fields whose non-zero counts mean the plane is structurally wrong
FATAL_FIELDS = tuple(f for f in PlaneAudit._fields
                     if f != "counter_saturated")


def _searchsorted_left(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(a, v)`` (side left, the scan method): a fixed
    number of halvings of ``[0, n)`` that keeps ``mid`` as the low end
    when ``v > a[mid]``.  On a sorted ``a`` it is the left insertion
    point; on an unsorted one it probes what JAX probes."""
    n = a.shape[0]
    lo = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    hi = torch.full(v.shape, n, dtype=torch.int64, device=v.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (lo + hi) // 2
        go_left = v <= a[mid]
        lo = torch.where(go_left, lo, mid)
        hi = torch.where(go_left, mid, hi)
    return hi


def _audit(st: sx.SplayState, plane: dix.DeviceLevelArrays, S: int):
    keys = plane.keys
    L, W = keys.shape
    dev = keys.device
    wl = W // S
    i32 = dict(dtype=torch.int32, device=dev)
    col = torch.arange(W, **i32)
    blk = col // wl
    loc = col - blk * wl
    live = keys != PAD_KEY                      # [L, W]
    bot = keys[L - 1]
    bot_live = live[L - 1]

    # -- per-segment sorted packed live prefix
    same_blk = (blk[1:] == blk[:-1])[None, :]
    adj_live = live[:, :-1] & live[:, 1:] & same_blk
    inversions = adj_live & (keys[:, :-1] >= keys[:, 1:])
    pad_before_live = same_blk & ~live[:, :-1] & live[:, 1:]
    row_unsorted = inversions.sum() + pad_before_live.sum()

    # -- cross-block ordering via the boundary table
    blk_first = bot.reshape(S, wl)[:, 0]
    raw = torch.where(torch.arange(S, device=dev) == 0, sx.NEG_INF_32,
                      blk_first)
    bounds = suffix_min_bounds(raw)
    hi_tab = torch.cat([bounds[1:], torch.tensor([sx.POS_INF_32], **i32)])
    lo = bounds[blk]
    hi = hi_tab[blk]
    block_order = (bot_live & ((bot < lo) | (bot >= hi))).sum()

    # -- widths: global live totals and nestedness
    live_counts = live.sum(1).to(plane.widths.dtype)
    widths_bad = ((live_counts != plane.widths).sum()
                  + (plane.widths[:-1] > plane.widths[1:]).sum())

    # -- heights <-> row membership
    h = plane.heights
    hh = torch.where(bot_live, h, -1)
    row_min = L - 1 - torch.arange(L, **i32)
    member = hh[None, :] >= row_min[:, None]                  # [L, W]
    exp_cnt = member.reshape(L, S, wl).sum(2)                 # [L, S]
    got_cnt = live.reshape(L, S, wl).sum(2)
    heights_bad = ((exp_cnt != got_cnt).sum()
                   + (bot_live & (h < 0)).sum())

    # -- rank_map: pointer recovery, pad windows, identity bottom row
    rm = plane.rank_map[:-1]                                  # [L-1, W]
    base = (blk * wl)[None, :]
    nxt_idx = torch.clamp(base + rm, 0, W - 1).long()
    tgt = torch.gather(keys[1:], 1, nxt_idx)
    live_u = live[:-1]
    rank_live_bad = live_u & ((rm < 0) | (rm >= wl) | (tgt != keys[:-1]))
    nxt_cnt = torch.repeat_interleave(got_cnt[1:], wl, dim=1)
    rank_pad_bad = ~live_u & (rm != nxt_cnt.to(rm.dtype))
    rank_bot_bad = plane.rank_map[L - 1] != loc
    rank_map_bad = (rank_live_bad.sum() + rank_pad_bad.sum()
                    + rank_bot_bad.sum())

    # -- bot_rank: live lanes point at their bottom-row copy
    br = plane.bot_rank
    br_idx = torch.clamp(base + br, 0, W - 1).long()
    br_tgt = torch.gather(bot.expand(L, W), 1, br_idx)
    bot_rank_bad = (live & ((br < 0) | (br >= wl) | (br_tgt != keys))).sum()

    # -- residency provenance
    lok = plane.local_ok[0]
    lok_range_bad = ((lok != 0) & (lok != 1)).to(torch.int64)
    local_mismatch = (
        (plane.local_bot != bot).sum()
        + (plane.local_live != bot_live.to(plane.local_live.dtype)).sum()
        + (plane.local_heights != h).sum())
    local_bad = lok_range_bad + torch.where(lok == 1, local_mismatch, 0)

    # -- state <-> plane membership
    skeys, _ = dix._alive_slots(st)
    sk = torch.sort(skeys)[0]                      # live prefix, PAD tail
    cs = torch.cumsum(bot_live, 0, dtype=torch.int32)
    n_plane = cs[W - 1]
    take = dix._compact_take(cs, W).long()
    pk = torch.where(col < n_plane, bot[take], PAD_KEY)
    cap = sk.shape[0]
    pos = torch.clamp(_searchsorted_left(pk, sk), 0, W - 1)
    state_missing = ((sk != PAD_KEY) & (pk[pos] != sk)).sum()
    pos2 = torch.clamp(_searchsorted_left(sk, pk), 0, cap - 1)
    state_extra = ((pk != PAD_KEY) & (sk[pos2] != pk)).sum()

    # -- hit counters
    counter_bad = (bool((st.selfhits < 0).any()) + bool((st.hits < 0).any())
                   + bool(st.m < 0) + bool(st.dhits < 0)
                   + bool(st.dhits > st.m))
    counter_saturated = int(bool(st.m > SATURATION_LIMIT)
                            or bool(st.selfhits.max() > SATURATION_LIMIT))

    counts = torch.stack([
        row_unsorted, block_order, widths_bad, heights_bad, rank_map_bad,
        bot_rank_bad, local_bad, state_missing, state_extra]).tolist()
    return PlaneAudit(*counts, counter_bad, counter_saturated)


def infer_segments(plane, axis: str = "model") -> int:
    """The segment count of a plane: 1 for the packed layout, the shard
    count of the mesh a segmented plane is laid out on
    (``sharding.plane_width_mesh``).  A segmented plane without such a
    layout raises ``ValueError``: pass ``n_segments`` then.  On a
    laid-out plane every rank of its mesh must call this."""
    if not dix.plane_is_segmented(plane):
        return 1
    mesh = shd.plane_width_mesh(plane, axis)
    if mesh is None:
        raise ValueError(
            "plane looks segmented (interior pad runs) but carries no "
            "width-sharded layout to infer the segment count from; "
            "pass n_segments explicitly")
    return int(mesh.shape[axis])


def audit_plane(st: sx.SplayState, plane: dix.DeviceLevelArrays,
                n_segments: int | None = None,
                axis: str = "model") -> PlaneAudit:
    """Run the full invariant audit and return host-int violation
    counts.  ``n_segments`` is 1 for the packed layout and the block
    count of a mass-split layout; ``None`` infers it
    (:func:`infer_segments`).  A laid-out plane is gathered and audited
    whole on every rank of its mesh."""
    W = shd.plane_width(plane)
    if n_segments is None:
        n_segments = infer_segments(plane, axis)
    n_segments = int(n_segments)
    if n_segments < 1 or W % n_segments:
        raise ValueError(
            f"audit_plane: width {W} not divisible into "
            f"{n_segments} segments")
    if st.device != plane.keys.device:
        raise ValueError(f"state on {st.device}, plane on "
                         f"{plane.keys.device}")
    return _audit(st, shd.gather_index_plane(plane), n_segments)


def audit_ok(audit: PlaneAudit) -> bool:
    """True when no fatal invariant is violated (saturation is a
    warning, not corruption)."""
    return all(getattr(audit, f) == 0 for f in FATAL_FIELDS)


def audit_summary(audit: PlaneAudit) -> str:
    """``audit OK`` for a clean plane, else ``audit FAIL[field=count,
    ...]`` naming every violated invariant; saturation adds a
    ``warn:`` suffix either way."""
    bad = [f"{f}={getattr(audit, f)}" for f in FATAL_FIELDS
           if getattr(audit, f)]
    tail = (" warn:counter_saturated"
            if audit.counter_saturated else "")
    if not bad:
        return "audit OK" + tail
    return "audit FAIL[" + ",".join(bad) + "]" + tail


__all__ = [
    "PlaneAudit", "FATAL_FIELDS", "SATURATION_LIMIT",
    "audit_plane", "audit_ok", "audit_summary", "infer_segments",
]
