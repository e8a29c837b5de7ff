"""Device-resident splay index plane: the twin of
``repro.core.device_index`` (replicated half).

* :class:`DeviceLevelArrays` — the level-array rectangle as tensors,
  plus the ``slots`` companion mapping bottom-row keys to state slots
  and the ``bot_rank`` companion the pipelined search resolves hits
  with;
* :func:`build_device` / :func:`from_state_device` — full construction
  (one stable co-sort, then the mask/prefix-sum pass);
* :func:`refresh_device` — incremental rebuild after an epoch: slot-map
  gathers for surviving keys, a bounded stable sort extracting the new
  keys, a merge by prefix-sum ranks, and the same re-layering — no
  full-membership sort, no host transfer, no shape change.

All of it is vectorised torch on whatever device the state lives on.
The JAX ``lax.cond`` branches become host ``if``s on one scalar each,
and ``.at[...].set(mode="drop")`` scatters write into one extra lane
that is sliced off.  Output is bit-identical to the JAX plane on the
same state (pad lanes of ``slots`` are unspecified in both).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import splaylist as sx

PAD_KEY = sx.POS_INF_32


class DeviceLevelArrays(NamedTuple):
    """The splay layout as device tensors (all int32)."""
    keys: torch.Tensor        # [L, W], +INF padded, sorted, nested
    widths: torch.Tensor      # [L], live entries per row
    heights: torch.Tensor     # [W], splay height of bottom-row keys
    rank_map: torch.Tensor    # [L, W], index of keys[r, j] in row r+1
    slots: torch.Tensor       # [W], state slot of bottom-row key j (-1:
    #                           unknown; refresh re-derives it)
    bot_rank: torch.Tensor    # [L, W], index of keys[r, j] in the bottom
    #                           row (pad lanes unspecified, never read)
    # segmented-plane residency (used by the sharded slice; every
    # replicated builder/refresh resets local_ok to 0)
    local_bot: torch.Tensor      # [W]
    local_heights: torch.Tensor  # [W]
    local_live: torch.Tensor     # [W]
    local_ok: torch.Tensor       # [1]

    @property
    def n_levels(self) -> int:
        return self.keys.shape[0]

    @property
    def width(self) -> int:
        return self.keys.shape[1]


class HostLevelArrays(NamedTuple):
    """Host copy of a plane's search fields (numpy int32)."""
    keys: np.ndarray
    widths: np.ndarray
    heights: np.ndarray
    rank_map: np.ndarray


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _compact_take(cs: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of a 0/1 prefix sum: take[..., j] = index of the j-th
    marked element (``cs`` is the inclusive cumsum of the mark vector;
    rows of a 2-D ``cs`` are independent).  Gather-only compaction."""
    col = torch.arange(1, width + 1, dtype=torch.int32, device=cs.device)
    col = col.expand(*cs.shape[:-1], width).contiguous()
    take = torch.searchsorted(cs.contiguous(), col, out_int32=True)
    return torch.clamp(take, max=width - 1)


def _assemble_device(keys_sorted, rel_h, slots, n_levels: int
                     ) -> DeviceLevelArrays:
    """The mask/prefix-sum construction: ``keys_sorted`` [W] holds the
    live keys sorted ascending in a prefix, PAD_KEY after; ``rel_h``/
    ``slots`` [W] are aligned (pad lanes ignored)."""
    dev = keys_sorted.device
    width = keys_sorted.shape[0]
    alive = keys_sorted != PAD_KEY
    h = torch.where(alive, rel_h, -1)

    row_min_h = n_levels - 1 - torch.arange(n_levels, dtype=torch.int32,
                                            device=dev)
    mask = h[None, :] >= row_min_h[:, None]                 # [L, W]
    cs = torch.cumsum(mask, dim=1, dtype=torch.int32)       # [L, W]
    widths = cs[:, width - 1].contiguous()

    col = torch.arange(width, dtype=torch.int32, device=dev)
    take = _compact_take(cs, width).long()                  # [L, W]
    live = col[None, :] < widths[:, None]
    rows = torch.where(live, keys_sorted[take], PAD_KEY)

    # rank map: the key at (r, j) sits in row r+1 at that row's prefix
    # count minus one (nested rows); pad entries close the descent
    # window at the next row's live width; bottom row is the identity
    cs_next = torch.cat(
        [cs[1:], torch.ones((1, width), dtype=torch.int32, device=dev)], 0)
    rank_live = torch.gather(cs_next, 1, take) - 1
    pad_default = torch.cat(
        [widths[1:], torch.zeros((1,), dtype=torch.int32, device=dev)])
    rank_map = torch.where(live, rank_live, pad_default[:, None])
    rank_map[n_levels - 1] = col

    # keys_sorted IS the bottom row, so the member picked for lane
    # (r, j) sits in the bottom row at its compaction index
    bot_rank = torch.where(live, _i32(take), widths[n_levels - 1])

    heights = _i32(torch.where(alive, rel_h, 0))
    return DeviceLevelArrays(
        keys=_i32(rows), widths=widths, heights=heights,
        rank_map=_i32(rank_map), slots=_i32(slots), bot_rank=bot_rank,
        local_bot=_i32(keys_sorted), local_heights=heights,
        local_live=_i32(alive),
        local_ok=torch.zeros((1,), dtype=torch.int32, device=dev))


def build_device(keys, rel_h, n_levels: int) -> DeviceLevelArrays:
    """Full build from bare (keys, heights): ``keys`` [W] int32 with
    PAD_KEY in dead lanes, ``rel_h`` [W] aligned.  One stable co-sort
    (live keys are < PAD_KEY so they land in a sorted prefix), then the
    shared prefix-sum pass.  The slot map is unknown (-1)."""
    keys = _i32(keys)
    h = torch.where(keys != PAD_KEY, _i32(rel_h), 0)
    ks, order = torch.sort(keys, stable=True)
    slots = torch.full(keys.shape, -1, dtype=torch.int32,
                       device=keys.device)
    return _assemble_device(ks, h[order], slots, n_levels)


def _alive_slots(st: sx.SplayState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alive (keys, relative heights) in slot order, [capacity]-shaped;
    dead lanes hold PAD_KEY / 0."""
    idx = torch.arange(st.capacity, device=st.device)
    alive = ((idx >= 2) & (idx < st.n_alloc) & (~st.deleted)
             & (st.key < sx.POS_INF_32))
    keys = _i32(torch.where(alive, st.key, PAD_KEY))
    rel_h = _i32(torch.where(alive, st.top - st.zl, 0))
    return keys, rel_h


def from_state_device(st: sx.SplayState, n_levels: int,
                      width: int) -> DeviceLevelArrays:
    """Build a fresh plane from a splay-list state.  ``width`` must
    bound the alive-key count (``capacity - 2`` always does);
    ``n_levels`` must bound relative heights (``max_level`` always
    does).  Also the overflow-recovery rebuild of ``run_serving``."""
    keys, rel_h = _alive_slots(st)
    ks, order = torch.sort(keys, stable=True)
    hs = rel_h[order]
    sl = _i32(order)
    if st.capacity < width:                # small states pad out
        pad = width - st.capacity
        ks = torch.nn.functional.pad(ks, (0, pad), value=PAD_KEY)
        hs = torch.nn.functional.pad(hs, (0, pad))
        sl = torch.nn.functional.pad(sl, (0, pad), value=-1)
    return _assemble_device(ks[:width], hs[:width], sl[:width], n_levels)


def _merge_rows(bottom, surv, old_h, slots_eff, ns, new_h, new_slots,
                n_new, width, kk):
    """Two-way merge of the surviving previous bottom row with the
    sorted inserted keys, gather-only: compact the survivors, place each
    at (survivors before it) + (new keys below it), and read the merged
    row back through one searchsorted over those positions."""
    dev = bottom.device
    col = torch.arange(width, dtype=torch.int32, device=dev)
    cs_s = torch.cumsum(surv, 0, dtype=torch.int32)
    n_old = cs_s[width - 1]
    take_a = _compact_take(cs_s, width).long()
    a_k = torch.where(col < n_old, bottom[take_a], PAD_KEY)
    a_h = old_h[take_a]
    a_s = slots_eff[take_a]

    # merged position of survivor i; strictly increasing, so it is
    # searchsorted-invertible
    pos_a = col + torch.searchsorted(ns, a_k, out_int32=True)
    a_of = torch.searchsorted(pos_a, col, out_int32=True)
    a_ofc = torch.clamp(a_of, max=width - 1).long()
    from_a = pos_a[a_ofc] == col
    b_of = torch.clamp(col - torch.minimum(a_of, col), max=kk - 1).long()

    n_tot = n_old + n_new
    merged_k = torch.where(col < n_tot,
                           torch.where(from_a, a_k[a_ofc], ns[b_of]),
                           PAD_KEY)
    merged_h = torch.where(from_a, a_h[a_ofc], new_h[b_of])
    merged_s = torch.where(from_a, a_s[a_ofc], new_slots[b_of])
    return merged_k, merged_h, merged_s


def refresh_device(st: sx.SplayState, prev: DeviceLevelArrays,
                   max_new: int = 1024, return_overflow: bool = False):
    """Incremental rebuild after a rebalance epoch.

      1. every alive slot is classified old/new by one ``searchsorted``
         against the previous sorted bottom row;
      2. surviving old keys keep their relative order — their heights
         come back through the slot map (gathers); deleted keys drop
         out by absence;
      3. the newly inserted keys are extracted *sorted* by one bounded
         stable sort (``max_new`` keeps the *smallest* keys; inserts
         beyond it are dropped from the plane until the next full
         build), then placed by rank arithmetic;
      4. the prefix-sum re-layering reruns on the merged row.

    A stale slot map (``rebuild`` compacts slots; ``build_device``
    leaves it unknown) routes the epoch through a scatter fallback that
    re-derives it.  Output shape equals ``prev``'s.  With
    ``return_overflow=True`` returns ``(plane, overflow)``: the alive
    keys the plane could not represent (inserts beyond ``max_new`` plus
    merged lanes beyond ``width``), as a 0-d int32 tensor."""
    dev = st.device
    n_levels, width = prev.keys.shape
    cap = st.capacity
    k_slot, _ = _alive_slots(st)
    alive = k_slot != PAD_KEY
    top_rel = _i32(st.top - st.zl)

    bottom = prev.keys[n_levels - 1].contiguous()          # [W] sorted
    w_bot = prev.widths[n_levels - 1]
    col = torch.arange(width, dtype=torch.int32, device=dev)
    lane = col < w_bot

    # ---- old keys: gather through the slot map
    sc = torch.clamp(prev.slots, 0, cap - 1).long()
    match = lane & (st.key[sc] == bottom)
    stale = bool((lane & ~match).any())

    # state-side classification: which alive slots are inserts
    p = torch.searchsorted(bottom, k_slot, out_int32=True)
    pc = torch.clamp(p, 0, width - 1).long()
    is_new = alive & (bottom[pc] != k_slot)

    if stale:
        # stale/absent slot map: re-derive it for this epoch
        is_old = alive & ~is_new
        dst = torch.where(is_old, pc, width)
        surv = torch.zeros((width + 1,), dtype=torch.bool, device=dev)
        surv[dst] = True
        surv = surv[:width]
        slots_eff = torch.full((width + 1,), -1, dtype=torch.int32,
                               device=dev)
        slots_eff[dst] = torch.arange(cap, dtype=torch.int32, device=dev)
        slots_eff = slots_eff[:width]
    else:
        surv = match & ~st.deleted[sc]
        slots_eff = _i32(sc)
    old_h = top_rel[torch.clamp(slots_eff, 0, cap - 1).long()]

    # ---- new keys: a stable descending sort of -key puts them first,
    # ascending, ties (the non-new fill) by slot index as lax.top_k does
    kk = min(max_new, cap)
    n_new_raw = int(is_new.sum())
    n_new = min(n_new_raw, kk)
    if n_new > 0:
        neg = torch.where(is_new, -k_slot, -PAD_KEY)
        vals, order = torch.sort(neg, descending=True, stable=True)
        ns = torch.where(torch.arange(kk, device=dev) < n_new, -vals[:kk],
                         PAD_KEY)
        new_slots = order[:kk]
        new_h = top_rel[new_slots]
        new_slots = _i32(new_slots)
    else:
        ns = torch.full((kk,), PAD_KEY, dtype=torch.int32, device=dev)
        new_h = new_slots = torch.zeros((kk,), dtype=torch.int32,
                                        device=dev)

    # height-only epoch (the common serving case): the merge is the
    # identity over the previous bottom row
    n_old = int(surv.sum())
    if n_new == 0 and n_old == int(w_bot):
        merged = bottom, old_h, slots_eff
    else:
        merged = _merge_rows(bottom, surv, old_h, slots_eff, ns, new_h,
                             new_slots, n_new, width, kk)
    plane = _assemble_device(*merged, n_levels)
    if not return_overflow:
        return plane
    overflow = (n_new_raw - n_new) + max(n_old + n_new - width, 0)
    return plane, torch.tensor(overflow, dtype=torch.int32, device=dev)


def plane_is_segmented(plane) -> bool:
    """True when a plane's bottom row has interior pad runs — the
    mass-split layout, valid only on the sharded paths."""
    keys = getattr(plane, "keys", None)
    if keys is None:
        return False
    live = keys[-1] != PAD_KEY
    # the live lanes form a prefix exactly when none sits past their count
    return bool(live[int(live.sum()):].any())


def to_host(plane: DeviceLevelArrays) -> HostLevelArrays:
    """Host copy of the search fields (tests / debugging only)."""
    return HostLevelArrays(
        keys=plane.keys.cpu().numpy(), widths=plane.widths.cpu().numpy(),
        heights=plane.heights.cpu().numpy(),
        rank_map=plane.rank_map.cpu().numpy())
