"""Device-resident splay index plane: the twin of
``repro.core.device_index``.

* :class:`DeviceLevelArrays` — the level-array rectangle as tensors,
  plus the ``slots`` companion mapping bottom-row keys to state slots
  and the ``bot_rank`` companion the pipelined search resolves hits
  with;
* :func:`build_device` / :func:`from_state_device` — full construction
  (one stable co-sort, then the mask/prefix-sum pass);
* :func:`refresh_device` — incremental rebuild after an epoch: slot-map
  gathers for surviving keys, a bounded stable sort extracting the new
  keys, a merge by prefix-sum ranks, and the same re-layering — no
  full-membership sort, no host transfer, no shape change;
* :func:`refresh_device_sharded` — the same pipeline with one rank per
  shard of a ``parallel.sharding.Mesh``, each owning a contiguous key
  range (``W/S`` columns), stitched by collectives; ``split="mass"``
  moves the shard boundaries to the hit-mass quantiles.

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
                n_new, width, kk, out_len=None):
    """Two-way merge of the surviving previous bottom row with the
    sorted inserted keys, gather-only: compact the survivors, place each
    at (survivors before it) + (new keys below it), and read the merged
    row back through one searchsorted over those positions.
    ``out_len`` is the emitted row length: ``width`` for the replicated
    refresh (lanes past it are truncated and counted as overflow),
    ``width + kk`` for a shard's merge in the sharded refresh, which
    never truncates."""
    if out_len is None:
        out_len = width
    dev = bottom.device
    col = torch.arange(out_len, dtype=torch.int32, device=dev)
    acol = torch.arange(width, dtype=torch.int32, device=dev)
    cs_s = torch.cumsum(surv, 0, dtype=torch.int32)
    n_old = cs_s[width - 1]
    take_a = _compact_take(cs_s, width).long()
    a_k = torch.where(acol < n_old, bottom[take_a], PAD_KEY)
    a_h = old_h[take_a]
    a_s = slots_eff[take_a]

    # merged position of survivor i; strictly increasing, so it is
    # searchsorted-invertible
    pos_a = acol + torch.searchsorted(ns, a_k, out_int32=True)
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


def _top_new(is_new, k_slot, top_rel, kk: int, n_new: int):
    """The ``kk`` smallest new keys, ascending (``lax.top_k`` of
    ``-key``: a stable descending sort, ties by slot index), with their
    heights and slots; lanes past ``n_new`` hold ``PAD_KEY``."""
    dev = k_slot.device
    if n_new > 0:
        neg = torch.where(is_new, -k_slot, -PAD_KEY)
        vals, order = torch.sort(neg, descending=True, stable=True)
        ns = torch.where(torch.arange(kk, device=dev) < n_new, -vals[:kk],
                         PAD_KEY)
        new_slots = order[:kk]
        return ns, top_rel[new_slots], _i32(new_slots)
    z = torch.zeros((kk,), dtype=torch.int32, device=dev)
    return torch.full((kk,), PAD_KEY, dtype=torch.int32, device=dev), z, z


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

    # ---- new keys: the kk smallest, sorted
    kk = min(max_new, cap)
    n_new_raw = int(is_new.sum())
    n_new = min(n_new_raw, kk)
    ns, new_h, new_slots = _top_new(is_new, k_slot, top_rel, kk, n_new)

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


# ---------------------------------------------------------------------------
# width-sharded refresh: the same pipeline, one rank per shard
# ---------------------------------------------------------------------------

def _refresh_shard_body(st: sx.SplayState, prev: DeviceLevelArrays, mesh,
                        n_levels: int, width: int, max_new: int,
                        split: str):
    """One rank's part of :func:`refresh_device_sharded` (``prev`` is
    this rank's block, the state is replicated): the replicated
    refresh's stages (classification, bounded extraction, merge,
    re-layering) stitched across the shards by collectives.

      1. the owned key range: an all-gather of each block's first
         bottom-row key (shard 0 sends the -inf sentinel), made monotone
         by ``suffix_min_bounds``, so an empty interior block of a
         segmented plane claims nothing;
      2. the slot map's staleness, summed over the shards, so every rank
         takes the same branch;
      3. the cross-shard exclusive scans of all-gathered counts: the
         new-key drop cap (shards left of this one spend the budget
         first) and the merged segments' offsets;
      4. segment redistribution: each rank merges its block into a
         segment of up to ``W/S + kk`` keys that never truncates, and
         the packed global bottom row is read out of all the gathered
         segments;
      5. ``split="lanes"``: the re-layering from one all-gather of
         every block's ``[L, W/S]`` per-row prefix sums (the reference
         gathers them a level row at a time; the answer is the same and
         the ``[L, W]`` sums are 4 bytes a lane); ``split="mass"``: the
         shard boundaries move to the hit-mass quantiles
         (``mass_split_bounds``), each rank assembles its segment as its
         local sub-plane, and ``widths`` is summed over the shards.

    Returns ``(this rank's block of the new plane, overflow)``."""
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    dev = st.device
    S = mesh.size
    wl = width // S
    cap = st.capacity
    kk = min(max_new, cap)
    ax = mesh.index
    L = n_levels
    col_l = torch.arange(wl, dtype=torch.int32, device=dev)
    col_g = ax * wl + col_l
    top_rel = _i32(st.top - st.zl)
    bot_l = prev.keys[L - 1].contiguous()

    # ---- 1. owned key range from the boundary table
    first = (bot_l[0] if ax else
             torch.tensor(sx.NEG_INF_32, dtype=torch.int32, device=dev))
    bounds = shd.suffix_min_bounds(cl.all_gather(first, mesh))
    lo = bounds[ax]
    hi = (torch.tensor(PAD_KEY, dtype=torch.int32, device=dev)
          if ax == S - 1 else bounds[min(ax + 1, S - 1)])

    # ---- 2. slot-map validation: live lanes are a prefix of the block
    lane = col_l < (bot_l != PAD_KEY).sum()
    sc = torch.clamp(prev.slots, 0, cap - 1).long()
    match = lane & (st.key[sc] == bot_l)
    stale = int(cl.psum((lane & ~match).any(), mesh)) > 0

    # state-side classification, restricted to the owned range
    k_slot, _ = _alive_slots(st)
    alive = k_slot != PAD_KEY
    owned = alive & (k_slot >= lo) & (k_slot < hi)
    p = torch.searchsorted(bot_l, k_slot, out_int32=True)
    pc = torch.clamp(p, 0, wl - 1).long()
    in_block = owned & (bot_l[pc] == k_slot)
    is_new = owned & ~in_block
    if stale:
        dst = torch.where(in_block, pc, wl)
        surv = torch.zeros((wl + 1,), dtype=torch.bool, device=dev)
        surv[dst] = True
        surv = surv[:wl]
        slots_eff = torch.full((wl + 1,), -1, dtype=torch.int32, device=dev)
        slots_eff[dst] = torch.arange(cap, dtype=torch.int32, device=dev)
        slots_eff = slots_eff[:wl]
    else:
        surv = match & ~st.deleted[sc]
        slots_eff = _i32(sc)
    old_h = top_rel[torch.clamp(slots_eff, 0, cap - 1).long()]

    # ---- 3. new keys: this shard's bounded extraction under the
    # cross-shard drop cap (ranges ascend with the shard index, so the
    # globally smallest kk new keys fill shards left to right)
    raw = is_new.sum().to(torch.int32)
    raws = cl.all_gather(raw, mesh).tolist()
    left = sum(raws[:ax])
    total_raw = sum(raws)
    n_new = max(0, min(kk - left, min(raws[ax], kk)))
    ns, new_h, new_slots = _top_new(is_new, k_slot, top_rel, kk, n_new)

    # ---- 4. local merge into an untruncated segment, then the global
    # packed bottom row out of every shard's segment
    m_len = wl + kk
    seg_k, seg_h, seg_s = _merge_rows(bot_l, surv, old_h, slots_eff, ns,
                                      new_h, new_slots, n_new, wl, kk,
                                      out_len=m_len)
    c = surv.sum().to(torch.int32) + n_new
    counts = cl.all_gather(c, mesh)                       # [S]
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    offs = cum - counts
    total = cum[S - 1]
    flat_k = cl.all_gather(seg_k, mesh).reshape(-1)       # [S * m_len]
    flat_h = cl.all_gather(_i32(seg_h), mesh).reshape(-1)
    flat_s = cl.all_gather(_i32(seg_s), mesh).reshape(-1)

    def pick(flat, pos, fill: int):
        t = torch.searchsorted(cum, pos, right=True, out_int32=True)
        tc = torch.clamp(t, 0, S - 1).long()
        li = torch.clamp(pos - offs[tc], 0, m_len - 1)
        v = flat[tc * m_len + li]
        return torch.where(pos < total, v, fill)

    pos_g = torch.arange(width, dtype=torch.int32, device=dev)
    keys_g = pick(flat_k, pos_g, PAD_KEY)                 # [W] merged row
    hts_g = pick(flat_h, pos_g, 0)
    overflow = (max(total_raw - kk, 0)
                + max(int(total) - width, 0))

    if split == "mass":
        # boundaries at the hit-mass quantiles: selfhits through the
        # merged slot ids, saturated at 2^16 (unknown slots weigh 1);
        # each shard packs its segment into its block prefix
        total_c = torch.clamp(total, max=width)
        slot_g = pick(flat_s, pos_g, -1)
        sh_g = torch.clamp(
            _i32(st.selfhits[torch.clamp(slot_g, 0, cap - 1).long()]),
            max=2 ** 16)
        mass = torch.where(pos_g < total_c,
                           1 + torch.where(slot_g >= 0, sh_g, 0), 0)
        bounds_r = shd.mass_split_bounds(
            torch.cumsum(mass, 0, dtype=torch.int32), total_c, S, wl)
        b_lo = bounds_r[ax]
        seg_live = col_l < bounds_r[ax + 1] - b_lo
        src = torch.clamp(b_lo + col_l, 0, width - 1).long()
        k_seg = torch.where(seg_live, keys_g[src], PAD_KEY)
        h_seg = torch.where(seg_live, hts_g[src], 0)
        s_seg = torch.where(seg_live, slot_g[src], -1)
        local = _assemble_device(k_seg, h_seg, s_seg, L)
        plane = local._replace(
            widths=cl.psum(local.widths, mesh),
            local_bot=_i32(k_seg), local_heights=local.heights,
            local_live=_i32(k_seg != PAD_KEY),
            local_ok=torch.ones((1,), dtype=torch.int32, device=dev))
        return shd._sharded_cls(DeviceLevelArrays, mesh)(*plane), overflow

    slots_own = pick(flat_s, col_g, -1)                   # own lanes only

    # ---- 5. re-layering: per-shard mask/prefix sums on own columns,
    # lifted to global by an exclusive scan of the per-row totals
    k_own = keys_g[ax * wl:(ax + 1) * wl]
    hraw_own = hts_g[ax * wl:(ax + 1) * wl]
    h_own = torch.where(k_own != PAD_KEY, hraw_own, -1)
    row_min_h = L - 1 - torch.arange(L, dtype=torch.int32, device=dev)
    mask_own = h_own[None, :] >= row_min_h[:, None]        # [L, wl]
    cs_own = torch.cumsum(mask_own, 1, dtype=torch.int32)
    tots = cl.all_gather(cs_own[:, wl - 1], mesh)          # [S, L]
    row_offs = torch.cumsum(tots, 0, dtype=torch.int32) - tots
    widths_g = tots.sum(0, dtype=torch.int32)              # [L]

    # own output columns: the member of a global lane can sit in any
    # shard's columns, so one gather brings every shard's prefix sums
    # and each row's composed sum is lifted by its row offsets; row r's
    # ranks read row r+1's sum through row r's take
    blocks = cl.all_gather(cs_own, mesh)                   # [S, L, wl]
    cs = (blocks + row_offs[:, :, None]).permute(1, 0, 2).reshape(L, width)
    takes = torch.clamp(
        torch.searchsorted(cs, col_g[None, :].expand(L, wl).contiguous() + 1,
                           out_int32=True),
        max=width - 1).long()                              # [L, wl]
    prev = torch.cat([torch.zeros((1, wl), dtype=torch.long, device=dev),
                      takes[:-1]], 0)
    rank_ups = torch.gather(cs, 1, prev) - 1
    live = col_g[None, :] < widths_g[:, None]
    rows_own = torch.where(live, keys_g[takes], PAD_KEY)
    rank_own = torch.where(live[:-1], rank_ups[1:], widths_g[1:, None])
    rank_own = torch.cat([rank_own, col_g[None, :]], 0)
    heights_own = _i32(torch.where(k_own != PAD_KEY, hraw_own, 0))
    # the global keys_g position of each member is its packed bottom rank
    bot_rank_own = torch.where(live, _i32(takes), widths_g[L - 1])
    plane = shd._sharded_cls(DeviceLevelArrays, mesh)(
        keys=_i32(rows_own), widths=widths_g, heights=heights_own,
        rank_map=_i32(rank_own), slots=_i32(slots_own),
        bot_rank=bot_rank_own,
        # lanes split keeps the packed global layout: blocks are global
        # row columns, not local sub-planes, so residency stays off
        local_bot=_i32(k_own), local_heights=heights_own,
        local_live=_i32(k_own != PAD_KEY),
        local_ok=torch.zeros((1,), dtype=torch.int32, device=dev))
    return plane, overflow


def refresh_device_sharded(st: sx.SplayState, prev: DeviceLevelArrays,
                           max_new: int = 1024, mesh=None,
                           axis: str = "model", split: str = "lanes"):
    """Width-sharded incremental refresh: :func:`refresh_device` with
    each rank of ``mesh`` (the active mesh when omitted) owning ``W/S``
    columns, a contiguous key range of the sorted bottom row
    (``_refresh_shard_body``).  The state is replicated on every rank;
    ``prev`` is this rank's block (``sharding.shard_index_plane``; a
    global plane is laid out first).  Every rank of the mesh must call
    it.  Returns ``(this rank's block of the new plane, overflow)``,
    ``overflow`` a 0-d int32 tensor equal on every rank: inserts beyond
    ``max_new`` plus merged lanes beyond ``W``.

    ``split="lanes"`` packs the merged row wall to wall: the gathered
    plane is bit-identical to :func:`refresh_device`'s (``slots`` on
    live lanes).  ``split="mass"`` puts the shard boundaries at the
    hit-counter mass quantiles and gives each shard its segment packed
    into its own block prefix: a *segmented* plane, searched correctly
    only by the sharded search, whose residency bit ``local_ok`` is set
    (its blocks are the shards' local sub-planes).

    No mesh, ``axis`` not the mesh's, or a width ``S`` does not divide:
    the replicated :func:`refresh_device` on the global plane, same
    return convention; a segmented ``prev`` raises ``ValueError``
    there."""
    from repro_torch.parallel import sharding as shd
    if split not in ("lanes", "mass"):
        raise ValueError(f"split must be 'lanes' or 'mass', got {split!r}")
    mesh = mesh if mesh is not None else shd.active_mesh()
    n_levels = prev.keys.shape[0]
    width = shd.plane_width(prev)
    if (mesh is None or axis not in mesh.shape or axis != mesh.axis
            or width % mesh.size):
        if plane_is_segmented(prev):
            raise ValueError(
                "segmented (mass-split) plane cannot take the replicated "
                "refresh: its interior pad runs break the packed-row "
                "invariants.  Pass a mesh (split='lanes' repacks), or "
                "rebuild with from_state_device first")
        return refresh_device(st, shd.gather_index_plane(prev),
                              max_new=max_new, return_overflow=True)
    prev = shd.shard_index_plane(prev, mesh, axis)
    plane, overflow = _refresh_shard_body(st, prev, mesh, n_levels, width,
                                          max_new, split)
    return plane, torch.tensor(overflow, dtype=torch.int32,
                               device=st.device)


def plane_is_segmented(plane) -> bool:
    """True when a plane's bottom row has interior pad runs — the
    mass-split layout, valid only on the sharded paths.  A laid-out
    plane is judged on its global bottom row: one all-gather of each
    block's live count and whether its live lanes form a prefix (every
    rank of the mesh must call it)."""
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    keys = getattr(plane, "keys", None)
    if keys is None:
        return False
    live = keys[-1] != PAD_KEY
    n = live.sum()
    # the live lanes form a prefix exactly when none sits past their count
    gap = live[int(n):].any()
    mesh = shd.plane_mesh(plane)
    if mesh is None:
        return bool(gap)
    wl = keys.shape[1]
    summary = cl.all_gather(torch.stack([n.to(torch.int32), _i32(gap)]),
                            mesh).tolist()
    seen_short = False
    for cnt, block_gap in summary:
        if block_gap or (seen_short and cnt > 0):
            return True
        seen_short = seen_short or cnt < wl
    return False


def to_host(plane: DeviceLevelArrays) -> HostLevelArrays:
    """Host copy of the search fields (tests / debugging only); a
    laid-out plane is gathered first (every rank of its mesh must
    call it)."""
    from repro_torch.parallel import sharding as shd
    plane = shd.gather_index_plane(plane)
    return HostLevelArrays(
        keys=plane.keys.cpu().numpy(), widths=plane.widths.cpu().numpy(),
        heights=plane.heights.cpu().numpy(),
        rank_map=plane.rank_map.cpu().numpy())
