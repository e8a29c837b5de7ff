"""PyTorch splay-list engine: the twin of ``repro.core.splaylist``.

The same array-backed splay-list with the forward-pass rebalancing of
Section 5, bit-exact against the JAX engine on the same op streams.
Representation (capacity ``C`` slots, ``L = max_level`` data levels,
one sentinel level on top; slot 0 = head, slot 1 = tail):

    key       int32[C]      NEG/POS_INF sentinels at slots 0/1
    nxt       int32[L+1, C] successor slot per level (-1 = unmaterialized)
    hits      cnt  [L+1, C] hits_u^h  (interval-sum semantics)
    selfhits  cnt  [C]      sh_u
    top       int32[C]      topmost level of the node
    nzero     int32[C]      lowest *materialized* level (lazy expansion)
    deleted   bool [C]
    m, dhits  cnt  []       total hit-ops / hits on marked nodes
    zl        int32[]       current bottom level of the list
    n_alloc   int32[]       bump allocator
    size      int32[]       unmarked key count

``cnt`` is ``torch.int32`` (exact for m < 2^30) or ``torch.int64``.

Execution model.  The batched searches (``find_batch``), ``rebuild``
and the epoch's plane work are vectorised torch ops.  The serialized
update fold — ``run_ops`` and the fold of ``run_contains_batch`` —
branches on the state at every step, so on the card it is one CUDA
kernel (``kernels/fold.py``, kernel F) walking the state in device
memory; on CPU tensors it is the step-by-step fold below (``_find``,
``_update``, ``_fill_down``, ``_link_bottom`` and the op bodies), which
mirrors the JAX ``_update`` branch for branch and is the kernel's plain
version.  The state is functional at the public surface: every entry
point returns a new ``SplayState`` and leaves its argument untouched.

Every entry point runs on the card unless the caller passes
``device="cpu"`` (or hands in CPU tensors); without a card a CUDA
request raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

NEG_INF_32 = -(2 ** 31) + 1
POS_INF_32 = 2 ** 31 - 1

# op kinds for run_ops / run_epoch / run_serving (the JAX package's
# numbering).  The result lane carries each op's answer: a 0/1 verdict
# for contains / insert / delete, the largest live key <= k for OP_PRED
# (NEG_INF_32 when none) and the count of live keys <= k for OP_RANGE.
OP_CONTAINS = 0
OP_INSERT = 1
OP_DELETE = 2
OP_PRED = 3
OP_RANGE = 4

HEAD = 0
TAIL = 1

COUNT_DTYPES = (torch.int32, torch.int64)


def _device(device) -> torch.device:
    """Resolve ``device``; a CUDA request on a machine without a card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain CPU path")
    return dev


class SplayState(NamedTuple):
    key: torch.Tensor        # [C]
    nxt: torch.Tensor        # [L+1, C]
    hits: torch.Tensor       # [L+1, C]
    selfhits: torch.Tensor   # [C]
    top: torch.Tensor        # [C]
    nzero: torch.Tensor      # [C]
    deleted: torch.Tensor    # [C]
    m: torch.Tensor          # scalar
    dhits: torch.Tensor      # scalar
    zl: torch.Tensor         # scalar int32
    n_alloc: torch.Tensor    # scalar int32
    size: torch.Tensor       # scalar int32

    @property
    def max_level(self) -> int:
        return self.nxt.shape[0] - 1

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device


def make(capacity: int, max_level: int = 32, count_dtype=torch.int32,
         device="cuda") -> SplayState:
    """Empty splay-list. head/tail sentinels occupy slots 0/1.

    ``max_level`` is bounded by the count type's width: the exact
    threshold shifts ``m >> e`` take ``e < max_level``."""
    if count_dtype not in COUNT_DTYPES:
        raise ValueError(f"count_dtype must be int32 or int64, got "
                         f"{count_dtype}")
    bits = torch.iinfo(count_dtype).bits
    if not 1 <= max_level <= bits:
        raise ValueError(f"max_level must be in [1, {bits}] for "
                         f"{count_dtype}, got {max_level}")
    dev = _device(device)
    L = max_level
    ml1 = L - 1
    i32 = dict(dtype=torch.int32, device=dev)
    key = torch.full((capacity,), POS_INF_32, **i32)
    key[HEAD] = NEG_INF_32
    nxt = torch.full((L + 1, capacity), -1, **i32)
    # head materialized at [ML1, ML] only (lazy expansion applies to head!)
    nxt[ml1, HEAD] = TAIL
    nxt[L, HEAD] = TAIL
    hits = torch.zeros((L + 1, capacity), dtype=count_dtype, device=dev)
    selfhits = torch.zeros((capacity,), dtype=count_dtype, device=dev)
    selfhits[HEAD] = 1
    selfhits[TAIL] = 1
    top = torch.zeros((capacity,), **i32)
    top[HEAD] = L
    top[TAIL] = L
    nzero = torch.full((capacity,), L, **i32)
    nzero[HEAD] = ml1
    nzero[TAIL] = L
    deleted = torch.zeros((capacity,), dtype=torch.bool, device=dev)

    def scalar(v, dt):
        return torch.tensor(v, dtype=dt, device=dev)

    return SplayState(
        key=key, nxt=nxt, hits=hits, selfhits=selfhits, top=top,
        nzero=nzero, deleted=deleted, m=scalar(0, count_dtype),
        dhits=scalar(0, count_dtype), zl=scalar(ml1, torch.int32),
        n_alloc=scalar(2, torch.int32), size=scalar(0, torch.int32))


def clone(st: SplayState) -> SplayState:
    return SplayState(*(t.clone() for t in st))


# ---------------------------------------------------------------------------
# find_batch — the lock-free search phase (pure, vectorised)
# ---------------------------------------------------------------------------

def find_batch(st: SplayState, ks) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorised lock-free search for a batch of keys (read-only):
    ``(slot, steps)`` int32, slot -1 where the key is not physically
    present; ``steps`` counts horizontal moves + level descents (the
    paper's 'average length of a path' metric).  One masked loop over
    the batch, each lane stepping exactly as the scalar walk would."""
    ks = _op_tensor(ks, torch.int32, st.device)
    n = ks.shape[0]
    dev = st.device
    pred = torch.full((n,), HEAD, dtype=torch.int64, device=dev)
    h = torch.full((n,), st.max_level - 1, dtype=torch.int64, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    key = st.key
    zl = st.zl.to(torch.int64)
    active = (h >= zl) & ~found
    while bool(active.any()):
        lvl = torch.maximum(h, st.nzero[pred].to(torch.int64))
        curr = st.nxt[lvl, pred].to(torch.int64)
        adv = key[curr] <= ks
        found = torch.where(active & ~adv, key[pred] == ks, found)
        pred = torch.where(active & adv, curr, pred)
        h = torch.where(active & ~adv, h - 1, h)
        steps = steps + active.to(torch.int32)
        active = (h >= zl) & ~found
    # found can also become true exactly at loop exit (descended past
    # the bottom)
    found = found | (key[pred] == ks)
    slot = torch.where(found & (pred != HEAD), pred, -1)
    return slot.to(torch.int32), steps


def find(st: SplayState, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar :func:`find_batch`: ``(slot, steps)`` 0-d int32."""
    slot, steps = find_batch(st, [int(k)])
    return slot[0], steps[0]


# ---------------------------------------------------------------------------
# the serialized fold, step by step (kernel F's plain version).  Each
# function mutates the CPU state it is given in place; scalar reads go
# through int(), so the control flow is ordinary Python.
# ---------------------------------------------------------------------------

def _shift(x: int, e: int, bits: int) -> int:
    """Arithmetic right shift with XLA's rule for shift amounts outside
    ``[0, bits)``: the sign fill."""
    if e < 0 or e >= bits:
        return -1 if x < 0 else 0
    return x >> e


def _eff_next(st: SplayState, i: int, h: int) -> int:
    """Successor of slot i at level h under lazy expansion."""
    return int(st.nxt[max(h, int(st.nzero[i])), i])


def _whits(st: SplayState, i: int, h: int) -> int:
    """hits_i^h honouring lazy expansion (logical 0 below nzero)."""
    return int(st.hits[h, i]) if h >= int(st.nzero[i]) else 0


def _get_hits(st: SplayState, i: int, h: int) -> int:
    """hits(C_i^h) = sh_i + hits_i^h."""
    return int(st.selfhits[i]) + _whits(st, i, h)


def _fill_down(st: SplayState, i: int, h: int) -> None:
    """Materialize slot i's levels down to h (updateZeroLevel)."""
    zl_i = int(st.nzero[i])
    lo = max(h, 0)
    if lo < zl_i:
        st.nxt[lo:zl_i, i] = st.nxt[zl_i, i]
        st.hits[lo:zl_i, i] = 0
    st.nzero[i] = min(zl_i, h)


def _find(st: SplayState, k: int) -> Tuple[int, int]:
    """The scalar lock-free walk: (slot or -1, steps)."""
    key = st.key
    pred, h, steps, found = HEAD, st.max_level - 1, 0, False
    zl = int(st.zl)
    while h >= zl and not found:
        curr = _eff_next(st, pred, h)
        if int(key[curr]) <= k:
            pred = curr
        else:
            found = int(key[pred]) == k
            h -= 1
        steps += 1
    found = found or int(key[pred]) == k
    return (pred if found and pred != HEAD else -1), steps


def _promote_cascade(st: SplayState, curr: int, pp: int, curr_m: int,
                     bits: int) -> bool:
    """Promote curr up while the ascent condition holds."""
    L = st.max_level
    ml1 = L - 1
    curh = int(st.top[curr])
    promoted = False
    while (curh + 1 < L and curh < int(st.top[pp])
           and (_whits(st, pp, curh + 1) - _whits(st, pp, curh)
                > _shift(curr_m, ml1 - curh - 1, bits))):
        _fill_down(st, pp, curh)
        new_hits = (int(st.hits[curh + 1, pp]) - int(st.hits[curh, pp])
                    - int(st.selfhits[curr]))
        st.top[curr] = curh + 1
        st.hits[curh + 1, curr] = new_hits
        st.nxt[curh + 1, curr] = st.nxt[curh + 1, pp]
        st.hits[curh + 1, pp] = st.hits[curh, pp]
        st.nxt[curh + 1, pp] = curr
        curh += 1
        promoted = True
    return promoted


def _demote(st: SplayState, curr: int, pred: int, h: int) -> None:
    if h == int(st.zl):
        st.zl.sub_(1)
    _fill_down(st, curr, h - 1)
    _fill_down(st, pred, h - 1)
    gh_curr = int(st.selfhits[curr]) + int(st.hits[h, curr])
    st.hits[h, pred] += gh_curr
    st.hits[h, curr] = 0
    st.nxt[h, pred] = st.nxt[h, curr]
    st.nxt[h, curr] = -1
    st.top[curr] = h - 1


def _update(st: SplayState, k: int, w: int = 1) -> None:
    """Forward-pass rebalance for a physically-present key k, with hit
    weight ``w`` (the aggregated fold adds ``w`` everywhere the unit
    pass adds 1)."""
    L = st.max_level
    ml1 = L - 1
    bits = torch.iinfo(st.m.dtype).bits
    st.m.add_(w)
    curr_m = int(st.m)
    key = st.key
    h, pred, pp = ml1, HEAD, HEAD
    found = done = scanned = False
    while not done and h >= int(st.zl):
        curr = _eff_next(st, pred, h)
        if int(key[curr]) > k:
            # end of scan at this level: on level entry (nothing scanned
            # yet) pred is k's parent here -> count the hit; on scan exit
            # the parent was already counted inside the scan
            if not (found or scanned):
                _fill_down(st, pred, h)
                st.hits[h, pred] += w
            h, pp, done, scanned = h - 1, pred, found, False
            continue
        is_parent = int(key[_eff_next(st, curr, h)]) > k
        is_target = int(key[curr]) == k
        if is_parent and is_target:
            st.selfhits[curr] += w
        if is_parent and not is_target:
            _fill_down(st, curr, h)
            st.hits[h, curr] += w
        found = found or (is_parent and is_target)
        scanned = True
        if _promote_cascade(st, curr, pp, curr_m, bits):
            pred = pp = curr
            continue
        nk = int(key[_eff_next(st, curr, h)])
        desc = (int(st.top[curr]) == h and nk <= k
                and (_get_hits(st, curr, h) + _get_hits(st, pred, h)
                     <= _shift(curr_m, ml1 - h, bits)))
        if desc:
            _demote(st, curr, pred, h)
        else:
            pred = curr


def _link_bottom(st: SplayState, k: int) -> None:
    """Physical insert of k at the bottom level."""
    zl = int(st.zl)
    pred, h = HEAD, st.max_level - 1
    while h >= zl:
        curr = _eff_next(st, pred, h)
        if int(st.key[curr]) <= k:
            pred = curr
        else:
            h -= 1
    j = int(st.n_alloc)
    if j >= st.capacity:
        raise RuntimeError(f"splay-list capacity {st.capacity} exhausted")
    _fill_down(st, pred, zl)
    st.key[j] = k
    st.nxt[zl, j] = st.nxt[zl, pred]
    st.nxt[zl, pred] = j
    st.top[j] = zl
    st.nzero[j] = zl
    st.selfhits[j] = 0
    st.deleted[j] = False
    st.n_alloc.add_(1)


def _rebuild_due(st: SplayState) -> bool:
    m = int(st.m)
    return m > 0 and 2 * int(st.dhits) >= m


def _contains_step(st: SplayState, k: int, upd: bool) -> Tuple[int, int]:
    slot, steps = _find(st, k)
    present = slot >= 0
    live = present and not bool(st.deleted[slot])
    if present and upd:
        _update(st, k)
        if not live:   # hit on a marked node counts toward deleted hits
            st.dhits.add_(1)
    return int(live), steps


def _insert_step(st: SplayState, k: int, upd: bool) -> Tuple[int, int]:
    slot, steps = _find(st, k)
    present = slot >= 0
    marked = present and bool(st.deleted[slot])
    if marked:                  # unmark + unconditional rebalance
        st.deleted[slot] = False
        st.dhits.sub_(st.selfhits[slot])
        st.size.add_(1)
        _update(st, k)
    elif present:               # unsuccessful insert: relaxed visit
        if upd:
            _update(st, k)
    else:
        _link_bottom(st, k)
        st.size.add_(1)
        _update(st, k)
    return int(not present or marked), steps


def _delete_step(st: SplayState, k: int, upd: bool) -> Tuple[int, int]:
    slot, steps = _find(st, k)
    present = slot >= 0
    marked = present and bool(st.deleted[slot])
    success = present and not marked
    if success:
        st.deleted[slot] = True
        st.size.sub_(1)
        _update(st, k)
        st.dhits.add_(st.selfhits[slot])
    elif marked and upd:        # relaxed visit of a marked node
        _update(st, k)
        st.dhits.add_(1)
    return int(success), steps


def _live_mask(st: SplayState) -> torch.Tensor:
    """bool [C]: the slots the ordered queries (and the index plane)
    see as live: allocated nodes, not delete-marked, sentinels
    excluded."""
    idx = torch.arange(st.capacity, device=st.device)
    return ((idx >= 2) & (idx < st.n_alloc) & ~st.deleted
            & (st.key < POS_INF_32))


def _pred_step(st: SplayState, k: int, upd: bool) -> Tuple[int, int]:
    """OP_PRED: the largest live key <= k (NEG_INF_32 when none); a
    pure read, ``upd`` ignored; the path length is the find walk's."""
    del upd
    _, steps = _find(st, k)
    mask = _live_mask(st) & (st.key <= k)
    return int(torch.where(mask, st.key, NEG_INF_32).max()), steps


def _range_step(st: SplayState, k: int, upd: bool) -> Tuple[int, int]:
    """OP_RANGE: the count of live keys <= k; a pure read."""
    del upd
    _, steps = _find(st, k)
    return int((_live_mask(st) & (st.key <= k)).sum()), steps


OP_STEPS = (_contains_step, _insert_step, _delete_step, _pred_step,
            _range_step)
# the op kinds after which the serialized fold checks for a due rebuild
# (an insert only lowers 2*dhits/m; ordered queries change nothing)
REBUILD_CHECKED = (OP_CONTAINS, OP_DELETE)


# ---------------------------------------------------------------------------
# rebuild (Section 2.2 "Efficient Rebuild"), vectorised.  The paper's
# recursion is unrolled level by level: at relative level r (top-down)
# every segment whose hit total H satisfies bit_length(H)-1 == r splits
# at its weighted median.
# ---------------------------------------------------------------------------

def _rev_cummin(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (dim,)), dim)[0], (dim,))


def rebuild(st: SplayState) -> SplayState:
    C = st.capacity
    L = st.max_level
    ml1 = L - 1
    cdt = st.hits.dtype
    dev = st.device
    i32 = dict(dtype=torch.int32, device=dev)

    # gather alive nodes in key order
    idx = torch.arange(C, device=dev)
    is_node = (idx >= 2) & (idx < st.n_alloc)
    alive = is_node & ~st.deleted & (st.key < POS_INF_32)
    sort_key = torch.where(alive, st.key, POS_INF_32)
    order = torch.sort(sort_key, stable=True)[1]       # alive first, by key
    keys_s = st.key[order]
    alive_s = alive[order]
    sh_s = torch.where(alive_s, st.selfhits[order], 0)
    n = int(alive_s.sum())
    big_m_t = sh_s.sum(dtype=cdt)
    big_m = int(big_m_t)

    k_new = min(max((big_m.bit_length() if big_m > 0 else 0) - 1, 0), ml1)
    zl_new = ml1 - k_new

    pref = torch.cumsum(sh_s, 0, dtype=cdt)            # inclusive prefix
    zero1 = torch.zeros((1,), dtype=cdt, device=dev)
    mfill = big_m_t.reshape(1)
    pref0 = torch.cat([zero1, pref[:-1]])

    # heights: rel height per sorted position, assigned top-down
    rel = torch.full((C,), -1, **i32)                  # -1 = unassigned
    one = torch.ones((), dtype=cdt, device=dev)
    for r in range(k_new, -1, -1):
        bnd = rel > r
        # segment start: prefix value at the last boundary strictly
        # before i; segment end: pref0 at the first boundary after i
        start_w = torch.cummax(torch.where(bnd, pref, 0), 0)[0]
        start_w = torch.cat([zero1, start_w[:-1]])
        end_w = _rev_cummin(torch.where(bnd, pref0, big_m_t), 0)
        end_w = torch.cat([end_w[1:], mfill])
        seg_h = end_w - start_w
        fires = (~bnd) & alive_s & (rel < 0) & (seg_h >= (one << r))
        # weighted median: first position with pref - start_w >= ceil(H/2)
        pos = torch.div(seg_h + 1, 2, rounding_mode="floor")
        reach = (pref - start_w) >= pos
        reach_prev = (pref0 - start_w) >= pos
        rel = torch.where(fires & reach & ~reach_prev, r, rel)
    rel = torch.where(alive_s, torch.clamp(rel, min=0), -1)
    top_new = torch.where(alive_s, zl_new + rel, 0).to(torch.int32)

    # fresh layout: alive nodes occupy slots 2..2+n in key order; dead
    # writes go to the extra lane C, which is sliced off
    slot_of_pos = torch.where(alive_s, idx + 2, 0)
    dst = torch.where(alive_s, slot_of_pos, C)

    def placed(vals, fill, dtype):
        out = torch.full((C + 1,), fill, dtype=dtype, device=dev)
        out[dst] = vals.to(dtype)
        return out[:C]

    new_key = placed(keys_s, POS_INF_32, torch.int32)
    new_key[HEAD] = NEG_INF_32
    new_sh = placed(sh_s, 0, cdt)
    new_sh[HEAD] = 1
    new_sh[TAIL] = 1
    new_top = placed(top_new, 0, torch.int32)
    new_top[HEAD] = L
    new_top[TAIL] = L
    new_nzero = placed(torch.full((C,), zl_new, **i32), L, torch.int32)
    new_nzero[HEAD] = zl_new
    new_nzero[TAIL] = L

    # per-level links + interval-sum hit counters
    lvls = torch.arange(L + 1, device=dev)[:, None]               # [L+1, 1]
    at_lvl = alive_s[None, :] & (top_new[None, :] >= lvls)        # [L+1, C]
    # next alive position at this level, scanning right-to-left
    nxt_pos = _rev_cummin(torch.where(at_lvl, idx[None, :], C + 7), 1)
    nxt_pos_excl = torch.cat(
        [nxt_pos[:, 1:], torch.full((L + 1, 1), C + 7, device=dev)], 1)
    has_succ = nxt_pos_excl <= C - 1
    succ_at = torch.clamp(nxt_pos_excl, max=C - 1)
    succ_slot = torch.where(has_succ, slot_of_pos[succ_at], TAIL)
    # interval sum (this, succ): pref0[succ_pos] - pref[this]
    seg_hits = torch.where(has_succ, pref0[succ_at], big_m_t) - pref[None, :]

    write_mask = at_lvl & (lvls >= zl_new)
    dst2 = torch.where(write_mask, slot_of_pos[None, :], C)
    lvl_idx = lvls.expand(L + 1, C)
    new_nxt = torch.full((L + 1, C + 1), -1, **i32)
    new_nxt[lvl_idx, dst2] = succ_slot.to(torch.int32)
    new_nxt = new_nxt[:, :C].contiguous()
    new_hits = torch.zeros((L + 1, C + 1), dtype=cdt, device=dev)
    new_hits[lvl_idx, dst2] = seg_hits.to(cdt)
    new_hits = new_hits[:, :C].contiguous()

    # head links: first alive position at each level (or tail)
    first_pos = nxt_pos[:, 0]
    has_first = first_pos <= C - 1
    first_at = torch.clamp(first_pos, max=C - 1)
    head_succ = torch.where(has_first, slot_of_pos[first_at], TAIL)
    head_hits = torch.where(has_first, pref0[first_at], big_m_t)
    head_lvl_mask = (lvls[:, 0] >= zl_new) & (lvls[:, 0] <= ml1)
    new_nxt[:, HEAD] = torch.where(head_lvl_mask, head_succ, -1).to(
        torch.int32)
    new_nxt[L, HEAD] = TAIL
    new_hits[:, HEAD] = torch.where(head_lvl_mask, head_hits, 0).to(cdt)

    def scalar(v, dt):
        return torch.tensor(v, dtype=dt, device=dev)

    return SplayState(
        key=new_key, nxt=new_nxt, hits=new_hits, selfhits=new_sh,
        top=new_top, nzero=new_nzero,
        deleted=torch.zeros((C,), dtype=torch.bool, device=dev),
        m=big_m_t.clone(), dhits=scalar(0, cdt), zl=scalar(zl_new,
                                                            torch.int32),
        n_alloc=scalar(n + 2, torch.int32), size=scalar(n, torch.int32))


def _maybe_rebuild(st: SplayState) -> SplayState:
    return rebuild(st) if _rebuild_due(st) else st


# ---------------------------------------------------------------------------
# operation-stream drivers
# ---------------------------------------------------------------------------

def _op_tensor(x, dtype, device):
    """Op inputs: host arrays/lists are copied to ``device``; a tensor
    must already be there (nothing moves between devices silently)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.array(x), device=device)
    elif x.device != device:
        raise ValueError(f"op tensor on {x.device}, state on {device}")
    return x.to(dtype).contiguous()


def run_ops(st: SplayState, kinds, keys, upd_mask):
    """Apply a stream of operations in order (the serialized fold).
    Returns ``(state, result int32 [T], path_len int32 [T])``: 0/1
    verdicts for contains/insert/delete, the predecessor key for
    ``OP_PRED`` and the prefix count for ``OP_RANGE`` (both pure reads
    of the live set at their place in the stream).  A rebuild fires
    inside the stream after any contains or delete that leaves
    ``2 * dhits >= m``, exactly where the JAX scan fires it."""
    from repro_torch.kernels import fold
    dev = st.device
    kinds = _op_tensor(kinds, torch.int32, dev)
    keys = _op_tensor(keys, torch.int32, dev)
    upd = _op_tensor(upd_mask, torch.bool, dev)
    n = kinds.shape[0]
    if not (keys.shape[0] == n and upd.shape[0] == n):
        raise ValueError(f"ragged op stream: kinds={n}, "
                         f"keys={keys.shape[0]}, upd={upd.shape[0]}")
    if n and bool(((kinds < OP_CONTAINS) | (kinds > OP_RANGE)).any()):
        raise ValueError("op kinds must be OP_CONTAINS, OP_INSERT, "
                         "OP_DELETE, OP_PRED or OP_RANGE")
    st = clone(st)
    res = torch.zeros((n,), dtype=torch.int32, device=dev)
    plen = torch.zeros((n,), dtype=torch.int32, device=dev)
    start = 0
    while start < n:
        stop = fold.fold_ops(st, kinds, keys, upd, res, plen, start)
        if stop >= n:
            break
        st = rebuild(st)
        start = stop + 1
    return st, res, plen


def contains(st: SplayState, k, upd=True):
    """One contains op: ``(state, live 0-d int32, path_len 0-d)``."""
    st, res, plen = run_ops(st, [OP_CONTAINS], [int(k)], [bool(upd)])
    return st, res[0], plen[0]


def insert(st: SplayState, k, upd=True):
    st, res, plen = run_ops(st, [OP_INSERT], [int(k)], [bool(upd)])
    return st, res[0], plen[0]


def delete(st: SplayState, k, upd=True):
    st, res, plen = run_ops(st, [OP_DELETE], [int(k)], [bool(upd)])
    return st, res[0], plen[0]


def predecessor(st: SplayState, k, upd=None):
    """The ``OP_PRED`` op: ``(state, largest live key <= k or
    NEG_INF_32, path_len)``; a pure read, ``upd`` ignored."""
    st, res, plen = run_ops(st, [OP_PRED], [int(k)], [False])
    return st, res[0], plen[0]


def rank_count(st: SplayState, k, upd=None):
    """The ``OP_RANGE`` op: ``(state, |{live k' <= k}|, path_len)``; a
    pure read, ``upd`` ignored."""
    st, res, plen = run_ops(st, [OP_RANGE], [int(k)], [False])
    return st, res[0], plen[0]


def pad_op_batch(kinds, keys, upd_mask, batch: int):
    """Host-side static-shape padding for epoch op buffers: right-pad
    an op batch of ``n <= batch`` live lanes to exactly ``batch`` lanes
    with guaranteed no-ops — ``OP_CONTAINS`` with ``upd=False`` (a pure
    read, so the padded epoch leaves the state bit-identical to the
    unpadded one).  Pad keys cycle the batch's live keys; an all-pad
    batch (``n == 0``) falls back to the max in-range key.

    Returns ``(kinds[batch], keys[batch], upd[batch], n)`` as int32 /
    int32 / bool numpy arrays plus the live-lane count."""
    kinds = np.asarray(kinds, np.int32).ravel()
    keys = np.asarray(keys, np.int32).ravel()
    upd = np.asarray(upd_mask, bool).ravel()
    n = kinds.shape[0]
    if not (keys.shape[0] == n and upd.shape[0] == n):
        raise ValueError(
            f"ragged op batch: kinds={n}, keys={keys.shape[0]}, "
            f"upd={upd.shape[0]}")
    if n > batch:
        raise ValueError(f"op batch of {n} exceeds pad target {batch}")
    out_kinds = np.full(batch, OP_CONTAINS, np.int32)
    out_keys = np.full(batch, POS_INF_32 - 1, np.int32)
    out_upd = np.zeros(batch, bool)
    out_kinds[:n] = kinds
    out_upd[:n] = upd
    if n:
        out_keys[:] = np.resize(keys, batch)
    return out_kinds, out_keys, out_upd, n


def fold_entries(st: SplayState, keys, upd_mask, aggregate: bool = False):
    """The search half of :func:`run_contains_batch`: the batch's
    lock-free searches against the state snapshot and the fold list
    they produce.  Returns ``((uk, w, wm), results bool [B], steps
    int32 [B])``: the fold runs a rebalance of weight ``w`` for each
    ``uk`` with ``w > 0`` and adds ``wm`` (the part on delete-marked
    nodes) to ``dhits``.  ``aggregate=True`` deduplicates the batch
    (stable sort + segment sums) into one entry per unique key,
    ascending; otherwise there is one unit entry per op."""
    dev = st.device
    keys = _op_tensor(keys, torch.int32, dev)
    upd = _op_tensor(upd_mask, torch.bool, dev)
    cdt = st.m.dtype
    slots, steps = find_batch(st, keys)
    present = slots >= 0
    marked = present & st.deleted[torch.clamp(slots, min=0).long()]
    do = upd & present
    if aggregate:
        B = keys.shape[0]
        order = torch.sort(keys, stable=True)[1]
        ks = keys[order]
        do_s = do[order]
        mk = marked[order]
        first = torch.ones((B,), dtype=torch.bool, device=dev)
        first[1:] = ks[1:] != ks[:-1]
        seg = torch.cumsum(first, 0, dtype=torch.int32).long() - 1
        w = torch.zeros((B,), dtype=cdt, device=dev).scatter_add_(
            0, seg, do_s.to(cdt))
        wm = torch.zeros((B,), dtype=cdt, device=dev).scatter_add_(
            0, seg, (do_s & mk).to(cdt))
        uk = torch.full((B,), torch.iinfo(torch.int32).max,
                        dtype=torch.int32, device=dev).scatter_reduce_(
            0, seg, ks, reduce="amin")
    else:
        uk, w, wm = keys, do.to(cdt), (do & marked).to(cdt)
    return (uk, w, wm), present & ~marked, steps


def run_contains_batch(st: SplayState, keys, upd_mask,
                       aggregate: bool = False):
    """A batch of B lock-free searches against the state snapshot,
    followed by the serialized update fold for the subsampled updaters
    (:func:`fold_entries`); the rebuild check runs once, at the batch
    boundary, so marked-but-visited keys stay physically present for
    the whole batch.  ``aggregate=True`` runs ONE weighted rebalance per
    unique key, ascending, instead of one per operation.
    Returns ``(state, results bool [B], steps int32 [B])``."""
    from repro_torch.kernels import fold
    entries, res, steps = fold_entries(st, keys, upd_mask, aggregate)
    st = clone(st)
    fold.fold_weighted(st, *entries)
    return _maybe_rebuild(st), res, steps


# ---------------------------------------------------------------------------
# serving epochs: op batch + device index-plane refresh
# ---------------------------------------------------------------------------

def _sharded(plane, mesh, axis) -> bool:
    """Whether an epoch runs its plane work width-sharded: a mesh whose
    axis ``axis`` divides the plane's global width."""
    from repro_torch.parallel import sharding as shd
    shd.check_mesh(mesh)
    return (mesh is not None and axis in mesh.shape and axis == mesh.axis
            and shd.plane_width(plane) % mesh.size == 0)


def _check_plane_dispatch(plane, mesh, axis, split):
    """Guard for the replicated epoch paths: a mass split needs the
    sharded refresh, and a segmented (mass-split) plane cannot take a
    replicated path."""
    from repro_torch.core import device_index as dix
    if _sharded(plane, mesh, axis):
        return
    if split == "mass":
        raise ValueError(
            "split='mass' requires the width-sharded path — pass mesh= "
            "with a plane width divisible by the axis size")
    if dix.plane_is_segmented(plane):
        raise ValueError(
            "segmented (mass-split) plane on the replicated epoch path "
            "— pass mesh= (a split='lanes' refresh repacks it) or "
            "rebuild with from_state_device before meshless serving")


def _check_route_args(route_capacity, route_slack):
    """The routed exchange's sizing knobs, validated even on meshless
    runs (where they are inert)."""
    if route_capacity is not None and int(route_capacity) < 1:
        raise ValueError(
            f"route_capacity must be >= 1, got {route_capacity}")
    if route_slack is not None and route_slack < 1.0:
        raise ValueError(
            f"route_slack must be >= 1.0, got {route_slack} "
            "(sub-1 slack guarantees spill on a balanced batch)")


def _run_epoch(st, plane, kinds, keys, upd_mask, aggregate, max_new,
               rebuild, plane_search, ordered, mesh=None, axis="model",
               split="lanes", route_capacity=None, route_slack=None,
               routed=True):
    from repro_torch.core import device_index as dix
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import splay_search as ssk
    from repro_torch.parallel import sharding as shd
    dev = st.device
    n_levels = plane.keys.shape[0]
    width = shd.plane_width(plane)
    sharded = _sharded(plane, mesh, axis)
    plane = (shd.shard_index_plane(plane, mesh, axis) if sharded
             else shd.gather_index_plane(plane))
    keys = _op_tensor(keys, torch.int32, dev)
    spill = torch.zeros((), dtype=torch.int32, device=dev)
    occupancy = torch.zeros((1,), dtype=torch.int32, device=dev)
    if plane_search:
        if not aggregate:
            raise ValueError("plane_search answers the batch from the "
                             "index plane — read-only batches only, "
                             "i.e. aggregate=True")
        if sharded:
            res, rank, plen, rstats = kops.splay_search_sharded(
                plane, keys, mesh=mesh, axis=axis, routed=routed,
                capacity=route_capacity,
                slack=(route_slack if route_slack is not None
                       else ssk.DEFAULT_ROUTE_SLACK),
                return_stats=True)
            spill, occupancy = rstats.spill, rstats.occupancy
        else:
            res, rank, plen = kops.splay_search(plane, keys, sharded=False)
        upd_eff = _op_tensor(upd_mask, torch.bool, dev)
        if ordered:
            # ordered lanes answer off the same descent's bottom-row
            # rank; pure reads, so they fold no hit weight
            kinds = _op_tensor(kinds, torch.int32, dev)
            pred_keys = kops.splay_select(plane, rank, sharded=sharded,
                                          mesh=mesh if sharded else None,
                                          axis=axis)
            res = torch.where(
                kinds == OP_PRED,
                torch.where(rank >= 0, pred_keys, NEG_INF_32),
                torch.where(kinds == OP_RANGE, rank + 1,
                            res.to(torch.int32)))
            upd_eff = upd_eff & (kinds == OP_CONTAINS)
        st, _, _ = run_contains_batch(st, keys, upd_eff, aggregate=True)
    elif aggregate:
        st, res, plen = run_contains_batch(st, keys, upd_mask,
                                           aggregate=True)
    else:
        st, res, plen = run_ops(st, kinds, keys, upd_mask)
    res = res.to(torch.int32)
    if max_new is None:
        # an epoch cannot insert more keys than it has ops
        max_new = keys.shape[0]
    if rebuild:
        plane = dix.from_state_device(st, n_levels=n_levels, width=width)
        # a full build drops nothing the plane can hold; only alive
        # counts beyond the width remain unrepresentable
        overflow = torch.clamp(st.size - width, min=0).to(torch.int32)
        if sharded:
            # the rebuild is replicated math: lay its result out again
            plane = shd.shard_index_plane(plane, mesh, axis)
    elif sharded:
        plane, overflow = dix.refresh_device_sharded(
            st, plane, max_new=max_new, mesh=mesh, axis=axis, split=split)
    else:
        plane, overflow = dix.refresh_device(st, plane, max_new=max_new,
                                             return_overflow=True)
    return st, plane, res, plen, overflow, spill, occupancy


def run_epoch(st: SplayState, plane, kinds, keys, upd_mask,
              aggregate: bool = False, max_new: int = None,
              rebuild=False, mesh=None, axis: str = "model",
              plane_search: bool = False, split: str = "lanes",
              route_capacity: int = None, route_slack: float = None,
              ordered: bool = False, routed: bool = True):
    """One serving epoch: apply a batch of operations (contains /
    insert / delete through :func:`run_ops`; ``aggregate=True`` runs the
    flat-combined contains fold of :func:`run_contains_batch` instead,
    ignoring ``kinds``), then refresh the device-resident index plane
    (``rebuild=True``: a full ``from_state_device`` rebuild instead of
    the incremental refresh — the overflow recovery path).

    ``plane_search`` (requires ``aggregate=True``) answers
    ``results``/``path_len`` from the plane entering the epoch through
    ``kernels.ops.splay_search``: ``results`` is the plane's membership
    verdict and ``path_len`` is ``level_found``.  The rebalance fold
    still runs.  ``ordered`` extends those answers to the ordered op
    codes: ``OP_PRED`` lanes answer the predecessor key (``NEG_INF_32``
    when none, one ``splay_select`` gather) and ``OP_RANGE`` lanes the
    prefix count, both from the same descent's rank; they carry no hit
    weight into the fold.  Off the plane-search path ``run_ops``
    answers the ordered codes itself.

    Sharded serving: with a ``mesh`` (``sharding.Mesh``; every rank of
    it calls this with the same replicated state and batch) whose axis
    ``axis`` divides the plane's width, the refresh runs as
    ``device_index.refresh_device_sharded`` (boundary rule ``split``,
    ``"lanes"`` or ``"mass"``) and plane-search answers come from the
    sharded search, routed (``routed=True``, sized by
    ``route_capacity``/``route_slack``) or through the masked trace.
    The plane may come laid out or global; the returned plane is this
    rank's block.  A rebuild epoch emits the packed layout.
    ``split="mass"`` without such a mesh raises ``ValueError``.

    Returns ``(state, plane, results[B] int32, path_len[B], overflow,
    spill, occupancy)``: ``overflow`` (0-d int32) counts alive keys the
    refreshed plane could not represent; ``spill`` (0-d) and
    ``occupancy`` (``[S]``) are the routed exchange's ``RouteStats`` on
    the sharded plane-search path, 0 and a ``[1]`` zero vector
    elsewhere."""
    _check_plane_dispatch(plane, mesh, axis, split)
    _check_route_args(route_capacity, route_slack)
    return _run_epoch(st, plane, kinds, keys, upd_mask, aggregate,
                      max_new, bool(rebuild), plane_search, ordered, mesh,
                      axis, split, route_capacity, route_slack, routed)


def run_serving(st: SplayState, plane, kinds, keys, upd_mask,
                aggregate: bool = False, max_new: int = None,
                mesh=None, axis: str = "model",
                plane_search: bool = False, split: str = "lanes",
                route_capacity: int = None, route_slack: float = None,
                ordered: bool = False, routed: bool = True):
    """The epoch loop: :func:`run_epoch` over ``[E, B]`` op batches,
    threading (state, plane, rebuild-pending) from epoch to epoch, with
    every option of :func:`run_epoch` (a mesh runs each epoch
    sharded).

    Overflow state machine: an epoch whose refresh reports nonzero
    overflow arms a pending flag, and the *next* epoch's refresh is a
    full ``from_state_device`` rebuild.  The alive count *entering* the
    near-full zone (within one batch of the plane width) arms it too,
    edge-triggered, once per crossing
    (``route_controller.overflow_machine_step``).  Returns ``(state,
    plane, results[E, B], path_len[E, B], overflow[E], spill[E],
    occupancy[E, S])`` (``occupancy[E, 1]`` of zeros off the sharded
    plane-search path)."""
    from repro_torch.core.route_controller import overflow_machine_step
    from repro_torch.parallel import sharding as shd
    _check_plane_dispatch(plane, mesh, axis, split)
    _check_route_args(route_capacity, route_slack)
    dev = st.device
    kinds = _op_tensor(kinds, torch.int32, dev)
    keys = _op_tensor(keys, torch.int32, dev)
    upd = _op_tensor(upd_mask, torch.bool, dev)
    width = shd.plane_width(plane)
    B = keys.shape[1]
    pending = pressed = False
    outs = []
    for e in range(keys.shape[0]):
        st, plane, *out = _run_epoch(
            st, plane, kinds[e], keys[e], upd[e], aggregate, max_new,
            pending, plane_search, ordered, mesh, axis, split,
            route_capacity, route_slack, routed)
        pending, pressed = overflow_machine_step(
            int(out[2]), int(st.size), B, width, pressed)
        outs.append(out)
    res, plen, ovf, spl, occ = (torch.stack(x) for x in zip(*outs))
    return st, plane, res, plen, ovf, spl, occ


# ---------------------------------------------------------------------------
# host-side introspection (tests / stats)
# ---------------------------------------------------------------------------

def to_numpy(st: SplayState) -> dict:
    return {f: getattr(st, f).cpu().numpy() for f in st._fields}


def heights(st: SplayState) -> dict:
    """key -> relative height, walking the bottom list on host."""
    s = to_numpy(st)
    out = {}
    zl = int(s["zl"])

    def eff_next(i, h):
        lvl = max(h, int(s["nzero"][i]))
        return int(s["nxt"][lvl, i])

    i = eff_next(HEAD, zl)
    while i != TAIL and i >= 0:
        out[int(s["key"][i])] = int(s["top"][i]) - zl
        i = eff_next(i, zl)
    return out
