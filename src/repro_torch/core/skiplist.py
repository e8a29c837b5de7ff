"""Classic (non-adaptive) skip-list baselines: the twin of
``repro.core.skiplist``.

The paper's primary baseline, a Pugh-style skip-list with geometric
random heights (p = 1/2), in two engines:

* :class:`SkipList`, sequential Python with lazy deletion, drawing its
  heights from ``random.Random(0xBEEF)``; it drives the sequential
  tables (Tables 1-3).  Its path length counts a step per move and per
  level, and a search stops at the level where it meets the key.
* the state engine (:class:`SkipState`, :func:`make`, :func:`find_batch`,
  :func:`run_contains_batch`, :func:`run_ops`), the array layout of
  ``core/splaylist.py`` minus the counters; it drives the batched
  figures (Figs. 3-5) on the same harness as the splay-list.  Its path
  length counts walk steps, one per advance or descent, and sees a
  match only on a descent, as the reference's ``while_loop`` does.

Each engine keeps its own twin's count, so each is held to its twin.

State representation (capacity ``C`` slots, ``L = max_level`` levels;
slot 0 = head, slot 1 = tail):

    key       int32[C]     NEG/POS_INF_32 sentinels at slots 0/1
    nxt       int32[L, C]  successor slot per level (-1 = unlinked)
    top       int32[C]     topmost level of the node
    deleted   bool [C]     lazy-delete mark
    n_alloc   int32[]      bump allocator
    size      int32[]      unmarked key count

Execution model.  ``find_batch`` (and so ``run_contains_batch``) is one
launch of kernel W (``kernels/state_walk.py``) on the card, each lane
stepping as the reference's vmapped ``while_loop`` does with no walk
step waiting on the host; on CPU tensors it is W's plain version, a
masked torch loop over the batch.  ``run_ops``, the serialized fold of
contains / insert / delete, is one launch of kernel S
(``kernels/skip_fold.py``) on CUDA tensors and its plain step-by-step
fold on CPU tensors.  Inserts take pre-sampled heights
(:func:`sample_heights`).  An insert that finds the capacity exhausted
raises ``RuntimeError`` and leaves the caller's state as it was (the
reference drops its writes there and links the predecessors to a slot
out of range, after which a walk can loop for ever).  Walk keys stay
below ``POS_INF_32``: a walk for the tail sentinel's key never returns
in the reference, and here it raises ``ValueError``.

Every entry point runs on the card unless the caller passes
``device="cpu"`` (or hands in CPU tensors); without a card a CUDA
request raises.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.splaylist import _device, _op_tensor
from repro_torch.kernels import state_walk

NEG_INF = -(1 << 62)
POS_INF = (1 << 62)

NEG_INF_32 = -(2 ** 31) + 1
POS_INF_32 = 2 ** 31 - 1

OP_CONTAINS = 0
OP_INSERT = 1
OP_DELETE = 2

HEAD = 0
TAIL = 1


# ---------------------------------------------------------------------------
# Python engine
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("key", "nxt", "top", "deleted")

    def __init__(self, key, top, max_level):
        self.key = key
        self.top = top
        self.nxt = [None] * (max_level + 1)
        self.deleted = False


class SkipList:
    """Sequential skip-list with lazy deletion (marking)."""

    def __init__(self, max_level: int = 32,
                 rng: Optional[random.Random] = None):
        self.max_level = max_level
        self.ML1 = max_level - 1
        self.rng = rng or random.Random(0xBEEF)
        self.head = _Node(NEG_INF, max_level, max_level)
        self.tail = _Node(POS_INF, max_level, max_level)
        for h in range(max_level + 1):
            self.head.nxt[h] = self.tail
        self.size = 0
        self.last_path_len = 0

    def _rand_height(self) -> int:
        h = 0
        while h < self.ML1 and self.rng.random() < 0.5:
            h += 1
        return h

    def find(self, key) -> Tuple[Optional[_Node], int]:
        pred = self.head
        steps = 0
        found = None
        for h in range(self.ML1, -1, -1):
            curr = pred.nxt[h]
            while curr.key <= key:
                pred = curr
                curr = pred.nxt[h]
                steps += 1
            steps += 1
            if pred.key == key:
                found = pred
                break
        self.last_path_len = steps
        return (found if found is not None and found is not self.head
                else None), steps

    def contains(self, key) -> bool:
        node, _ = self.find(key)
        return node is not None and not node.deleted

    def insert(self, key) -> bool:
        # collect predecessors at every level
        preds = [None] * (self.max_level + 1)
        pred = self.head
        for h in range(self.ML1, -1, -1):
            curr = pred.nxt[h]
            while curr.key <= key:
                pred = curr
                curr = pred.nxt[h]
            preds[h] = pred
        if pred.key == key:
            if pred.deleted:
                pred.deleted = False
                self.size += 1
                return True
            return False
        top = self._rand_height()
        node = _Node(key, top, self.max_level)
        for h in range(top + 1):
            node.nxt[h] = preds[h].nxt[h]
            preds[h].nxt[h] = node
        self.size += 1
        return True

    def delete(self, key) -> bool:
        node, _ = self.find(key)
        if node is None or node.deleted:
            return False
        node.deleted = True
        self.size -= 1
        return True


# ---------------------------------------------------------------------------
# state engine (the splay-list's array representation, minus counters)
# ---------------------------------------------------------------------------

class SkipState(NamedTuple):
    key: torch.Tensor        # [C]
    nxt: torch.Tensor        # [L, C]
    top: torch.Tensor        # [C]
    deleted: torch.Tensor    # [C]
    n_alloc: torch.Tensor    # scalar int32
    size: torch.Tensor       # scalar int32

    @property
    def max_level(self) -> int:
        return self.nxt.shape[0]

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device


def make(capacity: int, max_level: int = 20, device="cuda") -> SkipState:
    """Empty skip-list; head/tail sentinels occupy slots 0/1."""
    dev = _device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    key = torch.full((capacity,), POS_INF_32, **i32)
    key[HEAD] = NEG_INF_32
    nxt = torch.full((max_level, capacity), -1, **i32)
    nxt[:, HEAD] = TAIL
    top = torch.zeros((capacity,), **i32)
    top[HEAD] = max_level - 1
    top[TAIL] = max_level - 1
    return SkipState(
        key=key, nxt=nxt, top=top,
        deleted=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        n_alloc=torch.tensor(2, **i32), size=torch.tensor(0, **i32))


def clone(st: SkipState) -> SkipState:
    return SkipState(*(t.clone() for t in st))


def find_batch(st: SkipState, ks) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search for a batch of keys (read-only): ``(slot, steps)`` int32,
    slot -1 where the key is not physically present; ``steps`` counts
    advances and descents.  One launch of kernel W
    (``kernels/state_walk.py``) on the card, its plain masked loop on
    the CPU; each lane steps as the scalar walk would.  Keys
    ``>= POS_INF_32`` raise ``ValueError`` and leave the state as it
    was."""
    ks = _op_tensor(ks, torch.int32, st.device)
    return state_walk.skip_walk(st, ks)


def find(st: SkipState, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar :func:`find_batch`: ``(slot, steps)`` 0-d int32."""
    slot, steps = find_batch(st, [int(k)])
    return slot[0], steps[0]


def run_contains_batch(st: SkipState, keys):
    """A batch of searches against the state: ``(state, live bool [B],
    steps int32 [B])``; the state is returned as it came (a skip-list
    does not adapt)."""
    slots, steps = find_batch(st, keys)
    ok = (slots >= 0) & ~st.deleted[torch.clamp(slots, min=0).long()]
    return st, ok, steps


# ---------------------------------------------------------------------------
# the serialized fold, step by step (kernel S's plain version): plain
# Python over lists read from the CPU state and written back at the end
# ---------------------------------------------------------------------------

def _find(key, nxt, L: int, k: int) -> Tuple[int, int]:
    """The scalar walk: ``(slot or -1, steps)``.  Negative indices wrap,
    as the reference's gathers do."""
    pred, h, steps, found = HEAD, L - 1, 0, False
    while h >= 0 and not found:
        curr = nxt[h][pred]
        if key[curr] <= k:
            pred = curr
        else:
            found = key[pred] == k
            h -= 1
        steps += 1
    found = found or key[pred] == k
    return (pred if found and pred != HEAD else -1), steps


def _find_preds(key, nxt, L: int, k: int) -> list:
    """The reference's predecessors of ``k``: top-down from the head,
    at each level the last node with key ``<= k``."""
    preds, pred = [HEAD] * L, HEAD
    for h in range(L - 1, -1, -1):
        while key[nxt[h][pred]] <= k:
            pred = nxt[h][pred]
        preds[h] = pred
    return preds


def _finger_preds(key, nxt, L: int, k: int, fingers) -> list:
    """Kernel S's predecessors of ``k``, from ``fingers`` (the last
    insert's predecessor or new node at each level, None before the
    first insert).  The skip-list never unlinks, so a finger stays on
    its level: where its key is ``<= k`` and its successor's ``> k``, it
    is the predecessor at once.  The other levels resolve top-down, each
    from the level above's answer or from the finger's successor where
    that lies further right (both at or before the predecessor).  Equal
    to :func:`_find_preds` at every level."""
    preds, starts = [None] * L, [None] * L
    if fingers is not None:
        for h, f in enumerate(fingers):
            if key[f] <= k:
                succ = nxt[h][f]
                if key[succ] > k:
                    preds[h] = f
                else:
                    starts[h] = succ
    cur = HEAD
    for h in range(L - 1, -1, -1):
        if preds[h] is None:
            g = starts[h]
            if g is not None and key[g] > key[cur]:
                cur = g
            while key[nxt[h][cur]] <= k:
                cur = nxt[h][cur]
            preds[h] = cur
        cur = preds[h]
    return preds


def fold_plain(st: SkipState, kinds, keys, heights, res, plen,
               trace=None) -> int:
    """Contains / insert / delete in order on the CPU state ``st``, in
    place, writing each op's answer and path length (0 for an insert).
    Returns the index of an insert that found the capacity exhausted
    (nothing of that op written), or ``n``.  An insert finds its
    predecessors from the last insert's (:func:`_finger_preds`), as
    kernel S does.  A list ``trace`` gets, for each insert, its
    predecessors by the fingers and by :func:`_find_preds`."""
    C, L = st.capacity, st.max_level
    key, nxt, top = st.key.tolist(), st.nxt.tolist(), st.top.tolist()
    deleted = st.deleted.tolist()
    n_alloc, size = int(st.n_alloc), int(st.size)
    n = kinds.shape[0]
    stop = n
    res_l, plen_l = [False] * n, [0] * n
    fingers = None
    for i, (kind, k, height) in enumerate(zip(
            kinds.tolist(), keys.tolist(), heights.tolist())):
        steps = 0
        if kind == OP_INSERT:
            preds = _finger_preds(key, nxt, L, k, fingers)
            if trace is not None:
                trace.append((preds, _find_preds(key, nxt, L, k)))
            pred = preds[0]
            present = key[pred] == k
            marked = present and deleted[pred]
            fingers = preds
            if marked:
                deleted[pred] = False
                size += 1
            elif not present:
                j = n_alloc
                if j >= C:
                    stop = i
                    break
                for h in range(L):
                    if h <= height:
                        nxt[h][j] = nxt[h][preds[h]]
                        nxt[h][preds[h]] = j
                    else:
                        nxt[h][j] = -1
                key[j], top[j], deleted[j] = k, height, False
                n_alloc += 1
                size += 1
                fingers = [j if h <= height else p
                           for h, p in enumerate(preds)]
            r = not present or marked
        else:
            slot, steps = _find(key, nxt, L, k)
            r = slot >= 0 and not deleted[slot]
            if r and kind == OP_DELETE:
                deleted[slot] = True
                size -= 1
        res_l[i], plen_l[i] = r, steps
    for t, v in ((st.key, key), (st.nxt, nxt), (st.top, top),
                 (st.deleted, deleted), (st.n_alloc, n_alloc),
                 (st.size, size)):
        t.copy_(torch.tensor(v, dtype=t.dtype))
    res.copy_(torch.tensor(res_l, dtype=torch.bool))
    plen.copy_(torch.tensor(plen_l, dtype=torch.int32))
    return stop


def run_ops(st: SkipState, kinds, keys, heights):
    """Apply a stream of operations in order (the serialized fold):
    contains, insert (of height ``heights[i]``) and delete.  Returns
    ``(state, res bool [T], path_len int32 [T])``; inserts report path
    length 0, as the reference does.  Raises ``RuntimeError`` when an
    insert finds the capacity exhausted."""
    from repro_torch.kernels import skip_fold
    dev = st.device
    kinds = _op_tensor(kinds, torch.int32, dev)
    keys = _op_tensor(keys, torch.int32, dev)
    heights = _op_tensor(heights, torch.int32, dev)
    n = kinds.shape[0]
    if not (keys.shape[0] == n and heights.shape[0] == n):
        raise ValueError(f"ragged op stream: kinds={n}, "
                         f"keys={keys.shape[0]}, heights={heights.shape[0]}")
    if n and bool(((kinds < OP_CONTAINS) | (kinds > OP_DELETE)).any()):
        raise ValueError("op kinds must be OP_CONTAINS, OP_INSERT or "
                         "OP_DELETE")
    state_walk.check_keys(keys)
    st = clone(st)
    res = torch.zeros((n,), dtype=torch.bool, device=dev)
    plen = torch.zeros((n,), dtype=torch.int32, device=dev)
    stop = skip_fold.fold_ops(st, kinds, keys, heights, res, plen)
    if stop < n:
        raise RuntimeError(f"skip-list capacity {st.capacity} exhausted "
                           f"at op {stop}")
    return st, res, plen


def sample_heights(rng: np.random.Generator, n: int, max_level: int,
                   device="cuda") -> torch.Tensor:
    """Pre-sampled geometric(1/2) heights for the state engine, int32,
    the reference's values from the same generator."""
    u = rng.random(n)
    h = np.minimum(
        np.floor(-np.log2(np.maximum(u, 1e-12))).astype(np.int32),
        max_level - 1)
    return torch.as_tensor(h, device=_device(device))


# ---------------------------------------------------------------------------
# host-side introspection (tests / stats)
# ---------------------------------------------------------------------------

def to_numpy(st: SkipState) -> dict:
    return {f: getattr(st, f).cpu().numpy() for f in st._fields}
