"""The plain reference the benchmark holds the program to.

A sequential splay-list (Aksenov, Alistarh, Drozdova and Mohtashami,
arXiv:2008.01009) with the forward-pass rebalancing of Section 5, one
Python object per node, and the device index plane worked out from it
in NumPy.  It is a frozen copy of the semantics: the same operations on
the same inputs give the same answers, path lengths, counters, heights
and plane as any correct implementation.  It imports nothing of the
program under test, and takes nothing from it but the inputs.

Level indexing is absolute and anchored at the top: data levels run
from ``ML1 = max_level - 1`` down to ``zero_level`` (lowered lazily as
the hit total crosses powers of two), so the thresholds are exact
integer shifts:

    descent at level h :  hits(C_u^h) + hits(C_v^h) <= m >> (ML1 - h)
    ascent  from level h:  sum_{x in S_u} hits(C_x^h) > m >> (ML1 - h - 1)

Besides the operations of the paper, the batch forms the serving loop
runs: :meth:`SplayList.run_ops` (an op list in order, a rebuild where
``2 * dhits >= m`` after a contains or a delete) and
:meth:`SplayList.fold_batch` (a batch of searches against the snapshot,
then one weighted rebalance per distinct coined key, ascending, and the
rebuild check once at the end).  A ``journal`` records every node a
batch writes, so the entries it changed can be counted afterwards
(:meth:`SplayList.stop_journal`), for the roofline of the fold.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

NEG_INF = -(1 << 62)
POS_INF = 1 << 62

OP_CONTAINS, OP_INSERT, OP_DELETE = 0, 1, 2

# canonical values of the state comparison: a link to the tail, and a
# level a node does not materialize
TAIL_KEY = 1 << 40
NO_LINK = -(1 << 40)
# the plane's pad key (int32 max), as the program's plane holds it
PAD_KEY = 2 ** 31 - 1


class Node:
    __slots__ = ("key", "zero_level", "top_level", "selfhits", "nxt",
                 "hits", "deleted")

    def __init__(self, key: int, level: int, max_level: int):
        self.key = key
        self.zero_level = level            # lowest materialized level
        self.top_level = level             # highest level the node is on
        self.selfhits = 0
        self.nxt: List[Optional["Node"]] = [None] * (max_level + 1)
        self.hits: List[int] = [0] * (max_level + 1)
        self.deleted = False


def _snapshot(node: Node) -> tuple:
    return (node.zero_level, node.top_level, node.selfhits, node.deleted,
            [None if n is None else n.key for n in node.nxt],
            list(node.hits))


class SplayList:
    """Sequential splay-list with forward-pass rebalancing; every
    balancing decision comes in as an explicit coin (``upd``)."""

    def __init__(self, max_level: int):
        self.max_level = max_level
        self.ML1 = max_level - 1
        self.m = 0                          # total hit-operations
        self.deleted_hits = 0               # hits on marked nodes
        self.zero_level = self.ML1
        self.head = Node(NEG_INF, 0, max_level)
        self.tail = Node(POS_INF, 0, max_level)
        self.head.selfhits = 1
        self.tail.selfhits = 1
        self.head.zero_level = self.ML1
        self.head.top_level = max_level
        self.tail.zero_level = max_level
        self.tail.top_level = max_level
        self.head.nxt[self.ML1] = self.tail
        self.head.nxt[max_level] = self.tail
        self.size = 0                       # unmarked keys
        self.n_alloc = 2                    # slots in use, sentinels too
        self.rebuilds = 0
        self.journal: Optional[dict] = None
        self._journal_base = None
        self._journal_bytes = 0

    # -- helpers -----------------------------------------------------------

    def _touch(self, node: Node) -> None:
        j = self.journal
        if j is not None and id(node) not in j:
            j[id(node)] = (node, _snapshot(node))

    @staticmethod
    def _next(node: Node, h: int) -> Node:
        z = node.zero_level
        return node.nxt[z if z > h else h]

    def _fill_down(self, node: Node, h: int) -> None:
        """Materialize ``node``'s levels down to ``h``."""
        if node.zero_level > h:
            self._touch(node)
        while node.zero_level > h:
            zl = node.zero_level
            node.hits[zl - 1] = 0
            node.nxt[zl - 1] = node.nxt[zl]
            node.zero_level = zl - 1

    # -- find: the lock-free search (pure) --------------------------------

    def find(self, key: int) -> Tuple[Optional[Node], int]:
        """``(node or None, path length)``: every horizontal move plus
        one per level descended, down to the level the key is found on.
        A delete-marked node is returned too (it is physically present)."""
        pred = self.head
        steps = 0
        h = self.ML1
        zl = self.zero_level
        while h >= zl:
            z = pred.zero_level
            curr = pred.nxt[z if z > h else h]
            while curr.key <= key:
                pred = curr
                z = pred.zero_level
                curr = pred.nxt[z if z > h else h]
                steps += 1
            steps += 1
            if pred.key == key:
                break
            h -= 1
        if pred.key == key and pred is not self.head:
            return pred, steps
        return None, steps

    # -- the forward-pass update ------------------------------------------

    def _update(self, key: int, w: int = 1) -> None:
        """Forward-pass balancing for a physically present ``key`` with
        hit weight ``w`` (``w`` identical hit-operations folded into one
        traversal).  Per level, top down: count the hit on the key's
        parent, promote the leftmost scanned node while the ascent
        condition holds, demote a node that tops out here while the
        descent condition holds; stop on the level the key is found.
        (The lazy successor, ``nxt[max(h, zero_level)]``, and
        ``hits^h``, which reads 0 below ``zero_level``, are written
        out inline: this loop is most of the reference's time.)"""
        self.m += w
        m = self.m
        ML1 = self.ML1
        L = self.max_level
        touch = self._touch if self.journal is not None else None
        fill_down = self._fill_down

        pred = self.head
        h = ML1
        while h >= self.zero_level:
            predpred = pred
            z = pred.zero_level
            curr = pred.nxt[z if z > h else h]
            if curr.key > key:
                if pred.key != key:
                    if z > h:
                        fill_down(pred, h)
                    if touch:
                        touch(pred)
                    pred.hits[h] += w
                h -= 1
                continue

            found_here = False
            while curr.key <= key:
                z = curr.zero_level
                nxt = curr.nxt[z if z > h else h]
                if nxt.key > key:
                    if touch:
                        touch(curr)
                    if curr.key == key:
                        curr.selfhits += w
                        found_here = True
                    else:
                        if z > h:
                            fill_down(curr, h)
                        curr.hits[h] += w

                # ascent (promote while it holds)
                curh = curr.top_level
                promoted = False
                while curh + 1 < L and curh < predpred.top_level \
                        and curh + 1 <= ML1:
                    pz = predpred.zero_level
                    hp = predpred.hits
                    s_u = ((hp[curh + 1] if pz <= curh + 1 else 0)
                           - (hp[curh] if pz <= curh else 0))
                    if s_u <= (m >> (ML1 - curh - 1)):
                        break
                    fill_down(predpred, curh)
                    if touch:
                        touch(predpred)
                        touch(curr)
                    curr.top_level = curh + 1
                    curr.hits[curh + 1] = hp[curh + 1] - hp[curh] \
                        - curr.selfhits
                    curr.nxt[curh + 1] = predpred.nxt[curh + 1]
                    hp[curh + 1] = hp[curh]
                    predpred.nxt[curh + 1] = curr
                    curh += 1
                    promoted = True
                if promoted:
                    predpred = curr
                    pred = curr
                    z = curr.zero_level
                    curr = curr.nxt[z if z > h else h]
                    continue

                # descent (demote a node that tops out here)
                if curr.top_level == h and nxt.key <= key:
                    z = curr.zero_level
                    pz = pred.zero_level
                    g = (curr.selfhits + (curr.hits[h] if z <= h else 0)
                         + pred.selfhits + (pred.hits[h] if pz <= h else 0))
                    if g <= (m >> (ML1 - h)):
                        if h == self.zero_level:
                            self.zero_level -= 1
                        fill_down(curr, h - 1)
                        fill_down(pred, h - 1)
                        if touch:
                            touch(curr)
                            touch(pred)
                        pred.hits[h] = pred.hits[h] + curr.selfhits \
                            + curr.hits[h]
                        curr.hits[h] = 0
                        pred.nxt[h] = curr.nxt[h]
                        curr.nxt[h] = None
                        curr.top_level = h - 1
                        z = pred.zero_level
                        curr = pred.nxt[z if z > h else h]
                        continue

                pred = curr
                curr = nxt

            if found_here:
                return
            h -= 1

    # -- the operations, each with its coin -------------------------------

    def contains(self, key: int, upd: bool) -> Tuple[int, int]:
        node, steps = self.find(key)
        if node is None:
            return 0, steps
        live = not node.deleted
        if upd:
            self._update(key)
            if not live:
                self.deleted_hits += 1
        return int(live), steps

    def insert(self, key: int, upd: bool) -> Tuple[int, int]:
        node, steps = self.find(key)
        if node is not None and node.deleted:
            # revival: unmark, and rebalance unconditionally
            self._touch(node)
            node.deleted = False
            self.deleted_hits -= node.selfhits
            self.size += 1
            self._update(key)
            return 1, steps
        if node is not None:
            if upd:
                self._update(key)
            return 0, steps
        self._link_bottom(key)
        self.size += 1
        self._update(key)
        return 1, steps

    def delete(self, key: int, upd: bool) -> Tuple[int, int]:
        node, steps = self.find(key)
        if node is None:
            return 0, steps
        if node.deleted:
            if upd:
                self._update(key)
                self.deleted_hits += 1
            return 0, steps
        self._touch(node)
        node.deleted = True
        self.size -= 1
        self._update(key)
        self.deleted_hits += node.selfhits
        return 1, steps

    def _link_bottom(self, key: int) -> Node:
        zl = self.zero_level
        node = Node(key, zl, self.max_level)
        if self.journal is not None:
            self.journal[id(node)] = (node, None)
        pred = self.head
        for h in range(self.ML1, zl - 1, -1):
            curr = self._next(pred, h)
            while curr.key <= key:
                pred = curr
                curr = self._next(pred, h)
        self._fill_down(pred, zl)
        self._touch(pred)
        node.nxt[zl] = pred.nxt[zl]
        pred.nxt[zl] = node
        self.n_alloc += 1
        return node

    def rebuild_due(self) -> bool:
        return self.m > 0 and 2 * self.deleted_hits >= self.m

    def _maybe_rebuild(self) -> None:
        """Rebuild when due; a journal keeps what the batch changed before
        it and starts afresh on the rebuilt nodes."""
        if not self.rebuild_due():
            return
        if self.journal is not None:
            self._journal_bytes += self._changed_bytes()
        self.rebuild()
        if self.journal is not None:
            self._open_journal()

    # -- the batch forms the serving loop runs ------------------------------

    def run_ops(self, kinds, keys, upd, skip=None):
        """An op list in order (0 contains, 1 insert, 2 delete); returns
        ``(result int32 [n], path_len int32 [n])``.  A rebuild fires
        after any contains or delete that leaves ``2 * dhits >= m``.
        Ops where ``skip`` is true must be contains without a coin: a
        pure read changes nothing, so it is left out (its answer and
        path length read -1) and what follows is as if it had run."""
        ops = (self.contains, self.insert, self.delete)
        n = len(kinds)
        res = np.full(n, -1, np.int32)
        plen = np.full(n, -1, np.int32)
        if skip is None:
            skip = np.zeros(n, bool)
        if np.any(skip & ((np.asarray(kinds) != OP_CONTAINS)
                          | np.asarray(upd, bool))):
            raise ValueError("only contains without a coin can be skipped")
        for i, (kind, k, u, s) in enumerate(zip(
                kinds.tolist(), keys.tolist(), upd.tolist(), skip.tolist())):
            if s:
                continue
            res[i], plen[i] = ops[kind](k, u)
            if kind != OP_INSERT:
                self._maybe_rebuild()
        return res, plen

    def fold_batch(self, keys, upd) -> int:
        """A batch of contains against the snapshot, then the fold: one
        rebalance of weight ``w`` (the batch's coined ops on the key) per
        distinct present key, ascending, ``dhits`` raised by the part on
        marked nodes, and the rebuild check once at the end.  Returns
        the number of weighted entries."""
        coined = np.asarray(keys)[np.asarray(upd, bool)]
        uk, w = np.unique(coined, return_counts=True)
        entries = []
        for k, wk in zip(uk.tolist(), w.tolist()):
            node, _ = self.find(k)
            if node is not None:
                entries.append((k, wk, wk if node.deleted else 0))
        for k, wk, wm in entries:
            self._update(k, wk)
            self.deleted_hits += wm
        self._maybe_rebuild()
        return len(entries)

    # -- rebuild (Section 2.2, the O(M) weighted-median split) -------------

    def items(self):
        """Every physically present node, marked ones too, in key order."""
        node = self._next(self.head, self.zero_level)
        while node.key < POS_INF:
            yield node
            node = self._next(node, self.zero_level)

    def rebuild(self) -> None:
        alive = [(n.key, n.selfhits) for n in self.items() if not n.deleted]
        self.rebuilds += 1
        big_m = sum(sh for _, sh in alive)
        self.m = big_m
        self.deleted_hits = 0
        k_new = max(big_m.bit_length() - 1, 0)
        self.zero_level = self.ML1 - k_new
        self.head.zero_level = self.zero_level
        for h in range(self.max_level + 1):
            self.head.nxt[h] = self.tail if h >= self.zero_level else None
            self.head.hits[h] = 0
        n = len(alive)
        self.size = n
        self.n_alloc = n + 2
        self.head.nxt[self.max_level] = self.tail
        if not alive:
            return
        heights = [self.zero_level] * n
        prefix = [0] * (n + 1)
        for i, (_, sh) in enumerate(alive):
            prefix[i + 1] = prefix[i] + sh
        stack = [(0, n - 1)]
        while stack:
            lo, hi = stack.pop()
            if lo > hi:
                continue
            big_h = prefix[hi + 1] - prefix[lo]
            rel = min(max(max(big_h.bit_length(), 1) - 1, 0), k_new)
            pos = (big_h + 1) // 2 + prefix[lo]
            s = lo
            while prefix[s + 1] < pos:
                s += 1
            heights[s] = self.zero_level + rel
            stack.append((lo, s - 1))
            stack.append((s + 1, hi))
        nodes = []
        for (key, sh), top in zip(alive, heights):
            nd = Node(key, self.zero_level, self.max_level)
            nd.top_level = min(top, self.ML1)
            nd.selfhits = sh
            nodes.append(nd)
        for h in range(self.zero_level, self.ML1 + 1):
            pred_idx = -1
            for i, nd in enumerate(nodes):
                if nd.top_level >= h:
                    carrier = self.head if pred_idx < 0 else nodes[pred_idx]
                    carrier.nxt[h] = nd
                    carrier.hits[h] = (prefix[i] - (0 if pred_idx < 0
                                                    else prefix[pred_idx + 1]))
                    pred_idx = i
            carrier = self.head if pred_idx < 0 else nodes[pred_idx]
            carrier.nxt[h] = self.tail
            carrier.hits[h] = prefix[n] - (0 if pred_idx < 0
                                           else prefix[pred_idx + 1])

    # -- what the comparison and the counts read ----------------------------

    def live_heights(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(keys, relative heights)`` of the unmarked nodes, ascending."""
        ks, hs = [], []
        zl = self.zero_level
        for n in self.items():
            if not n.deleted:
                ks.append(n.key)
                hs.append(n.top_level - zl)
        return np.asarray(ks, np.int64), np.asarray(hs, np.int64)

    def canon(self) -> dict:
        """The state in the comparison's canonical form: per physically
        present node in key order its levels, counters and mark, its
        successor's key and its hit counter at each materialized level
        (``NO_LINK``/0 elsewhere), the head's links, and the counters."""
        L = self.max_level
        nodes = list(self.items())
        n = len(nodes)
        succ = np.full((L + 1, n), NO_LINK, np.int64)
        hits = np.zeros((L + 1, n), np.int64)
        key = np.empty(n, np.int64)
        top = np.empty(n, np.int64)
        nzero = np.empty(n, np.int64)
        sh = np.empty(n, np.int64)
        dele = np.empty(n, bool)
        for i, nd in enumerate(nodes):
            key[i], top[i], nzero[i] = nd.key, nd.top_level, nd.zero_level
            sh[i], dele[i] = nd.selfhits, nd.deleted
            for h in range(nd.zero_level, nd.top_level + 1):
                nx = nd.nxt[h]
                succ[h, i] = TAIL_KEY if nx is self.tail else nx.key
                hits[h, i] = nd.hits[h]
        hd = self.head
        head_succ = np.full(L + 1, NO_LINK, np.int64)
        head_hits = np.zeros(L + 1, np.int64)
        for h in range(hd.zero_level, L + 1):
            nx = hd.nxt[h]
            head_succ[h] = TAIL_KEY if nx is self.tail else nx.key
            head_hits[h] = hd.hits[h]
        return dict(key=key, top=top, nzero=nzero, selfhits=sh,
                    deleted=dele, succ=succ, hits=hits,
                    head_nzero=np.asarray([hd.zero_level], np.int64),
                    head_succ=head_succ, head_hits=head_hits,
                    scalars=np.asarray([self.m, self.deleted_hits,
                                        self.zero_level, self.size,
                                        self.n_alloc], np.int64))

    def _scalars(self) -> tuple:
        return (self.m, self.deleted_hits, self.zero_level, self.size,
                self.n_alloc)

    def _open_journal(self) -> None:
        self.journal = {}
        self._journal_base = self._scalars()

    def start_journal(self) -> None:
        """Record from here on which entries the operations change."""
        self._journal_bytes = 0
        self._open_journal()

    def stop_journal(self) -> int:
        """Stop recording; returns the bytes of state changed since
        :meth:`start_journal`, in the program's layout: 4 per key, link,
        counter, level and scalar, 1 per mark, each entry once however
        often it was written; a node created counts every entry it
        holds.  A rebuild's own writes are not counted (the fold does not
        make them)."""
        out = self._journal_bytes + self._changed_bytes()
        self.journal = None
        return out

    def _changed_bytes(self) -> int:
        out = 4 * sum(a != b for a, b in zip(self._journal_base,
                                             self._scalars()))
        for node, before in self.journal.values():
            now = _snapshot(node)
            if before is None:
                out += 4 * 4 + 1 + 8 * (node.top_level - node.zero_level + 1)
                continue
            out += sum(4 for a, b in zip(before[:3], now[:3]) if a != b)
            out += int(before[3] != now[3])
            out += 4 * sum(a != b for a, b in zip(before[4], now[4]))
            out += 4 * sum(a != b for a, b in zip(before[5], now[5]))
        return out


def populate(max_level: int, order) -> Tuple[SplayList, np.ndarray,
                                              np.ndarray]:
    """A fresh list after one op list of inserts in ``order``, every coin
    on, as the program populates: ``(list, results, path lengths)``."""
    ref = SplayList(max_level)
    order = np.asarray(order)
    n = order.shape[0]
    res, plen = ref.run_ops(np.full(n, OP_INSERT, np.int32), order,
                            np.ones(n, bool))
    return ref, res, plen


# ---------------------------------------------------------------------------
# the index plane, worked out from the keys and heights
# ---------------------------------------------------------------------------

def plane(keys, rel_h, n_levels: int, width: int) -> dict:
    """The level-array plane of ``keys`` (ascending, at most ``width``)
    with relative heights ``rel_h``: row ``r`` holds, sorted, the keys of
    height ``>= n_levels - 1 - r`` (row 0 the tallest, the bottom row all
    keys), ``+INF`` padded.  Beside the rows: the live width of each row,
    the bottom row's heights, ``rank_map`` (the index of each entry in
    the row below; a pad entry holds that row's width, the bottom row
    the identity) and ``bot_rank`` (each entry's index in the bottom
    row; a pad entry the bottom row's width).  All int64."""
    keys = np.asarray(keys, np.int64)
    rel_h = np.asarray(rel_h, np.int64)
    n = keys.shape[0]
    if n > width:
        raise ValueError(f"{n} keys do not fit a plane of width {width}")
    col = np.arange(width, dtype=np.int64)
    ks = np.full(width, PAD_KEY, np.int64)
    ks[:n] = keys
    h = np.full(width, -1, np.int64)
    h[:n] = rel_h
    row_min_h = n_levels - 1 - np.arange(n_levels, dtype=np.int64)
    mask = h[None, :] >= row_min_h[:, None]
    cs = np.cumsum(mask, axis=1, dtype=np.int64)
    widths = cs[:, width - 1].copy()
    take = np.empty((n_levels, width), np.int64)
    for r in range(n_levels):
        take[r] = np.searchsorted(cs[r], col + 1, side="left")
    np.minimum(take, width - 1, out=take)
    live = col[None, :] < widths[:, None]
    rows = np.where(live, ks[take], PAD_KEY)
    cs_next = np.concatenate([cs[1:], np.ones((1, width), np.int64)], 0)
    rank_live = np.take_along_axis(cs_next, take, axis=1) - 1
    pad_default = np.concatenate([widths[1:], [0]])
    rank_map = np.where(live, rank_live, pad_default[:, None])
    rank_map[n_levels - 1] = col
    bot_rank = np.where(live, take, widths[n_levels - 1])
    heights = np.zeros(width, np.int64)
    heights[:n] = rel_h
    return dict(keys=rows, widths=widths, heights=heights,
                rank_map=rank_map, bot_rank=bot_rank)


def levels_found(live_keys, live_h, queries, n_levels: int) -> np.ndarray:
    """The row a descent finds each query on: ``n_levels - 1 - h`` for a
    live key of relative height ``h``, ``n_levels`` for any other."""
    queries = np.asarray(queries, np.int64)
    pos = np.searchsorted(live_keys, queries)
    pos_c = np.minimum(pos, max(live_keys.shape[0] - 1, 0))
    hit = (pos < live_keys.shape[0]) & (live_keys[pos_c] == queries) \
        if live_keys.shape[0] else np.zeros(queries.shape, bool)
    return np.where(hit, n_levels - 1 - live_h[pos_c], n_levels)
