"""Pure-Python reference splay-list: the twin of ``repro.core.ref_py``.

The sequential splay-list of Aksenov, Alistarh, Drozdova and Mohtashami
(2020) with the forward-pass rebalancing of Section 5, one object per
node.  It is the semantic oracle of the package and the host index of
``serve.kv_cache.PagedKVPool`` (its host mode, and the rung-2 oracle of
the device mode's degradation ladder).

Level indexing is absolute and anchored at the top: data levels run
from ``ML1 = max_level - 1`` down to ``self.zero_level`` (the current
bottom, lowered lazily as m crosses powers of two), so the thresholds
are invariant:

    descent at level h :  hits(C_u^h) + hits(C_v^h) <= m / 2^(ML1 - h)
    ascent  from level h:  sum_{x in S_u} hits(C_x^h) > m / 2^(ML1 - h - 1)

Threshold comparisons are exact:  ``s <= m / 2^e  <=>  s <= (m >> e)`` and
``s > m / 2^e  <=>  s > (m >> e)`` for non-negative integers.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Tuple

NEG_INF = -(1 << 62)
POS_INF = (1 << 62)


class Node:
    __slots__ = (
        "key", "value", "zero_level", "top_level", "selfhits", "nxt",
        "hits", "deleted",
    )

    def __init__(self, key: int, value, level: int, max_level: int):
        self.key = key
        self.value = value
        self.zero_level = level            # lowest materialized level
        self.top_level = level             # highest level this node is on
        self.selfhits = 0                  # sh_u
        # nxt[h] / hits[h] valid for zero_level <= h <= top_level
        self.nxt: List[Optional["Node"]] = [None] * (max_level + 1)
        self.hits: List[int] = [0] * (max_level + 1)   # hits_u^h = hits(C_u^h \ {u})
        self.deleted = False

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Node(key={self.key}, top={self.top_level}, sh={self.selfhits})"


class SplayList:
    """Sequential splay-list with forward-pass rebalancing.

    Parameters
    ----------
    max_level:  total number of data levels available (paper uses 64).
                Level ``max_level`` is the sentinel list holding only
                head/tail.
    p:          balancing probability (relaxed rebalancing, Section 4).
                p = 1.0 reproduces the exact-counter algorithm.
    rng:        random source for the Bernoulli(p) balancing decisions.
    """

    def __init__(self, max_level: int = 32, p: float = 1.0,
                 rng: Optional[random.Random] = None):
        self.max_level = max_level
        self.ML1 = max_level - 1           # top data level
        self.p = p
        self.rng = rng or random.Random(0xC0FFEE)
        self.m = 0                          # total hit-operations (all objects)
        self.deleted_hits = 0               # hits currently on marked objects
        self.zero_level = self.ML1          # current bottom level (lazy)
        self.head = Node(NEG_INF, None, 0, max_level)
        self.tail = Node(POS_INF, None, 0, max_level)
        self.head.selfhits = 1              # convention: hits_head = 1
        self.tail.selfhits = 1
        # head participates in lazy expansion like any node: it is
        # materialized only at [zero_level, max_level] and copies its next
        # pointer downward as the list deepens (the original bug class this
        # guards against: a pre-materialized lower level on head would
        # bypass nodes demoted into freshly opened bottom levels).
        self.head.zero_level = self.ML1
        self.head.top_level = max_level     # sentinels span everything
        self.tail.zero_level = max_level
        self.tail.top_level = max_level
        self.head.nxt[self.ML1] = self.tail
        self.head.nxt[max_level] = self.tail
        self.size = 0                       # unmarked keys
        self.rebuilds = 0
        # instrumentation
        self.last_path_len = 0

    # -- helpers -----------------------------------------------------------

    def _get_hits(self, node: Node, h: int) -> int:
        """hits(C_node^h) = sh + hits^h, honouring lazy expansion."""
        if node.zero_level > h:
            return node.selfhits
        return node.selfhits + node.hits[h]

    def _next(self, node: Node, h: int) -> Node:
        """Effective successor at level h under lazy expansion."""
        if node.zero_level > h:
            return node.nxt[node.zero_level]
        return node.nxt[h]

    def _fill_down(self, node: Node, h: int) -> None:
        """updateZeroLevel: materialize node's levels down to h."""
        while node.zero_level > h:
            zl = node.zero_level
            node.hits[zl - 1] = 0
            node.nxt[zl - 1] = node.nxt[zl]
            node.zero_level = zl - 1

    def _descent_ok(self, s: int, h: int, m: int) -> bool:
        return s <= (m >> (self.ML1 - h))

    def _ascent_ok(self, s: int, h: int, m: int) -> bool:
        # ascent *from* level h to h+1
        return s > (m >> (self.ML1 - h - 1))

    # -- find (lock-free search phase; pure) -------------------------------

    def find(self, key: int) -> Tuple[Optional[Node], int]:
        """Return (node-or-None, path_length). Path length counts every
        node visit (horizontal move) plus one per level descended, matching
        the 'average length of a path' metric of Tables 1-3."""
        pred = self.head
        steps = 0
        found = None
        for h in range(self.ML1, self.zero_level - 1, -1):
            curr = self._next(pred, h)
            while curr.key <= key:
                pred = curr
                curr = self._next(pred, h)
                steps += 1
            steps += 1  # descend
            if pred.key == key:
                found = pred
                break
        self.last_path_len = steps
        if found is not None and found is not self.head:
            return found, steps
        return None, steps

    # -- the forward-pass update (search + counters + rebalance) -----------

    def _update(self, key: int, w: int = 1) -> Optional[Node]:
        """Forward-pass balancing (Section 5).  ``key`` must be physically
        present.  Returns the node with this key.

        ``w`` is the hit weight: the aggregated-batch oracle (mirroring
        ``splaylist.run_contains_batch(..., aggregate=True)``) folds w
        identical hit-operations into one traversal by adding w wherever
        the unit pass adds 1 (m, parent subtree counters, selfhits).

        Per level h (top -> bottom):
          - increment the hits counter of the parent of `key` at level h
            (selfhits if the parent *is* the key's node);
          - check the ascent condition for each scanned node (only the
            leftmost can fire, per Lemma 1) and promote, possibly several
            levels (cascade);
          - check the descent condition for scanned nodes that top out at
            this level and demote them.
        Stops at the level where the key's node is found (all lower parents
        are the node itself).
        """
        self.m += w
        curr_m = self.m
        target = None

        pred = self.head
        h = self.ML1
        while h >= self.zero_level:
            predpred = pred                    # parent of the scan at level h+1
            curr = self._next(pred, h)
            if curr.key > key:
                # pred is the parent of `key` at level h
                if pred.key == key:
                    # can only happen for the target found at a higher level;
                    # we stop before descending in that case, so unreachable.
                    pass
                else:
                    if pred.zero_level > h:
                        self._fill_down(pred, h)
                    pred.hits[h] += w
                h -= 1
                continue

            found_here = False
            while curr.key <= key:
                nxt = self._next(curr, h)
                if nxt.key > key:
                    # curr is the parent of `key` at level h
                    if curr.key == key:
                        curr.selfhits += w
                        target = curr
                        found_here = True
                    else:
                        if curr.zero_level > h:
                            self._fill_down(curr, h)
                        curr.hits[h] += w

                # --- ascent condition (pseudocode lines 38-56) ----------
                curh = curr.top_level
                promoted = False
                while (curh + 1 < self.max_level
                       and curh < predpred.top_level
                       and curh + 1 <= self.ML1
                       and self._ascent_ok(
                           self._get_hits(predpred, curh + 1)
                           - self._get_hits(predpred, curh),
                           curh, curr_m)):
                    # hoist curr above: S_u sum = predpred.hits[h+1]-hits[h]
                    # (materialize predpred through curh first: the write
                    # below needs real, not lazily-virtual, levels)
                    self._fill_down(predpred, curh)
                    curr.top_level = curh + 1
                    curr.hits[curh + 1] = (
                        predpred.hits[curh + 1] - predpred.hits[curh]
                        - curr.selfhits)
                    curr.nxt[curh + 1] = predpred.nxt[curh + 1]
                    predpred.hits[curh + 1] = predpred.hits[curh]
                    predpred.nxt[curh + 1] = curr
                    curh += 1
                    promoted = True
                if promoted:
                    predpred = curr
                    pred = curr
                    curr = self._next(curr, h)
                    continue

                # --- descent condition (pseudocode lines 57-89) ---------
                if (curr.top_level == h
                        and self._next(curr, h).key <= key
                        and self._descent_ok(
                            self._get_hits(curr, h) + self._get_hits(pred, h),
                            h, curr_m)):
                    if h == self.zero_level:
                        # lazy list expansion: open a new bottom level
                        self.zero_level -= 1
                    self._fill_down(curr, h - 1)
                    self._fill_down(pred, h - 1)
                    pred.hits[h] = pred.hits[h] + self._get_hits(curr, h)
                    curr.hits[h] = 0
                    pred.nxt[h] = curr.nxt[h]
                    curr.nxt[h] = None
                    curr.top_level = h - 1
                    curr = self._next(pred, h)
                    continue

                pred = curr
                curr = self._next(curr, h)

            if found_here:
                return target
            h -= 1

        return target

    def _maybe_update(self, key: int, upd: Optional[bool] = None
                      ) -> Optional[Node]:
        """Relaxed rebalancing coin; ``upd`` overrides the RNG (used by the
        differential tests to feed identical decisions to both engines)."""
        if upd is None:
            upd = self.p >= 1.0 or self.rng.random() < self.p
        if upd:
            return self._update(key)
        return None

    # -- public operations --------------------------------------------------

    def contains(self, key: int, upd: Optional[bool] = None) -> bool:
        node, _ = self.find(key)
        if node is None:
            return False
        was_deleted = node.deleted
        res = self._maybe_update(key, upd)
        if res is not None and was_deleted:
            self.deleted_hits += 1
            self._maybe_rebuild()
        return not was_deleted

    def insert(self, key: int, value=None, upd: Optional[bool] = None) -> bool:
        node, _ = self.find(key)
        if node is not None:
            if node.deleted:
                # revival: unmark, count the hit, rebalance unconditionally
                # ("the structure has to be re-balanced ... as in contains",
                # and insert's balancing phase is never relaxed, Section 5).
                node.deleted = False
                self.deleted_hits -= node.selfhits
                self.size += 1
                node.value = value
                self._update(key)
                return True
            self._maybe_update(key, upd)
            return False
        # physical insert at the current bottom level
        self._link_bottom(key, value)
        self.size += 1
        # insertion is a hit-operation: always update (the new node must
        # get sh=1; the paper's insert performs the backward pass
        # unconditionally — only contains is relaxed).
        self._update(key)
        return True

    def delete(self, key: int, upd: Optional[bool] = None) -> bool:
        node, _ = self.find(key)
        if node is None:
            return False
        if node.deleted:
            res = self._maybe_update(key, upd)
            if res is not None:
                self.deleted_hits += 1
                self._maybe_rebuild()
            return False
        node.deleted = True
        self.size -= 1
        self._update(key)
        self.deleted_hits += node.selfhits
        self._maybe_rebuild()
        return True

    # -- physical linking ----------------------------------------------------

    def _link_bottom(self, key: int, value) -> Node:
        zl = self.zero_level
        node = Node(key, value, zl, self.max_level)
        pred = self.head
        for h in range(self.ML1, zl - 1, -1):
            curr = self._next(pred, h)
            while curr.key <= key:
                pred = curr
                curr = self._next(pred, h)
        self._fill_down(pred, zl)
        node.nxt[zl] = pred.nxt[zl]
        pred.nxt[zl] = node
        return node

    # -- rebuild (Section 2.2, Efficient Rebuild) ----------------------------

    def _maybe_rebuild(self) -> None:
        if self.m > 0 and 2 * self.deleted_hits >= self.m:
            self.rebuild()

    def items(self) -> Iterator[Node]:
        node = self._next(self.head, self.zero_level)
        while node.key < POS_INF:
            yield node
            node = self._next(node, self.zero_level)

    def rebuild(self) -> None:
        """Physically drop marked nodes; rebuild so that (nearly) no node
        satisfies ascent/descent.  Recursive weighted-median split: the
        heaviest segment's split key gets the top height (O(M) algorithm)."""
        alive = [(n.key, n.value, n.selfhits) for n in self.items()
                 if not n.deleted]
        self.rebuilds += 1
        big_m = sum(sh for _, _, sh in alive)
        self.m = big_m
        self.deleted_hits = 0
        k_new = max(big_m.bit_length() - 1, 0)
        self.zero_level = self.ML1 - k_new
        self.head.zero_level = self.zero_level
        for h in range(self.max_level + 1):
            self.head.nxt[h] = (self.tail if h >= self.zero_level else None)
            self.head.hits[h] = 0
        if not alive:
            return
        n = len(alive)
        heights = [self.zero_level] * n   # absolute top level per node
        prefix = [0] * (n + 1)
        for i, (_, _, sh) in enumerate(alive):
            prefix[i + 1] = prefix[i] + sh

        # recursive split; iterative stack to avoid recursion limits
        stack = [(0, n - 1)]
        while stack:
            lo, hi = stack.pop()
            if lo > hi:
                continue
            big_h = prefix[hi + 1] - prefix[lo]
            p_exp = max(big_h.bit_length(), 1)       # 2^(p-1) <= H < 2^p
            rel = min(max(p_exp - 1, 0), k_new)
            # split point: the key sitting at the middle cell ceil(H/2) of
            # the expanded array T (paper's O(M) variant).  Gives
            # left <= H/2 and right <= floor(H/2).
            pos = (big_h + 1) // 2 + prefix[lo]       # global 1-indexed cell
            s = lo
            while prefix[s + 1] < pos:
                s += 1
            heights[s] = self.zero_level + rel
            stack.append((lo, s - 1))
            stack.append((s + 1, hi))

        # materialize nodes bottom-up with subtree hit counters
        nodes = []
        for (key, value, sh), top in zip(alive, heights):
            nd = Node(key, value, self.zero_level, self.max_level)
            nd.top_level = min(top, self.ML1)
            nd.selfhits = sh
            nodes.append(nd)
        # link each level; compute hits_u^h = sum of sh over (u, next_geq_h)
        for h in range(self.zero_level, self.ML1 + 1):
            pred = self.head
            pred_idx = -1
            for i, nd in enumerate(nodes):
                if nd.top_level >= h:
                    carrier = self.head if pred_idx < 0 else nodes[pred_idx]
                    carrier.nxt[h] = nd
                    carrier.hits[h] = (prefix[i] -
                                       (0 if pred_idx < 0 else
                                        prefix[pred_idx + 1]))
                    pred_idx = i
            carrier = self.head if pred_idx < 0 else nodes[pred_idx]
            carrier.nxt[h] = self.tail
            carrier.hits[h] = prefix[n] - (0 if pred_idx < 0 else
                                           prefix[pred_idx + 1])
        # head sentinel level
        self.head.nxt[self.max_level] = self.tail
        self.size = n

    # -- introspection for tests ---------------------------------------------

    def check_no_ascent(self) -> List[Tuple[int, int]]:
        """Return violations of Lemma 1 (empty list == invariant holds).

        For each level h and each 'leftmost child run' S_u starting after a
        taller node v, the sum over S_u of hits(C_x^h) must be
        <= m / 2^(ML1-h-1) ... strictly: not (> threshold)."""
        out = []
        if self.m == 0:
            return out
        for h in range(self.zero_level, self.ML1):
            # iterate runs between consecutive taller-than-h nodes
            v = self.head
            while v.key < POS_INF:
                # sum over nodes of height exactly h between v and the next
                # node with height > h
                s = 0
                first_run_node = None
                x = self._next(v, h)
                while x.key < POS_INF and x.top_level == h:
                    if first_run_node is None:
                        first_run_node = x
                    s += self._get_hits(x, h)
                    x = self._next(x, h)
                if first_run_node is not None and self._ascent_ok(
                        s, h, self.m):
                    out.append((first_run_node.key, h))
                v = x if x.key < POS_INF else self.tail
                if v is self.tail:
                    break
        return out

    def heights(self) -> dict:
        """key -> relative height (0 == bottom list)."""
        return {n.key: n.top_level - self.zero_level for n in self.items()}

    def counters_ok(self) -> bool:
        """Consistency: for every node u and materialized level h,
        hits_u^h == sum of selfhits of nodes strictly in (u, next^h(u))
        (interval-sum semantics of hits(C_u^h \\ {u}))."""
        # snapshot bottom list in key order with prefix sums
        order = [self.head] + list(self.items())
        pos = {id(n): i for i, n in enumerate(order)}
        pref = [0]
        for n in order:
            pref.append(pref[-1] + n.selfhits)
        for u in order:
            lo = max(u.zero_level, self.zero_level)
            hi = min(u.top_level, self.ML1)
            for h in range(lo, hi + 1):
                nxt = u.nxt[h] if u.zero_level <= h else None
                if nxt is None:
                    return False  # materialized level must have a link
                i = pos[id(u)]
                j = len(order) if nxt is self.tail else pos[id(nxt)]
                expected = pref[j] - pref[i + 1]
                if u.hits[h] != expected:
                    return False
        return True
