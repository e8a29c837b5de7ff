"""CBTree baseline (Afek, Kaplan, Korenfeld, Morrison, Tarjan, DISC'12):
the twin of ``repro.core.cbtree``, pure Python.

A counting-based self-adjusting BST: every node counts the accesses to
its subtree, and rotations keep hot nodes near the root (amortized
O(log(m/f(x))) access).  The rotation rule is the greedy local one: a
single rotation of x above its parent p strictly lowers the weighted
path length iff

    w(outer-subtree(x)) + cnt(x)  >  w(other-subtree(p)) + cnt(p)

so after each counted access the path is walked bottom-up and every
strictly improving rotation applied, with subtree weights kept in O(1)
per rotation.  The relaxed-balancing knob p is the splay-list's: an
access is counted with probability p, from ``random.Random(0xCB)``
unless the caller passes its own generator, so the same op sequence
gives the same tree, answers and path lengths as the JAX package's.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple


class _N:
    __slots__ = ("key", "left", "right", "parent", "cnt", "w", "deleted")

    def __init__(self, key):
        self.key = key
        self.left: Optional["_N"] = None
        self.right: Optional["_N"] = None
        self.parent: Optional["_N"] = None
        self.cnt = 0        # accesses to this node
        self.w = 0          # total accesses in subtree (incl. cnt)
        self.deleted = False


class CBTree:
    def __init__(self, p: float = 1.0, rng: Optional[random.Random] = None):
        self.root: Optional[_N] = None
        self.p = p
        self.rng = rng or random.Random(0xCB)
        self.size = 0
        self.m = 0
        self.last_path_len = 0

    # -- basic BST ----------------------------------------------------------

    def _search(self, key) -> Tuple[Optional[_N], Optional[_N], int]:
        """Returns (node-or-None, last-visited, path_len)."""
        node, prev, steps = self.root, None, 0
        while node is not None:
            steps += 1
            prev = node
            if key == node.key:
                self.last_path_len = steps
                return node, prev, steps
            node = node.left if key < node.key else node.right
        self.last_path_len = steps
        return None, prev, steps

    def contains(self, key, upd: Optional[bool] = None) -> bool:
        node, _, _ = self._search(key)
        if node is None:
            return False
        if upd is None:
            upd = self.p >= 1.0 or self.rng.random() < self.p
        if upd:
            self._count_and_adjust(node)
        return not node.deleted

    def insert(self, key) -> bool:
        node, prev, _ = self._search(key)
        if node is not None:
            if node.deleted:
                node.deleted = False
                self.size += 1
                self._count_and_adjust(node)
                return True
            return False
        n = _N(key)
        n.parent = prev
        if prev is None:
            self.root = n
        elif key < prev.key:
            prev.left = n
        else:
            prev.right = n
        self.size += 1
        self._count_and_adjust(n)
        return True

    def delete(self, key) -> bool:
        node, _, _ = self._search(key)
        if node is None or node.deleted:
            return False
        node.deleted = True     # logical deletion, like the splay-list
        self.size -= 1
        self._count_and_adjust(node)
        return True

    # -- counting + rotations -------------------------------------------------

    @staticmethod
    def _w(n: Optional[_N]) -> int:
        return 0 if n is None else n.w

    def _count_and_adjust(self, x: _N) -> None:
        self.m += 1
        x.cnt += 1
        node = x
        while node is not None:     # bump subtree weights up the path
            node.w += 1
            node = node.parent
        # greedy improving rotations bottom-up from x
        node = x
        while node.parent is not None:
            p = node.parent
            if node is p.left:
                gain = self._w(node.left) + node.cnt
                loss = self._w(p.right) + p.cnt
            else:
                gain = self._w(node.right) + node.cnt
                loss = self._w(p.left) + p.cnt
            if gain > loss:
                self._rotate_up(node)
                # node kept its new parent (former grandparent); continue
            else:
                node = p

    def _rotate_up(self, x: _N) -> None:
        p = x.parent
        g = p.parent
        if x is p.left:
            p.left = x.right
            if x.right is not None:
                x.right.parent = p
            x.right = p
        else:
            p.right = x.left
            if x.left is not None:
                x.left.parent = p
            x.left = p
        p.parent = x
        x.parent = g
        if g is None:
            self.root = x
        elif g.left is p:
            g.left = x
        else:
            g.right = x
        # weights: recompute p then x (O(1))
        p.w = self._w(p.left) + self._w(p.right) + p.cnt
        x.w = self._w(x.left) + self._w(x.right) + x.cnt

    # -- introspection ---------------------------------------------------------

    def depth(self, key) -> int:
        node, steps = self.root, 0
        while node is not None:
            steps += 1
            if key == node.key:
                return steps
            node = node.left if key < node.key else node.right
        return -1

    def check_weights(self) -> bool:
        def rec(n):
            if n is None:
                return 0, True
            lw, lo = rec(n.left)
            rw, ro = rec(n.right)
            return lw + rw + n.cnt, lo and ro and (lw + rw + n.cnt == n.w)
        _, ok = rec(self.root)
        return ok
