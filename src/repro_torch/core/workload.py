"""Workload generators for the paper's experiments (Section 6).

The port's own copy of the numpy generators it drives: the op-stream
record, the Bernoulli rebalancing coins, the bounded Zipf(s) stream of
Figure 12, the Zipf token ids of the vocab tier and the splay-shaped
level-array fixture the kernel checks use.  Pure numpy, so the arrays feed either package unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

OP_CONTAINS = 0
OP_INSERT = 1
OP_DELETE = 2


class OpStream(NamedTuple):
    kinds: np.ndarray   # int32[T]
    keys: np.ndarray    # int32[T]
    upd: np.ndarray     # bool[T]   pre-sampled Bernoulli(p) balancing coins
    populate: np.ndarray  # int32[n] keys to insert before timing


def _coins(rng: np.random.Generator, t: int, p: float) -> np.ndarray:
    if p >= 1.0:
        return np.ones(t, dtype=bool)
    return rng.random(t) < p


def zipf_workload(n: int, ops: int, s: float = 1.0, p: float = 1.0,
                  seed: int = 0) -> OpStream:
    """Bounded Zipf(s) over n keys (Figure 12; s=1 is the paper's setting).
    Key identities are randomly permuted so rank does not equal key order."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-s)
    probs /= probs.sum()
    perm = rng.permutation(n).astype(np.int32)
    draws = rng.choice(n, size=ops, p=probs)
    keys = perm[draws].astype(np.int32)
    return OpStream(np.zeros(ops, np.int32), keys, _coins(rng, ops, p),
                    np.sort(perm))


def zipf_token_ids(rng: np.random.Generator, vocab: int, shape,
                   s: float = 1.0) -> np.ndarray:
    """Zipf(s)-distributed token ids (id = frequency rank), as a decode
    stream or an LM batch draws them.  The support is capped at 2^17 ids
    for sampling speed, so the draws equal the reference's for any
    vocabulary."""
    v = min(vocab, 1 << 17)
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks ** (-s)
    probs /= probs.sum()
    draws = rng.choice(v, size=int(np.prod(shape)), p=probs)
    return draws.reshape(shape).astype(np.int32)


def zipf_level_fixture(width: int, alpha: float, nq: int, seed: int = 0):
    """Splay-shaped level arrays + an aligned Zipf(alpha) query batch.

    Heights follow the paper's calibration (top ~1% of ranks at height 5,
    halving per level); queries sample keys by the same rank order, so hot
    queries hit tall keys exactly as a converged splay-list would arrange.
    Returns (keys [width], heights [width], queries [nq]) — feed
    keys/heights to ``device_index.build_device``.
    """
    rng = np.random.default_rng(seed)
    n = width
    keys = np.sort(rng.choice(20 * n, n, replace=False)).astype(np.int32)
    ranks = np.argsort(rng.permutation(n))
    heights = np.clip(5 - np.log2(1 + ranks / (n * 0.01)), 0,
                      5).astype(np.int32)
    p = 1.0 / (1 + np.arange(n)) ** alpha
    p /= p.sum()
    key_by_rank = keys[np.argsort(ranks)]
    qs = rng.choice(key_by_rank, nq, p=p).astype(np.int32)
    return keys, heights, qs
