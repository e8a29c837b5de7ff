"""Workload generators for the paper's experiments (Section 6).

The port's own copy of the numpy generators it drives: the op-stream
record, the Bernoulli rebalancing coins, the bounded Zipf(s) stream of
Figure 12, the Zipf token ids of the vocab tier, the splay-shaped
level-array fixture the kernel checks use, and the request traces of
the paged KV pool's session index (``kv_request_trace``,
``kv_scan_trace``) and the serving engine's request arrivals
(``poisson_zipf_arrivals``).  Pure numpy, drawing in the JAX package's
order, so the same seed gives the same arrays and they feed either
package unchanged.
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


# request-level arrival processes: what the serving engine's queue
# consumes (requests with arrival times, Zipf prompt token streams and
# per-request decode budgets)

class ArrivalStream(NamedTuple):
    """A request arrival trace for ``serve.engine.Engine``.

    Declared invariants (``tests/test_torch_serve_engine.py`` holds
    them):
      * ``arrival`` is non-decreasing with ``arrival[0] >= 0`` — epochs
        are *decode-step* units, the engine's virtual clock;
      * ``seq_ids`` are unique (session identity, keys of the paged-KV
        splay index);
      * ``prompt_lens[i] in [1, prompts.shape[1]]`` and
        ``prompts[i, j]`` is a token id in ``[1, vocab)`` for
        ``j < prompt_lens[i]`` and ``-1`` (pad) past it;
      * ``max_new[i] >= 1``.
    An empty stream (``n_requests == 0``) keeps every invariant with
    zero-length leading axes."""
    arrival: np.ndarray      # int32[R] non-decreasing decode-step epochs
    seq_ids: np.ndarray      # int32[R] unique request/session ids
    prompts: np.ndarray      # int32[R, P] token ids, -1 right-padded
    prompt_lens: np.ndarray  # int32[R]
    max_new: np.ndarray      # int32[R] per-request decode budget
    name: str


def poisson_zipf_arrivals(n_requests: int, rate: float, vocab: int,
                          prompt_len=(2, 8), max_new=8,
                          zipf_s: float = 1.0, seed: int = 0,
                          name: str = "poisson_zipf") -> ArrivalStream:
    """Poisson arrivals (``rate`` = mean requests per decode step;
    ``rate=inf`` collapses to a single burst at epoch 0) carrying
    Zipf(``zipf_s``) prompt token streams — token traffic and session
    traffic are the same skew phenomenon the splay tiers exploit.
    ``prompt_len`` and ``max_new`` may be ints or inclusive ``(lo, hi)``
    ranges.  Deterministic per seed."""
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0, got {n_requests}")
    if not rate > 0:
        raise ValueError(f"rate must be > 0 (or inf), got {rate}")
    if vocab < 2:
        raise ValueError(f"vocab must be >= 2, got {vocab}")
    rng = np.random.default_rng(seed)
    lo, hi = (prompt_len, prompt_len) if np.isscalar(prompt_len) \
        else prompt_len
    mlo, mhi = (max_new, max_new) if np.isscalar(max_new) else max_new
    if lo < 1 or mlo < 1:
        raise ValueError("prompt_len and max_new must be >= 1")
    r = n_requests
    if np.isinf(rate):
        arrival = np.zeros(r, np.int64)
    else:
        arrival = np.floor(np.cumsum(
            rng.exponential(1.0 / rate, r))).astype(np.int64)
    lens = rng.integers(lo, hi + 1, r).astype(np.int32)
    p = int(hi)
    toks = 1 + zipf_token_ids(rng, vocab - 1, (r, p), s=zipf_s) \
        if r else np.zeros((0, p), np.int32)
    toks = np.where(np.arange(p)[None, :] < lens[:, None], toks,
                    -1).astype(np.int32)
    return ArrivalStream(
        arrival=arrival.astype(np.int32),
        seq_ids=np.arange(r, dtype=np.int32),
        prompts=toks, prompt_lens=lens,
        max_new=rng.integers(mlo, mhi + 1, r).astype(np.int32),
        name=name)


# kv-pool request-trace op kinds.  KV_SCAN and KV_PRED are the ordered
# queries: a KV_SCAN op is an inclusive session-id range lookup
# [seq_id, hi_id] (pool.lookup_range), a KV_PRED op a predecessor query
# (pool.predecessor).
KV_CREATE, KV_LOOKUP, KV_RELEASE = 0, 1, 2
KV_SCAN, KV_PRED = 3, 4


class KVTrace(NamedTuple):
    """A recorded ``PagedKVPool`` request trace: create/lookup/release
    over a bounded session-id space, with re-used ids and deliberate
    misses.  Scan traces add ``KV_SCAN``/``KV_PRED`` ops; ``hi_ids``
    holds the scan upper bounds (``seq_ids`` on other lanes; ``None`` on
    membership-only traces)."""
    kinds: np.ndarray    # int32[T], KV_* op kinds
    seq_ids: np.ndarray  # int32[T]
    name: str
    hi_ids: np.ndarray = None  # int32[T] scan upper bounds, or None


def kv_request_trace(n_ops: int, n_seqs: int, seed: int = 0,
                     p_create: float = 0.3, p_release: float = 0.15,
                     miss_frac: float = 0.15,
                     name: str = "kv_trace") -> KVTrace:
    """A :class:`KVTrace` that tracks its own live set: creates target
    absent ids (re-using released ones), releases live ids, lookups
    mostly live ids; a ``miss_frac`` slice inverts that (absent lookups,
    double-creates, absent releases).  Deterministic per seed."""
    if n_seqs < 1:
        raise ValueError(f"n_seqs must be >= 1, got {n_seqs}")
    rng = np.random.default_rng(seed)
    live: list = []
    dead = list(range(n_seqs))
    kinds = np.empty(n_ops, np.int32)
    sids = np.empty(n_ops, np.int32)
    for t in range(n_ops):
        u = rng.random()
        miss = rng.random() < miss_frac
        if (u < p_create and dead) or not live:
            if miss and live:                  # double-create (a miss)
                kinds[t], sids[t] = KV_CREATE, rng.choice(live)
            else:
                sid = dead.pop(int(rng.integers(len(dead))))
                live.append(sid)
                kinds[t], sids[t] = KV_CREATE, sid
        elif u < p_create + p_release and live:
            if miss and dead:                  # absent release (a miss)
                kinds[t], sids[t] = KV_RELEASE, rng.choice(dead)
            else:
                sid = live.pop(int(rng.integers(len(live))))
                dead.append(sid)
                kinds[t], sids[t] = KV_RELEASE, sid
        else:
            pool = dead if (miss and dead) else live
            kinds[t], sids[t] = KV_LOOKUP, rng.choice(pool)
    return KVTrace(kinds=kinds, seq_ids=sids, name=name)


def kv_scan_trace(n_ops: int, n_seqs: int, seed: int = 0,
                  p_scan: float = 0.25, p_pred: float = 0.1,
                  span: int = 8, p_prefix: float = 0.25,
                  name: str = "kv_scan_trace") -> KVTrace:
    """:func:`kv_request_trace` with a ``p_scan`` slice of its lookups
    turned into ``KV_SCAN`` range queries and a ``p_pred`` slice into
    ``KV_PRED`` predecessor queries.  A range is anchored at a random id
    with width drawn in ``[0, span]``, except a ``p_prefix`` fraction of
    prefix ranges ``[0, hi]``; anchors include dead ids and ids past
    ``n_seqs``.  Deterministic per seed."""
    base = kv_request_trace(n_ops, n_seqs, seed=seed, name=name)
    rng = np.random.default_rng(seed + 1)
    kinds = base.kinds.copy()
    sids = base.seq_ids.copy()
    his = sids.copy()
    for t in range(n_ops):
        if kinds[t] != KV_LOOKUP:
            continue
        u = rng.random()
        if u < p_scan:
            kinds[t] = KV_SCAN
            w = int(rng.integers(0, span + 1))
            if rng.random() < p_prefix:
                lo = 0
                hi = int(rng.integers(0, n_seqs + span))
            else:
                lo = int(rng.integers(0, n_seqs + span))
                hi = lo + w
            sids[t], his[t] = lo, hi
        elif u < p_scan + p_pred:
            kinds[t] = KV_PRED
            sids[t] = int(rng.integers(0, n_seqs + span))
            his[t] = sids[t]
    return KVTrace(kinds=kinds, seq_ids=sids, name=name, hi_ids=his)
