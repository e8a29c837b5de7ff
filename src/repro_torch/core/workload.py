"""Workload generators for the paper's experiments (Section 6).

The port's own copy of the numpy generators it drives: the op-stream
record, the Bernoulli rebalancing coins, the paper's families (the
read-only ``n-x-y`` streams of Tables 1-4, the uniform and bounded
Zipf(s) streams of Figures 11-12, the general read-write ``n-r-x-y-s``
streams of Appendix C.3), the drift scenarios that race the routing
controller (``DRIFT_SCENARIOS``), the Zipf token ids of the vocab tier, the splay-shaped
level-array fixture the kernel checks use, and the request traces of
the paged KV pool's session index (``kv_request_trace``,
``kv_scan_trace``) and the serving engine's request arrivals
(``poisson_zipf_arrivals``).  Pure numpy, drawing in the JAX package's
order, so the same seed gives the same arrays and they feed either
package unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def xy_workload(n: int, x: float, y: float, ops: int, p: float = 1.0,
                seed: int = 0, key_space: Optional[int] = None) -> OpStream:
    """n-x-y read-only workload: x-fraction of contains hit the popular set
    S (|S| = y*n), the rest hit the complement uniformly."""
    rng = np.random.default_rng(seed)
    key_space = key_space or n
    keys_all = rng.permutation(key_space)[:n].astype(np.int32)
    n_pop = max(int(round(y * n)), 1)
    popular = keys_all[:n_pop]
    rest = keys_all[n_pop:] if n_pop < n else keys_all
    take_pop = rng.random(ops) < x
    k_pop = popular[rng.integers(0, len(popular), ops)]
    k_rest = rest[rng.integers(0, len(rest), ops)]
    keys = np.where(take_pop, k_pop, k_rest).astype(np.int32)
    return OpStream(
        kinds=np.zeros(ops, np.int32), keys=keys,
        upd=_coins(rng, ops, p), populate=np.sort(keys_all))


def uniform_workload(n: int, ops: int, p: float = 1.0, seed: int = 0
                     ) -> OpStream:
    """The 1e5-100-100 uniform workload (Figure 11)."""
    rng = np.random.default_rng(seed)
    keys_all = np.arange(n, dtype=np.int32)
    keys = rng.integers(0, n, ops).astype(np.int32)
    return OpStream(np.zeros(ops, np.int32), keys, _coins(rng, ops, p),
                    keys_all)


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


def general_workload(n: int, r: float, x: float, y: float, s: float,
                     ops: int, p: float = 1.0, seed: int = 0) -> OpStream:
    """n-r-x-y-s general workload (Appendix C.3):
      r%:   contains; the rest split evenly insert/delete;
      x% of contains target y% of keys (the popular set R);
      insert/delete draw uniformly from an s-fraction key set W.
    Keys are pre-populated with probability 90% each (paper's setup)."""
    rng = np.random.default_rng(seed)
    keys_all = rng.permutation(2 * n)[:n].astype(np.int32)
    populate = np.sort(keys_all[rng.random(n) < 0.9])
    n_r = max(int(round(y * n)), 1)
    set_r = keys_all[:n_r]
    rest = keys_all[n_r:] if n_r < n else keys_all
    n_w = max(int(round(s * n)), 1)
    set_w = rng.permutation(keys_all)[:n_w]

    u = rng.random(ops)
    kinds = np.where(u < r, OP_CONTAINS,
                     np.where(u < r + (1 - r) / 2, OP_INSERT, OP_DELETE)
                     ).astype(np.int32)
    take_pop = rng.random(ops) < x
    k_pop = set_r[rng.integers(0, len(set_r), ops)]
    k_rest = rest[rng.integers(0, len(rest), ops)]
    k_reads = np.where(take_pop, k_pop, k_rest)
    k_writes = set_w[rng.integers(0, len(set_w), ops)]
    keys = np.where(kinds == OP_CONTAINS, k_reads, k_writes).astype(np.int32)
    return OpStream(kinds, keys, _coins(rng, ops, p), populate)


# ---------------------------------------------------------------------------
# drift scenarios: epoch-shaped streams whose access distribution shifts
# mid-run, the adversaries of the routing controller
# ---------------------------------------------------------------------------

class DriftStream(NamedTuple):
    """An ``[E, B]`` epoch-shaped op stream with known distribution
    transitions.  Contains-only (``kinds`` all zero) so every epoch is
    eligible for the aggregate/plane-search serving path and the routed
    exchange's answers stay bit-comparable across routing policies;
    ``upd`` carries the Bernoulli(p) splay coins.  ``transitions`` are
    the epoch indices whose batch is the *first* drawn from a shifted
    distribution — the drift probe measures recovery time from them."""
    kinds: np.ndarray        # int32[E, B] (all OP_CONTAINS)
    keys: np.ndarray         # int32[E, B]
    upd: np.ndarray          # bool[E, B]
    populate: np.ndarray     # int32[n] sorted keys to insert first
    transitions: tuple       # epoch indices of distribution shifts
    name: str


def _drift_pool(rng: np.random.Generator, n: int,
                key_space: Optional[int] = None) -> np.ndarray:
    key_space = key_space or 4 * n
    return np.sort(rng.choice(key_space, n, replace=False)).astype(
        np.int32)


def rotating_hotset_workload(n: int, epochs: int, batch: int,
                             period: int = 4, hot_frac: float = 0.01,
                             hot_prob: float = 0.8, p: float = 0.1,
                             seed: int = 0,
                             key_space: Optional[int] = None
                             ) -> DriftStream:
    """Rotating hot set: ``hot_prob`` of each batch hits a *contiguous*
    window of ``hot_frac·n`` keys (contiguous in sorted key order, so
    under equal-lane boundaries the hot mass lands in one shard — the
    worst case for the routed exchange), and every ``period`` epochs
    the window jumps to a different region of the key space.  The rest
    of the batch is uniform over the pool."""
    rng = np.random.default_rng(seed)
    pool = _drift_pool(rng, n, key_space)
    h = max(int(round(hot_frac * n)), 1)
    # ~golden-ratio stride: successive windows land in different lanes
    stride = max(int(round(0.381 * n)), h)
    kinds = np.zeros((epochs, batch), np.int32)
    keys = np.empty((epochs, batch), np.int32)
    transitions = []
    for e in range(epochs):
        phase = e // period
        if e > 0 and e % period == 0:
            transitions.append(e)
        lo = (phase * stride) % max(n - h, 1)
        hot = pool[lo:lo + h]
        take = rng.random(batch) < hot_prob
        keys[e] = np.where(take, hot[rng.integers(0, len(hot), batch)],
                           pool[rng.integers(0, n, batch)])
    return DriftStream(kinds, keys, _coins(rng, epochs * batch,
                                           p).reshape(epochs, batch),
                       pool, tuple(transitions), "rotating_hotset")


def flash_crowd_workload(n: int, epochs: int, batch: int,
                         onset: int = 3, duration: Optional[int] = None,
                         crowd_frac: float = 0.01, spike: float = 100.0,
                         p: float = 0.1, seed: int = 0,
                         key_space: Optional[int] = None) -> DriftStream:
    """Flash crowd: uniform traffic until ``onset``, then a sudden
    ``spike``× per-key overweight on a previously *cold* contiguous
    range of ``crowd_frac·n`` keys (at 100× over 1% of keys, roughly
    half of every batch piles onto one lane's key range).  ``duration``
    epochs later the crowd disperses back to uniform (default: holds to
    the end)."""
    rng = np.random.default_rng(seed)
    pool = _drift_pool(rng, n, key_space)
    c = max(int(round(crowd_frac * n)), 1)
    lo = (2 * n) // 3                       # a cold, off-center range
    w = np.ones(n, np.float64)
    w[lo:lo + c] = spike
    w /= w.sum()
    kinds = np.zeros((epochs, batch), np.int32)
    keys = np.empty((epochs, batch), np.int32)
    end = epochs if duration is None else min(onset + duration, epochs)
    transitions = [t for t in (onset, end) if 0 < t < epochs]
    for e in range(epochs):
        if onset <= e < end:
            keys[e] = pool[rng.choice(n, batch, p=w)]
        else:
            keys[e] = pool[rng.integers(0, n, batch)]
    return DriftStream(kinds, keys, _coins(rng, epochs * batch,
                                           p).reshape(epochs, batch),
                       pool, tuple(transitions), "flash_crowd")


def diurnal_zipf_workload(n: int, epochs: int, batch: int,
                          period: int = 6, s_day: float = 1.3,
                          s_night: float = 0.4, p: float = 0.1,
                          seed: int = 0,
                          key_space: Optional[int] = None) -> DriftStream:
    """Diurnal Zipf mixture: batches alternate every ``period/2``
    epochs between a 'day' regime (Zipf(``s_day``) whose top ranks sit
    at the *left* end of the sorted pool) and a 'night' regime
    (Zipf(``s_night``), top ranks in the *middle*) — both the skew
    exponent and the identity of the hot range move, so a boundary
    split tuned for one phase is mis-tuned for the next."""
    rng = np.random.default_rng(seed)
    pool = _drift_pool(rng, n, key_space)
    half = max(period // 2, 1)
    ranks = np.arange(1, n + 1, dtype=np.float64)

    def probs(s):
        q = ranks ** (-s)
        return q / q.sum()

    p_day, p_night = probs(s_day), probs(s_night)
    # rank->key maps: day hot head at the left end, night in the middle
    day_keys = pool
    night_keys = np.roll(pool, n // 2)
    kinds = np.zeros((epochs, batch), np.int32)
    keys = np.empty((epochs, batch), np.int32)
    transitions = []
    for e in range(epochs):
        phase = (e // half) % 2
        if e > 0 and e % half == 0:
            transitions.append(e)
        kmap, pr = ((day_keys, p_day) if phase == 0
                    else (night_keys, p_night))
        keys[e] = kmap[rng.choice(n, batch, p=pr)]
    return DriftStream(kinds, keys, _coins(rng, epochs * batch,
                                           p).reshape(epochs, batch),
                       pool, tuple(transitions), "diurnal_zipf")


DRIFT_SCENARIOS = {
    "rotating_hotset": rotating_hotset_workload,
    "flash_crowd": flash_crowd_workload,
    "diurnal_zipf": diurnal_zipf_workload,
}


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
