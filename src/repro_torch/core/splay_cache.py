"""Splay-tiered adaptive embedding cache: the twin of
``repro.core.splay_cache``.

Token frequencies are Zipf-distributed; the splay-list run over the
token stream gives each id a height calibrated to its frequency
(height >= h*  <=>  freq >= m/2^(k-h*), Lemma 2).  The cache maps
heights to memory tiers:

    tier 0 (height >= h*):   the hot buffer, built by kernel B4
                             (``kernels/hot_gather.py gather_rows``),
                             small enough to stay in the card's L2;
    tier 1 (the rest):       the full table in device memory.

A lookup reads both tiers in one launch of the fused two-tier gather
(``ops.hot_gather``).

Refresh is relaxed like the paper's rebalancing: hit counting runs on a
Bernoulli(``update_prob``) subsample of batches, and the hot set is
recomputed every ``refresh_every`` steps with hysteresis (a resident id
is evicted only when it falls two levels below the admission height).

``refresh_on_device=True`` (the reference's ``device=True``) runs the
heights -> hot set pipeline as torch ops on ``device``
(:func:`_heights_device`, :func:`_hot_select`); ``False`` runs the
numpy pipeline, the differential oracle.  Both call the single
:meth:`SplayVocabCache.heights` calibration or its exact torch mirror.
``device`` is the torch device of the hot rank map and the stream
state: ``"cuda"`` by default, ``"cpu"`` for the plain CPU path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx
from repro_torch.kernels import ops as kops
from repro_torch.kernels.hot_gather import gather_rows


def _int_log2_floor(q: np.ndarray) -> np.ndarray:
    """Exact floor(log2(q)) for integer q >= 1: frexp exponent, with an
    integer-shift correction for q >= 2^53 where float64 can round q up
    to the next power of two (e.g. 2^60 - 1)."""
    lg = np.frexp(q.astype(np.float64))[1].astype(np.int64) - 1
    return np.where(q >> lg == 0, lg - 1, lg)


def _log2_floor_i32(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) for int32 x >= 1 (the reference's
    ``31 - clz(x)``): float64 holds every int32 exactly, so the frexp
    exponent is exact (float32 would round 2^24 + 1 and up)."""
    return (torch.frexp(x.to(torch.float64))[1] - 1).to(torch.int32)


def _hot_select(h: torch.Tensor, prev_in_hot: torch.Tensor, hot_size: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One device pass from heights to the hot set.

    Mirrors the numpy pipeline bit for bit: admission set = the
    ``hot_size`` tallest ids (height desc, id asc), hysteresis keeps
    residents within 2 levels of the admission height (kept ids in
    ascending order), and the remainder is filled from the admission set
    in rank order.  The score ``h * v + (v - 1 - id)`` is unique per id,
    so ``torch.topk(sorted=True)`` gives the reference's ``lax.top_k``
    order.  The reference's dropped out-of-range scatters become
    scatters into a sink slot that is sliced off.  Returns
    ``(hot_ids [hot_size] int32, -1 padded; hot_rank [vocab] int32)``."""
    v = h.shape[0]
    dev = h.device
    n_adm = min(hot_size, v)        # admission set (vocab may be tiny)
    ids = torch.arange(v, dtype=torch.int32, device=dev)
    score = h.to(torch.int32) * v + (v - 1 - ids)
    cand = torch.topk(score, n_adm, sorted=True).indices.to(torch.int32)
    h_star = torch.clamp(h[cand[n_adm - 1]] - 2, min=0)

    keep_mask = prev_in_hot & (h >= h_star)                 # [V]
    n_keep = keep_mask.to(torch.int32).sum()                # <= hot_size
    kp = torch.cumsum(keep_mask.to(torch.int32), 0) - 1
    hot_ids = torch.full((hot_size + 1,), -1, dtype=torch.int32, device=dev)
    hot_ids[torch.where(keep_mask, kp, hot_size).long()] = ids

    sel = ~keep_mask[cand.long()]                           # not yet kept
    sp = torch.cumsum(sel.to(torch.int32), 0) - 1
    take = sel & (sp < hot_size - n_keep)
    hot_ids[torch.where(take, n_keep + sp, hot_size).long()] = cand
    hot_ids = hot_ids[:hot_size]

    valid = hot_ids >= 0
    hot_rank = torch.full((v + 1,), -1, dtype=torch.int32, device=dev)
    hot_rank[torch.where(valid, hot_ids, v).long()] = torch.arange(
        hot_size, dtype=torch.int32, device=dev)
    return hot_ids, hot_rank[:v]


def _heights_device(counts: torch.Tensor, m) -> torch.Tensor:
    """Torch mirror of :meth:`SplayVocabCache.heights` for int32 counts
    and ``m`` — exact integer form (asserted equal in tests)."""
    m = torch.as_tensor(m, dtype=torch.int32, device=counts.device)
    k = torch.clamp(_log2_floor_i32(torch.clamp(m, min=1)), min=0)
    q = torch.clamp(torch.div(m, torch.clamp(counts, min=1),
                              rounding_mode="floor"), min=1)
    return torch.clamp(k - _log2_floor_i32(q), min=0).to(torch.int32)


@dataclasses.dataclass
class SplayVocabCache:
    vocab: int
    hot_size: int = 4096
    update_prob: float = 0.01       # the paper's p = 1/c
    refresh_every: int = 64
    seed: int = 0
    refresh_on_device: bool = True  # torch refresh (False: numpy oracle)
    device: object = "cuda"

    def __post_init__(self):
        self._dev = sx._device(self.device)
        self.counts = np.zeros(self.vocab, np.int64)
        self.m = 0
        self.hot_ids = np.zeros((0,), np.int32)
        self.hot_rank = torch.full((self.vocab,), -1, dtype=torch.int32,
                                   device=self._dev)
        self._hot_ids_dev = None    # [hot_size] int32, -1 padded
        self.steps = 0
        self.rng = np.random.default_rng(self.seed)
        self._hot_buf = None
        self._stream_st = None      # token-keyed SplayState (observe_serving)
        self._stream_plane = None
        self.stream_epochs = 0

    # -- bookkeeping (host side, like the paper's relaxed counters) -------

    def observe(self, token_ids: np.ndarray) -> None:
        """Count a batch of token ids with probability update_prob."""
        self.steps += 1
        if self.rng.random() < self.update_prob or self.m == 0:
            ids, cnt = np.unique(np.asarray(token_ids).ravel(),
                                 return_counts=True)
            self.counts[ids] += cnt
            self.m += int(cnt.sum())
        if self.steps % self.refresh_every == 0:
            self.refresh()

    def observe_serving(self, tokens: np.ndarray) -> None:
        """Fold an ``[E, B]`` block of live decode-stream token ids
        (``-1`` = dead/pad lane) through the splay-list serving loop
        itself: every row is an all-``OP_INSERT`` epoch of
        ``splaylist.run_serving`` on a token-keyed ``SplayState`` whose
        device plane refreshes every epoch.  A token's first sight
        inserts it and counts it unconditionally; re-touches count on
        Bernoulli(``update_prob``) coins — the paper's relaxed counters,
        kept by the structure they calibrate.  Counts sync back from the
        state's per-node ``selfhits`` (whose total is ``m``) and feed
        the same :meth:`heights` -> hot-set refresh as :meth:`observe`.

        Pad lanes become ``OP_CONTAINS`` on the absent key ``-1`` with
        ``upd=False``: a pure read."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 2:
            raise ValueError(f"tokens must be [E, B], got {tokens.shape}")
        E, B = tokens.shape
        if E == 0:
            return
        if np.any(tokens >= self.vocab):
            raise ValueError("token id out of range for vocab "
                             f"{self.vocab}: max {tokens.max()}")
        if self._stream_st is None:
            self._stream_st = sx.make(self.vocab + 2, device=self._dev)
            self._stream_plane = dix.from_state_device(
                self._stream_st, n_levels=self._stream_st.max_level,
                width=self.vocab)
        live = tokens >= 0
        kinds = np.where(live, sx.OP_INSERT, sx.OP_CONTAINS) \
            .astype(np.int32)
        upd = live & (self.rng.random((E, B)) < self.update_prob)
        st, plane, _, _, _, _, _ = sx.run_serving(
            self._stream_st, self._stream_plane, kinds, tokens, upd)
        self._stream_st, self._stream_plane = st, plane
        self.stream_epochs += E
        # sync the calibrated counters out of the structure
        s_key = st.key.cpu().numpy()
        s_self = st.selfhits.cpu().numpy()
        node = np.zeros(s_key.shape[0], bool)
        node[2:int(st.n_alloc)] = True
        node &= ~st.deleted.cpu().numpy() & (s_key >= 0) \
            & (s_key < self.vocab)
        self.counts[:] = 0
        self.counts[s_key[node]] = s_self[node]
        self.m = int(st.m)
        before = self.steps
        self.steps += E
        if self.steps // self.refresh_every != before // self.refresh_every:
            self.refresh()

    def heights(self) -> np.ndarray:
        """Splay heights from counts: h(x) = max(0, k - floor(log2(m/f)))
        — the Lemma-2 calibration, in exact integer arithmetic (the
        single source of the formula; the device refresh calls its
        mirror :func:`_heights_device`)."""
        k = max(int(self.m).bit_length() - 1, 0)
        q = np.maximum(int(self.m) // np.maximum(self.counts, 1), 1)
        return np.maximum(k - _int_log2_floor(q), 0)

    def refresh(self, table: Optional[torch.Tensor] = None) -> None:
        """Recompute the hot set with hysteresis: torch ops on the
        cache's device, or the numpy pipeline when
        ``refresh_on_device`` is False."""
        if self.m == 0:
            return
        # the torch pass works in int32; past that range the exact int64
        # numpy pipeline takes over rather than saturating k or
        # collapsing large counts into ties
        if self.refresh_on_device and self.m < 2 ** 31 and \
                int(self.counts.max(initial=0)) < 2 ** 31:
            h = _heights_device(
                torch.as_tensor(self.counts.astype(np.int32),
                                device=self._dev), self.m)
            ids_dev, rank_dev = _hot_select(h, self.hot_rank >= 0,
                                            self.hot_size)
            self._hot_ids_dev = ids_dev
            self.hot_rank = rank_dev
            ids = ids_dev.cpu().numpy()        # small host mirror (stats)
            self.hot_ids = ids[ids >= 0].astype(np.int32)
        else:
            h = self.heights()
            order = np.argsort(-h, kind="stable")
            cand = order[:self.hot_size]
            h_star = h[cand[-1]] if len(cand) else 0
            keep = np.intersect1d(
                self.hot_ids, np.nonzero(h >= max(h_star - 2, 0))[0])
            new = cand[~np.isin(cand, keep)][:self.hot_size - len(keep)]
            self.hot_ids = np.concatenate([keep, new]).astype(np.int32)
            rank = np.full(self.vocab, -1, np.int32)
            rank[self.hot_ids] = np.arange(len(self.hot_ids),
                                           dtype=np.int32)
            self.hot_rank = torch.as_tensor(rank, device=self._dev)
            self._hot_ids_dev = None
        self._hot_buf = None        # invalidate

    # -- device side ---------------------------------------------------------

    def hot_buffer(self, table: torch.Tensor) -> torch.Tensor:
        """Gathered hot rows, one launch of B4 (``gather_rows``) per
        hot-set rebuild.  On the device path the buffer has a fixed
        ``[hot_size, d]`` shape (pad rows point at row 0 and are never
        addressed — ``hot_rank`` is -1 for absent ids)."""
        if self._hot_buf is None:
            if self._hot_ids_dev is not None:
                rows = torch.clamp(self._hot_ids_dev, min=0)
            elif len(self.hot_ids):
                rows = torch.as_tensor(self.hot_ids)
            else:
                self._hot_buf = torch.zeros((1, table.shape[1]),
                                            dtype=table.dtype,
                                            device=table.device)
                return self._hot_buf
            self._hot_buf = gather_rows(table, rows.to(table.device))
        return self._hot_buf

    def lookup(self, table: torch.Tensor, ids) -> torch.Tensor:
        """Two-tier gather, one launch of the fused kernel
        (``ops.hot_gather``); with no hot set, B4 (``gather_rows``).
        ``ids`` of any shape -> ``[*ids.shape, d]``."""
        ids = torch.as_tensor(ids, device=table.device)
        flat = ids.reshape(-1)
        if len(self.hot_ids) == 0:
            out = gather_rows(table, flat)
        else:
            out = kops.hot_gather(table, self.hot_buffer(table),
                                  self.hot_rank, flat)
        return out.reshape(*ids.shape, table.shape[1])

    def hit_rate(self, ids: np.ndarray) -> float:
        if len(self.hot_ids) == 0:
            return 0.0
        rank = self.hot_rank.cpu().numpy()
        return float(np.mean(rank[np.asarray(ids).ravel()] >= 0))
