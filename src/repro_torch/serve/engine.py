"""Batched serving engine with the splay-adaptive session index and
vocab tier (the twin of ``repro.serve.engine``).

A continuous-batching loop: requests arrive on a virtual clock
(decode-step units), wait in an arrival queue, and are admitted into
waves of up to ``max_batch``.  Admission reserves their prompt pages up
front and refuses (head-of-line backpressure) when the page pool or the
session index is full, so a wave never starts work it cannot hold.
Each wave left-pad prefills through the decode cell, then decodes in
lockstep with per-request ``max_new`` truncation; page reservations are
re-checked every generated token and a reservation failure preempts
the request (release and requeue).

Two splay-list structures serve it:
  * the session/page index is a :class:`PagedKVPool`; with
    ``device_index=True`` its per-step liveness lookups run on the
    device index plane (the descent engine B1/B2, and F's fold on each
    flush epoch);
  * the decode stream feeds ``SplayVocabCache.observe_serving``:
    fixed-shape ``[stream_epochs, max_batch]`` blocks through
    ``splaylist.run_serving``, which counts the tokens and picks the hot
    set.  As in the reference, the embedding lookups of the model index
    the table directly; the cache's two-tier gather is not on this path
    (the reference's docstring says otherwise, its code does this).

Decoding is greedy, so a host-indexed and a device-indexed engine given
the same arrivals produce identical outputs, admission decisions and
latencies.  The model, its cache, the pool's device index and the vocab
cache live on ``device`` (the card unless the caller passes ``"cpu"``).

On a mesh (``mesh=``, one engine a rank, every rank given the same
arrivals) the pool's index is width-sharded over it, as in the
reference, and the model runs as the caller lays it out: a global tree
whole on every rank (the reference's engine), or a tree of any family
laid out on the mesh (``sharding.lay_out`` by ``layers.axes_to_specs``:
heads, experts, Mamba2 heads and the vocab over ``model``) sharded
under ``use_mesh(mesh, rules)``, its cache laid out by
``model_zoo.cache_axes``.  Every rank serves the whole wave, so a
laid-out tree whose rules split the batch over more than one rank is
refused (``forward``/``decode_step`` take a rank's rows; the engine
does not).  Every decision (admission, preemption,
retry, the next token) is taken on values every rank holds equally:
the pool's answers and the greedy ids come out of collectives, so every
rank makes the same calls in the same order, and a meshless and a mesh
engine given the same arrivals emit the same ids, admission decisions
and latencies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.faults import InjectedFault
from repro_torch.core.splay_cache import SplayVocabCache
from repro_torch.core.splaylist import _device
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as shd
from repro_torch.serve import serve_step as ss
from repro_torch.serve.kv_cache import PagedKVPool


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: np.ndarray
    max_new: int = 16
    arrival: int = 0                 # decode-step epoch (virtual clock)
    out: Optional[List[int]] = None


class Engine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_seq: int = 256, use_splay_tier: bool = True,
                 n_pages: int = 1024, page_size: int = 16,
                 device_index: bool = False, index_batch: int = 32,
                 index_width: int = None, mesh=None,
                 stream_epochs: int = 4, audit_every: int = 0,
                 fault_plan=None, max_retries: int = 8, device="cuda"):
        shd.check_mesh(mesh)
        # "cuda" names the current card: compare with the resolved index
        self.device = torch.empty(0, device=_device(device)).device
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, "
                             f"the engine on {self.device}")
        on = shd.tree_mesh(params)
        if on is not None and on is not mesh:
            raise ValueError("the params are laid out on another mesh than "
                             "the engine's")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh computes on {mesh.device}, the "
                             f"engine on {self.device}")
        if on is not None:
            batch = tuple(a for a in (params.rules.get("batch") or ())
                          if a in on.shape)
            if batch and shd.axes_size(on, batch) > 1:
                raise NotImplementedError(
                    f"the engine serves every row of a wave on every rank: "
                    f"its tree's rules split the batch over {batch} "
                    f"({on.shape})")
        # the (mesh, rules) the model's steps run under
        self._ctx = ((mesh, params.rules) if on is not None
                     else (None, None))
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.pool = PagedKVPool(n_pages=n_pages, page_size=page_size,
                                device=device_index,
                                index_width=index_width,
                                index_batch=index_batch, mesh=mesh,
                                audit_every=audit_every,
                                fault_plan=fault_plan,
                                torch_device=self.device)
        self.vocab_cache = (SplayVocabCache(cfg.vocab_padded,
                                            hot_size=cfg.hot_vocab,
                                            device=self.device)
                            if use_splay_tier else None)
        self._decode = ss.make_decode_step(cfg)
        self.queue: List[Request] = []
        self.clock = 0               # virtual time, decode-step units
        self.stream_epochs = stream_epochs
        self._stream_buf: List[np.ndarray] = []
        self.latencies: Dict[int, int] = {}     # seq_id -> steps in system
        self.tokens_out = 0
        self.stalls = 0              # admission refusals (backpressure)
        self.preemptions = 0         # mid-decode page-exhaustion requeues
        # degraded-epoch retry: transient injected faults requeue the
        # wave and back off (doubling), never raise
        self.max_retries = max_retries
        self.degraded_retries = 0
        self._backoff = 1            # virtual-time retry delay (doubles)
        self._consec_fail = 0

    def submit(self, req: Request) -> None:
        """Enqueue a request; it is admitted (pages reserved) once the
        clock reaches ``req.arrival`` and capacity allows."""
        req.out = []
        self.queue.append(req)
        self.queue.sort(key=lambda r: r.arrival)   # stable: FIFO per epoch

    def _pad_prompts(self, reqs) -> np.ndarray:
        L = max(len(r.prompt) for r in reqs)
        out = np.zeros((len(reqs), L), np.int32)
        for i, r in enumerate(reqs):
            out[i, L - len(r.prompt):] = r.prompt    # left-pad
        return out

    # -- admission --------------------------------------------------------

    def _try_reserve(self, r: Request) -> bool:
        """Create the session and reserve its prompt pages atomically:
        a partial reservation is rolled back so a refused request leaves
        no footprint."""
        if not self.pool.create(r.seq_id):
            return False
        if not self.pool.append_tokens(r.seq_id, len(r.prompt)):
            self.pool.release(r.seq_id)
            return False
        return True

    def _admit(self) -> List[Request]:
        """Admit arrived requests in order until the wave or the pool is
        full.  Head-of-line: the first refusal stops admission."""
        wave: List[Request] = []
        while self.queue and len(wave) < self.max_batch \
                and self.queue[0].arrival <= self.clock:
            if not self._try_reserve(self.queue[0]):
                self.stalls += 1
                break
            wave.append(self.queue.pop(0))
        return wave

    # -- the decode-stream -> vocab-cache tap -----------------------------

    def _stream_observe(self, toks: np.ndarray, live: np.ndarray) -> None:
        """Buffer one decode step's emitted tokens (dead lanes -> -1,
        width padded to ``max_batch``) and flush fixed-shape
        ``[stream_epochs, max_batch]`` blocks through
        ``observe_serving``."""
        if self.vocab_cache is None:
            return
        row = np.full(self.max_batch, -1, np.int32)
        n = toks.shape[0]
        row[:n] = np.where(live[:n], toks[:, 0], -1)
        self._stream_buf.append(row)
        if len(self._stream_buf) >= self.stream_epochs:
            self.vocab_cache.observe_serving(np.stack(self._stream_buf))
            self._stream_buf = []

    # -- the serving loop -------------------------------------------------

    def run(self) -> Dict[int, List[int]]:
        """Serve the queue to completion; returns seq_id -> generated
        ids.  Advances the virtual clock through idle gaps, admits waves
        as requests arrive, and records per-request latency (completion
        clock minus arrival) in ``self.latencies``.

        An injected fault surfacing mid-wave (``InjectedFault``) does not
        raise: the wave's unfinished requests requeue and the engine
        retries after a doubling virtual-time backoff, up to
        ``max_retries`` consecutive failures."""
        results: Dict[int, List[int]] = {}
        while self.queue:
            wave = self._admit()
            if not wave:
                nxt = self.queue[0].arrival
                if nxt > self.clock:
                    self.clock = nxt           # idle: jump to next arrival
                    continue
                raise RuntimeError(
                    f"request seq_id={self.queue[0].seq_id} cannot be "
                    f"admitted into an empty engine (prompt needs more "
                    f"pages than the pool holds / index full)")
            try:
                self._serve_wave(wave, results)
            except InjectedFault:
                self.degraded_retries += 1
                self._consec_fail += 1
                if self._consec_fail > self.max_retries:
                    raise   # persistent, not transient: surface it
                self._requeue_wave(wave, results)
                self.clock += self._backoff
                self._backoff *= 2
                continue
            self._backoff = 1
            self._consec_fail = 0
        if self._stream_buf and self.vocab_cache is not None:
            pad = [np.full(self.max_batch, -1, np.int32)] * \
                (self.stream_epochs - len(self._stream_buf))
            self.vocab_cache.observe_serving(
                np.stack(self._stream_buf + pad))
            self._stream_buf = []
        return results

    def _requeue_wave(self, wave: List[Request],
                      results: Dict[int, List[int]]) -> None:
        """Roll a faulted wave back into the queue: every request not
        yet completed (and not already requeued by a preemption inside
        the wave) releases its session and resubmits with its original
        arrival, so latency spans the retry."""
        for r in wave:
            if r.seq_id in results:
                continue             # finished before the fault hit
            if any(q is r for q in self.queue):
                continue             # preempt-requeued inside the wave
            self.pool.release(r.seq_id)
            self.submit(r)

    def _serve_wave(self, wave: List[Request],
                    results: Dict[int, List[int]]) -> None:
        toks = self._pad_prompts(wave)
        B, L = toks.shape
        # left-padding consumes cache positions: top the reservation up
        # to the padded length (same host accounting in both index modes)
        kept_idx: List[int] = []
        for i, r in enumerate(wave):
            pad = L - len(r.prompt)
            if pad and not self.pool.append_tokens(r.seq_id, pad):
                self.pool.release(r.seq_id)
                self.preemptions += 1
                self.submit(r)
                continue
            kept_idx.append(i)
        if not kept_idx:
            return
        if len(kept_idx) < len(wave):
            toks = toks[kept_idx]
            wave = [wave[i] for i in kept_idx]
            B = len(wave)
        mesh, rules = self._ctx
        cache = zoo.init_cache(self.cfg, B, self.max_seq, self.device,
                               mesh=mesh, rules=rules)
        # prefill token by token through the decode path
        with shd.use_mesh(*self._ctx):
            cur, cache, cache_len = ss.prefill_loop(
                self._decode, self.params, toks, cache)
        self.clock += L
        live = np.ones(B, bool)
        max_new = max(r.max_new for r in wave)
        for t in range(max_new):
            self._stream_observe(cur.cpu().numpy(), live)
            with shd.use_mesh(*self._ctx):
                cur, cache = self._decode(self.params, cur, cache,
                                          cache_len)
            cache_len += 1
            self.clock += 1
            arr = cur.cpu().numpy()
            # one index lookup per decode step over the wave's live
            # sessions
            ids = [r.seq_id for i, r in enumerate(wave) if live[i]]
            if ids:
                ok = self.pool.lookup_batch(ids)
                if not ok.all():
                    raise RuntimeError("a live session is missing from "
                                       "the index")
            for i, r in enumerate(wave):
                if not live[i] or t >= r.max_new:
                    continue
                if not self.pool.append_tokens(r.seq_id, 1):
                    # page exhaustion mid-decode: preempt, don't emit
                    # into unreserved pages; release and requeue whole
                    # (original arrival kept: latency spans the retry)
                    self.pool.release(r.seq_id)
                    if self.pool.utilization == 0.0:
                        raise RuntimeError(
                            f"seq_id={r.seq_id} exhausted the page pool "
                            f"alone: prompt+max_new needs more than "
                            f"{self.pool.n_pages} pages")
                    self.preemptions += 1
                    r.out = []
                    self.submit(r)
                    live[i] = False
                    continue
                r.out.append(int(arr[i, 0]))
                self.tokens_out += 1
                if len(r.out) >= r.max_new:
                    self.latencies[r.seq_id] = self.clock - r.arrival
                    results[r.seq_id] = r.out
                    self.pool.release(r.seq_id)
                    live[i] = False
            if not live.any():
                break
