#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It runs from a checkout: the port under ``src/``, and the timing
inputs and the card-against-CPU checks under ``scripts/``
(``card_checks.py``, shared with the profile scripts and the
CUDA-marked tests).

Phases:

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print what ``-Xptxas -v`` reports;
2. each kernel against its plain PyTorch version on the same inputs,
   bit-exact on every output (the pipelined search's byte counter
   included): B1 tiered search at W=131072, L=24, q=65536, at each
   block size; B2 pipelined search at W=16384 (64 tiles), W=1008
   (16-lane tiles) and an odd batch, each on clusters of 1 to 8 CTAs;
   F update fold on a 2,000-key prefill plus 4 mixed epochs and a
   1024-op list of all five op kinds (the ordered kinds OP_PRED and
   OP_RANGE included); S skip-list fold on a 4096-key populate (heights
   from ``sample_heights``) plus two 4096-op mixed lists of contains,
   inserts, deletes and revives, and its raise at capacity; B3,
   B4 and the fused two-tier gather on float32, bfloat16, int32 and
   uint8 tables at d=4096 (TMA bulk copies) and d=1001 and 37 (vector
   words), q in {0, 1, 333, 8192} with out-of-range ids, int64 ids, and
   all-hot and all-cold batches, printing each case's copy path;
   B5 full-width search at W=16384, L=24, q=2048 plus the pad sentinel.
   Phases 4, 5 and 6 repeat the checks on the main path's own state and
   inputs (F's op fold on the paper-scale state, the searches and F's
   weighted fold on the served planes and batches);
3. the main path at the paper's scale (Aksenov et al., arXiv:2008.01009
   §6, Fig. 12: 10^5 keys, Zipf s=1, rebalancing coin p=0.01): a
   10^5-insert prefill through ``run_ops`` (one F launch, timed by
   CUDA events), ``from_state_device`` at
   L=24, W=131072, then ``run_serving(aggregate=True,
   plane_search=True)`` over 25 epochs of 4096 contains.  Every epoch's
   plane verdicts must equal the state walk's, the hit rate must be
   exactly 1.0, and keys outside the key space must answer 0;
4. membership: 4 epochs of 4096 ops with 10% fresh inserts and 5%
   deletes, first through ``run_ops`` on the card and on a CPU copy of
   the paper-scale state (every field, verdict and path length equal),
   then through ``run_serving(aggregate=False)``; then a plane-search
   epoch over the inserted and deleted keys.  F on a 512-op list of all
   five kinds on the paper-scale state, against its plain fold;
5. serving at W=16384 (10^4 keys), where B2 answers the searches;
   then the seed baseline search (B5, ``ops.splay_search_full``) over
   the served plane for each of the 8 batches, equal to its plain
   version and to B2's answers;
5b. the splay vocab tier at minitron-8b width (vocab 256000, d_model
   4096, hot_vocab 4096, bfloat16; a 2.1 GB table from a seeded
   generator on the card): ``SplayVocabCache.observe_serving`` over 32
   decode-stream flushes of [4, 256] Zipf token ids (5% dead lanes;
   128 epochs, two hot-set refreshes, each equal to the numpy oracle's
   on the same counts), then ``lookup`` of 64 decode batches of 256 ids
   and 4 prefill chunks of 8192, each one launch of the fused gather
   and bit-equal to ``table[ids]``;
5c. the ordered operations on phase 3's served plane: rank,
   predecessor, successor, select, range count, range scan (at most 64)
   and top-k (k=256) on 4096 Zipf queries, each equal to a numpy oracle
   on the sorted live set; ``run_serving(ordered=True,
   plane_search=True)`` over 4 x 4096 lanes (contains, predecessor and
   prefix count, a third each), equal to the oracle and to ``run_ops``
   of the same lanes through F, timed beside the membership-only run of
   the same keys; F's ms per ordered op; the plane audit, clean and
   after one bit-flip in each of the four fields, each caught in its
   field and repaired by one rebuild epoch;
5d. the paged KV pool's device index at minitron-8b's size on the card
   (28672 pages of 16 tokens at 128 KiB a token, index width 28672,
   epochs of 256): 3584 sessions of 7 pages admitted in flush epochs of
   256, 64 decode steps of 256 Zipf lookups with creates and releases,
   a 300-op ``kv_scan_trace``, under a bit-flip and a telemetry
   blackout (audit every 16 lookup epochs); every answer and the final
   chains equal a host-mode pool's, the audit catches and repairs.
   Midway (decode step 34, four ops buffered) a serving snapshot is
   saved with ``CheckpointManager`` and restored onto the card, and the
   restored pool answers the rest of the trace beside the uninterrupted
   one: every verdict, the chains, the free list and the stats equal;
   ms to save (to the host, then the write), to restore, bytes on disk;
5e. the model zoo and the serving engine: each of the ten registry
   architectures at smoke width in float32 on the card against the CPU
   (parameters from the port's seeded builder with stacked weights at
   trained scale, carried to the card as numpy): ``forward`` stage by
   stage (each stage from the CPU's state,
   read through the model's head), ``prefill_loop`` and three decode
   steps, allclose(rtol=1e-4, atol=1e-5) and equal greedy tokens; then
   minitron-8b at full width in float32 (39.5 GB, built on the card):
   a left-padded batch of 4 through ``prefill_loop`` gives ``forward``'s
   greedy tokens; then minitron-8b at full width in bfloat16, the first
   16 of its 32 layers (9.9 GB), served through ``Engine`` (max_batch
   4, max_seq 128, 8 requests
   from ``poisson_zipf_arrivals(rate=inf, prompt_len=(2, 7), max_new=8,
   seed=0)``) with the device session index and again with the host
   one: generated ids, latencies, stalls, preemptions, retries, tokens
   out, the pool's chains and the vocab counters equal; ms per model
   decode step (events) beside its weight-read bound, ms per pool
   lookup and per vocab stream flush, tokens/s, peak memory; then a
   serving snapshot of the device-indexed engine restored into a new
   pool and engine (``apply_engine_state``), and 4 more requests
   (``poisson_zipf_arrivals(4, inf, seed=1)``) through the continuing
   and the restored engine: generated ids, latencies, stalls,
   preemptions, retries, tokens out and chains equal; and
   ``launch.serve --smoke --device-index --snapshot-dir`` then
   ``--resume``;
5f. training: one ``make_train_step`` step of each of the ten
   architectures at smoke width in float32, and of qwen2-0.5b at full
   width, the first 4 of its 24 layers, with float32 compute (batch 1 x
   64), on the card against the
   CPU (loss, grad_norm and each gradient leaf by ``Agreement``, the
   float64 witness being the CPU's run in float64); then qwen2-0.5b at
   full width as configured (bf16 compute, remat per block) through
   ``launch/train.main`` at batch 8 x 512: run A (10 steps), run B (6
   steps, its final checkpoint at 6) and run C (resumed at 6, to 10), into a
   temporary directory under ``build/`` that the phase removes.  Every
   loss finite, A's falling; step 6's checkpoint verified (SHA-256) and
   holding every parameter and AdamW moment under the reference's names
   and shapes; C's first loss equal, bit for bit, to one step from the
   parameters of step 6 on ``batch_at(6)``.  ms per step by events
   (median of steps 2-9), tokens/s, peak memory and the checkpoint's
   I/O times beside the 6·N·T bound at the bf16 rate.  One step is
   traced last, after phase 8 (``scripts/train_step_profile.py``: ATen
   ops, device busy ms, idle share);
6. timings of each kernel at the main path's shapes beside its plain
   version, its bound and, where one PyTorch call computes the same
   function (``index_select`` for B3, B4 and the fused gather), that
   call; B1 and B2 (``scripts/search_timing.py``) per launch from a
   trace, by CUDA-graph replay and by the eager loop, with the plane's
   widths, the rows walked per query and per warp, and the chain figure
   (dependent loads on the longest lane x the pointer chase's ns per
   dependent load in L2); the fused gather at q=8192 and q=256 also beside the
   reference's composition (B3 + B4 + a where-merge); an L2 probe of
   the hot buffer (an all-hot chunk right after an all-cold one).
   B5's bound is restated at the card's own int32 rate (SMs x 64 x
   ``clocks.max.sm``, one compare per element and query) and printed
   beside the bound with an add per compare and the fp32-rate bound of
   the earlier runs;
7. one paper-scale epoch layer by layer (host clock; the search of
   ``fold_entries`` is kernel W), and once under
   ``torch.profiler``: the device's busy time is the union of the
   traced kernels' intervals; the same for one vocab-tier lookup of a
   prefill chunk, the same chunk through the reference's composition,
   and one stream flush;
8. kernel F on its three paths (``scripts/fold_timing.py``
   ``fold_paths``: device time per launch from a trace, and ms per
   wrapper call by events): the prefill launch, a paper-scale epoch's
   fold list and its ``w > 0`` subset (equal states), and one
   vocab-tier stream epoch; each with its ns per walk step, beside the
   one-thread pointer chase that phase 6 measures (``kernels/
   calibrate.py``: ns per dependent load in L2 and from a 256 MB
   array).  Its traces come
   after phase 7's, which they would otherwise disturb;
9. the width-sharded index on 4 ranks (``sharded_rank``), each rank
   also running the drift battery (``benchmarks/drift_probe.py``):
   ``run_parity`` at the reference's parity shape (W 1024, B 512, 12
   epochs; it raises unless the four recovery properties hold), then
   ``run_bench`` at its bench shape (W 4096, q 8192, 10 epochs, L 14),
   printing per scenario and policy the time to recover, the peak share
   after each transition and the wall seconds;
10. the paper's Figs. 3-5 on the card (``benchmarks/
   concurrent_scaling.py``, :func:`scaling_phase`): 10^5 keys, the
   90-10 and 99-1 workloads, the reference's 65536 contains in batches
   of 16, 64 and 256, the splay-list (W and F a batch) against the
   skip-list (W a batch; S populates it); ops/s, mean path, ms a batch
   and launches of F, S and W for each; the first batches at B = 256
   replayed on the CPU; S's populate (ascending, then the same keys
   descending and shuffled) and a mixed list against its plain fold,
   timed by events, beside S's latency floor;
11. kernel W, the state walk of both engines' ``find_batch``
   (:func:`walk_phase`), against its plain loop on the card, bit for
   bit: phase 10's states, the paper serving state, small states with
   marked keys, lazy nodes and a rebuilt bottom, batches of 0, 1 and
   333, a POS_INF_32 key (alone, and first, last and inside 4096 keys
   on phase 10's states, which stay as they were) and a cyclic state;
   W's block size; then per launch by graph replay at the phase-7 shape
   and at B = 16, 64, 256 on phase 10's states, beside the longest lane
   and its latency floor (one dependent round a step; a serial walk's
   beside it);
12. the four example entry points (``repro_torch.examples``,
   :func:`examples_phase`), each through its ``main``: ``quickstart``
   (equal to its run on CPU tensors), ``splay_workloads`` (the host
   engines, as in the reference: nothing of it runs on the card),
   ``train_adaptive_lm``'s 60 smoke steps, and ``serve_adaptive`` (the
   engine demo, then the sharded demos on the 4 gloo ranks on the card
   that its ``main`` spawns);
13. the models on a mesh (:func:`mesh_phase`, run right after phase 5e
   on its bf16 minitron-8b weights, seed 0, and its 8 requests): the
   weights written as a host flat tree (a file a tensor under
   ``build/mesh13``, removed after), 4 gloo ranks on the card (``--phase13
   --backend nccl``: a card a rank) each cutting its blocks out of it
   (``elastic.reshard`` by ``axes_to_specs`` on the 1 x 4 mesh: about
   2.5 GB a rank), every block's SHA-256 equal to the global tensor's
   slice; one sharded decode step of phase 5e's left-padded batch, its
   logits at most twice as far from the float32 witness (the same
   weights computed in float32) as the meshless bf16 step's, the greedy
   ids equal on every rank, the step's collectives from a trace;
   ``Engine(mesh=...)`` on the 8 requests: latencies, stalls,
   preemptions, retries, tokens out and the pool's chains equal phase
   5e's, the ids equal on every rank and each sequence that differs
   from phase 5e's witnessed at its first differing id by the float32
   witness (:func:`engine_witness`), B1/B2, F and W launched on every
   rank (path ``model_mesh``), tokens/s and ms a step; a rank lost
   (``elastic.remesh`` to the 1 x 2 mesh of ranks 0 and 1, the host tree
   re-laid, one decode step under the witness); GPipe over the ``pod``
   axis of the 4 ranks (16 blocks in 4 stages, a bf16 8 x 128 batch in
   4 microbatches) against the meshless layers under the witness;
14. the other model families on a mesh (:func:`family_phase`, run right
   after phase 13; ``--phase14`` alone, ``--backend nccl`` a card a
   rank): phi3.5-moe at full width with its depth cut to 8 of 32 layers
   (bf16 from seed 0, 21.07 GB), its meshless engine on 8 requests over
   its vocab and a left-padded batch of 4's meshless bf16 decode step
   and float32 witness, the weights written as a host flat tree under
   ``build/mesh14`` (removed after); on 4 gloo ranks of the card, phi
   laid out 1 x 4 by ``elastic.reshard`` (4 experts a rank, about 5.27
   GB), every block's SHA-256 equal to the global slice, one sharded
   decode step under the witness (its collectives from a trace, the
   tokens routed to other experts than the witness's counted),
   ``Engine(mesh=...)`` on the 8 requests (latencies, stalls,
   preemptions, retries, tokens out and chains equal the meshless
   engine's, each differing sequence witnessed at its first differing
   id; B1/B2, F and W launched on every rank, path ``model_mesh_moe``;
   tokens/s and ms a step), one decode step on the 2 x 2 (data, model)
   mesh with fsdp over data and each rank's rows, from the batch's last
   two ids (its own witness); then zamba2-7b,
   whisper-large-v3 and paligemma-3b at full width and depth (bf16,
   built on the card one rank at a time and laid out 1 x 4), each a
   prefill of a 2 x 2 prompt (whisper's frames and paligemma's patches
   a seeded stub) and a decode step under the witness, the step's
   collectives from a trace;
15. the benchmark twins (:func:`drivers_phase`, after phase 12;
   ``--phase15`` alone, ``--backend nccl`` a card a rank):
   ``kernels_bench.run(quick=False)`` on the card (B1 == B5 on three
   Zipf alphas, B2 == B1 with its byte counter, the aggregation, host
   refresh == device refresh == ``from_state``), its six mesh cases
   (the sharded refresh, search and ``range_scan`` races, the drift
   controller, the serving sweep of the smoke qwen2-0.5b, the chaos
   battery with its four gates) on 4 gloo ranks of the card, each rank's
   launches read; the sharded search at the reference's defaults and
   the serving sweep of qwen2-0.5b at its published widths (bf16, seed
   0) through ``Engine(mesh=...)`` on 1 x 4, 6 requests a rate, parity
   true; then ``kernels_bench.run(quick=True)`` on the card, its
   deterministic columns equal to the same run with ``--device cpu`` in
   a child process started before phase 14; the timing columns beside
   the card's name and power limit;
16. the sequence layouts and the dry-run (:func:`seq_phase`, after
   phase 15; ``--phase16`` alone): qwen2-0.5b at published widths (bf16
   from seed 0) on 4 gloo ranks of the card under the dry-run's rules
   for a 1 x 4 mesh, a [2, 4096] prefill under ``cp_seq`` + ``cp_q``
   (Megatron-SP, context-parallel q, blockwise attention) and three
   ``kvseq`` decode steps (flash-decoding) from a cache of 8192 that the
   meshless model filled to 4095, the second step writing rank 2's first
   position; zamba2-7b at full width and depth on the 2 x 2 (data,
   model) mesh with batch 1 (``seq``/``kvseq`` over data, its shared
   cache of 32768 split over data), two decode steps; each within twice
   the meshless bf16 distance from the float32 witness, greedy ids
   equal on every rank, bytes a rank; then the dry-run (meta device, H100
   constants) of qwen2-0.5b ``train_4k``/``prefill_32k``/``decode_32k``
   and zamba2-7b ``long_500k`` with their roofline lines.  ``--phase16
   --backend nccl`` on 4 cards measures NCCL's all-reduce and
   all-gather bus bandwidth at 256 MiB (``launch/mesh.py``'s
   ``LINK_BW``).  The path launches none of the hand kernels;
17. the sharded train step (:func:`train_job`, :func:`_train17`, in
   phase 16's world; ``--phase17`` alone): qwen2-0.5b at published
   widths (bf16 from seed 0) on the 1 x 4 mesh under ``cell_rules`` of
   a train shape (``cp_seq`` + ``cp_q``) and on the 2 x 2 mesh with
   fsdp and the batch over ``data``, two ``make_train_step`` steps of 8
   x 512 (``card_checks.train_batch``) on each, the second from the
   float32 witness's state; each step's loss and each leaf's new
   parameter blocks within twice the meshless bf16 step's distance
   from the float32 witness (the bf16 ``grad_norm``'s distance read),
   the loss and ``grad_norm`` equal on every rank; then on each mesh
   the first step in float32, its loss and ``grad_norm`` within the
   tests' rtol 1e-4 of the witness's and each leaf's new first moment
   within 1% of the witness's, norm-wise (the gradients' scale and
   direction); ms a step, the forward's and the rest's collectives by
   kind, a rank's parameter, AdamW-state and peak bytes; launches by
   rank (path ``train_mesh``, none).  A line of
   seconds per phase (``[clock]``) precedes the kernels line.

Each path reads its own launch counts: they are zeroed just before it
(phase 3's prefill and serving run, phase 4's ``run_serving``, phase
5's prefill and serving run, phase 5's full-width searches, phase 5b's
flushes and lookups, phase 5c's ordered run, phase 5d's pool, phase
5e's device-indexed engine, phase 5f's run A, phase 6's timed
composition, phase 10's race, phase 12's quickstart, workloads, train
run and engine demo) and read just after it, before any
check or reference run; the launches of the pools restored from snapshots (phases 5d and
5e) are counted apart, as path ``snapshot``.  Every kernel of a path must
have run on it; on the vocab tier the fused gather runs once per
lookup, B4 builds the hot buffer, and F runs at least once per stream
epoch.  The kernels line reports each kernel's launches on the path it
serves (B1 and F: phase 3, the main path; B2: phase 5; B5: phase 5's
full-width searches; B4 and the fused gather: phase 5b; B3, whose only
caller in the reference is the composition: phase 6's timed
composition; S: phase 10's race; W: phase 3 for the splay-list and
phase 10's race for the skip-list); ``launches_by_path`` adds every
other path, the engine's, ``snapshot`` and ``train`` (which launches none of them)
among them, and the ranks of phase 9 (``sharded``), of phase 12's
sharded demos (``examples_sharded``), of phase 13's engine
(``model_mesh``), of phase 14's (``model_mesh_moe``), of phase 17's
(``train_mesh``) and of phase 15's
(``drivers_kernels`` in this process; ``drivers_refresh``,
``drivers_search``, ``drivers_ordered``, ``drivers_drift``,
``drivers_serving``, ``drivers_chaos``, ``drivers_search_default`` and
``drivers_serving_full`` by rank).  Prints that JSON line, the
card's ``name, power.limit``,
and as the last line ``{"ok": true, "device": {...}}``.  Exits
nonzero, with no result line, on any failed check or without a CUDA
device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "scripts"))
from card_checks import (BF16_OPS, MEM_BW, Agreement,  # noqa: E402
                         CheckFailed, card_line, decode_bound_ms,
                         device_busy, left_pad, smoke_arch_check, train_batch,
                         train_step_check)

FP32_OPS = 67e12          # H100 SXM non-tensor fp32 rate (the old bound)
INT32_PER_SM_CLK = 64     # int32 adds/compares per SM per clock (cc 9.0)


def fail(msg: str) -> None:
    """Print the failure on standard output and on standard error (whose
    end a caller that keeps only the error stream still sees), and the
    seconds per phase so far when the whole smoke runs; exit 1."""
    print(f"FAIL: {msg}", flush=True)
    if PhaseClock.running is not None:
        print(PhaseClock.running.line(), flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class PhaseClock:
    """Seconds per phase on the host clock: :meth:`start` closes the
    phase that ran and opens the next; :meth:`line` is the one line
    that lists them in run order with their sum.  ``running`` is the
    whole smoke's, which :func:`fail` prints."""

    running = None

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.name = None
        self.seconds = {}

    def start(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.seconds[self.name] = (self.seconds.get(self.name, 0.0)
                                       + now - self.t)
        self.name, self.t = name, now

    def line(self) -> str:
        self.start(None)
        return ("[clock] seconds per phase: " + json.dumps(
            {k: round(v, 1) for k, v in self.seconds.items()})
            + f"; total {time.perf_counter() - self.t0:.1f} s")


def host_memory() -> str:
    """This process's resident and peak resident size (``VmRSS`` and
    ``VmHWM``: unlike ``ru_maxrss``, a spawned process's peak starts
    afresh) and the host's available memory, for the log; a field that
    this kernel's ``/proc`` does not give reads "not reported"."""
    def kib(path, *names):
        try:
            with open(path) as f:
                got = {x.split(":")[0]: int(x.split()[1]) for x in f
                       if x.split(":")[0] in names}
        except OSError:
            got = {}
        return [f"{got[n] / 2**20:.2f} GiB" if n in got else "not reported"
                for n in names]
    rss, peak = kib("/proc/self/status", "VmRSS", "VmHWM")
    avail, = kib("/proc/meminfo", "MemAvailable")
    return f"resident {rss} (peak {peak}), host available {avail}"


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def int_rate(torch) -> tuple:
    """The card's own int32 rate: SMs x 64 operations per clock (the
    CUDA throughput table for compute capability 9.0) x the maximum SM
    clock ``nvidia-smi`` reports.  Returns (ops/s, SMs, MHz)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return sms * INT32_PER_SM_CLK * mhz * 1e6, sms, mhz


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != "
              f"{tuple(w.shape)}")
        if g.numel():
            d = (g.cpu().long() - w.cpu().long()).abs().max()
            err = max(err, int(d))
    return err


def row_err(got, want) -> float:
    """Largest absolute difference of two row blocks (0.0 when equal)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} "
          f"{want.dtype}")
    if not got.numel():
        return 0.0
    return float((got.double() - want.double()).abs().max())


def traced(torch, name: str, fn, unprofiled_ms: float) -> None:
    """Run ``fn`` once under ``torch.profiler`` and print the device's
    busy time (``device_busy``) and its idle share of
    ``unprofiled_ms``, the same call's host-clock time unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    busy = device_busy(prof)
    if busy is None:
        print(f"[7] traced {name}: the profiler recorded no device "
              "activity (device busy share not measured)", flush=True)
        return
    kev, busy_ms, span_ms, top = busy
    print(f"[7] traced {name}: {len(kev)} device activities, busy "
          f"{busy_ms:.4f} ms (union of their intervals) over a "
          f"{span_ms:.4f} ms device span; traced wall {wall_ms:.4f} ms; "
          f"idle share of the unprofiled call ({unprofiled_ms} ms) "
          f"{1 - busy_ms / unprofiled_ms:.4f}; top: "
          + "; ".join(f"{k[:60]} {us / 1e3:.4f} ms x{n}"
                      for k, (n, us) in top), flush=True)


def snapshot_round_trip(torch, pool, dev, engine=None):
    """Save a serving snapshot of ``pool`` (and ``engine``'s queue) with
    ``CheckpointManager`` into a temporary directory under ``build/``
    and restore it onto ``dev``.  Returns the restored pool and the
    readings: ms to copy to the host (``save`` with ``blocking=False``
    returns then), ms to write, ms to restore (load, SHA-256 check, to
    the card), bytes and files on disk, the summary and the engine
    state."""
    import tempfile
    from repro_torch.serve import snapshot as snap
    from repro_torch.train.checkpoint import CheckpointManager
    out = {"pending": len(pool._pending), "lookup_no": pool._lookup_no}
    with tempfile.TemporaryDirectory(dir=HERE / "build") as d:
        mgr = CheckpointManager(d)
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap.save_serving_snapshot(mgr, 1, pool, engine=engine,
                                   blocking=False)
        out["sync_ms"] = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        mgr.wait()
        out["write_ms"] = 1e3 * (time.perf_counter() - t)
        files = list((Path(d) / "step_0000000001").iterdir())
        out["files"] = len(files)
        out["bytes"] = sum(f.stat().st_size for f in files)
        t = time.perf_counter()
        back, out["engine"], out["summary"] = snap.restore_serving_snapshot(
            mgr, device=dev)
        torch.cuda.synchronize()
        out["restore_ms"] = 1e3 * (time.perf_counter() - t)
    return back, out


TRAIN_CHECK_LAYERS = 4   # phase 5f: qwen2-0.5b's card-vs-CPU step, its first
                         # layers of 24


def train_phase(torch, dev, read_launches, card):
    """Phase 5f: training (host clocks and CUDA events only).  The ten
    archs at smoke width and qwen2-0.5b at full width (the first
    ``TRAIN_CHECK_LAYERS`` of its layers) in float32, one train step on
    the card against the CPU; then qwen2-0.5b at full
    width as configured through ``launch/train.main``: runs A (10
    steps), B (6 steps, a checkpoint at 6) and C (resumed at 6 to 10).
    Removes the checkpoints and frees what it builds."""
    import dataclasses
    import shutil
    import tempfile
    from unittest import mock
    from repro_torch.configs import registry
    from repro_torch.launch import train as tmain
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train import checkpoint as ckm
    from repro_torch.train import data as dm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    # -- 1. each architecture at smoke width, float32, card against CPU --
    t = time.perf_counter()
    rows = []
    for i, arch in enumerate(registry.ARCHS):
        cfg = registry.get_smoke(arch)
        agree = Agreement(torch, arch)
        share, leaf = train_step_check(
            torch, cfg, zoo.build_params(cfg, seed=0, device="cpu"),
            train_batch(cfg, np.random.default_rng(17 + i), 2, 16), dev,
            agree)
        rows.append((arch, agree, share, leaf))
    print(f"[5f] ten archs at smoke width, float32: one make_train_step "
          f"step on the card == on the CPU (loss, grad_norm and every "
          f"gradient leaf allclose rtol 1e-4 atol 1e-5; a miss passes only "
          f"if the card lies at most twice as far as the CPU's float32 from "
          f"the CPU's float64) in {time.perf_counter() - t:.1f} s; largest "
          f"difference of loss, grad_norm and gradients, and (a reading) of "
          f"an updated leaf as a share of its norm: "
          + "; ".join(f"{a} {g.worst:.2e}, {s:.2e} ({k})"
                      for a, g, s, k in rows), flush=True)
    full = registry.get("qwen2-0.5b")
    cfg32 = dataclasses.replace(full, dtype="float32")
    p_cpu = zoo.build_params(cfg32, seed=0, device="cpu")
    # the first layers of the published depth's weights: the init
    # draws a stacked weight at 1/sqrt(n_layers), so a model built 4
    # layers deep is another, worse conditioned one
    depth = min(TRAIN_CHECK_LAYERS, cfg32.n_layers)
    stacked = set(zoo._layer_keys(p_cpu, cfg32))
    p_cpu = {k: (v[:depth].clone() if k in stacked else v)
             for k, v in p_cpu.items()}
    cfg32 = dataclasses.replace(cfg32, n_layers=depth)
    agree = Agreement(torch, "qwen2-0.5b full width float32")
    t = time.perf_counter()
    share, leaf = train_step_check(
        torch, cfg32, p_cpu, train_batch(cfg32, np.random.default_rng(5),
                                         1, 64), dev, agree)
    rows.append(("qwen2-0.5b full width", agree, share, leaf))
    print(f"[5f] qwen2-0.5b at full width, its first {depth} of "
          f"{full.n_layers} layers, float32 compute, batch 1 x 64: "
          f"card == CPU under the same rule in "
          f"{time.perf_counter() - t:.1f} s; largest difference of "
          f"loss, grad_norm and gradients {agree.worst:.3e}; of an updated "
          f"leaf "
          f"{share:.3e} of its norm ({leaf})", flush=True)
    for a, g, _, _ in rows:
        for what, diff, e_card, e_cpu in g.witnessed:
            print(f"[5f] witnessed: {a} {what}: card - CPU float32 "
                  f"{diff:.4e}; from the CPU's float64: card {e_card:.4e}, "
                  f"CPU float32 {e_cpu:.4e}", flush=True)
    del p_cpu
    torch.cuda.empty_cache()

    # -- 2. qwen2-0.5b at full width as configured, through the trainer --
    free = shutil.disk_usage(HERE).free
    print(f"[5f] free disk beside the checkout: {free} B (two checkpoints "
          f"of about 5.9 GB each are written)", flush=True)
    check(free > 13e9, "less than 13 GB of free disk for the checkpoints")
    events, io = [], {"sync": [], "write": []}

    make = ts.make_train_step

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(*args)
            e1.record()
            events.append((e0, e1))
            return out
        return run

    class TimedManager(ckm.CheckpointManager):
        def save(self, step, params, opt_state=None, extra=None,
                 blocking=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(step, params, opt_state, extra, blocking=False)
            io["sync"].append(1e3 * (time.perf_counter() - t0))
            if blocking:
                self.wait()

        def _write(self, *a):
            t0 = time.perf_counter()
            super()._write(*a)
            io["write"].append(1e3 * (time.perf_counter() - t0))

    base = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "512"]
    d = tempfile.mkdtemp(dir=HERE / "build", prefix="train_ckpt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(tmain.ts, "make_train_step", timed_make):
            from repro_torch.kernels import ops
            ops.reset_launch_counts()
            t = time.perf_counter()
            la = tmain.main(base + ["--steps", "10", "--log-every", "1"])
            torch.cuda.synchronize()
            wall_a = time.perf_counter() - t
            read_launches("train", ())
        peak = torch.cuda.max_memory_allocated()
        step_ms = [a.elapsed_time(b) for a, b in events]
        check(len(la) == 10 and all(math.isfinite(x) for x in la),
              f"run A's losses {la}")
        check(la[-1] < la[0], f"run A's loss did not fall: {la}")
        with mock.patch.object(tmain.ckpt_mod, "CheckpointManager",
                               TimedManager):
            # the final save writes step 6 (a periodic save at 6 would
            # write the same checkpoint twice)
            lb = tmain.main(base + ["--steps", "6", "--ckpt-dir", d])
            check(len(lb) == 6 and all(math.isfinite(x) for x in lb),
                  f"run B's losses {lb}")
            mgr = ckm.CheckpointManager(d)
            check(mgr.steps() == [6], f"checkpoints {mgr.steps()}")
            step_dir = Path(d) / "step_0000000006"
            nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
            t = time.perf_counter()
            flat, extra = mgr.load(6)              # SHA-256 checked
            load_ms = 1e3 * (time.perf_counter() - t)
            tpl = zoo.build_params(full, seed=0, device=dev)
            n_par = sum(v.numel() for v in tpl.values())
            want = {"opt/step": ((), "int32")}
            for k, v in ckm._flatten(tpl).items():
                for pre in ("params", "opt/mu", "opt/nu"):
                    want[f"{pre}/{k}"] = (tuple(v.shape), "float32")
            got = {k: (v.shape, str(v.dtype)) for k, v in flat.items()}
            check(got == want and extra == {"data_step": 6}
                  and int(flat["opt/step"]) == 6,
                  f"step 6's checkpoint holds {sorted(got.items())[:4]}..."
                  f" against {sorted(want.items())[:4]}..., extra {extra}")
            lc = tmain.main(base + ["--steps", "10", "--ckpt-dir", d])
        check(len(lc) == 4 and all(math.isfinite(x) for x in lc),
              f"run C's losses {lc}")
        params6 = ckm.unflatten_into(
            {k: v for k, v in flat.items() if k.startswith("params/")}, tpl)
        del flat, tpl
        b6 = dm.SyntheticZipfData(full.vocab, 512, 8, seed=0).batch_at(6)
        _, _, m6 = ts.make_train_step(full)(
            params6, opt.init(params6),
            {k: torch.as_tensor(v, device=dev) for k, v in b6.items()})
        loss6 = float(m6["loss"])
        check(loss6 == lc[0], f"run C's first loss {lc[0]!r} is not the "
              f"loss of one step from step 6's parameters on batch_at(6), "
              f"{loss6!r}")
        del params6, m6
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    med = float(np.median(step_ms[2:10]))
    bound_ms = 1e3 * 6 * n_par * 8 * 512 / BF16_OPS
    print(f"[5f] qwen2-0.5b full width ({n_par} parameters, bf16 compute, "
          f"remat block) through launch/train.main, batch 8 x 512: run A "
          f"losses {[round(x, 4) for x in la]} (falls); {med:.4f} ms a "
          f"step by events (median of steps 2-9; all: "
          f"{[round(x, 3) for x in step_ms]}), {4096 / med * 1e3:.1f} "
          f"tokens/s, run A {wall_a:.1f} s on the host clock; 6NT bound "
          f"{bound_ms:.4f} ms at {BF16_OPS:.3g} FLOP/s bf16 (remat "
          f"recomputes the forward pass on top: {med / bound_ms:.2f}x); "
          f"max_memory_allocated {peak} B; card {card}", flush=True)
    print(f"[5f] checkpoint of step 6: {nbytes} B, every parameter and "
          f"AdamW moment under the reference's names and shapes; save "
          f"{[round(x, 1) for x in io['sync']]} ms to the host, writes "
          f"{[round(x, 1) for x in io['write']]} ms (runs B and C), load "
          f"with SHA-256 {load_ms:.1f} ms; run B losses "
          f"{[round(x, 4) for x in lb]}; run C resumed at 6: first loss "
          f"{lc[0]!r} == one step from step 6's parameters on batch_at(6); "
          f"C's losses {[round(x, 4) for x in lc]} beside A's "
          f"{[round(x, 4) for x in la[6:]]} (AdamW's moments restart on "
          f"resume, as in the reference)", flush=True)


def models_phase(torch, dev, read_launches, path_launches, minitron):
    """Phase 5e: the model zoo and the serving engine (host clocks and
    CUDA events only).  Frees everything it builds; returns phase 13's
    inputs (:func:`mesh_job`)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core import workload as wl
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import serve_step as ss
    from repro_torch.serve.engine import Engine, Request

    # -- each architecture at smoke width, float32, card against CPU ------
    # (and whisper on the inputs where the card first missed the CPU's)
    t = time.perf_counter()
    cases = [(arch, 17 + i) for i, arch in enumerate(registry.ARCHS)]
    cases.append(("whisper-large-v3", 3))
    smoke = [(a, s) + smoke_arch_check(torch, a, dev, s) for a, s in cases]
    print(f"[5e] ten archs at smoke width, float32, card == CPU "
          f"(allclose rtol 1e-4 atol 1e-5; forward stage by stage read "
          f"through the head, prefill_loop + 3 decode steps; equal greedy "
          f"tokens), at the builder's scale (a miss passes only if the card "
          f"lies at most twice as far as the CPU's float32 from the CPU's "
          f"float64) and at trained scale (no miss) in "
          f"{time.perf_counter() - t:.1f} s; largest differences "
          f"(builder's scale, trained scale): "
          + "; ".join(f"{a} seed {s} {r.worst:.2e}, {tr.worst:.2e}"
                      for a, s, r, tr in smoke), flush=True)
    for a, s, r, _ in smoke:
        for what, diff, e_card, e_cpu in r.witnessed:
            print(f"[5e] witnessed: {a} seed {s} {what}: card - CPU float32 "
                  f"{diff:.4e}; from the CPU's float64: card {e_card:.4e}, "
                  f"CPU float32 {e_cpu:.4e}", 
                  flush=True)

    arr = wl.poisson_zipf_arrivals(8, float("inf"), minitron.vocab,
                                   prompt_len=(2, 7), max_new=8, seed=0)

    # -- minitron-8b at full width in float32: prefill_loop == forward ----
    cfg32 = dataclasses.replace(minitron, dtype="float32",
                                param_dtype="float32")
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = zoo.build_params(cfg32, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for v in params.values())
    build_s = time.perf_counter() - t
    toks = left_pad(arr.prompts[:4], arr.prompt_lens[:4])
    B, L = toks.shape
    dec = ss.make_decode_step(cfg32)
    last, _, n = ss.prefill_loop(dec, params, toks,
                                 zoo.init_cache(cfg32, B, 16, dev))
    logits = zoo.forward(params, cfg32, torch.as_tensor(toks, device=dev))
    want = logits[:, -1].argmax(-1)
    check(n == L and torch.equal(last[:, 0].long(), want),
          f"minitron-8b float32: prefill_loop's greedy tokens "
          f"{last[:, 0].tolist()} != forward's {want.tolist()}")
    _, c, _ = ss.prefill_loop(dec, params, toks[:, :-1],
                              zoo.init_cache(cfg32, B, 16, dev))
    d_logits, _ = zoo.decode_step(params, cfg32,
                                  torch.as_tensor(toks[:, -1:], device=dev),
                                  c, L - 1)
    rel = float((d_logits[:, 0] - logits[:, -1]).abs().max()
                / logits[:, -1].abs().max())
    print(f"[5e] minitron-8b float32 full width ({n_par} parameters, "
          f"{4 * n_par / 1e9:.2f} GB, built in {build_s:.1f} s): "
          f"left-padded batch {B}x{L} through prefill_loop == forward's "
          f"greedy tokens {want.tolist()}; largest logit difference / "
          f"largest logit {rel:.3e}", flush=True)
    del params, logits, c, d_logits
    torch.cuda.empty_cache()

    # -- minitron-8b at full width in bfloat16, through the engine --------
    torch.cuda.reset_peak_memory_stats()
    cfg16, params = minitron16(torch, dev, minitron)
    torch.cuda.synchronize()
    step_bound_ms = decode_bound_ms(params, 4)

    def serve(device_index):
        eng = Engine(cfg16, params, max_batch=4, max_seq=128,
                     device_index=device_index, device=dev)
        events, lookup_ms, flush_ms = [], [], []
        decode, lookup = eng._decode, eng.pool.lookup_batch
        observe = eng.vocab_cache.observe_serving

        def timed_decode(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = decode(*a)
            e1.record()
            events.append((e0, e1))
            return out

        def host_timed(fn, into):
            def run(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                into.append(1e3 * (time.perf_counter() - t0))
                return out
            return run

        eng._decode = timed_decode
        eng.pool.lookup_batch = host_timed(lookup, lookup_ms)
        eng.vocab_cache.observe_serving = host_timed(observe, flush_ms)
        for i in range(len(arr.seq_ids)):
            n_i = int(arr.prompt_lens[i])
            eng.submit(Request(seq_id=int(arr.seq_ids[i]),
                               prompt=arr.prompts[i, :n_i].copy(),
                               max_new=int(arr.max_new[i]),
                               arrival=int(arr.arrival[i])))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if device_index:
            read_launches("engine", ("splay_fold",))
        step_ms = [a.elapsed_time(b) for a, b in events]
        return eng, results, wall, step_ms, lookup_ms, flush_ms

    runs = {m: serve(m) for m in (True, False)}
    peak = torch.cuda.max_memory_allocated()
    (de, dres, dwall, dstep, dlook, dflush) = runs[True]
    (he, hres, hwall, hstep, hlook, hflush) = runs[False]
    for name, a, b in (("generated ids", dres, hres),
                       ("latencies", de.latencies, he.latencies),
                       ("stalls", de.stalls, he.stalls),
                       ("preemptions", de.preemptions, he.preemptions),
                       ("degraded retries", de.degraded_retries,
                        he.degraded_retries),
                       ("tokens out", de.tokens_out, he.tokens_out),
                       ("pool chains", de.pool.chains, he.pool.chains),
                       ("vocab counts", de.vocab_cache.counts.tolist(),
                        he.vocab_cache.counts.tolist())):
        check(a == b, f"minitron-8b engine: {name} differ between the "
              f"device and the host index: {a} != {b}")
    check(len(dres) == 8 and all(len(v) == int(arr.max_new[s])
                                 for s, v in dres.items()),
          f"the engine served {len(dres)} of 8 requests")
    check(all(0 <= x < cfg16.vocab_padded for v in dres.values()
              for x in v), "a generated id lies outside the vocabulary")
    el = path_launches["engine"]
    n_search = el["splay_search_tiered"] + el["splay_search_pipelined"]
    check(n_search > 0, "no descent (B1 or B2) launched on the engine path")
    print(f"[5e] minitron-8b bf16 full width, {cfg16.n_layers} of 32 "
          f"layers, through the engine "
          f"(max_batch 4, max_seq 128, 8 requests, prompts of 2-7, max_new "
          f"8, seed 0): device index == host index on generated ids, "
          f"latencies, stalls {de.stalls}, preemptions {de.preemptions}, "
          f"degraded retries {de.degraded_retries}, tokens out "
          f"{de.tokens_out}, the pool's chains and the vocab counters "
          f"(m {de.vocab_cache.m})", flush=True)
    print(f"[5e] engine, device index: {de.tokens_out / dwall:.2f} tokens/s "
          f"end to end ({de.tokens_out} tokens in {dwall:.3f} s); ms per "
          f"model decode step (events, {len(dstep)} steps) mean "
          f"{np.mean(dstep):.4f}, median {np.median(dstep):.4f}, min "
          f"{np.min(dstep):.4f} (weight-read bound {step_bound_ms:.4f} at "
          f"batch 4); ms per pool lookup batch {np.mean(dlook):.4f} "
          f"({len(dlook)} lookups); ms per vocab stream flush "
          f"{np.mean(dflush):.4f} ({len(dflush)} flushes, host clock, "
          f"synchronised); max_memory_allocated {peak} B", flush=True)
    print(f"[5e] engine, host index: {he.tokens_out / hwall:.2f} tokens/s; "
          f"ms per model decode step mean {np.mean(hstep):.4f}, median "
          f"{np.median(hstep):.4f}; ms per host lookup batch "
          f"{np.mean(hlook):.4f}; ms per vocab stream flush "
          f"{np.mean(hflush):.4f}; launches on path engine (device index): "
          f"B1 {el['splay_search_tiered']}, B2 {el['splay_search_pipelined']}"
          f", F {el['splay_fold']}, B4 {el['gather_rows']} (B4 builds a "
          f"hot buffer only for a lookup through the cache; the engine's "
          f"embedding lookups index the table, as the reference's do)",
          flush=True)

    # phase 13's inputs, before the snapshot's requests change the engine
    job13 = mesh_job(torch, dev, params, cfg16, arr, de, dres, card_line())

    # -- a serving snapshot of the device-indexed engine, restored -------
    from repro_torch.launch import serve as serve_main
    from repro_torch.serve import snapshot as snap
    rpool, es = snapshot_round_trip(torch, de.pool, dev, engine=de)
    re = Engine(cfg16, params, max_batch=4, max_seq=128, device_index=True,
                device=dev)
    re.pool = rpool
    snap.apply_engine_state(re, es["engine"])
    more = wl.poisson_zipf_arrivals(4, float("inf"), minitron.vocab,
                                    prompt_len=(2, 7), max_new=8, seed=1)
    for eng in (de, re):
        for i in range(len(more.seq_ids)):
            n_i = int(more.prompt_lens[i])
            eng.submit(Request(seq_id=int(more.seq_ids[i]),
                               prompt=more.prompts[i, :n_i].copy(),
                               max_new=int(more.max_new[i]),
                               arrival=int(more.arrival[i])))
    de_res = de.run()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    re_res = re.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    snap_paths = path_launches.setdefault("snapshot", {})
    for k, v in counts.items():
        snap_paths[k] = snap_paths.get(k, 0) + v
    check(counts["splay_fold"] > 0 and counts["splay_search_tiered"]
          + counts["splay_search_pipelined"] > 0,
          f"the restored engine's pool launched no descent or no F: {counts}")
    for name, a, b in (("generated ids", re_res, de_res),
                       ("latencies", re.latencies, de.latencies),
                       ("stalls", re.stalls, de.stalls),
                       ("preemptions", re.preemptions, de.preemptions),
                       ("degraded retries", re.degraded_retries,
                        de.degraded_retries),
                       ("tokens out", re.tokens_out, de.tokens_out),
                       ("pool chains", re.pool.chains, de.pool.chains)):
        check(a == b, f"minitron-8b engine restored from a snapshot: {name} "
              f"differ from the continuing engine's: {a} != {b}")
    check(len(re_res) == 4, f"the restored engine served {len(re_res)} of 4")
    print(f"[5e] snapshot of the device-indexed engine at clock "
          f"{es['engine']['clock']}: {es['bytes']} B in {es['files']} files;"
          f" save {es['sync_ms']:.3f} ms to the host then "
          f"{es['write_ms']:.3f} ms to write, restore {es['restore_ms']:.3f}"
          f" ms; {es['summary']}; 4 more requests (seed 1) to the "
          f"continuing and the restored engine: generated ids, latencies, "
          f"stalls, preemptions, retries, tokens out and chains equal; the "
          f"restored pool's launches {counts}", flush=True)
    import contextlib
    import io
    import tempfile
    with tempfile.TemporaryDirectory(dir=HERE / "build") as d:
        outs = []
        for extra in ([], ["--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = serve_main.main(["--smoke", "--device-index",
                                       "--snapshot-dir", d] + extra)
            outs.append((res, buf.getvalue()))
    restored = [ln for ln in outs[1][1].splitlines()
                if ln.startswith("restored")]
    check(len(restored) == 1 and outs[0][0] == outs[1][0],
          f"launch.serve --snapshot-dir then --resume: {outs[1][1][-400:]}")
    print(f"[5e] launch.serve --smoke --device-index --snapshot-dir, then "
          f"--resume: {restored[0]}; the same {len(outs[1][0])} sequences",
          flush=True)
    del de, he, re, rpool, runs, params
    torch.cuda.empty_cache()
    return job13


KV_PAGES, KV_PAGE_SIZE = 28672, 16   # phase 5d's pool (minitron-8b)


def as_plain(x):
    """An answer as plain Python values (arrays as lists)."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (tuple, list)):
        return [as_plain(y) for y in x]
    return x


def kv_admit(s, n_tok):
    return lambda p: p.create(int(s)) and p.append_tokens(int(s), n_tok)


def kv_flush(p):
    return p.lookup_batch(np.empty(0, np.int64))


def kv_drive(call, wl, on_step=None) -> int:
    """Phase 5d's request stream, one pool call at a time: ``call(fn,
    timed)`` applies ``fn`` to the pool(s) under test and returns its
    answer (``timed`` names the call's kind for timing).  3584 sessions
    of 7 pages admitted in groups of 256, each group flushed and looked
    up; 64 decode steps of 2 creates, 2 releases, a flush and 256 Zipf
    lookups; then a 300-op ``kv_scan_trace``.  ``on_step`` is called
    with ``"admitted"`` after the admissions and with each decode step's
    index before its flush.  Returns the scan trace's length."""
    krng = np.random.default_rng(31)
    ids = krng.permutation(1 << 20)[:3584 + 128].astype(np.int64)
    sessions, spare = list(ids[:3584]), list(ids[3584:])
    for g in range(0, 3584, 256):
        grp = ids[g:g + 256]
        for s in grp:
            check(call(kv_admit(s, 7 * KV_PAGE_SIZE)), "an admission failed")
        call(kv_flush, "flush")
        call(lambda p: p.lookup_batch(grp), "lookup")
    if on_step:
        on_step("admitted")
    zp = 1.0 / np.arange(1, len(sessions) + 1)
    zp /= zp.sum()
    for step in range(64):
        for _ in range(2):
            s = spare.pop()
            call(kv_admit(s, 7 * KV_PAGE_SIZE))
            sessions.append(s)
        for _ in range(2):
            victim = sessions.pop(int(krng.integers(len(sessions))))
            call(lambda p: p.release(int(victim)))
        if on_step:
            on_step(step)
        call(kv_flush, "flush")
        pick = np.asarray(sessions)[krng.choice(len(sessions), 256, p=zp)]
        call(lambda p: p.lookup_batch(pick), "lookup")
    trace = wl.kv_scan_trace(300, 4096, seed=7)
    for k, s, h in zip(trace.kinds.tolist(), trace.seq_ids.tolist(),
                       trace.hi_ids.tolist()):
        if k == wl.KV_CREATE:
            call(kv_admit(s, 3))
        elif k == wl.KV_LOOKUP:
            call(lambda p: p.lookup(s))
        elif k == wl.KV_RELEASE:
            call(lambda p: (p.release(s), p.utilization))
        elif k == wl.KV_SCAN:
            call(lambda p: p.lookup_range(s, h, max_range=64), "range")
        else:
            call(lambda p: p.predecessor(s), "predecessor")
    return len(trace.kinds)


SHARDED_RANKS = 4        # phase 9: ranks, one process each
SHARDED_CPU_EPOCHS = 2   # phase 9: epochs held against the CPU plain path
SHARDED_PROFILE_EPOCHS = 4
SHARDED_KERNELS = ("splay_search_tiered", "splay_search_pipelined",
                   "splay_fold", "splay_walk")   # B1, B2, F, W: every
                                                 # rank launches each


def merged(spans) -> list:
    """Intervals merged into disjoint ones, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def collective_split(prof, backend: str, n_epochs: int,
                     wall_ms: float) -> dict:
    """Where the traced epochs' wall went, read off one
    ``torch.profiler`` trace (ms an epoch).  The collectives are the
    process group's own host events (``gloo:<op>``/``nccl:<op>``, one a
    call, its input's shape recorded; every tensor the port's
    collectives carry is int32, 4 bytes an element); the device's work
    is every device activity but NCCL's kernels, which wait on their
    own stream for the peers.  ``collective_ms`` is the union of the
    collectives' intervals, ``collective_idle_ms`` the part of it in
    which the device did no work, ``device_busy_ms`` the union of the
    device's work, and ``host_ms`` the rest of the wall: the three
    last add up to ``wall_ms``.  With NCCL the host events are the
    enqueues, and ``collective_device_ms`` sums NCCL's kernels."""
    from torch.autograd import DeviceType
    prefix = ("gloo:", "nccl:")
    coll = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and e.name.startswith(prefix)]
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    comm = [e for e in dev if "nccl" in e.name.lower()]
    work = [e for e in dev if "nccl" not in e.name.lower()]

    def spans(evs):
        return [(e.time_range.start, e.time_range.end) for e in evs]

    def total(ivs):
        return sum(b - a for a, b in ivs) / 1e3 / n_epochs

    elems = sum(math.prod(e.input_shapes[0]) for e in coll
                if e.input_shapes and e.input_shapes[0])
    out = {"backend": backend, "collectives": len(coll) / n_epochs,
           "collective_bytes": 4 * elems / n_epochs,
           "collective_ms": total(merged(spans(coll))),
           "collective_device_ms": sum(b - a for a, b in spans(comm))
           / 1e3 / n_epochs,
           "collective_idle_ms": None, "device_busy_ms": None,
           "host_ms": None, "idle_share": None}
    if work:                # else the trace saw no device activity
        w_ms = total(merged(spans(work)))
        both = total(merged(spans(coll) + spans(work)))
        out.update(collective_idle_ms=both - w_ms, device_busy_ms=w_ms,
                   host_ms=wall_ms - both, idle_share=1 - w_ms / wall_ms)
    return out


def plane_digest(plane) -> str:
    """SHA-256 over a plane's search fields (keys, widths, heights,
    rank_map, bot_rank), in that order."""
    import hashlib
    h = hashlib.sha256()
    for f in ("keys", "widths", "heights", "rank_map", "bot_rank"):
        h.update(getattr(plane, f).cpu().numpy().tobytes())
    return h.hexdigest()


def sharded_job(torch, dev, served=None, kv_log=None, kv_chains=None):
    """The references phase 9's ranks are held to: phase 3's meshless
    verdicts and levels of the paper-scale stream, the digest of its
    served plane, and every epoch's batch searched on that plane; phase
    5d's host-pool answers and final chains.  ``served`` (phase 3's
    ``run_serving`` output) and the 5d log are computed here when not
    given (``--phase9``)."""
    import fold_timing as ft
    from repro_torch.core import device_index as dix
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.kernels import ops
    from repro_torch.serve.kv_cache import PagedKVPool
    E, B = ft.PAPER_E, ft.PAPER_B
    stream, pre_args = ft.paper_prefill(sx, wl)
    keys = stream.keys.reshape(E, B)
    if served is None:
        st = sx.make(capacity=ft.PAPER_CAPACITY, max_level=ft.PAPER_LEVELS,
                     device=dev)
        st, _, _ = sx.run_ops(st, *pre_args)
        plane0 = dix.from_state_device(st, n_levels=ft.PAPER_LEVELS,
                                       width=ft.PAPER_CAPACITY - 2)
        served = sx.run_serving(st, plane0, np.zeros((E, B), np.int32), keys,
                                stream.upd.reshape(E, B), aggregate=True,
                                plane_search=True)
    plane = served[1]
    search = []
    for e in range(E):
        q = torch.as_tensor(keys[e], device=dev)
        search.append([x.cpu().numpy() for x in ops.splay_search(plane, q)])
    if kv_log is None:
        hpool = PagedKVPool(KV_PAGES, KV_PAGE_SIZE)
        kv_log = []

        def host(fn, timed=None):
            got = fn(hpool)
            kv_log.append(as_plain(got))
            return got
        kv_drive(host, wl)
        kv_chains = dict(hpool.chains)
    return {"res": served[2].cpu().numpy(), "plen": served[3].cpu().numpy(),
            "plane": plane_digest(plane), "search": search,
            "kv_log": kv_log, "kv_chains": kv_chains,
            "snap_dir": tempfile.mkdtemp(dir=HERE / "build")}


def sharded_rank(mesh, job) -> dict:
    """Phase 9 on one rank (``launch.spmd`` runs it on every rank; each
    holds the replicated state and its block of the plane, all on its
    card).  Paper-scale serving with the mesh (routed under lanes and
    mass, masked, a forced spill), each epoch's verdicts and levels
    equal to phase 3's meshless ones; the served plane gathered equal to
    phase 3's; every epoch's batch searched sharded, masked with B1 and
    routed with B2, equal to the meshless search; the first epochs'
    ``RouteStats`` equal to the CPU plain path's over a gloo group; the
    epoch's time split by a timed and a traced run; then phase 5d's KV
    pool sharded, with a shard loss to 2 and a snapshot restored onto 2
    ranks, every answer equal to the host pool's.  Returns the rank's
    readings and launches."""
    import shutil

    import torch
    import torch.distributed as dist

    import fold_timing as ft
    from repro_torch.core import convert
    from repro_torch.core import device_index as dix
    from repro_torch.core import faults as fl
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.kernels import ops
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import snapshot as snap
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.train import elastic
    from repro_torch.train.checkpoint import CheckpointManager
    dev, me = mesh.device, f"rank {mesh.index}"
    check(dev.type == "cuda", f"{me} computes on {dev}, not the card")
    E, B = ft.PAPER_E, ft.PAPER_B
    stream, pre_args = ft.paper_prefill(sx, wl)
    kinds = np.zeros((E, B), np.int32)
    keys = stream.keys.reshape(E, B)
    upd = stream.upd.reshape(E, B)
    st = sx.make(capacity=ft.PAPER_CAPACITY, max_level=ft.PAPER_LEVELS,
                 device=dev)
    st, _, _ = sx.run_ops(st, *pre_args)
    W = ft.PAPER_CAPACITY - 2
    plane0 = dix.from_state_device(st, n_levels=ft.PAPER_LEVELS, width=W)
    out = {"rank": mesh.index, "backend": mesh.backend,
           "device": torch.cuda.get_device_name(dev), "runs": {},
           "launches": {}}
    total = {}

    def count(name):
        c = ops.launch_counts()
        out["launches"][name] = c
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    def serve(name, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        got = sx.run_serving(st, plane0, kinds, keys, upd, aggregate=True,
                             plane_search=True, mesh=mesh, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        count(name)
        check(np.array_equal(got[2].cpu().numpy(), job["res"])
              and np.array_equal(got[3].cpu().numpy(), job["plen"]),
              f"{me}: {name}: verdicts or levels differ from phase 3's "
              "meshless ones")
        check(int(got[4].sum()) == 0, f"{me}: {name} overflowed")
        out["runs"][name] = {
            "ms_per_epoch": 1e3 * wall / E,
            "spill": got[5].tolist(), "occupancy": got[6].tolist()}
        return got

    lanes = serve("routed_lanes")
    check(plane_digest(shd.gather_index_plane(lanes[1])) == job["plane"],
          f"{me}: the gathered plane differs from phase 3's")
    mass = serve("routed_mass", split="mass")
    check(int(mass[1].local_ok[0]) == 1 and dix.plane_is_segmented(mass[1]),
          f"{me}: the mass split left no resident segmented plane")
    serve("masked", routed=False)
    spilled = serve("spill", route_capacity=512)
    check(int(spilled[5].sum()) > 0, f"{me}: capacity 512 did not spill")

    # every epoch's batch on the served plane: masked through B1, routed
    # with pipelined=True, against the meshless search of phase 3's
    # plane.  At 32768 lanes a rank B2's tile count (128 of 256 lanes)
    # passes its 64-tile budget, so the shard descent takes B1 there by
    # the reference's rule; B2 runs on the KV pool's 7168-lane blocks
    for name, kw in (("search_masked_b1", dict(routed=False,
                                               pipelined=False)),
                     ("search_routed", dict(pipelined=True))):
        ops.reset_launch_counts()
        for e in range(E):
            got = ops.splay_search_sharded(
                lanes[1], torch.as_tensor(keys[e], device=dev), mesh=mesh,
                **kw)
            check(all(np.array_equal(g.cpu().numpy(), w)
                      for g, w in zip(got, job["search"][e])),
                  f"{me}: {name}: epoch {e} differs from the meshless "
                  "search")
        torch.cuda.synchronize()
        count(name)

    # RouteStats, verdicts and levels of the first epochs against the
    # CPU plain path over a gloo group of the same ranks
    cpu_group = (mesh.group if mesh.backend == "gloo"
                 else dist.new_group(backend="gloo"))
    cpu_mesh = shd.Mesh(cpu_group, device="cpu")
    st_c = convert.state_from_numpy(sx.to_numpy(st), device="cpu")
    plane_c = dix.from_state_device(st_c, n_levels=ft.PAPER_LEVELS, width=W)
    Ec = SHARDED_CPU_EPOCHS
    for name, card_out, kw in (("routed_lanes", lanes, {}),
                               ("routed_mass", mass, dict(split="mass"))):
        t = time.perf_counter()
        got = sx.run_serving(st_c, plane_c, kinds[:Ec], keys[:Ec],
                             upd[:Ec], aggregate=True, plane_search=True,
                             mesh=cpu_mesh, **kw)
        for i, what in ((2, "verdicts"), (3, "levels"), (5, "spill"),
                        (6, "occupancy")):
            check(torch.equal(got[i], card_out[i][:Ec].cpu()),
                  f"{me}: {name}: the CPU plain path's {what} differ from "
                  "the card's")
        out["runs"][name]["cpu_epochs_s"] = time.perf_counter() - t

    # where a steady sharded epoch's time goes (after the runs above,
    # so no first-call setup is in it): the wall of a plain run, then
    # one traced run split on the trace's own clock into the host's
    # waits in collectives while the device is idle, the device's busy
    # time, and the host's own time (neither)
    from torch.profiler import ProfilerActivity, profile
    from card_checks import device_busy
    Ep = SHARDED_PROFILE_EPOCHS

    def steady():
        torch.cuda.synchronize()
        t = time.perf_counter()
        sx.run_serving(st, plane0, kinds[:Ep], keys[:Ep], upd[:Ep],
                       aggregate=True, plane_search=True, mesh=mesh)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / Ep

    split = {"wall_ms": steady()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        split["traced_wall_ms"] = steady()
    split.update(collective_split(prof, mesh.backend, Ep,
                                  split["traced_wall_ms"]))
    busy = device_busy(prof)
    if busy is not None and split["device_busy_ms"] is not None:
        hand = sum(e.time_range.end - e.time_range.start for e in busy[0]
                   if "descent_kernel" in e.name
                   or "fold_kernel" in e.name) / 1e3 / Ep
        split.update(kernel_ms=hand,
                     other_device_ms=split["device_busy_ms"] - hand)
    else:
        split.update(kernel_ms=None, other_device_ms=None)
    out["split"] = split

    # phase 5d's KV pool, sharded: a shard loss to 2 at lookup epoch 79
    # (an audited epoch, so the audit cadence stays 5d's), a snapshot at
    # decode step 34 (epoch 96, right after an audit) restored onto 2
    # ranks; every answer equal to the host pool's, and the restored
    # pool's to the uninterrupted one's
    plan = fl.FaultPlan(seed=11, events=[
        fl.FaultEvent(47, fl.FAULT_BITFLIP, 1),
        fl.FaultEvent(60, fl.FAULT_TELEMETRY, 4),
        fl.FaultEvent(79, fl.FAULT_SHARD_LOSS, 2)])
    pool = PagedKVPool(KV_PAGES, KV_PAGE_SIZE, device=True, index_batch=256,
                       audit_every=16, fault_plan=plan, mesh=mesh)
    log, at = job["kv_log"], [0]
    kv = {"restored": None}

    def call(fn, timed=None):
        got = as_plain(fn(pool))
        check(got == log[at[0]], f"{me}: KV call {at[0]}: the sharded pool "
              f"answers {got}, the host pool {log[at[0]]}")
        if kv["restored"] is not None:
            again = as_plain(fn(kv["restored"]))
            check(again == got, f"{me}: KV call {at[0]}: the restored pool "
                  f"answers {again}, the uninterrupted one {got}")
        at[0] += 1
        return got

    def on_step(step):
        if step != 34:
            return
        check(pool.mesh is not None or mesh.index >= 2,
              f"{me}: a survivor lost its mesh")
        check(len(pool._pending) == 4 and pool._since_audit == 0,
              f"{me}: snapshot point: {len(pool._pending)} pending ops, "
              f"{pool._since_audit} lookups since the last audit")
        mgr = CheckpointManager(job["snap_dir"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        # the survivors' pool is the one the snapshot holds: its mesh's
        # ranks save it (the first writes); the rest wait for the write
        if pool.mesh is not None:
            snap.save_serving_snapshot(mgr, 1, pool)
        dist.barrier()
        kv["save_ms"] = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        mesh2 = elastic.remesh(mesh.ranks[:2], model_parallel=2,
                               device=dev)
        kv["restored"], _, kv["summary"] = snap.restore_serving_snapshot(
            mgr, mesh=mesh2, device=dev)
        torch.cuda.synchronize()
        kv["restore_ms"] = 1e3 * (time.perf_counter() - t)

    ops.reset_launch_counts()
    t = time.perf_counter()
    kv_drive(call, wl, on_step)
    torch.cuda.synchronize()
    kv["s"] = time.perf_counter() - t
    count("kv_pool")
    back = kv.pop("restored")
    check(pool.chains == job["kv_chains"] and back.chains == pool.chains
          and back.free == pool.free,
          f"{me}: the pools' chains or free lists differ")
    survivor = mesh.index < 2
    check(not survivor or back.stats == pool.stats,
          f"{me}: the restored pool's stats {back.stats} differ from the "
          f"uninterrupted one's {pool.stats}")
    check(pool.stats["remeshes"] == 1 and (pool.mesh is not None) ==
          survivor and (back.mesh is not None) == survivor,
          f"{me}: the shard loss left mesh {pool.mesh} / {back.mesh}")
    kv["stats"] = dict(pool.stats)
    kv["shards_after"] = int(pool.mesh.size) if pool.mesh else 1
    out["kv"] = kv
    # the drift battery (benchmarks/drift_probe.py): the recovery
    # properties at the reference's parity shape, then the three
    # policies raced at its bench shape; run_parity raises on a
    # violation, which fails the launch
    from repro_torch.benchmarks import drift_probe as dp
    ops.reset_launch_counts()
    t = time.perf_counter()
    out["drift_parity"] = dp.run_parity(mesh)
    out["drift_bench"] = dp.run_bench(mesh)
    torch.cuda.synchronize()
    out["drift_s"] = time.perf_counter() - t
    count("drift")
    out["total_launches"] = total
    out["memory"] = (f"{host_memory()}; card peak allocated "
                     f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
                     f"GiB")
    if mesh.index == 0:
        shutil.rmtree(job["snap_dir"], ignore_errors=True)
    return out


def sharded_phase(torch, dev, job, backend: str) -> dict:
    """Phase 9: :func:`sharded_rank` on ``SHARDED_RANKS`` ranks started
    by the port's launcher (gloo: every rank on ``cuda:0``; nccl: one
    card a rank).  Prints each rank's readings; returns each kernel's
    launches by rank."""
    import gc

    from repro_torch.launch import spmd
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[9] starting {SHARDED_RANKS} {backend} ranks; this process: "
          f"{host_memory()}; card free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB", flush=True)
    t = time.perf_counter()
    try:
        ranks = spmd.spawn(sharded_rank, SHARDED_RANKS, job,
                           backend=backend, device="cuda", timeout=900)
    except RuntimeError as e:
        fail(f"phase 9: {e}")
    wall = time.perf_counter() - t
    for r in ranks:
        for k in SHARDED_KERNELS:
            check(r["total_launches"][k] > 0, f"rank {r['rank']} never "
                  f"launched {k} on the sharded path")
    r0 = ranks[0]
    print(f"[9] the width-sharded index on {SHARDED_RANKS} ranks "
          f"({backend}, {r0['device']}): paper scale (10^5 keys, Zipf s=1, "
          f"L=24, W=131072, {131072 // SHARDED_RANKS} lanes a rank, 25 "
          f"epochs x 4096 contains): every run's verdicts and levels equal "
          f"phase 3's meshless ones on every rank; the served plane "
          f"gathered equals phase 3's; every batch searched masked (B1) "
          f"and routed equals the meshless search; the first "
          f"{SHARDED_CPU_EPOCHS} epochs' RouteStats equal the CPU plain "
          f"path's; {wall:.1f} s for the phase", flush=True)
    print("[9]   (routed_lanes is each process's first sharded run: its "
          "ms hold the first collectives' setup and the kernels' loading)",
          flush=True)
    for name, run in r0["runs"].items():
        print(f"[9]   {name}: {run['ms_per_epoch']:.3f} ms an epoch; spill "
              f"{run['spill']}; occupancy of the first, middle and last "
              f"epochs {[run['occupancy'][e] for e in (0, len(run['spill']) // 2, -1)]}",
              flush=True)
    for r in ranks:
        sp = r["split"]
        print(f"[9]   rank {r['rank']} where a steady routed-lanes epoch "
              f"goes ({SHARDED_PROFILE_EPOCHS} epochs, ms an epoch, from "
              f"one trace): wall {sp['wall_ms']} untraced, "
              f"{sp['traced_wall_ms']} traced = collectives with the "
              f"device idle {sp['collective_idle_ms']} + device busy "
              f"{sp['device_busy_ms']} + host {sp['host_ms']}; collectives "
              f"{sp['collectives']} calls, {sp['collective_bytes']} B, "
              f"{sp['collective_ms']} ms on the host; hand kernels "
              f"(B1/B2/F) {sp['kernel_ms']}, other device work "
              f"{sp['other_device_ms']}; NCCL kernels "
              f"{sp['collective_device_ms']}; idle share "
              f"{sp['idle_share']}", flush=True)
        print(f"[9]   rank {r['rank']} launches (B1, B2, F, W) by run: "
              + "; ".join(f"{run} {[c[k] for k in SHARDED_KERNELS]}"
                          for run, c in r["launches"].items()), flush=True)
        print(f"[9]   rank {r['rank']} memory: {r['memory']}", flush=True)
    for r in ranks:
        par, ben = r["drift_parity"], r["drift_bench"]
        print(f"[9]   rank {r['rank']} drift battery ({r['drift_s']:.1f} s; "
              f"launches (B1, B2, F, W) "
              f"{[r['launches']['drift'][k] for k in SHARDED_KERNELS]}): "
              f"parity "
              f"W={par['width']} B={par['batch']} E={par['epochs']} K="
              f"{par['recovery_bound_epochs']}: answers equal the meshless "
              f"loop's, the controller recovers within K, static lanes "
              f"fails somewhere, the calm stream never actuates; "
              + "; ".join(f"{n} ttr on {v['ttr_on']} off {v['ttr_off']} "
                          f"peak share {v['peak_share']:.4f} wall s "
                          f"{v['wall_s']['controller']:.3f}/"
                          f"{v['wall_s']['static_lanes']:.3f}"
                          for n, v in par["scenarios"].items()),
              flush=True)
        for n, row in ben["scenarios"].items():
            print(f"[9]   rank {r['rank']} drift bench W={ben['width']} "
                  f"q={ben['batch']} E={ben['epochs']} {n} (transitions "
                  f"{row['transitions']}): " + "; ".join(
                      f"{pol} ttr {row[pol]['time_to_recover']} peak share "
                      f"after {row[pol]['peak_share_post']} peak spill "
                      f"{row[pol]['peak_spill_rate']} wall "
                      f"{row[pol]['wall_s']} s"
                      for pol in ("controller", "static_lanes",
                                  "static_mass")), flush=True)
    kv = r0["kv"]
    print(f"[9] the KV pool (W={KV_PAGES}, {KV_PAGES // SHARDED_RANKS} "
          f"lanes a rank) sharded: every answer equal to the host pool's "
          f"on every rank, under a bitflip (epoch 47), a telemetry "
          f"blackout (60) and a shard loss to 2 (79); {kv['s']:.1f} s; "
          f"snapshot at decode step 34 saved in {kv['save_ms']:.3f} ms and "
          f"restored onto 2 ranks in {kv['restore_ms']:.3f} ms "
          f"({kv['summary']}), its answers, chains, free list and stats "
          f"equal to the uninterrupted pool's; stats {kv['stats']}",
          flush=True)
    return {k: {f"rank{r['rank']}": r["total_launches"][k] for r in ranks}
            for k in r0["total_launches"]}


SCALING_N = 100_000       # phase 10: keys (the paper's Tables 1-3)
SCALING_OPS = 65536       # phase 10: contains a race (the reference's)
SCALING_CHECK = 4         # phase 10: B=256 batches replayed on the CPU
S_LIST = 4096             # phase 10: S's timed mixed list


def scaling_phase(torch, dev, read_launches) -> dict:
    """Phase 10: the paper's Figs. 3-5 setting on the card
    (``benchmarks/concurrent_scaling.py``): 10^5 keys, the 90-10 and
    99-1 workloads (``xy_workload``, seed 9), ``SCALING_OPS`` contains
    in batches of 16, 64 and 256, the splay-list (coins p = 1/100 from
    ``default_rng(1)``; one W and one F launch a batch) raced
    against the skip-list (heights from ``default_rng(0)``, populated by
    one S launch; one W launch a batch), max level 20, capacity 2n + 4.  Every
    answer must be True; the first ``SCALING_CHECK`` batches at B = 256
    replayed on CPU copies of the card's starting states through the
    plain versions must give the same path sums and states.  Then S
    alone: the populate again (events) against its plain fold on the
    CPU, bit for bit, the same keys descending and shuffled, each against
    its plain fold too, and a mixed list of ``S_LIST`` ops on the
    populated state.  Returns S's readings for the kernels line."""
    from repro_torch.benchmarks import concurrent_scaling as cs
    from repro_torch.core import skiplist as skx
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.kernels import ops, skip_fold
    n, total = SCALING_N, SCALING_OPS
    t = time.perf_counter()
    ops.reset_launch_counts()
    res = cs.run(n=n, total_ops=total, device=dev, keep_start=True)
    read_launches("paper_scaling", ("splay_fold", "skip_fold", "splay_walk",
                                    "skip_walk"))
    race_s = time.perf_counter() - t
    for key, r in res.items():
        if key[1] == "populate":
            print(f"[10] {key[0]} populate of {n} keys: splay-list "
                  f"{r['splay_ms']:.3f} ms (one F launch), skip-list "
                  f"{r['skip_ms']:.3f} ms (one S launch), host clock; "
                  f"launches {r['launches']}", flush=True)
            continue
        check(r["all_found"], f"phase 10 {key}: a contains answered False")
        print(f"[10] {key[0]} {key[1]} B={key[2]}: {r['ops_s']:.1f} ops/s, "
              f"mean path {r['path']:.4f} ({r['psum']} steps; the "
              f"longest lane of a batch {r['loop_steps']:.2f} on average), "
              f"{r['ms_per_batch']:.4f} ms a batch; launches F "
              f"{r['launches']['splay_fold']} S "
              f"{r['launches']['skip_fold']} W "
              f"{r['launches']['splay_walk'] + r['launches']['skip_walk']}",
              flush=True)
    ratio = {f"{tag}/B{B}": res[(tag, "splay", B)]["ops_s"]
             / res[(tag, "skip", B)]["ops_s"]
             for _, _, tag in cs.WORKLOADS for B in cs.BATCHES}
    print(f"[10] splay/skip ops/s: {ratio}; the race {race_s:.1f} s",
          flush=True)

    def cpu(st):
        return type(st)(*(x.cpu() for x in st))

    for x, y, tag in cs.WORKLOADS:
        q = wl.xy_workload(n, x, y, total, seed=9).keys[:total].reshape(
            -1, 256)[:SCALING_CHECK]
        for eng in ("splay", "skip"):
            r = res[(tag, eng, 256)]
            coins = (None if r["coins"] is None
                     else r["coins"][:SCALING_CHECK])
            got = cs.race(eng, r["start"], torch.as_tensor(q, device=dev),
                          None if coins is None
                          else torch.as_tensor(coins, device=dev))
            want = cs.race(eng, cpu(r["start"]), torch.as_tensor(q),
                           None if coins is None else torch.as_tensor(coins))
            sums = [int(v) for v in want[1]]
            check(sums == [int(v) for v in got[1]]
                  == r["batch_psums"][:SCALING_CHECK],
                  f"phase 10 {tag} {eng}: the path sums of the first "
                  f"batches differ between the card, its race and the CPU")
            check(max_abs_err(list(got[0]), list(want[0])) == 0,
                  f"phase 10 {tag} {eng}: the card's state differs from "
                  f"the CPU's after {SCALING_CHECK} batches")
    print(f"[10] the first {SCALING_CHECK} batches at B=256 of each "
          f"workload and engine, replayed on CPU copies of the card's "
          f"starting states: equal path sums and states", flush=True)

    # S alone: the populate (the 99-1 workload's keys) on the card by
    # events, and through the plain fold on the CPU; then a mixed list
    # on the populated state
    keys = np.sort(wl.xy_workload(n, 0.99, 0.01, total, seed=9).populate)
    hts = skx.sample_heights(np.random.default_rng(0), n, cs.MAX_LEVEL,
                             device="cpu")
    ins = torch.ones(n, dtype=torch.int32)
    cap = 2 * n + 4

    def s_launch(st, args, on):
        work = skx.clone(st)
        args = [a.to(on) for a in args]
        r_ = torch.zeros(args[0].shape[0], dtype=torch.bool, device=on)
        p_ = torch.zeros(args[0].shape[0], dtype=torch.int32, device=on)
        if on.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            stop = skip_fold.fold_ops(work, *args, r_, p_)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            stop = skip_fold.fold_ops(work, *args, r_, p_)
            ms = 1e3 * (time.perf_counter() - t0)
        check(stop == args[0].shape[0], f"S stopped at op {stop}")
        return work, r_, p_, ms

    def changed_bytes(a, b):
        return sum(int((x.cpu() != y.cpu()).sum()) * x.element_size()
                   for x, y in zip(a, b))

    out = {}
    empty_g = skx.make(cap, cs.MAX_LEVEL, device=dev)
    pop_args = (ins, torch.as_tensor(keys), hts)
    g_pop = s_launch(empty_g, pop_args, dev)
    c_pop = s_launch(cpu(empty_g), pop_args, torch.device("cpu"))
    err = max(max_abs_err(list(g_pop[0]), list(c_pop[0])),
              max_abs_err(g_pop[1:3], c_pop[1:3]))
    check(err == 0, f"S's populate of {n} keys differs from its plain "
          f"fold (err {err})")
    check(max_abs_err(list(g_pop[0]),
                      list(res[("99-1", "skip", 256)]["start"])) == 0,
          "S's populate differs from the race's")
    out["populate"] = dict(ms=g_pop[3], plain_ms=c_pop[3], ops=n,
                           changed=changed_bytes(empty_g, g_pop[0]))
    # the same keys descending and shuffled: S's fingers settle every
    # level of a sorted insert at once, and few of a shuffled one
    for what, order in (("descending", keys[::-1].copy()),
                        ("shuffled", np.random.default_rng(3)
                         .permutation(keys))):
        o_args = (ins, torch.as_tensor(order), hts)
        g_o = s_launch(empty_g, o_args, dev)
        c_o = s_launch(cpu(empty_g), o_args, torch.device("cpu"))
        err = max(max_abs_err(list(g_o[0]), list(c_o[0])),
                  max_abs_err(g_o[1:3], c_o[1:3]))
        check(err == 0, f"S's {what} populate of {n} keys differs from its "
              f"plain fold (err {err})")
        out[what] = dict(ms=g_o[3], plain_ms=c_o[3], ops=n)
        print(f"[10] S {what} populate of {n} keys: {g_o[3]:.3f} ms a "
              f"launch (events; plain fold {c_o[3]:.1f} ms), equal to its "
              f"plain fold", flush=True)
    mrng = np.random.default_rng(12)
    m_kinds = torch.as_tensor(mrng.choice(3, S_LIST, p=[0.6, 0.2, 0.2])
                              .astype(np.int32))
    m_keys = torch.as_tensor(np.where(
        mrng.random(S_LIST) < 0.8, mrng.choice(keys, S_LIST),
        mrng.integers(0, 2 * n, S_LIST)).astype(np.int32))
    m_h = skx.sample_heights(np.random.default_rng(13), S_LIST,
                             cs.MAX_LEVEL, device="cpu")
    m_args = (m_kinds, m_keys, m_h)
    g_mix = s_launch(g_pop[0], m_args, dev)
    c_mix = s_launch(c_pop[0], m_args, torch.device("cpu"))
    err = max(max_abs_err(list(g_mix[0]), list(c_mix[0])),
              max_abs_err(g_mix[1:3], c_mix[1:3]))
    check(err == 0, f"S's mixed list differs from its plain fold "
          f"(err {err})")
    out["mixed"] = dict(ms=g_mix[3], plain_ms=c_mix[3], ops=S_LIST,
                        changed=changed_bytes(g_pop[0], g_mix[0]),
                        walk_steps=int(g_mix[2].sum()),
                        inserts=int((m_kinds == skx.OP_INSERT).sum()))
    mix_steps = out["mixed"]["walk_steps"]
    out["ratio"] = ratio
    out["race_s"] = race_s
    out["starts"] = {(tag, eng): res[(tag, eng, 256)]["start"]
                     for _, _, tag in cs.WORKLOADS
                     for eng in ("splay", "skip")}
    out["phase_s"] = time.perf_counter() - t
    print(f"[10] S alone: the populate of {n} keys {g_pop[3]:.3f} ms a "
          f"launch (events; plain fold on the host CPU {c_pop[3]:.1f} ms), "
          f"a {S_LIST}-op mixed list {g_mix[3]:.3f} ms "
          f"({mix_steps} find steps; plain {c_mix[3]:.1f} ms); both "
          f"equal their plain folds; the phase {out['phase_s']:.1f} s",
          flush=True)
    return out


# dependent rounds of loads a walk step: W issues a step's loads
# together; a walk that loads nzero, nxt and key one after another
# (splay), nxt and key (skip), pays the serial count
WALK_LOADS = {"splay_walk": 1, "skip_walk": 1}
WALK_LOADS_SERIAL = {"splay_walk": 3, "skip_walk": 2}


def walk_footprint(torch, st, ks) -> int:
    """The bytes a batch's walks must move at least: the keys read, the
    slots and steps written, and each distinct state entry the walks
    read (``key`` and ``nxt`` entries, and ``nzero`` entries and ``zl``
    on the splay-list) once; from the reads of the plain walk on the
    card."""
    from repro_torch.kernels import state_walk as sw
    lazy = hasattr(st, "nzero")
    C = st.capacity
    reads = []
    (sw.splay_walk_plain if lazy else sw.skip_walk_plain)(st, ks, reads)

    def distinct(xs):
        return int(torch.unique(torch.cat(xs)).numel()) if xs else 0

    nxt_seen = [lvl * C + p % C for lvl, p, _ in reads]
    key_seen = [ks.new_full((1,), sw.HEAD, dtype=torch.int64)] + [
        c % C for _, _, c in reads]
    nz_seen = [p % C for _, p, _ in reads] if lazy else []
    return 12 * ks.shape[0] + 4 * (distinct(nxt_seen) + distinct(key_seen)
                                   + distinct(nz_seen) + (1 if lazy else 0))


def walk_phase(torch, dev, st3, k0, starts, chase_l2, graph_ms,
               eager_ms) -> dict:
    """Phase 11: kernel W, the state walk of both engines' find_batch,
    against its plain loop on the card, bit for bit in slot and steps:
    phase 10's populated states (256 queries of each workload and 4096
    random keys, absent and negative ones among them), the paper serving
    state after its 25 epochs (4096 contains), small states with
    delete-marked keys, lazy nodes and a bottom raised by a rebuild,
    batches of 0, 1 and 333, a POS_INF_32 key (refused, first, last and
    inside 4096 keys on phase 10's states, which stay as they were) and
    a cyclic state (the step bound).  Then W per launch by graph replay
    at the phase-7 shape and at B = 16, 64 and 256 on phase 10's states,
    each beside its longest lane, the latency floor (the longest lane's
    dependent rounds x the pointer chase's ns in L2; the serial walk's
    beside it) and the bytes bound;
    the plain loop and a find_batch call by events.  Returns the
    readings for the kernels line."""
    from repro_torch.benchmarks import concurrent_scaling as cs
    from repro_torch.core import skiplist as skx
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.kernels import state_walk as sw

    plains = {"splay_walk": sw.splay_walk_plain,
              "skip_walk": sw.skip_walk_plain}
    mods = {"splay_walk": sx, "skip_walk": skx}
    errs = {"splay_walk": 0, "skip_walk": 0}
    cases = {"splay_walk": 0, "skip_walk": 0}

    def name_of(st):
        return "splay_walk" if hasattr(st, "nzero") else "skip_walk"

    def hold(st, q, what):
        name = name_of(st)
        got = mods[name].find_batch(st, q)
        want = plains[name](st, q)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"W {name} {what}: differs from its plain loop "
              f"(err {e})")
        errs[name] = max(errs[name], e)
        cases[name] += 1
        return got

    n = SCALING_N
    rng = np.random.default_rng(21)
    rand = torch.as_tensor(np.concatenate([
        rng.integers(-2 * n, 0, 1024), rng.integers(0, 4 * n, 3072)])
        .astype(np.int32), device=dev)
    for x, y, tag in cs.WORKLOADS:
        wq = torch.as_tensor(wl.xy_workload(n, x, y, SCALING_OPS, seed=9)
                             .keys[:256], device=dev)
        for eng in ("splay", "skip"):
            st = starts[(tag, eng)]
            hold(st, wq, f"{tag} {eng} 256 workload keys")
            hold(st, rand, f"{tag} {eng} 4096 random keys")
            for nq in (0, 1, 333):
                hold(st, rand[:nq], f"{tag} {eng} batch of {nq}")
    hold(st3, k0, "paper serving state, 4096 contains")

    # small states (the recipe of tests/test_torch_state_walk.py): 240
    # inserts, then 20 deletes and six contains epochs (marked keys and
    # lazy nodes), or 80 deletes, whose hits fire a rebuild that
    # compacts the list and leaves its bottom above level 0, four
    # epochs and 12 fresh inserts (lazy nodes again)
    for what, seed in (("marked", 1), ("rebuilt", 2)):
        srng = np.random.default_rng(seed)
        pool = srng.permutation(1000)[:240].astype(np.int32)
        st = sx.make(320, 10, device=dev)
        st, _, _ = sx.run_ops(st, np.full(240, sx.OP_INSERT, np.int32),
                              pool, srng.random(240) < 0.5)
        gone = pool[:20] if what == "marked" else pool[::3]
        live = np.setdiff1d(pool, gone)
        st, _, _ = sx.run_ops(st, np.full(len(gone), sx.OP_DELETE,
                                          np.int32), gone,
                              np.zeros(len(gone), bool))
        hot = srng.choice(live, 24)
        for e in range(6 if what == "marked" else 4):
            qs = np.where(srng.random(128) < 0.7, srng.choice(hot, 128),
                          srng.choice(live, 128)).astype(np.int32)
            st, _, _ = sx.run_contains_batch(st, qs, srng.random(128) < 0.6,
                                             aggregate=bool(e % 2))
        if what == "rebuilt":
            new = (1000 + srng.permutation(500)[:12]).astype(np.int32)
            st, _, _ = sx.run_ops(st, np.full(12, sx.OP_INSERT, np.int32),
                                  new, srng.random(12) < 0.5)
            pool = np.concatenate([pool, new])
        nz = st.nzero[2:int(st.n_alloc)]
        check(bool((nz > st.zl).any()) and int(st.zl) > 0,
              f"small {what} state: no lazy node or zl == 0")
        check(int(st.deleted.sum()) == 20 if what == "marked"
              else int(st.n_alloc) == 2 + 160 + 12,
              f"small {what} state: marks lost or no rebuild")
        q = torch.as_tensor(np.concatenate([
            pool, srng.integers(-50, 2000, 120),
            [sx.NEG_INF_32, -1, 1000, 2000, sx.POS_INF_32 - 1]])
            .astype(np.int32), device=dev)
        for nq in (0, 1, 333, q.shape[0]):
            hold(st, q[:nq], f"small {what} state, batch of {nq}")
    # the refusal: a POS_INF_32 key first, last and among 4096 keys; W
    # refuses it in its status word, and the walk leaves the state as it
    # was
    refused = 0
    for x, y, tag in cs.WORKLOADS:
        for eng in ("splay", "skip"):
            st = starts[(tag, eng)]
            before = [t.clone() for t in st]
            for at in (0, rand.shape[0] - 1, 1234):
                q = rand.clone()
                q[at] = sx.POS_INF_32
                try:
                    mods[name_of(st)].find_batch(st, q)
                    fail(f"W {tag} {eng}: a POS_INF_32 key at {at} of "
                         f"{q.shape[0]} did not raise")
                except ValueError as e:
                    check("POS_INF_32" in str(e), f"W's refusal: {e}")
                refused += 1
            check(all(torch.equal(a, b) for a, b in zip(before, st)),
                  f"W {tag} {eng}: a refused batch changed the state")
    for name, mod in mods.items():
        st = mod.make(8, 4, device=dev)
        try:
            mod.find_batch(st, [3, sx.POS_INF_32])
            fail(f"W {name}: a POS_INF_32 key did not raise")
        except ValueError:
            pass
        if name == "splay_walk":
            st.nzero[2] = 0
            st.top[2] = 3
        st.key[2] = 5
        st.nxt[:, 0] = 2
        st.nxt[:, 2] = 0
        try:
            mod.find_batch(st, [3, 10])
            fail(f"W {name}: a cyclic state did not raise")
        except RuntimeError as e:
            check("step bound" in str(e), f"W {name}: {e}")
    print(f"[11] W against its plain loop on the card, bit for bit: "
          f"{cases} cases (phase 10's states at 10^5 keys, the paper "
          f"serving state, small states with marked keys, lazy nodes and "
          f"a rebuilt bottom; batches of 0, 1, 333); a POS_INF_32 key "
          f"raises ValueError ({refused} batches of 4096 on phase 10's "
          f"states, the key first, last and inside, each state unchanged) "
          f"and a cyclic state RuntimeError on both engines; "
          f"{sw.BLOCK} threads a block", flush=True)

    def timed(st, q, what):
        name = name_of(st)
        steps = mods[name].find_batch(st, q)[1]
        longest = int(steps.max())
        ms = graph_ms(torch, sw.launcher(st, q))
        floor_ms = longest * WALK_LOADS[name] * chase_l2 * 1e-6
        serial_ms = longest * WALK_LOADS_SERIAL[name] * chase_l2 * 1e-6
        nbytes = walk_footprint(torch, st, q)
        r = dict(ms=ms, longest=longest, steps=int(steps.sum()),
                 floor_ms=floor_ms, serial_floor_ms=serial_ms,
                 nbytes=nbytes, nq=q.shape[0])
        print(f"[11] W {name} {what} q={q.shape[0]}: {ms:.5f} ms a launch "
              f"(graph replay); longest lane {longest} steps (mean "
              f"{r['steps'] / q.shape[0]:.2f}); latency floor {longest} x "
              f"{WALK_LOADS[name]} dependent round x {chase_l2:.1f} ns = "
              f"{floor_ms:.5f} ms (a serial walk's, "
              f"{WALK_LOADS_SERIAL[name]} dependent loads a step: "
              f"{serial_ms:.5f} ms); {nbytes} B to move", flush=True)
        return r

    out = {"errs": errs, "splay_walk": {}, "skip_walk": {}}
    r = timed(st3, k0, "phase-7 shape (paper serving state)")
    r["call_ms"] = eager_ms(torch, lambda: sx.find_batch(st3, k0), 20)
    r["plain_ms"] = eager_ms(torch, lambda: sw.splay_walk_plain(st3, k0),
                             3, 1)
    print(f"[11] W splay_walk phase-7 shape: find_batch call "
          f"{r['call_ms']:.5f} ms (events, the key check and the status "
          f"read included); plain loop {r['plain_ms']:.3f} ms", flush=True)
    out["splay_walk"]["phase7"] = r
    for x, y, tag in cs.WORKLOADS:
        keys = wl.xy_workload(n, x, y, SCALING_OPS, seed=9).keys
        for eng in ("splay", "skip"):
            st = starts[(tag, eng)]
            for B in cs.BATCHES:
                q = torch.as_tensor(keys[:B], device=dev)
                r = timed(st, q, f"{tag} {eng} B={B}")
                if B == 256:
                    r["plain_ms"] = eager_ms(
                        torch, lambda: plains[name_of(st)](st, q), 3, 1)
                    r["call_ms"] = eager_ms(
                        torch, lambda: mods[name_of(st)].find_batch(st, q),
                        20)
                    print(f"[11] W {tag} {eng} B=256: find_batch call "
                          f"{r['call_ms']:.5f} ms (events); plain loop "
                          f"{r['plain_ms']:.3f} ms", flush=True)
                out[name_of(st)][f"{tag}/B{B}"] = r
    return out


def examples_phase(torch, dev, read_launches) -> dict:
    """Phase 12: the example twins (``repro_torch.examples``) through
    their ``main``.  ``quickstart`` on the card, its numbers equal to the
    same twin on CPU tensors; ``splay_workloads`` at its own sizes, which
    drives the host engines as the reference does and so launches
    nothing on the card; ``train_adaptive_lm``'s 60 smoke steps
    (checkpoints into a temporary directory under ``build/``, removed
    after), every loss finite; ``serve_adaptive``: the engine demo on
    the card, then the sharded demos on ``SERVE_SHARDS`` (4) gloo ranks
    on the card, which ``main`` spawns, each rank launching W.  Returns
    every kernel's launches by rank."""
    import shutil

    from repro_torch.examples import quickstart, serve_adaptive
    from repro_torch.examples import splay_workloads, train_adaptive_lm
    from repro_torch.kernels import ops

    t = time.perf_counter()
    ops.reset_launch_counts()
    got = quickstart.main([])
    read_launches("examples_quickstart", ("splay_fold", "splay_walk"))
    q_s = time.perf_counter() - t
    want = quickstart.main(["--device", "cpu"])
    check(got == want, f"quickstart on the card {got} differs from CPU "
          f"tensors {want}")
    print(f"[12] quickstart on the card ({q_s:.1f} s): {got}, equal to "
          f"the twin on CPU tensors", flush=True)

    t = time.perf_counter()
    ops.reset_launch_counts()
    rows = splay_workloads.main([])
    read_launches("examples_workloads", ())
    wk_s = time.perf_counter() - t
    check(len(rows) == len(splay_workloads.ENGINES)
          and all(r[2] > 0 and math.isfinite(r[3]) for r in rows),
          f"splay_workloads: {rows}")
    paths = {(e, p): path for e, p, _, path in rows}
    check(paths[("splaylist", 1.0)] < paths[("skiplist", 1.0)],
          f"splay_workloads: the splay-list's path is not shorter: {rows}")
    print(f"[12] splay_workloads on the host engines ({wk_s:.1f} s, no "
          f"launch on the card): avg path {paths}", flush=True)

    (HERE / "build").mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="train-example-",
                                 dir=HERE / "build"))
    try:
        t = time.perf_counter()
        ops.reset_launch_counts()
        losses = train_adaptive_lm.main(["--ckpt-dir", str(ckpt)])
        read_launches("examples_train", ())
        tr_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(len(losses) == 60 and all(math.isfinite(v) for v in losses),
          f"train_adaptive_lm: {len(losses)} losses, {losses[-3:]}")
    print(f"[12] train_adaptive_lm on the card: 60 steps in {tr_s:.1f} s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    # the engine demo runs in this process, the sharded demos in the
    # ranks main spawns: this process's counts are the engine demo's
    t = time.perf_counter()
    ops.reset_launch_counts()
    try:
        out = serve_adaptive.main([])
    except RuntimeError as e:
        fail(f"phase 12: {e}")
    read_launches("examples_serve_engine", ())
    sv_s = time.perf_counter() - t
    ranks = out["ranks"]
    check(len(out["engine"]) == 10, f"serve_adaptive engine demo: "
          f"{out['engine']}")
    check(len(ranks) == serve_adaptive.N_SHARDS >= 2,
          f"serve_adaptive ran {len(ranks)} ranks")
    for i, r in enumerate(ranks):
        check(r["device"].startswith("cuda"), f"phase 12 rank {i} on "
              f"{r['device']}")
        check(r["launches"]["splay_walk"] > 0, f"phase 12 rank {i} never "
              "launched W")
    sharded = ranks[0]["lines"]
    check(any("re-split recovery" in line for line in sharded)
          and any("controller recovery" in line for line in sharded),
          f"serve_adaptive's sharded demos: {sharded}")
    print(f"[12] serve_adaptive on the card ({sv_s:.1f} s; the sharded "
          f"demos on {len(ranks)} gloo ranks): launches by rank "
          + "; ".join(f"rank {i} {r['launches']}"
                      for i, r in enumerate(ranks)), flush=True)
    return {k: {f"rank{i}": r["launches"][k] for i, r in enumerate(ranks)}
            for k in ranks[0]["launches"]}


DRIVER_RANKS = 4          # phase 15: the probes' mesh (kernels_bench.N_DEV)
SERVE_FULL_ARCH = "qwen2-0.5b"   # phase 15's serving sweep at published widths
SERVE_FULL_REQUESTS = 6          # its requests a rate (run_bench's default 12)
# phase 15: the jobs of its one 4-rank world, in order: ``(path, probe
# twin module, rank function, arguments, kernels every rank must
# launch)``.  The first nine are the mesh cases of kernels_bench's full
# then quick profile with the arguments its ``run`` passes (the chaos
# battery's snapshot directory comes from the phase); the last two are
# the phase's own: the sharded search at the reference's defaults, and
# the serving sweep at the published widths.  A path of the quick
# profile only is suffixed ``_quick``.
B2, F, W = "splay_search_pipelined", "splay_fold", "splay_walk"
DRIVER_JOBS = (
    ("drivers_refresh", "sharded_refresh_probe", "run_bench", (4096,), ()),
    ("drivers_search", "sharded_search_probe", "run_bench",
     (4096, 8192, 4, True), (B2,)),
    ("drivers_ordered", "ordered_search_probe", "run_bench", (2048, 2048),
     (B2, F)),
    ("drivers_drift", "drift_probe", "_rank", (False, True, 4096, 8192, 10),
     (B2, F, W)),
    ("drivers_serving", "serving_probe", "_rank", (False, True, 16),
     (B2, F, W)),
    ("drivers_chaos", "chaos_probe", "run_battery", None, (B2, F, W)),
    ("drivers_refresh_quick", "sharded_refresh_probe", "run_bench",
     (1024,), ()),
    ("drivers_ordered_quick", "ordered_search_probe", "run_bench",
     (1024, 1024), (B2, F)),
    ("drivers_serving_quick", "serving_probe", "_rank", (False, True, 8),
     (B2, F, W)),
    ("drivers_search_default", "sharded_search_probe", "run_bench", (),
     (B2,)),
    ("drivers_serving_full", "chip_smoke", "serve_full", (SERVE_FULL_ARCH,),
     (B2, F, W)),
)


def serve_full(mesh, arch: str) -> dict:
    """``serving_probe.run_bench`` through ``Engine(mesh=...)`` with
    ``arch`` at its published widths, bf16 weights from seed 0 built on
    this rank's card, ``SERVE_FULL_REQUESTS`` requests a rate."""
    import dataclasses

    from repro_torch.benchmarks import serving_probe as svp
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get(arch), param_dtype="bfloat16")
    return svp.run_bench(mesh, n_requests=SERVE_FULL_REQUESTS, cfg=cfg)


def drivers_rank(mesh, snap_dir: str) -> dict:
    """Phase 15's rank body: every job of ``DRIVER_JOBS`` in order, each
    with the kernels' launches it made on this rank (zeroed just before,
    read just after) and its seconds; the peak card memory of the
    published-width sweep."""
    import importlib

    import torch

    from repro_torch.kernels import ops
    out = {"device": str(mesh.device)}
    for path, module, name, args, _ in DRIVER_JOBS:
        mod = (sys.modules[__name__] if module == "chip_smoke" else
               importlib.import_module(f"repro_torch.benchmarks.{module}"))
        if args is None:
            args = (snap_dir,)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        res = getattr(mod, name)(mesh, *args)
        torch.cuda.synchronize()
        out[path] = (res, ops.launch_counts(), time.perf_counter() - t,
                     torch.cuda.max_memory_allocated())
    return out


def kernels_bench_cpu():
    """Start ``kernels_bench``'s quick profile with ``--device cpu`` in a
    child process (phase 15's CPU side, a few minutes of host work with
    its own CPU ranks); phase 15 reads its last line.  The child leads a
    process group of its own, which is killed, its ranks with it, if
    this process exits first (a failed check)."""
    import atexit
    import os
    import signal
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.benchmarks.kernels_bench",
         "--device", "cpu"], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)

    def stop():
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    atexit.register(stop)
    return child


def drivers_phase(torch, dev, read_launches, card: str,
                  backend: str = "gloo", cpu=None) -> dict:
    """Phase 15: the benchmark twins on the card.

    One world of ``DRIVER_RANKS`` ranks (gloo on the card; nccl a card a
    rank) runs :func:`drivers_rank`: the six mesh cases of
    ``kernels_bench.run(quick=False)``, the three of the quick profile
    whose shapes differ, the sharded search at the reference's defaults
    and the serving sweep at ``SERVE_FULL_ARCH``'s published widths
    (parity true), each rank's launches read job by job.  Then, in this
    process, ``kernels_bench.run(quick=False)`` (B1 against B5, B2
    against B1, the refresh paths, the aggregation, each race's outputs
    asserted equal inline) and ``kernels_bench.run(quick=True)``, whose
    ``_on_mesh`` hands each mesh case the world's rank-0 result for the
    same rank function and arguments (one spawn instead of ten: a
    launch of four ranks costs about 10 s on the card's machine).  The
    quick run's deterministic columns equal the same twin's quick run
    with ``--device cpu``, which a child process runs meanwhile
    (:func:`kernels_bench_cpu`; ``cpu``: one started earlier).  Prints
    the timing columns beside the card's name and power limit; returns
    the launches of every path, by rank for the world's paths."""
    import shutil

    from repro_torch.benchmarks import kernels_bench as kb
    from repro_torch.kernels import ops
    from repro_torch.launch import spmd
    t_phase = time.perf_counter()
    if cpu is None:
        cpu = kernels_bench_cpu()
    (HERE / "build").mkdir(exist_ok=True)
    snap_dir = tempfile.mkdtemp(prefix="chaos15-", dir=HERE / "build")
    t = time.perf_counter()
    try:
        ranks = spmd.spawn(drivers_rank, DRIVER_RANKS, snap_dir,
                           backend=backend, device="cuda", timeout=1200)
    except RuntimeError as e:
        cpu.kill()
        fail(f"phase 15: {e}")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    world_s = time.perf_counter() - t
    by_path, results = {}, {}
    for path, module, name, args, need in DRIVER_JOBS:
        for r, rank in enumerate(ranks):
            check(rank["device"].startswith("cuda"), f"phase 15 rank {r} "
                  f"on {rank['device']}")
            for k in need:
                check(rank[path][1][k] > 0, f"phase 15 {path} rank {r} "
                      f"never launched {k}")
        by_path[path] = [rank[path][1] for rank in ranks]
        results[(module, name, args)] = ranks[0][path][0]
    spawn_on_mesh = kb._on_mesh

    def on_mesh(fn, *args, device="cuda", backend="gloo"):
        module = fn.__module__.rsplit(".", 1)[-1]
        key = (module, fn.__name__,
               None if module == "chaos_probe" else args)
        if key not in results:
            fail(f"phase 15: kernels_bench asked for {key}, which the "
                 "world did not run (DRIVER_JOBS)")
        return results[key]

    kb._on_mesh = on_mesh
    try:
        t = time.perf_counter()
        ops.reset_launch_counts()
        full = kb.run(quick=False, backend=backend)
        # this process's counts: the kernel races
        read_launches("drivers_kernels", (
            "splay_search_tiered", "splay_search_full",
            "splay_search_pipelined", "splay_fold", "splay_walk"))
        full_s = time.perf_counter() - t
        t = time.perf_counter()
        quick = kb.run(quick=True, backend=backend)
        quick_s = time.perf_counter() - t
    finally:
        kb._on_mesh = spawn_on_mesh
    try:
        cpu_out, cpu_err = cpu.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        cpu.kill()
        cpu.communicate()
        fail("phase 15: the CPU run of kernels_bench did not end in 900 s")
    check(cpu.returncode == 0, f"phase 15: kernels_bench --device cpu "
          f"failed:\n{cpu_err[-3000:]}")
    cpu_payload = json.loads(cpu_out.strip().splitlines()[-1])

    # the races and the chaos gates are asserted inline; the serving
    # sweeps' parity flags and the ranks' agreement here
    serve_full_out = ranks[0]["drivers_serving_full"][0]
    for name, out in (("smoke", full["serving_engine"]),
                      (SERVE_FULL_ARCH, serve_full_out)):
        check(out["parity_bit_identical"], f"phase 15 serving ({name}): "
              "host and device engines differ")
    check(serve_full_out["arch"] == SERVE_FULL_ARCH and all(
        row["served"] == serve_full_out["n_requests"]
        for row in serve_full_out["rates"].values()),
        f"phase 15: the published-width sweep lost requests: "
        f"{serve_full_out}")
    for path, *_ in DRIVER_JOBS:
        want = kb.deterministic(ranks[0][path][0])
        for r, rank in enumerate(ranks[1:], 1):
            check(kb.deterministic(rank[path][0]) == want, f"phase 15 "
                  f"{path}: rank {r}'s columns differ from rank 0's")
    card_det = kb.deterministic(quick)
    cpu_det = kb.deterministic(cpu_payload)
    diff = sorted(k for k in set(card_det) | set(cpu_det)
                  if card_det.get(k) != cpu_det.get(k))
    check(json.loads(json.dumps(card_det)) == cpu_det, f"phase 15: the "
          f"quick run's deterministic columns differ card against CPU in "
          f"{diff}")

    # the readings, beside the card
    z = {r["alpha"]: r for r in full["zipf_search"]}
    print(f"[15] kernels_bench.run(quick=False)'s races on the card: "
          f"{full_s:.1f} s ({card}); B1 us/query " + ", ".join(
              f"a{a} {r['us_per_query_tiered']:.4f} (B5 "
              f"{r['us_per_query_seed']:.4f}, mean level "
              f"{r['mean_level_found']})" for a, r in z.items()),
          flush=True)
    p = full["search_pipelined"]
    print(f"[15] B2 against B1 at alpha 1.4, W {p['width']}, q {p['nq']}: "
          f"{p['us_per_query_pipelined']:.4f} / {p['us_per_query_tiered']:.4f}"
          f" us/query; streamed bytes "
          f"{p['streamed_bytes_per_batch_pipelined']} against the whole-row "
          f"model's {p['streamed_bytes_per_batch_tiered_model']}", flush=True)
    a = full["aggregation"]
    print(f"[15] aggregation: {a['us_per_op_serialized']:.3f} -> "
          f"{a['us_per_op_aggregated']:.3f} us/op, folds "
          f"{a['folds_serialized']} -> {a['folds_aggregated']}", flush=True)
    for r in full["refresh_path"]:
        print(f"[15] refresh {r['mode']} W {r['width']}: host "
              f"{r['us_per_epoch_host']:.1f} us/epoch, device "
              f"{r['us_per_epoch_device']:.1f} ({card})", flush=True)
    rs, ss, os_ = (full["refresh_sharded"], full["search_sharded"],
                   full["search_ordered"])
    print(f"[15] sharded refresh W {rs['width']} on {rs['shards']} "
          f"{backend} ranks: {rs['us_per_epoch_sharded']:.1f} us/epoch, "
          f"replicated {rs['us_per_epoch_replicated']:.1f}", flush=True)
    print(f"[15] sharded search W {ss['width']} q {ss['nq']}: routed mass "
          f"{ss['us_per_query_sharded']:.4f} us/query, lanes "
          f"{ss['us_per_query_routed_lane_split']:.4f}, masked "
          f"{ss['us_per_query_masked']:.4f}, replicated "
          f"{ss['us_per_query_replicated']:.4f}, gather "
          f"{ss['us_per_query_gather_dispatch']:.4f}; spill "
          f"{ss['spill_count']} -> {ss['spill_count_mass']} (mass), "
          f"assembled {ss['assembled_resident']}/{ss['assembled_forced']}"
          f"; {ss['us_per_query_sharded'] * ss['nq'] / 1e3:.3f} ms a "
          f"routed batch", flush=True)
    sd = ranks[0]["drivers_search_default"][0]
    print(f"[15] sharded search at the reference's defaults (W "
          f"{sd['width']}, q {sd['nq']}): routed mass "
          f"{sd['us_per_query_sharded']:.4f} us/query, replicated "
          f"{sd['us_per_query_replicated']:.4f}", flush=True)
    print(f"[15] range_scan W {os_['width']} q {os_['nq']}: sharded "
          f"{os_['us_per_scan_sharded']:.4f} us/scan, replicated "
          f"{os_['us_per_scan_replicated']:.4f}; bytes ratio "
          f"{os_['bytes_ratio_ours_over_naive']}, truncated "
          f"{os_['scans_truncated']}", flush=True)
    for name, row in full["routing_controller"]["scenarios"].items():
        c = row["controller"]
        print(f"[15] drift {name}: ttr controller {c['time_to_recover']}, "
              f"static lanes {row['static_lanes']['time_to_recover']}; "
              f"wall s controller {c['wall_s']}, static lanes "
              f"{row['static_lanes']['wall_s']}, static mass "
              f"{row['static_mass']['wall_s']}", flush=True)
    ch = full["chaos_recovery"]
    print(f"[15] chaos: {ch['detected']}/{ch['injected']} detected, "
          f"{ch['wrong_verdicts']} wrong, recovery <= "
          f"{ch['recovery_epochs_max']} of {ch['recovery_bound_epochs']} "
          f"epochs, restores {ch['restores']}, wall {ch['wall_s']} s",
          flush=True)
    for name, sv in (("smoke", full["serving_engine"]),
                     (f"{SERVE_FULL_ARCH} published widths, bf16",
                      serve_full_out)):
        print(f"[15] serving sweep ({name}, {sv['n_requests']} requests, "
              f"{sv['shards']} {backend} ranks): " + "; ".join(
                  f"rate {k}: p50 {v['p50_latency_steps']} p99 "
                  f"{v['p99_latency_steps']} steps, "
                  f"{v['tokens_per_sec']} tokens/s, wall {v['wall_s']} s"
                  for k, v in sv["rates"].items())
              + f"; parity {sv['parity_bit_identical']}", flush=True)
    _, _, sf_s, sf_peak = ranks[0]["drivers_serving_full"]
    print(f"[15] the published-width sweep: {sf_s:.1f} s, peak {sf_peak} B "
          f"on rank 0; the world's jobs " + ", ".join(
              f"{path} {ranks[0][path][2]:.1f} s" for path, *_ in DRIVER_JOBS),
          flush=True)
    print(f"[15] quick run on the card ({quick_s:.1f} s) equals the CPU "
          f"run's deterministic columns ({len(card_det)} entries); the "
          f"world {world_s:.1f} s, the full run in this process "
          f"{full_s:.1f} s; phase 15 {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)
    for path, counts in sorted(by_path.items()):
        print(f"    launches on path {path} by rank: "
              + "; ".join(str({k: v for k, v in c.items() if v})
                          for c in counts), flush=True)
    return by_path


MESH_RANKS = 4            # phase 13: ranks of the model's mesh
MESH_DIR = "mesh13"       # phase 13: the host weights, under build/
PIPE_MB = 4               # phase 13: GPipe's microbatches
PIPE_SHAPE = (8, 128)     # phase 13: GPipe's batch x sequence


MINITRON_LAYERS = 16     # phases 5e (engine) and 13: minitron-8b's first layers


def minitron16(torch, dev, minitron):
    """Phases 5e and 13's minitron-8b: bf16 weights from seed 0 at full
    width, the first ``MINITRON_LAYERS`` of its layers, and the config
    of that depth.  The weights are the published depth's (the init
    draws a stacked weight at 1/sqrt(n_layers): a model built less deep
    is another, worse conditioned one).  Returns ``(cfg, params)``."""
    import dataclasses

    from repro_torch.models import model_zoo as zoo
    full = dataclasses.replace(minitron, param_dtype="bfloat16")
    params = zoo.build_params(full, seed=0, device=dev)
    depth = min(MINITRON_LAYERS, full.n_layers)
    stacked = set(zoo._layer_keys(params, full))
    params = {k: (v[:depth].clone() if k in stacked else v)
              for k, v in params.items()}
    torch.cuda.empty_cache()
    return dataclasses.replace(full, n_layers=depth), params


def _slice_for(shape, spec, coords, sizes):
    """The index of the block a rank at ``coords`` holds of a tensor of
    ``shape`` laid out by ``spec`` (read here independently of the
    port's ``sharding.block_slices``: axes row-major, the last one
    fastest)."""
    idx = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        k, i = 1, 0
        for a in axes:
            k *= sizes[a]
            i = i * sizes[a] + coords[a]
        idx.append(slice(i * n // k, (i + 1) * n // k))
    return tuple(idx)


def _digest(t) -> str:
    """SHA-256 of a CPU tensor's bytes."""
    import hashlib

    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(
        torch.uint8).numpy()).hexdigest()


def write_host_tree(torch, params, specs, sizes, d):
    """The flat tree ``params`` written under ``d`` (a file a tensor,
    ``torch.save`` of its host copy) and the SHA-256 digest of each
    rank's block of each tensor on the ``(data, model)`` mesh ``sizes``
    laid out by ``specs``; the writes and the digests run on 8 threads
    (both release the interpreter lock), the host copies made in turn.
    Returns ``(files, {rank: {name: digest}})``."""
    from concurrent.futures import ThreadPoolExecutor
    files = {name: str(d / f"{name}.pt") for name in params}
    futs = {}
    with ThreadPoolExecutor(8) as ex:
        for name, v in params.items():
            host = v.cpu()
            futs[name] = ex.submit(torch.save, host, files[name])
            for r in range(sizes["model"]):
                futs[r, name] = ex.submit(_digest, host[_slice_for(
                    host.shape, specs[name], {"data": 0, "model": r},
                    sizes)])
            del host
    digests = {r: {} for r in range(sizes["model"])}
    for key, f in futs.items():
        out = f.result()
        if isinstance(key, tuple):
            digests[key[0]][key[1]] = out
    return files, digests


def mesh_job(torch, dev, params, cfg16, arr, de, dres, card) -> dict:
    """Phase 13's inputs, from phase 5e's bf16 minitron-8b weights and
    its device-indexed engine ``de`` (results ``dres``): the weights as
    a host flat tree, one file a tensor under ``build/mesh13`` (the
    ranks map them), each rank's expected block digests on the 1 x 4
    mesh, phase 5e's left-padded batch with its meshless bf16 decode
    step's logits and the float32 witness (the same weights, computed
    in float32), GPipe's input's meshless bf16 and float32 outputs, and
    the engine's length-driven outputs."""
    import dataclasses
    import shutil
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    t = time.perf_counter()
    d = HERE / "build" / MESH_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    need = sum(v.numel() * v.element_size() for v in params.values())
    free_disk = shutil.disk_usage(d).free
    check(free_disk > need + 2**30, f"phase 13 needs {need} B of disk under "
          f"build/ for the host weights, {free_disk} B are free")
    _, axes = zoo.param_axes(cfg16)
    sizes = {"data": 1, "model": MESH_RANKS}
    specs = ly.axes_to_specs(params, axes, shd.AbstractMesh(sizes),
                             shd.default_rules())
    files, digests = write_host_tree(torch, params, specs, sizes, d)
    write_s = time.perf_counter() - t
    # the decode step of phase 5e's float32 check, on the bf16 weights:
    # meshless in bf16, and the witness in float32
    toks = left_pad(arr.prompts[:4], arr.prompt_lens[:4])
    B, L = toks.shape
    cfg32w = dataclasses.replace(cfg16, dtype="float32")

    def step(cfg):
        dec = ss.make_decode_step(cfg)
        _, c, _ = ss.prefill_loop(dec, params, toks[:, :-1],
                                  zoo.init_cache(cfg, B, 16, dev))
        logits, _ = zoo.decode_step(
            params, cfg, torch.as_tensor(toks[:, -1:], device=dev), c, L - 1)
        return logits[:, 0].float().cpu()
    with torch.no_grad():
        l16, l32 = step(cfg16), step(cfg32w)
        x = torch.as_tensor(pipe_input(cfg16.d_model),
                            device=dev).to(torch.bfloat16)
        p16 = zoo._run_layers(x, params, cfg16, torch.bfloat16)
        p32 = zoo._run_layers(x.float(), params, cfg32w, torch.float32)
    job = dict(
        files=files, digests=digests, card=card, toks=toks,
        l16=l16.numpy(), l32=l32.numpy(),
        e_step=float((l16 - l32).abs().max()),
        pipe16=p16.float().cpu().numpy(), pipe32=p32.cpu().numpy(),
        e_pipe=float((p16.float() - p32).abs().max()),
        engine=dict(ids=dres, latencies=dict(de.latencies),
                    stalls=de.stalls, preemptions=de.preemptions,
                    retries=de.degraded_retries, tokens_out=de.tokens_out,
                    chains=dict(de.pool.chains)),
        write_s=write_s, nbytes=need, cfg16=cfg16)
    print(f"[13] host weights written in {write_s:.1f} s ({need} B, "
          f"{len(files)} files under build/{MESH_DIR}); meshless bf16 step "
          f"vs the float32 witness: max |logit diff| {job['e_step']:.4e}; "
          f"GPipe input {PIPE_SHAPE[0]}x{PIPE_SHAPE[1]} through "
          f"{cfg16.n_layers} layers: "
          f"bf16 vs float32 {job['e_pipe']:.4e}", flush=True)
    return job


def pipe_input(d_model: int):
    """GPipe's input: a ``[8, 128, d_model]`` batch from seed 0."""
    return np.random.default_rng(0).standard_normal(
        PIPE_SHAPE + (d_model,), dtype=np.float32)


def _history_logits(torch, params, cfg, hist):
    """The logits ``[V]`` (float32, on the host) after the ids ``hist``
    fed one at a time through the decode cell, on a laid-out tree
    (gathered whole; a collective) or a global one."""
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    dev = params["embed"].device
    mesh = shd.tree_mesh(params)
    cache = zoo.init_cache(cfg, 1, len(hist), dev, mesh=mesh,
                           rules=getattr(params, "rules", None))
    _, cache, _ = ss.prefill_loop(ss.make_decode_step(cfg), params,
                                  hist[None, :-1], cache)
    logits, _ = zoo.decode_step(
        params, cfg, torch.as_tensor(hist[None, -1:], device=dev), cache,
        len(hist) - 1)
    if mesh is not None:
        return _whole_logits(torch, logits[0, 0], params, cfg).float().cpu()
    return logits[0, 0].float().cpu()


def _whole_logits(torch, block, tree, cfg):
    """A laid-out tree's logits block gathered whole (a collective)."""
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    axes = zoo.vocab_axes(tree, cfg)
    spec = (None,) * (block.dim() - 1) + (axes,)
    return shd.relayout(block, spec, (), tree.mesh)


def mesh_rank(mesh, job) -> dict:
    """Phase 13 on one rank: minitron-8b laid out over the 1 x 4 mesh
    (from the host flat tree, ``elastic.reshard`` by ``axes_to_specs``),
    its blocks' digests; one sharded decode step of phase 5e's batch
    under the float32 witness; ``Engine(mesh=...)`` on phase 5e's 8
    requests; the re-lay onto the 1 x 2 mesh of ranks 0 and 1 after a
    rank is lost, and its decode step; GPipe over the ``pod`` mesh of
    the 4 ranks, the 16 blocks in 4 stages."""
    import dataclasses

    import torch

    from repro_torch.core import workload as wl
    from repro_torch.kernels import ops
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import pipeline as pl
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train import elastic
    torch.set_grad_enabled(False)
    dev = mesh.device
    me = mesh.index
    cfg16 = job["cfg16"]
    cfg32w = dataclasses.replace(cfg16, dtype="float32")
    host = {k: torch.load(f, mmap=True, weights_only=True)
            for k, f in job["files"].items()}
    _, axes = zoo.param_axes(cfg16)
    rules = shd.default_rules()
    out = {"rank": me, "device": str(dev)}

    def lay(m):
        specs = ly.axes_to_specs(host, axes, m, rules)
        return shd.LaidOutTree(elastic.reshard(host, specs, m), specs, m,
                               rules)

    def sync_ms(t0):
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0)

    toks = job["toks"]
    B, L = toks.shape
    l32 = torch.as_tensor(job["l32"])

    def step(tree, cfg):
        """Phase 5e's batch: prefill then one decode step; the logits
        gathered whole, the greedy ids, and the step's ms (events)."""
        dec = ss.make_decode_step(cfg)
        cache = zoo.init_cache(cfg, B, 16, dev, mesh=tree.mesh, rules=rules)
        _, c, _ = ss.prefill_loop(dec, tree, toks[:, :-1], cache)
        last = torch.as_tensor(toks[:, -1:], device=dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, _ = zoo.decode_step(tree, cfg, last, c, L - 1)
        e1.record()
        whole = _whole_logits(torch, logits[:, 0], tree, cfg).float().cpu()
        tok = ss.greedy(logits[:, 0], tree, cfg)
        torch.cuda.synchronize(dev)
        return whole, tok, e0.elapsed_time(e1), (c, last)

    # -- 1. the weights laid out over 1 x 4 -------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tree = lay(mesh)
    out["lay_ms"] = sync_ms(t0)
    out["param_bytes"] = sum(v.numel() * v.element_size()
                             for v in tree.values())
    out["digests_equal"] = sum(
        _digest(v.cpu()) == job["digests"][me][k] for k, v in tree.items())
    out["n_tensors"] = len(tree)
    out["peak_after_lay"] = torch.cuda.max_memory_allocated(dev)

    # -- 2. one sharded decode step under the witness ----------------------
    whole, tok, ms, (c, last) = step(tree, cfg16)
    out["e_step"] = float((whole - l32).abs().max())
    out["step_ms"] = ms
    toks_all = cl.all_gather(tok, mesh)
    out["greedy"] = tok.tolist()
    out["greedy_equal_on_ranks"] = bool((toks_all == tok).all())
    out["greedy_meshless"] = torch.as_tensor(job["l16"]).argmax(-1).tolist()
    # one step traced: the collectives a step
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    zoo.decode_step(tree, cfg16, last, c, L - 1)
    wall = sync_ms(t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        zoo.decode_step(tree, cfg16, last, c, L - 1)
        traced = sync_ms(t0)
    out["step_split"] = dict(collective_split(prof, mesh.backend, 1, traced),
                             wall_ms=wall, traced_wall_ms=traced)
    del c

    # -- 3. the engine on the mesh -----------------------------------------
    arr = wl.poisson_zipf_arrivals(8, float("inf"), cfg16.vocab,
                                   prompt_len=(2, 7), max_new=8, seed=0)
    eng = Engine(cfg16, tree, max_batch=4, max_seq=128, device_index=True,
                 index_width=1024, mesh=mesh, device=dev)
    events, padded = [], {}
    decode, pad = eng._decode, eng._pad_prompts

    def recorded_pad(reqs):
        rows = pad(reqs)
        padded.update({r.seq_id: row for r, row in zip(reqs, rows)})
        return rows

    def timed_decode(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = decode(*a)
        e1.record()
        events.append((e0, e1))
        return r
    eng._decode = timed_decode
    eng._pad_prompts = recorded_pad
    for i in range(len(arr.seq_ids)):
        n_i = int(arr.prompt_lens[i])
        eng.submit(Request(seq_id=int(arr.seq_ids[i]),
                           prompt=arr.prompts[i, :n_i].copy(),
                           max_new=int(arr.max_new[i]),
                           arrival=int(arr.arrival[i])))
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize(dev)
    out["engine_wall_s"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    out["engine_step_ms"] = [a.elapsed_time(b) for a, b in events]
    out["engine"] = dict(ids=res, latencies=dict(eng.latencies),
                         stalls=eng.stalls, preemptions=eng.preemptions,
                         retries=eng.degraded_retries,
                         tokens_out=eng.tokens_out,
                         chains=dict(eng.pool.chains))
    out["peak_after_engine"] = torch.cuda.max_memory_allocated(dev)
    free, total = torch.cuda.mem_get_info(dev)
    out["card_used"] = total - free
    # each sequence whose ids differ from phase 5e's, at its first
    # differing id: the history both engines saw there (its left-padded
    # prompt in the wave that finished it, then the ids before) and the
    # mesh's bf16 logits after it, for the float32 witness (mesh_phase)
    witnessed = []
    for s, ids in sorted(res.items()):
        ref = job["engine"]["ids"][s]
        if ids == ref:
            continue
        p = next(j for j in range(len(ids)) if ids[j] != ref[j])
        hist = np.concatenate([padded[s], np.asarray(ref[:p], np.int32)])
        witnessed.append(dict(seq=s, pos=p, mesh_id=ids[p], ref_id=ref[p],
                              hist=hist, logits=_history_logits(
                                  torch, tree, cfg16, hist).numpy()))
    out["witnessed"] = witnessed
    # the wrappers' bound methods hold the engine, and it the tree
    del eng, tree, pad, decode, recorded_pad, timed_decode
    torch.cuda.empty_cache()

    # -- 4. a rank lost: the re-lay onto 1 x 2 ------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    m2 = elastic.remesh([0, 1], model_parallel=2, device=dev)
    out["relay"] = None
    if m2 is not None:
        t0 = time.perf_counter()
        tree2 = lay(m2)
        lay_ms = sync_ms(t0)
        whole2, tok2, ms2, _ = step(tree2, cfg16)
        out["relay"] = dict(
            lay_ms=lay_ms, step_ms=ms2, greedy=tok2.tolist(),
            e_step=float((whole2 - l32).abs().max()),
            param_bytes=sum(v.numel() * v.element_size()
                            for v in tree2.values()),
            peak=torch.cuda.max_memory_allocated(dev),
            shape=dict(m2.shape))
        del tree2
        torch.cuda.empty_cache()
    out["scale_microbatch"] = elastic.scale_microbatch(8, 4, 2, 1)

    # -- 5. GPipe over the pod mesh of the 4 ranks ---------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    pod = shd.world_mesh(device=dev, axis="pod")
    keys = zoo._layer_keys(host, cfg16)
    stacked = pl.split_stages({k: host[k] for k in keys}, MESH_RANKS)
    stage = elastic.reshard(stacked, {k: ("pod",) for k in keys}, pod)
    cfg_stage = dataclasses.replace(cfg16,
                                    n_layers=cfg16.n_layers // MESH_RANKS)

    def stage_fn(p, h):
        return zoo._run_layers(h, p, cfg_stage, torch.bfloat16)
    x = torch.as_tensor(pipe_input(cfg16.d_model),
                        device=dev).to(torch.bfloat16)
    stage_fn({k: v[0] for k, v in stage.items()},
             x[:PIPE_SHAPE[0] // PIPE_MB])          # warm the kernels
    # a barrier: the sum's wait (NCCL enqueues it, so wait on the card)
    cl.psum(torch.zeros(1, device=dev), pod, "pod")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    y = pl.pipeline_forward(x, stage, stage_fn, pod, PIPE_MB, axis="pod")
    out["pipe_ms"] = sync_ms(t0)
    out["pipe_stage_bytes"] = sum(v.numel() * v.element_size()
                                  for v in stage.values())
    out["pipe_peak"] = torch.cuda.max_memory_allocated(dev)
    ys = cl.all_gather(y, pod, "pod")
    out["pipe_equal_on_ranks"] = bool((ys == y).all())
    out["e_pipe"] = float((y.float().cpu() - torch.as_tensor(
        job["pipe32"])).abs().max())
    return out


def engine_witness(torch, dev, job, cases, cfg16=None,
                   phase="phase 13") -> list:
    """The float32 witness of each sequence whose ids on the mesh differ
    from the meshless engine's (``cases``, from :func:`mesh_rank` or
    :func:`family_rank`): the weights of ``cfg16`` (phase 13's bf16
    minitron-8b, ``job["cfg16"]``, when omitted) loaded whole onto the
    card from the host
    tree, the history's logits meshless in bf16 and, the witness, in
    float32 on the same weights; the mesh's bf16 logits must lie at most
    twice as far from the witness as the meshless bf16 ones
    (``Agreement``'s rule).  Returns ``(sequence, position, mesh id, the
    meshless id, mesh distance, meshless distance)`` for each."""
    import dataclasses

    if not cases:
        return []
    cfg16 = job["cfg16"] if cfg16 is None else cfg16
    cfg32w = dataclasses.replace(cfg16, dtype="float32")
    params = {k: torch.load(f, mmap=True, weights_only=True).to(dev)
              for k, f in job["files"].items()}
    out = []
    with torch.no_grad():
        for w in cases:
            l16 = _history_logits(torch, params, cfg16, w["hist"])
            l32 = _history_logits(torch, params, cfg32w, w["hist"])
            e_mesh = float((torch.as_tensor(w["logits"]) - l32).abs().max())
            e_one = float((l16 - l32).abs().max())
            check(e_mesh <= 2 * e_one, f"{phase}: sequence {w['seq']} id "
                  f"{w['pos']}: {w['mesh_id']} on the mesh, {w['ref_id']} "
                  f"meshless; the mesh's logits lie {e_mesh:.4e} from "
                  f"the float32 witness, more than twice the meshless "
                  f"bf16's {e_one:.4e}")
            out.append((w["seq"], w["pos"], w["mesh_id"], w["ref_id"],
                        round(e_mesh, 6), round(e_one, 6)))
    del params
    torch.cuda.empty_cache()
    return out


def mesh_phase(torch, dev, job, backend: str) -> dict:
    """Phase 13: :func:`mesh_rank` on ``MESH_RANKS`` ranks (gloo: every
    rank on ``cuda:0``; nccl: one card a rank).  Checks and prints each
    rank's readings beside the card's name and power limit; removes the
    host weights; returns each kernel's launches by rank on the engine's
    path."""
    import gc
    import shutil

    from repro_torch.launch import spmd
    card = job["card"]
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[13] starting {MESH_RANKS} {backend} ranks; this process: "
          f"{host_memory()}; card free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB ({card})", flush=True)
    t = time.perf_counter()
    try:
        ranks = spmd.spawn(mesh_rank, MESH_RANKS, job, backend=backend,
                           device="cuda", timeout=1200)
        wall = time.perf_counter() - t
        witness = engine_witness(torch, dev, job, ranks[0]["witnessed"])
    except RuntimeError as e:
        fail(f"phase 13: {e}")
    finally:
        shutil.rmtree(HERE / "build" / MESH_DIR, ignore_errors=True)
    e_ref, eng_ref = job["e_step"], job["engine"]
    for r in ranks:
        me = f"phase 13 rank {r['rank']}"
        check(r["digests_equal"] == r["n_tensors"],
              f"{me}: {r['n_tensors'] - r['digests_equal']} blocks differ "
              f"from the global tensors' slices")
        check(r["e_step"] <= 2 * e_ref, f"{me}: the sharded step lies "
              f"{r['e_step']:.4e} from the float32 witness, more than twice "
              f"the meshless bf16 step's {e_ref:.4e}")
        check(r["greedy_equal_on_ranks"], f"{me}: greedy ids differ "
              f"between the ranks")
        for k in ("latencies", "stalls", "preemptions", "retries",
                  "tokens_out", "chains"):
            check(r["engine"][k] == eng_ref[k], f"{me}: the engine's {k} "
                  f"differ from phase 5e's: {r['engine'][k]} != "
                  f"{eng_ref[k]}")
        check(r["engine"]["ids"] == ranks[0]["engine"]["ids"],
              f"{me}: generated ids differ from rank 0's")
        n = r["launches"]
        check(n["splay_search_tiered"] + n["splay_search_pipelined"] > 0
              and n["splay_fold"] > 0 and n["splay_walk"] > 0,
              f"{me}: a kernel of the model_mesh path never launched: {n}")
        if r["relay"] is not None:
            check(r["relay"]["e_step"] <= 2 * e_ref, f"{me}: the 1 x 2 "
                  f"step lies {r['relay']['e_step']:.4e} from the witness, "
                  f"more than twice {e_ref:.4e}")
        check(r["pipe_equal_on_ranks"], f"{me}: GPipe outputs differ "
              f"between ranks")
        check(r["e_pipe"] <= 2 * job["e_pipe"], f"{me}: GPipe lies "
              f"{r['e_pipe']:.4e} from the float32 layers, more than twice "
              f"the meshless bf16 layers' {job['e_pipe']:.4e}")
    r0 = ranks[0]
    ids_equal = sum(r0["engine"]["ids"][s] == eng_ref["ids"][s]
                    for s in eng_ref["ids"])
    tok_equal = sum(a == b for s in eng_ref["ids"] for a, b in zip(
        r0["engine"]["ids"][s], eng_ref["ids"][s]))
    steps = np.concatenate([r["engine_step_ms"] for r in ranks])
    print(f"[13] minitron-8b bf16 on a 1 x {MESH_RANKS} mesh ({backend}, "
          f"{r0['device']}), {wall:.1f} s for the phase ({card})",
          flush=True)
    for r in ranks:
        print(f"[13]   rank {r['rank']}: parameter bytes "
              f"{r['param_bytes']} (laid out in {r['lay_ms']:.1f} ms, "
              f"{r['digests_equal']}/{r['n_tensors']} block digests equal "
              f"the global tensors' slices); peak memory after the lay-out "
              f"{r['peak_after_lay']} B, after the engine "
              f"{r['peak_after_engine']} B; card used by all processes "
              f"{r['card_used']} B ({card})", flush=True)
    sp = r0["step_split"]
    print(f"[13] one sharded decode step of phase 5e's batch "
          f"{job['toks'].shape}: largest |logit - float32 witness| by rank "
          f"{[round(r['e_step'], 6) for r in ranks]} (meshless bf16 "
          f"{e_ref:.6f}; limit twice it); greedy ids {r0['greedy']} on "
          f"every rank (meshless bf16 {r0['greedy_meshless']}); ms a step "
          f"(events) {[round(r['step_ms'], 4) for r in ranks]}; rank 0 "
          f"traced: wall {sp['wall_ms']:.4f} untraced, "
          f"{sp['traced_wall_ms']:.4f} traced = collectives with the "
          f"device idle {sp['collective_idle_ms']} + device busy "
          f"{sp['device_busy_ms']} + host {sp['host_ms']}; collectives "
          f"{sp['collectives']} calls, {sp['collective_bytes']} B, "
          f"{sp['collective_ms']} ms on the host; idle share "
          f"{sp['idle_share']} ({card})", flush=True)
    print(f"[13] Engine(mesh=...) on phase 5e's 8 requests, every rank: "
          f"latencies, stalls {r0['engine']['stalls']}, preemptions "
          f"{r0['engine']['preemptions']}, retries "
          f"{r0['engine']['retries']}, tokens out "
          f"{r0['engine']['tokens_out']} and the pool's chains equal phase "
          f"5e's; ids equal on every rank; {ids_equal}/8 sequences and "
          f"{tok_equal}/{r0['engine']['tokens_out']} ids equal phase 5e's, "
          f"the rest witnessed at their first differing id "
          f"(sequence, position, mesh id, phase 5e's id, |mesh - float32|,"
          f" |meshless bf16 - float32|) {witness}; "
          f"{r0['engine']['tokens_out'] / r0['engine_wall_s']:.2f} tokens/s "
          f"({r0['engine_wall_s']:.3f} s); ms a decode step (events, "
          f"{len(steps)} over the ranks) mean {np.mean(steps):.4f}, median "
          f"{np.median(steps):.4f}, min {np.min(steps):.4f}; launches on "
          f"path model_mesh by rank (B1, B2, F, W): "
          + "; ".join(f"{r['rank']} "
                      f"{[r['launches'][k] for k in SHARDED_KERNELS]}"
                      for r in ranks) + f" ({card})", flush=True)
    rl = [r for r in ranks if r["relay"] is not None]
    print(f"[13] a rank lost: elastic.remesh(ranks=[0, 1], model_parallel="
          f"2) -> {rl[0]['relay']['shape']}, reshard of the host tree: "
          + "; ".join(f"rank {r['rank']} {r['relay']['param_bytes']} B in "
                      f"{r['relay']['lay_ms']:.1f} ms, peak "
                      f"{r['relay']['peak']} B, step "
                      f"{r['relay']['step_ms']:.4f} ms, |logit - witness| "
                      f"{r['relay']['e_step']:.6f}, "
                      f"greedy {r['relay']['greedy']}" for r in rl)
          + f"; scale_microbatch(8, 4, 2, 1) = {r0['scale_microbatch']} "
          f"({card})", flush=True)
    print(f"[13] GPipe over the pod axis: {MESH_RANKS} stages of "
          f"{job['cfg16'].n_layers // MESH_RANKS} blocks "
          f"({r0['pipe_stage_bytes']} B a rank), "
          f"bf16 {PIPE_SHAPE[0]}x{PIPE_SHAPE[1]} in {PIPE_MB} microbatches: "
          f"{[round(r['pipe_ms'], 3) for r in ranks]} ms a call, bubble "
          f"{(MESH_RANKS - 1) / (MESH_RANKS - 1 + PIPE_MB):.4f}; "
          f"|out - float32 layers| {r0['e_pipe']:.6f} (meshless bf16 "
          f"{job['e_pipe']:.6f}); peak {r0['pipe_peak']} B ({card})",
          flush=True)
    return {k: {f"rank{r['rank']}": r["launches"][k] for r in ranks}
            for k in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 14: the other model families on a mesh
# ---------------------------------------------------------------------------

FAMILY_DIR = "mesh14"         # phase 14: phi's host weights, under build/
PHI_LAYERS = 8                # phase 14: phi3.5-moe's depth (of 32)
FAMILY_ARCHS = ("zamba2-7b", "whisper-large-v3", "paligemma-3b")
FAMILY_PROMPT = (2, 2)        # phase 14: their prefill's batch x prompt
PHI22_PROMPT = 2              # phase 14: phi's 2 x 2 decode, the last ids


def family_configs():
    """Phase 14's models, bf16 parameters from seed 0: phi3.5-moe at
    full width with its depth cut to ``PHI_LAYERS``, and zamba2-7b,
    whisper-large-v3 and paligemma-3b at full width and depth."""
    import dataclasses

    from repro_torch.configs import registry
    phi = dataclasses.replace(registry.get("phi3.5-moe-42b-a6.6b"),
                              n_layers=PHI_LAYERS, param_dtype="bfloat16")
    return phi, {a: dataclasses.replace(registry.get(a),
                                        param_dtype="bfloat16")
                 for a in FAMILY_ARCHS}


def family_frontend(cfg, batch: int):
    """The seeded stub frontend of whisper (frames) or paligemma
    (patches), at the embedding's scale, or ``None``."""
    n = {"encdec": cfg.enc_positions, "vlm": cfg.img_tokens}.get(cfg.family)
    if n is None:
        return None
    return (0.02 * np.random.default_rng(1).standard_normal(
        (batch, n, cfg.d_model))).astype(np.float32)


class Routes:
    """Within it, the top-k experts of every MoE layer a pass computes
    (``moe.route``), in order, on the host: ``self.top_e``."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.mod, self.route, self.top_e = moe_mod, moe_mod.route, []

        def rec(*a, **kw):
            plan = self.route(*a, **kw)
            self.top_e.append(plan.top_e.cpu())
            return plan
        moe_mod.route = rec
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route


def expert_sets_differ(a, b) -> int:
    """Tokens (layer x row x position) whose set of experts differs
    between two runs' :class:`Routes`."""
    import torch
    x = torch.stack(a).sort(-1).values
    y = torch.stack(b).sort(-1).values
    return int((x != y).any(-1).sum())


def _decode_last(torch, params, cfg, toks, dev, mesh=None, rules=None,
                 rows=slice(None)):
    """Prefill ``toks[:, :-1]`` through the decode cell, then one decode
    step on the last ids, on this rank's ``rows``: ``(logits, cache, last
    ids)``, the step's routes recorded."""
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serve import serve_step as ss
    B, L = toks.shape
    cache = zoo.init_cache(cfg, B, 16, dev, mesh=mesh, rules=rules)
    _, c, _ = ss.prefill_loop(ss.make_decode_step(cfg), params,
                              toks[rows, :-1], cache)
    last = torch.as_tensor(toks[rows, -1:], device=dev)
    with Routes() as r:
        logits, _ = zoo.decode_step(params, cfg, last, c, L - 1)
    return logits, c, last, r.top_e


def family_job(torch, dev, phi, others, card) -> dict:
    """Phase 14's inputs.  phi3.5-moe: the bf16 weights built on the
    card from seed 0, its meshless engine on 8 requests (the mesh
    engine's reference), a left-padded batch of 4's meshless bf16
    decode step and its float32 witness (with each step's experts), and
    the weights written as a host flat tree under ``build/mesh14`` with
    each rank's block digests on the 1 x 4 mesh.  Each of ``others``:
    a short prompt's prefill (``forward``) and decode step, meshless in
    bf16 and in float32 on the same weights."""
    import dataclasses
    import shutil

    from repro_torch.core import workload as wl
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.engine import Engine, Request
    torch.set_grad_enabled(False)
    t = time.perf_counter()
    params = zoo.build_params(phi, seed=0, device=dev)
    arr = wl.poisson_zipf_arrivals(8, float("inf"), phi.vocab,
                                   prompt_len=(2, 7), max_new=8, seed=0)
    eng = Engine(phi, params, max_batch=4, max_seq=128, device_index=True,
                 index_width=1024, device=dev)
    for i in range(len(arr.seq_ids)):
        n_i = int(arr.prompt_lens[i])
        eng.submit(Request(seq_id=int(arr.seq_ids[i]),
                           prompt=arr.prompts[i, :n_i].copy(),
                           max_new=int(arr.max_new[i]),
                           arrival=int(arr.arrival[i])))
    torch.cuda.synchronize(dev)
    t_eng = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize(dev)
    eng_s = time.perf_counter() - t_eng
    toks = left_pad(arr.prompts[:4], arr.prompt_lens[:4])
    phi32 = dataclasses.replace(phi, dtype="float32")
    l16, _, _, r16 = _decode_last(torch, params, phi, toks, dev)
    l32, _, _, r32 = _decode_last(torch, params, phi32, toks, dev)
    l16, l32 = l16[:, 0].float().cpu(), l32[:, 0].float().cpu()
    # the 2 x 2 mesh's decode (fsdp gathers every weight over gloo each
    # step) from the batch's last PHI22_PROMPT ids, with its own witness
    t22 = toks[:, -PHI22_PROMPT:]
    w16, w32 = (_decode_last(torch, params, c, t22, dev)[0][:, 0]
                .float().cpu() for c in (phi, phi32))
    job = dict(card=card, phi=phi, others=others, toks=toks,
               l16=l16.numpy(), l32=l32.numpy(),
               e_step=float((l16 - l32).abs().max()), routes32=r32,
               toks22=t22, l32_22=w32.numpy(),
               e_step22=float((w16 - w32).abs().max()),
               routes_differ=expert_sets_differ(r16, r32),
               engine=dict(ids=res, latencies=dict(eng.latencies),
                           stalls=eng.stalls, preemptions=eng.preemptions,
                           retries=eng.degraded_retries,
                           tokens_out=eng.tokens_out,
                           chains=dict(eng.pool.chains)),
               engine_tok_s=eng.tokens_out / eng_s)
    del eng
    # the host flat tree and each rank's block digests on 1 x 4
    d = HERE / "build" / FAMILY_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    need = sum(v.numel() * v.element_size() for v in params.values())
    free_disk = shutil.disk_usage(d).free
    check(free_disk > need + 2**30, f"phase 14 needs {need} B of disk under "
          f"build/ for phi's host weights, {free_disk} B are free")
    _, axes = zoo.param_axes(phi)
    sizes = {"data": 1, "model": MESH_RANKS}
    specs = ly.axes_to_specs(params, axes, shd.AbstractMesh(sizes),
                             shd.default_rules())
    t_w = time.perf_counter()
    files, digests = write_host_tree(torch, params, specs, sizes, d)
    job.update(files=files, digests=digests, nbytes=need,
               write_s=time.perf_counter() - t_w)
    del params
    torch.cuda.empty_cache()
    # the other families: meshless bf16 and the float32 witness
    job["ref"] = {}
    for arch, cfg in others.items():
        p = zoo.build_params(cfg, seed=0, device=dev)
        ptoks = np.random.default_rng(2).integers(
            0, cfg.vocab, FAMILY_PROMPT).astype(np.int32)
        fr = family_frontend(cfg, FAMILY_PROMPT[0])
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        ref = {"toks": ptoks, "nbytes": sum(
            v.numel() * v.element_size() for v in _leaves(p))}
        for tag, c in (("16", cfg), ("32", cfg32)):
            f = None if fr is None else torch.as_tensor(fr, device=dev)
            ref["f" + tag] = zoo.forward(
                p, c, torch.as_tensor(ptoks, device=dev),
                frontend=f)[:, -1].float().cpu()
            ref["d" + tag] = _decode_last(torch, p, c, ptoks, dev)[0][
                :, 0].float().cpu()
        ref["e_fwd"] = float((ref["f16"] - ref["f32"]).abs().max())
        ref["e_step"] = float((ref["d16"] - ref["d32"]).abs().max())
        job["ref"][arch] = ref
        del p
        torch.cuda.empty_cache()
    print(f"[14] phi3.5-moe ({PHI_LAYERS} of 32 layers, full width, bf16): "
          f"meshless engine {job['engine_tok_s']:.2f} tokens/s; host "
          f"weights written in {job['write_s']:.1f} s ({need} B, "
          f"{len(files)} files under build/{FAMILY_DIR}); meshless bf16 "
          f"step vs the float32 witness: max |logit diff| "
          f"{job['e_step']:.4e}, {job['routes_differ']} tokens x layers "
          f"routed to other experts; "
          + "; ".join(f"{a} prefill {r['e_fwd']:.4e}, step "
                      f"{r['e_step']:.4e}" for a, r in job["ref"].items())
          + f"; {time.perf_counter() - t:.1f} s ({card})", flush=True)
    return job


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _whole_rows(torch, block, tree, cfg, mesh, rules, batch_size):
    """A laid-out tree's logits block ``[B_rank, V/S]`` of a batch of
    ``batch_size`` gathered whole over the batch and vocab axes (a
    collective)."""
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    batch = shd.resolve_spec((batch_size,), ("batch",), mesh, rules)
    spec = ((batch[0] if batch else None),) + (None,) * (block.dim() - 2) \
        + (zoo.vocab_axes(tree, cfg) or None,)
    return shd.relayout(block, spec, (), mesh)


def family_rank(mesh, job) -> dict:
    """Phase 14 on one rank: phi3.5-moe laid out over the 1 x 4 mesh
    (``elastic.reshard`` of the host tree), its blocks' digests, one
    sharded decode step under the float32 witness (its collectives from
    a trace, its experts against the witness's), ``Engine(mesh=...)`` on
    the 8 requests (launches on path ``model_mesh_moe``); phi on the
    2 x 2 (data, model) mesh, fsdp over data and this rank's 2 rows, one
    decode step; then each other family built on the card in turn
    (one rank at a time), laid out, a prefill and a decode step."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.core import workload as wl
    from repro_torch.train import elastic
    from torch.profiler import ProfilerActivity, profile
    torch.set_grad_enabled(False)
    dev = mesh.device
    me = mesh.index
    phi = job["phi"]
    rules = shd.default_rules()
    host = {k: torch.load(f, mmap=True, weights_only=True)
            for k, f in job["files"].items()}
    _, axes = zoo.param_axes(phi)
    out = {"rank": me, "device": str(dev), "part_s": {}}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        out["part_s"][name] = round(now - t_part[0], 1)
        t_part[0] = now
    l32 = torch.as_tensor(job["l32"])
    toks = job["toks"]

    def lay(m):
        specs = ly.axes_to_specs(host, axes, m, rules)
        return shd.LaidOutTree(elastic.reshard(host, specs, m), specs, m,
                               rules)

    def sync_ms(t0):
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0)

    # -- 1. phi over 1 x 4 ---------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tree = lay(mesh)
    out["lay_ms"] = sync_ms(t0)
    out["param_bytes"] = sum(v.numel() * v.element_size()
                             for v in tree.values())
    out["digests_equal"] = sum(
        _digest(v.cpu()) == job["digests"][me][k] for k, v in tree.items())
    out["n_tensors"] = len(tree)
    out["w_gate_spec"] = tree.specs["w_gate"]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cache = zoo.init_cache(phi, toks.shape[0], 16, dev, mesh=mesh,
                           rules=rules)
    _, c, _ = ss.prefill_loop(ss.make_decode_step(phi), tree, toks[:, :-1],
                              cache)
    last = torch.as_tensor(toks[:, -1:], device=dev)
    e0.record()
    with Routes() as r:
        logits, _ = zoo.decode_step(tree, phi, last, c, toks.shape[1] - 1)
    e1.record()
    whole = _whole_logits(torch, logits[:, 0], tree, phi).float().cpu()
    tok = ss.greedy(logits[:, 0], tree, phi)
    torch.cuda.synchronize(dev)
    out["step_ms"] = e0.elapsed_time(e1)
    out["e_step"] = float((whole - l32).abs().max())
    out["routes_differ"] = expert_sets_differ(r.top_e, job["routes32"])
    out["greedy"] = tok.tolist()
    out["greedy_equal_on_ranks"] = bool((cl.all_gather(tok, mesh)
                                         == tok).all())
    t0 = time.perf_counter()
    zoo.decode_step(tree, phi, last, c, toks.shape[1] - 1)
    wall = sync_ms(t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        zoo.decode_step(tree, phi, last, c, toks.shape[1] - 1)
        traced = sync_ms(t0)
    out["step_split"] = dict(collective_split(prof, mesh.backend, 1, traced),
                             wall_ms=wall, traced_wall_ms=traced)
    del c, cache
    out["peak_after_lay"] = torch.cuda.max_memory_allocated(dev)

    part("phi 1x4 step")
    # -- 2. Engine(mesh=...) on the 8 requests -------------------------------
    arr = wl.poisson_zipf_arrivals(8, float("inf"), phi.vocab,
                                   prompt_len=(2, 7), max_new=8, seed=0)
    eng = Engine(phi, tree, max_batch=4, max_seq=128, device_index=True,
                 index_width=1024, mesh=mesh, device=dev)
    events, padded = [], {}
    decode, pad = eng._decode, eng._pad_prompts

    def recorded_pad(reqs):
        rows = pad(reqs)
        padded.update({q.seq_id: row for q, row in zip(reqs, rows)})
        return rows

    def timed_decode(*a):
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0.record()
        res = decode(*a)
        s1.record()
        events.append((s0, s1))
        return res
    eng._decode, eng._pad_prompts = timed_decode, recorded_pad
    for i in range(len(arr.seq_ids)):
        n_i = int(arr.prompt_lens[i])
        eng.submit(Request(seq_id=int(arr.seq_ids[i]),
                           prompt=arr.prompts[i, :n_i].copy(),
                           max_new=int(arr.max_new[i]),
                           arrival=int(arr.arrival[i])))
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize(dev)
    out["engine_wall_s"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    out["engine_step_ms"] = [a.elapsed_time(b) for a, b in events]
    out["engine"] = dict(ids=res, latencies=dict(eng.latencies),
                         stalls=eng.stalls, preemptions=eng.preemptions,
                         retries=eng.degraded_retries,
                         tokens_out=eng.tokens_out,
                         chains=dict(eng.pool.chains))
    out["peak_after_engine"] = torch.cuda.max_memory_allocated(dev)
    witnessed = []
    for s, ids in sorted(res.items()):
        ref = job["engine"]["ids"][s]
        if ids == ref:
            continue
        p = next(j for j in range(len(ids)) if ids[j] != ref[j])
        hist = np.concatenate([padded[s], np.asarray(ref[:p], np.int32)])
        witnessed.append(dict(seq=s, pos=p, mesh_id=ids[p], ref_id=ref[p],
                              hist=hist, logits=_history_logits(
                                  torch, tree, phi, hist).numpy()))
    out["witnessed"] = witnessed
    del eng, tree, pad, decode, recorded_pad, timed_decode
    torch.cuda.empty_cache()

    part("phi engine")
    # -- 3. phi on 2 x 2: fsdp over data, the batch's rows over it -----------
    torch.cuda.reset_peak_memory_stats(dev)
    m22 = elastic.remesh(model_parallel=2, device=dev)
    t0 = time.perf_counter()
    tree = lay(m22)
    lay_ms = sync_ms(t0)
    rows = shd.block_slices((toks.shape[0],), shd.resolve_spec(
        (toks.shape[0],), ("batch",), m22, rules), m22)[0]
    t22 = job["toks22"]
    # _decode_last's prefill and step, the step timed (each step gathers
    # every weight over data: one is all the path needs)
    c = zoo.init_cache(phi, t22.shape[0], 16, dev, mesh=m22, rules=rules)
    _, c, _ = ss.prefill_loop(ss.make_decode_step(phi), tree,
                              t22[rows, :-1], c)
    e0.record()
    logits, _ = zoo.decode_step(tree, phi, torch.as_tensor(
        t22[rows, -1:], device=dev), c, t22.shape[1] - 1)
    e1.record()
    torch.cuda.synchronize(dev)
    whole = _whole_rows(torch, logits[:, 0], tree, phi, m22, rules,
                        t22.shape[0]).float().cpu()
    out["mesh22"] = dict(
        shape=dict(m22.shape), coords=dict(m22.coords), rows=(rows.start,
                                                              rows.stop),
        lay_ms=lay_ms, param_bytes=sum(v.numel() * v.element_size()
                                       for v in tree.values()),
        e_step=float((whole - torch.as_tensor(job["l32_22"])).abs().max()),
        step_ms=e0.elapsed_time(e1), peak=torch.cuda.max_memory_allocated(dev))
    del tree, host, c
    torch.cuda.empty_cache()

    part("phi 2x2")
    # -- 4. the other families on 1 x 4 -------------------------------------
    out["others"] = {}
    for arch, cfg in job["others"].items():
        ref = job["ref"][arch]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _, ax = zoo.param_axes(cfg)
        for turn in range(mesh.size):      # one global copy at a time
            if turn == me:
                g = zoo.build_params(cfg, seed=0, device=dev)
                specs = ly.axes_to_specs(g, ax, mesh, rules)
                tree = shd.lay_out(g, specs, mesh, rules)
                del g
                torch.cuda.empty_cache()
            dist.barrier()
        lay_ms = sync_ms(t0)
        ptoks = ref["toks"]
        fr = family_frontend(cfg, FAMILY_PROMPT[0])
        t0 = time.perf_counter()
        f = zoo.forward(tree, cfg, torch.as_tensor(ptoks, device=dev),
                        frontend=None if fr is None else torch.as_tensor(
                            fr, device=dev))[:, -1]
        fwd_ms = sync_ms(t0)
        f = _whole_logits(torch, f, tree, cfg).float().cpu()
        logits, c, last, _ = _decode_last(torch, tree, cfg, ptoks, dev,
                                          mesh, rules)
        d = _whole_logits(torch, logits[:, 0], tree, cfg).float().cpu()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            zoo.decode_step(tree, cfg, last, c, ptoks.shape[1] - 1)
            traced = sync_ms(t0)
        out["others"][arch] = dict(
            lay_ms=lay_ms, fwd_ms=fwd_ms,
            param_bytes=sum(v.numel() * v.element_size()
                            for v in _leaves(tree)),
            e_fwd=float((f - ref["f32"]).abs().max()),
            e_step=float((d - ref["d32"]).abs().max()),
            step_split=collective_split(prof, mesh.backend, 1, traced),
            step_ms=traced, peak=torch.cuda.max_memory_allocated(dev),
            cache_shapes={k: tuple(v.shape) for k, v in c.items()})
        del tree, c
        torch.cuda.empty_cache()
        part(arch)
    return out


def family_phase(torch, dev, job, backend: str) -> dict:
    """Phase 14: :func:`family_rank` on ``MESH_RANKS`` ranks (gloo: every
    rank on ``cuda:0``; nccl: one card a rank), then the float32 witness
    of each engine sequence that differs from the meshless engine's.
    Checks and prints each rank's readings beside the card's name and
    power limit; removes the host weights; returns each kernel's
    launches by rank on path ``model_mesh_moe``."""
    import gc
    import shutil

    from repro_torch.launch import spmd
    card = job["card"]
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[14] starting {MESH_RANKS} {backend} ranks; this process: "
          f"{host_memory()}; card free {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB ({card})", flush=True)
    t = time.perf_counter()
    try:
        ranks = spmd.spawn(family_rank, MESH_RANKS, job, backend=backend,
                           device="cuda", timeout=1200)
        wall = time.perf_counter() - t
        witness = engine_witness(torch, dev, job, ranks[0]["witnessed"],
                                 job["phi"], "phase 14")
    except RuntimeError as e:
        fail(f"phase 14: {e}")
    finally:
        shutil.rmtree(HERE / "build" / FAMILY_DIR, ignore_errors=True)
    e_ref, eng_ref = job["e_step"], job["engine"]
    for r in ranks:
        me = f"phase 14 rank {r['rank']}"
        check(r["digests_equal"] == r["n_tensors"],
              f"{me}: {r['n_tensors'] - r['digests_equal']} phi blocks "
              f"differ from the global tensors' slices")
        check(r["e_step"] <= 2 * e_ref, f"{me}: phi's sharded step lies "
              f"{r['e_step']:.4e} from the float32 witness, more than twice "
              f"the meshless bf16 step's {e_ref:.4e}")
        check(r["mesh22"]["e_step"] <= 2 * job["e_step22"], f"{me}: phi's "
              f"2 x 2 step lies {r['mesh22']['e_step']:.4e} from the "
              f"witness, more than twice {job['e_step22']:.4e}")
        check(r["greedy_equal_on_ranks"], f"{me}: greedy ids differ "
              f"between the ranks")
        for k in ("latencies", "stalls", "preemptions", "retries",
                  "tokens_out", "chains"):
            check(r["engine"][k] == eng_ref[k], f"{me}: the mesh engine's "
                  f"{k} differ from the meshless engine's: "
                  f"{r['engine'][k]} != {eng_ref[k]}")
        check(r["engine"]["ids"] == ranks[0]["engine"]["ids"],
              f"{me}: generated ids differ from rank 0's")
        n = r["launches"]
        check(n["splay_search_tiered"] + n["splay_search_pipelined"] > 0
              and n["splay_fold"] > 0 and n["splay_walk"] > 0,
              f"{me}: a kernel of the model_mesh_moe path never launched: "
              f"{n}")
        for arch, o in r["others"].items():
            ref = job["ref"][arch]
            check(o["e_fwd"] <= 2 * ref["e_fwd"], f"{me}: {arch}'s sharded "
                  f"prefill lies {o['e_fwd']:.4e} from the float32 witness,"
                  f" more than twice the meshless bf16's {ref['e_fwd']:.4e}")
            check(o["e_step"] <= 2 * ref["e_step"], f"{me}: {arch}'s "
                  f"sharded step lies {o['e_step']:.4e} from the float32 "
                  f"witness, more than twice the meshless bf16's "
                  f"{ref['e_step']:.4e}")
    r0 = ranks[0]
    phi = job["phi"]
    ids_equal = sum(r0["engine"]["ids"][s] == eng_ref["ids"][s]
                    for s in eng_ref["ids"])
    steps = np.concatenate([r["engine_step_ms"] for r in ranks])
    sp = r0["step_split"]
    print(f"[14] phi3.5-moe ({phi.n_layers} layers, d {phi.d_model}, "
          f"{phi.n_experts} experts top-{phi.top_k}, bf16) on a 1 x "
          f"{MESH_RANKS} mesh ({backend}, {r0['device']}): w_gate "
          f"{r0['w_gate_spec']}; "
          + "; ".join(f"rank {r['rank']} {r['param_bytes']} B (laid out in "
                      f"{r['lay_ms']:.1f} ms, {r['digests_equal']}/"
                      f"{r['n_tensors']} digests equal), peak "
                      f"{r['peak_after_lay']} B" for r in ranks)
          + f" ({card})", flush=True)
    print(f"[14] one sharded decode step of a left-padded batch "
          f"{job['toks'].shape}: |logit - float32 witness| by rank "
          f"{[round(r['e_step'], 6) for r in ranks]} (meshless bf16 "
          f"{e_ref:.6f}; limit twice it); tokens x layers routed to other "
          f"experts than the witness's: mesh {r0['routes_differ']}, "
          f"meshless bf16 {job['routes_differ']}; greedy ids "
          f"{r0['greedy']} on every rank; ms a step (events) "
          f"{[round(r['step_ms'], 4) for r in ranks]}; rank 0 traced: "
          f"wall {sp['wall_ms']:.4f} untraced, {sp['traced_wall_ms']:.4f} "
          f"traced = collectives with the device idle "
          f"{sp['collective_idle_ms']} + device busy {sp['device_busy_ms']}"
          f" + host {sp['host_ms']}; collectives {sp['collectives']} calls,"
          f" {sp['collective_bytes']} B, {sp['collective_ms']} ms on the "
          f"host; idle share {sp['idle_share']} ({card})", flush=True)
    print(f"[14] Engine(mesh=...) on 8 requests over phi's vocab, every "
          f"rank: latencies, stalls {r0['engine']['stalls']}, preemptions "
          f"{r0['engine']['preemptions']}, retries {r0['engine']['retries']}"
          f", tokens out {r0['engine']['tokens_out']} and the pool's chains "
          f"equal the meshless engine's; ids equal on every rank; "
          f"{ids_equal}/8 sequences equal the meshless engine's, the rest "
          f"witnessed at their first differing id (sequence, position, "
          f"mesh id, meshless id, |mesh - float32|, |meshless bf16 - "
          f"float32|) {witness}; "
          f"{r0['engine']['tokens_out'] / r0['engine_wall_s']:.2f} tokens/s "
          f"({r0['engine_wall_s']:.3f} s; meshless "
          f"{job['engine_tok_s']:.2f}); ms a decode step (events, "
          f"{len(steps)} over the ranks) mean {np.mean(steps):.4f}, median "
          f"{np.median(steps):.4f}, min {np.min(steps):.4f}; launches on "
          f"path model_mesh_moe by rank (B1, B2, F, W): "
          + "; ".join(f"{r['rank']} "
                      f"{[r['launches'][k] for k in SHARDED_KERNELS]}"
                      for r in ranks) + f" ({card})", flush=True)
    print(f"[14] seconds by part, rank 0: {ranks[0]['part_s']} ({card})",
          flush=True)
    print(f"[14] phi on the 2 x 2 (data, model) mesh, fsdp over data, the "
          f"batch's last {PHI22_PROMPT} ids (meshless bf16 "
          f"{job['e_step22']:.6f} from its witness; limit twice it): "
          + "; ".join(f"rank {r['rank']} {r['mesh22']['coords']} rows "
                      f"{r['mesh22']['rows']} {r['mesh22']['param_bytes']} B"
                      f" in {r['mesh22']['lay_ms']:.1f} ms, peak "
                      f"{r['mesh22']['peak']} B, a step "
                      f"{r['mesh22']['step_ms']:.2f} ms, |logit - witness| "
                      f"{r['mesh22']['e_step']:.6f}" for r in ranks)
          + f" ({card})", flush=True)
    for arch in job["others"]:
        ref = job["ref"][arch]
        o0 = r0["others"][arch]
        osp = o0["step_split"]
        print(f"[14] {arch} (bf16, 1 x {MESH_RANKS}): "
              + "; ".join(f"rank {r['rank']} {r['others'][arch]['param_bytes']}"
                          f" B (built and laid out in "
                          f"{r['others'][arch]['lay_ms']:.1f} ms, peak "
                          f"{r['others'][arch]['peak']} B), |prefill - "
                          f"witness| {r['others'][arch]['e_fwd']:.6f}, "
                          f"|step - witness| "
                          f"{r['others'][arch]['e_step']:.6f}"
                          for r in ranks)
              + f" (meshless bf16: prefill {ref['e_fwd']:.6f}, step "
              f"{ref['e_step']:.6f}; limit twice); prefill of "
              f"{FAMILY_PROMPT} {o0['fwd_ms']:.2f} ms; a traced decode "
              f"step {o0['step_ms']:.2f} ms, {osp['collectives']} "
              f"collectives ({osp['collective_bytes']} B, "
              f"{osp['collective_ms']} ms on the host), idle share "
              f"{osp['idle_share']}; cache blocks {o0['cache_shapes']} "
              f"({card})", flush=True)
    print(f"[14] phase 14: {wall:.1f} s for the ranks ({card})", flush=True)
    return {k: {f"rank{r['rank']}": r["launches"][k] for r in ranks}
            for k in r0["launches"]}


SEQ_RANKS = 4             # phase 16: ranks of the sequence layouts' meshes
SEQ_BW_BYTES = 256 * 2**20     # phase 16 (nccl): a collective's buffer


SEQ_ARCH = "qwen2-0.5b"       # phase 16: 1 x 4, cp_seq + cp_q, then kvseq
SEQ_PREFILL = (2, 4096)       # phase 16: its prefill's batch x positions
SEQ_CACHE, SEQ_FILL = 8192, 4095   # its cache; positions the meshless fills
SEQ_HYBRID = "zamba2-7b"      # phase 16: 2 x 2, seq/kvseq over data
SEQ_HCACHE, SEQ_HFILL = 32768, 16383
SEQ_DRY = (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
           ("qwen2-0.5b", "decode_32k"), ("zamba2-7b", "long_500k"))


def seq_configs():
    """Phase 16's models at published widths and depth, bf16 weights
    (and compute) from seed 0."""
    import dataclasses

    from repro_torch.configs import registry
    return {a: dataclasses.replace(registry.get(a), param_dtype="bfloat16")
            for a in (SEQ_ARCH, SEQ_HYBRID)}


def fill_cache(torch, params, cfg, toks, cache):
    """The decode cache of ``toks`` ``[B, L]`` written in bulk: the
    meshless prefill's roped k and v of every layer at positions
    ``0 .. L`` (the port's own ``_attn_block``, as ``forward`` runs
    it)."""
    from repro_torch.models import model_zoo as zoo
    cdt = zoo._dt(cfg)
    n = toks.shape[1]
    x = zoo.embed_tokens(params, cfg, toks, cdt)
    layers = zoo._unstack(params, zoo._layer_keys(params, cfg))
    for i, lp in enumerate(layers):
        a, (k, v) = zoo._attn_block(x, lp, cfg, "causal", 0, cdt)
        cache["k"][i, :, :n] = k.to(cache["k"].dtype)
        cache["v"][i, :, :n] = v.to(cache["v"].dtype)
        x = x + a
        x = x + zoo._mlp_block(x, lp, cfg, cdt)
    return cache


def hybrid_cache(torch, cfg, dev):
    """zamba2's decode cache for phase 16 in ``cfg``'s dtype: zeros, the
    shared block's k/v seeded N(0, 1) rounded to bf16 at positions
    ``0 .. SEQ_HFILL`` (a stand-in history that fills the first block
    of the positions' split), on ``dev``."""
    from repro_torch.models import model_zoo as zoo
    cache = zoo.init_cache(cfg, 1, SEQ_HCACHE, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    for k in ("k", "v"):
        shape = cache[k][:, :, :SEQ_HFILL].shape
        cache[k][:, :, :SEQ_HFILL] = torch.randn(
            shape, generator=g, device=dev).to(torch.bfloat16)
    return cache


def _decode_chain(torch, params, cfg, toks, cache, start, n_steps):
    """``n_steps`` meshless decode steps from ``cache`` filled to
    ``start``: each step's logits (float, on the host) and greedy ids."""
    from repro_torch.models import model_zoo as zoo
    logits, ids = [], []
    for j in range(n_steps):
        out, cache = zoo.decode_step(params, cfg, toks[:, j:j + 1], cache,
                                     start + j)
        logits.append(out[:, 0].float().cpu())
        ids.append(out[:, 0].argmax(-1).cpu())
        del out
    return logits, ids


def seq_job(torch, dev, card) -> dict:
    """Phase 16's inputs, meshless on the card.  qwen2-0.5b: its
    ``SEQ_PREFILL`` prompt's last-position logits in bf16 and the
    float32 witness (the same bf16 weights computed in float32), its
    cache of ``SEQ_CACHE`` filled to ``SEQ_FILL`` in bulk, and three
    decode steps from it in bf16 and in float32.  zamba2-7b: two decode
    steps of one sequence from :func:`hybrid_cache`, in bf16 and in
    float32.  Returns the references and the bf16 cache (on the
    host)."""
    import dataclasses

    from repro_torch.models import model_zoo as zoo
    torch.set_grad_enabled(False)
    t = time.perf_counter()
    cfgs = seq_configs()
    job = {"card": card, "cfgs": cfgs}
    cfg = cfgs[SEQ_ARCH]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = zoo.build_params(cfg, seed=0, device=dev)
    job["param_sum"] = _bits_sum(p["embed"])
    rng = np.random.default_rng(16)
    toks = rng.integers(0, cfg.vocab, SEQ_PREFILL).astype(np.int64)
    dtoks = rng.integers(0, cfg.vocab, (SEQ_PREFILL[0], SEQ_FILL + 3)
                         ).astype(np.int64)
    job.update(toks=toks, dtoks=dtoks)
    tt = torch.as_tensor(toks, device=dev)
    ref = {}
    for tag, c in (("16", cfg), ("32", cfg32)):
        ref["f" + tag] = zoo.forward(p, c, tt)[:, -1].float().cpu()
    ref["e_fwd"] = float((ref["f16"] - ref["f32"]).abs().max())
    ref["ids_fwd"] = ref["f16"].argmax(-1)
    dt = torch.as_tensor(dtoks, device=dev)
    for tag, c in (("16", cfg), ("32", cfg32)):
        cache = fill_cache(torch, p, c, dt[:, :SEQ_FILL], zoo.init_cache(
            c, SEQ_PREFILL[0], SEQ_CACHE, dev))
        if tag == "16":
            job["cache"] = {k: v.cpu() for k, v in cache.items()}
        ref["d" + tag], ref["ids" + tag] = _decode_chain(
            torch, p, c, dt[:, SEQ_FILL:], cache, SEQ_FILL, 3)
        del cache
    ref["e_dec"] = [float((a - b).abs().max())
                    for a, b in zip(ref["d16"], ref["d32"])]
    job["ref"] = ref
    del p
    torch.cuda.empty_cache()
    # zamba2-7b, batch 1
    hcfg = cfgs[SEQ_HYBRID]
    h32 = dataclasses.replace(hcfg, dtype="float32")
    p = zoo.build_params(hcfg, seed=0, device=dev)
    job["h_param_sum"] = _bits_sum(p["embed"])
    htoks = rng.integers(0, hcfg.vocab, (1, 2)).astype(np.int64)
    job["htoks"] = htoks
    ht = torch.as_tensor(htoks, device=dev)
    href = {}
    for tag, c in (("16", hcfg), ("32", h32)):
        href["d" + tag], href["ids" + tag] = _decode_chain(
            torch, p, c, ht, hybrid_cache(torch, c, dev), SEQ_HFILL, 2)
        torch.cuda.empty_cache()
    href["e_dec"] = [float((a - b).abs().max())
                     for a, b in zip(href["d16"], href["d32"])]
    job["href"] = href
    del p
    torch.cuda.empty_cache()
    print(f"[16] meshless references: {SEQ_ARCH} prefill {SEQ_PREFILL} "
          f"|bf16 - float32| {ref['e_fwd']:.4e}, decode steps from a cache "
          f"of {SEQ_CACHE} filled to {SEQ_FILL} "
          f"{[round(e, 6) for e in ref['e_dec']]}; {SEQ_HYBRID} two steps "
          f"from a shared cache of {SEQ_HCACHE} filled to {SEQ_HFILL} "
          f"{[round(e, 6) for e in href['e_dec']]}; "
          f"{time.perf_counter() - t:.1f} s ({card})", flush=True)
    return job


def _bits_sum(t) -> int:
    """The sum of a 16-bit tensor's bit patterns, exact in any order: a
    cheap check that two processes drew the same weights."""
    import torch
    return int(t.view(torch.int16).to(torch.int64).sum())


def _one_at_a_time(torch, fn):
    """``fn()`` on each rank in turn (a barrier between): the ranks that
    build a whole model on the one card do not hold it at once."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _seq16(mesh, m22, job, out) -> None:
    """Phase 16 on one rank of 4 (gloo, every rank on the card).
    qwen2-0.5b on the 1 x 4 world mesh under ``cell_rules`` of a
    prefill of ``SEQ_PREFILL`` (``cp_seq`` + ``cp_q``): the prefill's
    last-position logits and greedy ids (``make_prefill``), its
    collectives recorded; then under the decode rules (``kvseq`` over
    ``model``) three steps from the meshless cache laid out, the second
    writing rank 2's first position.  zamba2-7b on the 2 x 2 mesh under
    ``seq``/``kvseq`` over ``data`` (batch 1): two steps from its
    shared cache laid out, built one rank at a time.  The rank's
    readings go into ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import serve_step as ss
    torch.set_grad_enabled(False)
    ops.reset_launch_counts()
    dev, me = mesh.device, mesh.index
    cfgs = job["cfgs"]
    cfg = cfgs[SEQ_ARCH]
    am = shd.AbstractMesh(dict(mesh.shape))

    def nbytes(tree):
        return sum(v.numel() * v.element_size() for v in _leaves(tree))

    def sync_ms(t0):
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0)

    # -- qwen2-0.5b prefill on 1 x 4 -------------------------------------
    pre = dryrun.cell_rules(cfg, ShapeConfig("p16", SEQ_PREFILL[1],
                                             SEQ_PREFILL[0], "prefill"),
                            am, False)
    p = zoo.build_params(cfg, seed=0, device=dev)
    out["param_sum_equal"] = _bits_sum(p["embed"]) == job["param_sum"]
    _, axes = zoo.param_axes(cfg)
    specs = ly.axes_to_specs(p, axes, mesh, pre)
    tree = shd.lay_out(p, specs, mesh, pre)
    del p
    torch.cuda.empty_cache()
    out["rules_prefill"] = {k: pre[k] for k in dryrun.SEQ_NAMES if pre[k]}
    out["param_bytes"] = nbytes(tree)
    toks = torch.as_tensor(job["toks"], device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    with cl.recording() as rec:
        logits = zoo.forward(tree, cfg, toks)
        last = ss.last_logits(logits, tree, cfg, toks.shape[1])
        ids = ss.greedy(last, tree, cfg)
    out["prefill_ms"] = sync_ms(t0)
    out["prefill_colls"] = rf.tally(rec)
    whole = ly.gather_last(last[:, 0], zoo.vocab_axes(tree, cfg), mesh)
    out["e_fwd"] = float((whole.float().cpu() - job["ref"]["f32"]).abs().max())
    out["ids_fwd"] = ids[:, 0].cpu().tolist()
    del logits, last, whole
    # -- qwen2-0.5b decode, kvseq over model -------------------------------
    dec = dryrun.cell_rules(cfg, ShapeConfig("d16", SEQ_CACHE,
                                             SEQ_PREFILL[0], "decode"),
                            am, False)
    out["rules_decode"] = {k: dec[k] for k in dryrun.SEQ_NAMES if dec[k]}
    tree = shd.LaidOutTree(dict(tree), tree.specs, mesh, dec)
    cax = zoo.cache_axes(cfg)
    cache = shd.lay_out(job["cache"], {
        k: shd.resolve_spec(v.shape, cax[k], mesh, dec)
        for k, v in job["cache"].items()}, mesh, dec)
    out["cache_bytes"] = nbytes(cache)
    out["cache_block"] = tuple(cache["k"].shape)
    dt = torch.as_tensor(job["dtoks"][:, SEQ_FILL:], device=dev)
    out["e_dec"], out["ids_dec"], out["step_ms"] = [], [], []
    for j in range(3):
        t0 = time.perf_counter()
        logits, cache = zoo.decode_step(tree, cfg, dt[:, j:j + 1], cache,
                                        SEQ_FILL + j)
        ids = ss.greedy(logits[:, -1], tree, cfg)
        out["step_ms"].append(sync_ms(t0))
        whole = ly.gather_last(logits[:, 0], zoo.vocab_axes(tree, cfg), mesh)
        out["e_dec"].append(float((whole.float().cpu()
                                   - job["ref"]["d32"][j]).abs().max()))
        out["ids_dec"].append(ids.cpu().tolist())
    blk = cache["k"].shape[2]
    out["written_here"] = [SEQ_FILL + j for j in range(3)
                           if me * blk <= SEQ_FILL + j < (me + 1) * blk]
    del tree, cache
    torch.cuda.empty_cache()
    # -- zamba2-7b decode on 2 x 2, seq/kvseq over data ----------------------
    hcfg = cfgs[SEQ_HYBRID]
    h_rules = dryrun.cell_rules(hcfg, ShapeConfig("h16", SEQ_HCACHE, 1,
                                                  "decode"),
                                shd.AbstractMesh(dict(m22.shape)), False)
    out["rules_hybrid"] = {k: h_rules[k] for k in dryrun.SEQ_NAMES
                           if h_rules[k]}
    _, haxes = zoo.param_axes(hcfg)
    hcax = zoo.cache_axes(hcfg)

    def build():
        p = zoo.build_params(hcfg, seed=0, device=dev)
        ok = _bits_sum(p["embed"]) == job["h_param_sum"]
        t = shd.lay_out(p, ly.axes_to_specs(p, haxes, m22, h_rules), m22,
                        h_rules)
        del p
        c = hybrid_cache(torch, hcfg, dev)
        c = shd.lay_out(c, {k: shd.resolve_spec(v.shape, hcax[k], m22,
                                                h_rules)
                            for k, v in c.items()}, m22, h_rules)
        return ok, t, c
    t0 = time.perf_counter()
    ok, htree, hcache = _one_at_a_time(torch, build)
    out["h_build_ms"] = sync_ms(t0)
    out["h_param_sum_equal"] = ok
    out["h_param_bytes"] = nbytes(htree)
    out["h_cache_bytes"] = nbytes(hcache)
    out["h_coords"] = dict(m22.coords)
    out["h_cache_block"] = tuple(hcache["k"].shape)
    ht = torch.as_tensor(job["htoks"], device=dev)
    out["h_e_dec"], out["h_ids"], out["h_step_ms"] = [], [], []
    for j in range(2):
        t0 = time.perf_counter()
        with cl.recording() as rec:
            logits, hcache = zoo.decode_step(htree, hcfg, ht[:, j:j + 1],
                                             hcache, SEQ_HFILL + j)
            ids = ss.greedy(logits[:, -1], htree, hcfg)
        out["h_step_ms"].append(sync_ms(t0))
        whole = ly.gather_last(logits[:, 0], zoo.vocab_axes(htree, hcfg), m22)
        out["h_e_dec"].append(float((whole.float().cpu()
                                     - job["href"]["d32"][j]).abs().max()))
        out["h_ids"].append(ids.cpu().tolist())
    out["h_colls"] = len(rec)
    out["launches"] = ops.launch_counts()


def seq_rank(mesh, job) -> dict:
    """Phases 16 and 17 on one rank of the same world of 4 (gloo, every
    rank on the card), the parts ``job["parts"]`` names: phase 16's
    sequence layouts (:func:`_seq16`), then phase 17's sharded train
    steps (:func:`_train17`).  Returns the rank's readings."""
    import torch

    from repro_torch.train import elastic
    t0 = time.perf_counter()
    out = {"rank": mesh.index, "device": str(mesh.device), "part_s": {}}
    m22 = elastic.remesh(model_parallel=2, device=mesh.device.type)
    for part, fn in (("16", _seq16), ("17", _train17)):
        if part in job["parts"]:
            fn(mesh, m22, job, out)
            torch.cuda.empty_cache()
            out["part_s"][part] = time.perf_counter() - t0
            t0 = time.perf_counter()
    return out


TRAIN_MESH_BATCH = (8, 512)    # phase 17: phase 5f's batch x sequence
TRAIN_MESH_STEPS = 2           # phase 17: steps on each mesh
TRAIN_MESH_DIR = "train17"     # phase 17: the witness's states, under build/
F32_RTOL = 1e-4     # phase 17's float32 step: loss and grad_norm (the tests')
F32_MU_REL = 1e-2   # and each leaf's new first moment, norm-wise


def train_job(torch, dev, card) -> dict:
    """Phase 17's references, meshless on the card: from qwen2-0.5b's
    bf16 weights (seed 0, phase 16's) and ``TRAIN_MESH_BATCH`` from
    ``card_checks.train_batch``, the float32 witness's
    ``TRAIN_MESH_STEPS`` ``make_train_step`` steps (the weights cast,
    computed and updated in float32) and, for each step, the meshless
    bf16 step from the witness's parameters (cast to bf16) and AdamW
    state before it: two bf16 runs part ways within a step, so each
    step is held from a common start and its distance is that step's
    own.  Each witness step's new parameters (and, where a step
    follows, its AdamW state) are written under ``build/TRAIN_MESH_DIR``
    for the ranks; returned: each step's loss and ``grad_norm`` of both,
    the bf16 step's distance from the witness (loss, ``grad_norm``,
    each leaf's largest difference of the new parameters), the batch
    and the files."""
    import dataclasses
    import shutil

    from repro_torch.core.tree import tree_map
    from repro_torch.models import model_zoo as zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    t = time.perf_counter()
    cfg = seq_configs()[SEQ_ARCH]
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    batch = train_batch(cfg, np.random.default_rng(17), *TRAIN_MESH_BATCH)
    tb = {k: torch.as_tensor(v.astype(np.int64), device=dev)
          for k, v in batch.items()}
    d = HERE / "build" / TRAIN_MESH_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    p = zoo.build_params(cfg, seed=0, device=dev)
    job = {"batch": batch, "files": [], "param_sum": _bits_sum(p["embed"]),
           "loss": {"16": [], "32": []}, "grad_norm": {"16": [], "32": []},
           "e_loss": [], "e_norm": [], "e_leaf": []}
    p = tree_map(lambda x: x.float(), p)
    st = opt.init(p)
    cpu = (lambda tree: {k: v.cpu() for k, v in tree.items()})
    for j in range(TRAIN_MESH_STEPS):
        b, _, m16 = ts.make_train_step(cfg)(
            tree_map(lambda x: x.to(torch.bfloat16), p), st, tb)
        p, st, m32 = ts.make_train_step(cfg32)(p, st, tb)
        for key, m in (("16", m16), ("32", m32)):
            job["loss"][key].append(float(m["loss"]))
            job["grad_norm"][key].append(float(m["grad_norm"]))
        job["e_leaf"].append({k: float((b[k].float() - p[k]).abs().max())
                              for k in p})
        for key, e in (("loss", "e_loss"), ("grad_norm", "e_norm")):
            job[e].append(abs(job[key]["16"][j] - job[key]["32"][j]))
        del b, m16
        f = d / f"step{j}.pt"
        torch.save({"params": cpu(p)} if j + 1 == TRAIN_MESH_STEPS else
                   {"params": cpu(p), "mu": cpu(st.mu), "nu": cpu(st.nu),
                    "step": int(st.step)}, f)
        job["files"].append(str(f))
    del p, st
    torch.cuda.empty_cache()
    print(f"[17] meshless references: {SEQ_ARCH} (bf16, published widths) "
          f"{TRAIN_MESH_STEPS} make_train_step steps of "
          f"{TRAIN_MESH_BATCH}, each from the float32 witness's state "
          f"before it: loss bf16 {job['loss']['16']}, witness "
          f"{job['loss']['32']}; grad_norm bf16 {job['grad_norm']['16']}, "
          f"witness {job['grad_norm']['32']}; largest leaf distance bf16 - "
          f"witness by step {[max(e.values()) for e in job['e_leaf']]}; "
          f"{time.perf_counter() - t:.1f} s ({card})", flush=True)
    return job


def _train17(mesh, m22, job, out) -> None:
    """Phase 17 on one rank: qwen2-0.5b (bf16, seed 0) laid out on the
    1 x 4 world mesh under ``cell_rules`` of a train shape of
    ``TRAIN_MESH_BATCH`` (``cp_seq`` + ``cp_q``) and on the 2 x 2 mesh
    under the default rules (fsdp and the batch over ``data``, whole
    heads over ``model``); on each, ``TRAIN_MESH_STEPS``
    ``make_train_step`` steps of the rank's rows, the first from the
    seed's weights, each later one from the float32 witness's
    parameters (cast to bf16) and AdamW state before it, laid out
    (:func:`train_job`), each timed by CUDA events with its collectives
    recorded; each step's loss, ``grad_norm`` and each new parameter
    block's largest difference from the witness's block; then the
    first step in float32 (the seed's weights cast, as the witness
    starts): its loss, ``grad_norm`` and each leaf's new first moment's
    distance from the witness's and the witness's norm, both summed over
    the axes that split the leaf (a replicated block counted once);
    whether the seed's weights are phase 16's; the forward's collectives
    counted on the meta device (the dry-run's count of the same
    program); the rank's parameter, AdamW-state and peak bytes; the
    launches (path ``train_mesh``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    dev = mesh.device
    tj = job["train"]
    cfg = job["cfgs"][SEQ_ARCH]
    b, s = TRAIN_MESH_BATCH
    shape = ShapeConfig("t17", s, b, "train")
    meshes = {"1x4": (mesh, dryrun.cell_rules(
                  cfg, shape, shd.AbstractMesh(dict(mesh.shape)), False)),
              "2x2": (m22, shd.default_rules())}
    _, axes = zoo.param_axes(cfg)
    step = ts.make_train_step(cfg)
    ops.reset_launch_counts()
    for key, (m, rules) in meshes.items():
        r = {"rules": {k: rules[k] for k in dryrun.SEQ_NAMES if rules[k]},
             "coords": dict(m.coords), "ms": [], "loss": [], "grad_norm": [],
             "e_leaf": [], "colls": []}
        p = zoo.build_params(cfg, seed=0, device=dev)
        r["param_sum_equal"] = _bits_sum(p["embed"]) == tj["param_sum"]
        specs = ly.axes_to_specs(p, axes, m, rules)
        tree = shd.lay_out(p, specs, m, rules)
        del p
        state = opt.init(tree)
        spec = shd.resolve_spec((b,), ("batch",), m, rules)
        rows = shd.block_slices((b,), spec, m)[0]
        tb = {k: torch.as_tensor(v[rows].astype(np.int64), device=dev)
              for k, v in tj["batch"].items()}
        r["rows"] = (rows.start or 0, rows.stop or b)
        r["param_bytes"] = sum(x.numel() * x.element_size()
                               for x in leaves(tree))
        r["state_bytes"] = sum(x.numel() * x.element_size()
                               for x in leaves(state))
        # the forward's collectives: the same program on the meta device
        am = shd.AbstractMesh(dict(m.shape))
        meta = shd.LaidOutTree(dryrun._blocks(zoo.param_axes(cfg)[0],
                                              specs, am), specs, am, rules)
        mrows = {k: torch.empty(tuple(v.shape), dtype=v.dtype,
                                device="meta") for k, v in tb.items()}

        def forward():
            with torch.no_grad():
                ts.loss_fn(meta, cfg, mrows)
        r["fwd_colls"] = {k: v["count"] for k, v in
                          dryrun.count(forward)["collectives"].items()}
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for j in range(TRAIN_MESH_STEPS):
            if j:                    # the witness's state before step j
                w = torch.load(tj["files"][j - 1], mmap=True)

                def cut(t, dtype):
                    return tree.with_blocks({
                        k: shd.shard_tensor(v, specs[k], m).to(dtype)
                        for k, v in t.items()})
                tree = cut(w["params"], tree[next(iter(tree))].dtype)
                state = opt.AdamWState(
                    torch.tensor(w["step"], dtype=torch.int32, device=dev),
                    cut(w["mu"], torch.float32), cut(w["nu"], torch.float32))
                del w
            dist.barrier()
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            with cl.recording() as rec:
                tree, state, met = step(tree, state, tb)
            z.record()
            torch.cuda.synchronize(dev)
            r["ms"].append(a.elapsed_time(z))
            r["colls"].append({k: v["count"] for k, v in
                               rf.tally(rec).items()})
            r["loss"].append(float(met["loss"]))
            r["grad_norm"].append(float(met["grad_norm"]))
            w = torch.load(tj["files"][j], mmap=True)["params"]
            r["e_leaf"].append({
                k: float((tree[k].float()
                          - shd.shard_tensor(v, specs[k], m)).abs().max())
                for k, v in w.items()})
            del w
        r["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        r["laid_out"] = all(isinstance(t, shd.LaidOutTree)
                            for t in (tree, state.mu, state.nu))
        del tree, state, met
        torch.cuda.empty_cache()
        r["f32"] = _train17_f32(m, rules, job, tb)
        out["t17_" + key] = r
    out["t17_launches"] = ops.launch_counts()


def _train17_f32(m, rules, job, tb) -> dict:
    """Phase 17's float32 step on one rank of mesh ``m``: the seed's
    weights cast to float32 and laid out by ``rules``, a fresh AdamW
    state, one ``make_train_step`` step of the rank's rows ``tb`` (as
    the witness's first step starts), timed by CUDA events; its loss,
    ``grad_norm`` and, by leaf, the new first moment's squared distance
    from the witness's and the witness's squared norm, summed over the
    axes that split the leaf."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core.tree import tree_map
    from repro_torch.models import layers as ly
    from repro_torch.models import model_zoo as zoo
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    dev = m.device
    cfg = job["cfgs"][SEQ_ARCH]
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    _, axes = zoo.param_axes(cfg)
    p = tree_map(lambda x: x.float(), zoo.build_params(cfg, seed=0,
                                                       device=dev))
    specs = ly.axes_to_specs(p, axes, m, rules)
    tree = shd.lay_out(p, specs, m, rules)
    del p
    dist.barrier()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    _, state, met = ts.make_train_step(cfg32)(tree, opt.init(tree), tb)
    z.record()
    torch.cuda.synchronize(dev)
    w = torch.load(job["train"]["files"][0], mmap=True)["mu"]
    names = sorted(w)
    sq = []
    for k in names:
        ref = shd.shard_tensor(w[k], specs[k], m).to(dev)
        d = state.mu[k] - ref
        sq.append(torch.stack([torch.sum(d * d), torch.sum(ref * ref)]))
    sq = shd.psum_grouped(sq, [
        tuple(x for x in shd.spec_axes(specs[k]) if m.shape[x] > 1)
        for k in names], m)
    out = {"ms": a.elapsed_time(z), "loss": float(met["loss"]),
           "grad_norm": float(met["grad_norm"]),
           "mu_rel": {k: math.sqrt(float(v[0]) / max(float(v[1]), 1e-30))
                      for k, v in zip(names, sq)}}
    del tree, state, met, w
    torch.cuda.empty_cache()
    return out


def seq_report(ranks, job, card) -> None:
    """Phase 16's checks of the ranks' readings, and its lines."""
    ref, href = job["ref"], job["href"]
    for r in ranks:
        me = f"phase 16 rank {r['rank']}"
        check(r["param_sum_equal"] and r["h_param_sum_equal"],
              f"{me}: the rank's weights differ from the parent's")
        check(r["rules_prefill"] == {"cp_seq": ("model",),
                                     "cp_q": ("model",)}
              and r["rules_decode"] == {"kvseq": ("model",)}
              and r["rules_hybrid"] == {"seq": ("data",),
                                        "kvseq": ("data",)},
              f"{me}: unexpected rules {r['rules_prefill']}, "
              f"{r['rules_decode']}, {r['rules_hybrid']}")
        check(r["e_fwd"] <= 2 * ref["e_fwd"], f"{me}: the sharded prefill "
              f"lies {r['e_fwd']:.4e} from the float32 witness, more than "
              f"twice the meshless bf16's {ref['e_fwd']:.4e}")
        for j, (e, e_ref) in enumerate(zip(r["e_dec"], ref["e_dec"])):
            check(e <= 2 * e_ref, f"{me}: kvseq step {j} lies {e:.4e} from "
                  f"the float32 witness, more than twice {e_ref:.4e}")
        for j, (e, e_ref) in enumerate(zip(r["h_e_dec"], href["e_dec"])):
            check(e <= 2 * e_ref, f"{me}: {SEQ_HYBRID} step {j} lies "
                  f"{e:.4e} from the float32 witness, more than twice "
                  f"{e_ref:.4e}")
        for k in ("ids_fwd", "ids_dec", "h_ids"):
            check(r[k] == ranks[0][k], f"{me}: {k} differ from rank 0's")
    check(ranks[1]["written_here"] == [SEQ_FILL]
          and ranks[2]["written_here"][:1] == [SEQ_FILL + 1]
          and ranks[2]["cache_block"][2] * 2 == SEQ_FILL + 1,
          "phase 16: the second step's position is not rank 2's first")
    r0 = ranks[0]
    print(f"[16] {SEQ_ARCH} (bf16, published widths) on 1 x {SEQ_RANKS} "
          f"gloo ranks of the card, prefill rules {r0['rules_prefill']}: "
          f"{r0['param_bytes']} B of weights a rank; prefill of "
          f"{SEQ_PREFILL} (blockwise attention) ms by rank "
          f"{[round(r['prefill_ms'], 2) for r in ranks]}, collectives "
          f"{r0['prefill_colls']}; |last logits - float32 witness| by rank "
          f"{[round(r['e_fwd'], 6) for r in ranks]} (meshless bf16 "
          f"{ref['e_fwd']:.6f}; limit twice it); greedy ids "
          f"{r0['ids_fwd']} on every rank (meshless bf16 "
          f"{ref['ids_fwd'].tolist()}) ({card})", flush=True)
    print(f"[16] {SEQ_ARCH} decode, rules {r0['rules_decode']} "
          f"(flash-decoding): cache block {r0['cache_block']} "
          f"({r0['cache_bytes']} B a rank) of {SEQ_CACHE} positions filled "
          f"to {SEQ_FILL}; three steps writing positions "
          f"{[SEQ_FILL + j for j in range(3)]} (ranks "
          f"{[[r['rank'] for r in ranks if SEQ_FILL + j in r['written_here']] for j in range(3)]}): "
          f"|logits - witness| by step, rank 0 "
          f"{[round(e, 6) for e in r0['e_dec']]} (all ranks within "
          f"twice the meshless bf16 {[round(e, 6) for e in ref['e_dec']]});"
          f" greedy ids {r0['ids_dec']} on every rank (meshless bf16 "
          f"{[i.tolist() for i in ref['ids16']]}); ms a step by rank "
          f"{[[round(x, 2) for x in r['step_ms']] for r in ranks]} "
          f"({card})", flush=True)
    print(f"[16] {SEQ_HYBRID} (bf16, published widths and depth) on 2 x 2 "
          f"(data, model), rules {r0['rules_hybrid']}, batch 1: "
          + "; ".join(f"rank {r['rank']} {r['h_coords']} {r['h_param_bytes']}"
                      f" B of weights + {r['h_cache_bytes']} B of cache "
                      f"(shared k block {r['h_cache_block']})"
                      for r in ranks)
          + f"; built one rank at a time in {r0['h_build_ms']:.0f} ms; two "
          f"steps writing {SEQ_HFILL} and {SEQ_HFILL + 1}: |logits - "
          f"witness| rank 0 {[round(e, 6) for e in r0['h_e_dec']]} (limit "
          f"twice {[round(e, 6) for e in href['e_dec']]}), greedy ids "
          f"{r0['h_ids']} on every rank (meshless bf16 "
          f"{[i.tolist() for i in href['ids16']]}); ms a step "
          f"{[round(x, 1) for x in r0['h_step_ms']]}, {r0['h_colls']} "
          f"collectives a step ({card})", flush=True)
    print(f"[16] launches on the ranks (the sequence layouts run none of the "
          f"hand kernels): {[r['launches'] for r in ranks]}", flush=True)


def train_report(ranks, job, card) -> None:
    """Phase 17's lines, then its checks of the ranks' readings: on
    each mesh every step's loss and each leaf's new parameter blocks
    (the largest difference over the ranks) within twice the meshless
    bf16 step's distance from the float32 witness (:func:`train_job`);
    the loss and ``grad_norm`` equal on every rank; the seed's weights
    phase 16's; the outputs laid out; the rules as asked; the float32
    step's loss and ``grad_norm`` within ``F32_RTOL`` of the witness's
    first step (and so within twice the meshless bf16 distance) and
    each leaf's new first moment within ``F32_MU_REL`` of the
    witness's, norm-wise.  The bf16 steps' ``grad_norm`` distance is
    read, not held: at these widths and this seed the meshless bf16
    gradient lies 118-146% of the float32 one's norm from it in every
    leaf but ``ln_f``, and the meshes' bf16 gradients 64-93% from the
    meshless one, so one meshless draw of its norm bounds no other
    layout's; the float32 steps hold the gradients' scale and direction
    (PERF.md §6, ``scripts/torch_train_mesh_grads.py``)."""
    tj = job["train"]
    want = {"1x4": {"cp_seq": ("model",), "cp_q": ("model",)}, "2x2": {}}
    checks = []
    for key in ("1x4", "2x2"):
        rs = [r["t17_" + key] for r in ranks]
        r0 = rs[0]
        checks.append((all(r["param_sum_equal"] for r in rs),
                       f"phase 17 {key}: a rank's weights differ from the "
                       f"parent's"))
        checks.append((all(r["laid_out"] for r in rs)
                       and r0["rules"] == want[key],
                       f"phase 17 {key}: outputs laid out "
                       f"{[r['laid_out'] for r in rs]}, rules {r0['rules']}"))
        ratio = []
        for j in range(TRAIN_MESH_STEPS):
            for what in ("loss", "grad_norm"):
                vals = {r[what][j] for r in rs}
                checks.append((len(vals) == 1, f"phase 17 {key} step {j}: "
                               f"{what} differs over the ranks: "
                               f"{sorted(vals)}"))
            d = abs(r0["loss"][j] - tj["loss"]["32"][j])
            checks.append((d <= 2 * tj["e_loss"][j], f"phase 17 {key} step "
                           f"{j}: the loss {r0['loss'][j]} lies {d:.4e} from "
                           f"the float32 witness, more than twice the "
                           f"meshless bf16's {tj['e_loss'][j]:.4e}"))
            ratio.append(0.0)
            for leaf, lim in tj["e_leaf"][j].items():
                d = max(r["e_leaf"][j][leaf] for r in rs)
                ratio[-1] = max(ratio[-1], d / lim if lim else 0.0)
                checks.append((d <= 2 * lim, f"phase 17 {key} step {j}: "
                               f"{leaf}'s new blocks lie {d:.4e} from the "
                               f"witness, more than twice the meshless "
                               f"bf16's {lim:.4e}"))
        f = [r["f32"] for r in rs]
        for what in ("loss", "grad_norm"):
            vals = {x[what] for x in f}
            w32 = tj[what]["32"][0]
            checks.append((len(vals) == 1, f"phase 17 {key} float32 step: "
                           f"{what} differs over the ranks: {sorted(vals)}"))
            checks.append((abs(f[0][what] - w32)
                           <= 1e-5 + F32_RTOL * abs(w32),
                           f"phase 17 {key} float32 step: {what} "
                           f"{f[0][what]} against the witness's {w32}, "
                           f"past rtol {F32_RTOL}"))
        mu_rel = max(f[0]["mu_rel"].values())
        checks.append((mu_rel <= F32_MU_REL, f"phase 17 {key} float32 step:"
                       f" a leaf's new first moment lies {mu_rel:.3e} of the "
                       f"witness's norm from it: {f[0]['mu_rel']}"))
        e_norm = [round(abs(g - w), 6) for g, w in
                  zip(r0["grad_norm"], tj["grad_norm"]["32"])]
        step_colls = [{k: v - r0["fwd_colls"].get(k, 0)
                       for k, v in c.items()} for c in r0["colls"]]
        print(f"[17] {SEQ_ARCH} (bf16, published widths) {key}, rules "
              f"{r0['rules']}, rows {[r['rows'] for r in rs]} of "
              f"{TRAIN_MESH_BATCH}: {TRAIN_MESH_STEPS} make_train_step "
              f"steps (the second from the witness's state), ms a step by "
              f"rank (events) "
              f"{[[round(x, 1) for x in r['ms']] for r in rs]}; loss "
              f"{r0['loss']} (witness {tj['loss']['32']}, meshless bf16 "
              f"{tj['loss']['16']}); grad_norm {r0['grad_norm']}, "
              f"|grad_norm - witness| {e_norm} (meshless bf16 "
              f"{[round(e, 6) for e in tj['e_norm']]}, ratio "
              f"{[round(e / x, 3) for e, x in zip(e_norm, tj['e_norm'])]}; "
              f"read); the largest "
              f"ratio of a leaf's new blocks' distance from the witness to "
              f"the meshless bf16's, by step {ratio} (limit 2); "
              f"collectives of a step {r0['colls']}: the forward's "
              f"{r0['fwd_colls']} (the same program counted on the meta "
              f"device), the rest (backward, the remat's recompute, the "
              f"gradient and norm sums) {step_colls}; a rank's bytes: "
              f"parameters {r0['param_bytes']}, AdamW state "
              f"{r0['state_bytes']}, peak by rank "
              f"{[r['peak_bytes'] for r in rs]} ({card})", flush=True)
        print(f"[17] {SEQ_ARCH} {key} float32 step from the seed's weights "
              f"(the witness's first step): ms by rank (events) "
              f"{[round(x['ms'], 1) for x in f]}; loss {f[0]['loss']} "
              f"(witness {tj['loss']['32'][0]}), grad_norm "
              f"{f[0]['grad_norm']} (witness {tj['grad_norm']['32'][0]}; "
              f"rtol {F32_RTOL}); each leaf's new first moment's distance "
              f"from the witness's over its norm "
              f"{ {k: round(v, 6) for k, v in f[0]['mu_rel'].items()} } "
              f"(limit {F32_MU_REL}) ({card})", flush=True)
    print(f"[17] launches on the ranks (the train step runs none of the "
          f"hand kernels): {[r['t17_launches'] for r in ranks]}",
          flush=True)
    for cond, msg in checks:
        check(cond, msg)


def seq_phase(torch, dev, card, parts=("16", "17")) -> list:
    """Phases 16 and 17 (the parts ``parts`` names) in one world of
    ``SEQ_RANKS`` gloo ranks of the card (:func:`seq_rank`): phase 16's
    references (:func:`seq_job`) and phase 17's (:func:`train_job`)
    here first; each rank's readings checked against the float32
    witness (within twice the meshless bf16 distance from it, greedy
    ids equal on every rank); then phase 16's dry-run of ``SEQ_DRY`` on
    the meta device with its roofline lines.  Returns the ranks'
    readings."""
    import gc
    import shutil

    from repro_torch.launch import dryrun
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import LINK_BW
    t_all = time.perf_counter()
    job = (seq_job(torch, dev, card) if "16" in parts
           else {"cfgs": seq_configs(), "card": card})
    job["parts"] = tuple(parts)
    if "17" in parts:
        job["train"] = train_job(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        ranks = spmd.spawn(seq_rank, SEQ_RANKS, job, backend="gloo",
                           device="cuda", timeout=900)
    except RuntimeError as e:
        fail(f"phases {'/'.join(parts)}: {e}")
    finally:
        shutil.rmtree(HERE / "build" / TRAIN_MESH_DIR, ignore_errors=True)
    wall = time.perf_counter() - t
    parts_s = [{k: round(v, 1) for k, v in r["part_s"].items()}
               for r in ranks]
    print(f"[16] the world of {SEQ_RANKS} ranks: {wall:.1f} s; seconds "
          f"by part and rank {parts_s} ({card})", flush=True)
    if "17" in parts:
        train_report(ranks, job, card)
    if "16" not in parts:
        return ranks
    seq_report(ranks, job, card)
    t = time.perf_counter()
    for arch, shape in SEQ_DRY:
        meta = dryrun.run_cell(arch, shape, False, None)
        print(f"[16] dry-run {arch} {shape} (single 16 x 16, rank 0, meta "
              f"device; H100 constants, LINK_BW {LINK_BW:.4e} B/s): flops "
              f"{meta['flops_per_device']:.4e}, bytes "
              f"{meta['bytes_per_device']:.4e}, wire "
              f"{meta['wire_bytes_per_device']:.4e} a rank; roofline "
              f"{meta['roofline']}; rules {meta['rules']}", flush=True)
    print(f"[16] phases 16-17: {time.perf_counter() - t_all:.1f} s "
          f"({wall:.1f} s for the ranks, {time.perf_counter() - t:.1f} s "
          f"for the dry-run) ({card})", flush=True)
    return ranks


def link_bw_rank(mesh, nbytes: int) -> dict:
    """Phase 16 over NCCL on one rank (a card a rank): the bus bandwidth
    of ``dist.all_reduce`` and ``dist.all_gather_into_tensor`` on
    ``nbytes`` of bf16 (the all-gather's result), nccl-tests' rule:
    algbw = bytes / time, busbw = algbw x 2(n-1)/n for the all-reduce and
    x (n-1)/n for the all-gather; 5 warm-up calls, then the mean of 20
    by CUDA events."""
    import torch
    import torch.distributed as dist
    dev, n = mesh.device, mesh.size
    x = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)
    part = torch.ones(nbytes // 2 // n, dtype=torch.bfloat16, device=dev)
    whole = torch.empty(nbytes // 2, dtype=torch.bfloat16, device=dev)

    def timed(fn, reps=20):
        for _ in range(5):
            fn()
        torch.cuda.synchronize(dev)
        dist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / reps
    out = {"rank": mesh.index, "device": str(dev),
           "name": torch.cuda.get_device_name(dev)}
    for kind, fn, factor in (
            ("all_reduce", lambda: dist.all_reduce(x), 2 * (n - 1) / n),
            ("all_gather", lambda: dist.all_gather_into_tensor(whole, part),
             (n - 1) / n)):
        ms = timed(fn)
        alg = nbytes / (ms * 1e-3)
        out[kind] = {"ms": ms, "algbw": alg, "busbw": alg * factor}
    return out


def link_bw_phase(torch, card: str) -> dict:
    """Phase 16 over NCCL: :func:`link_bw_rank` on ``SEQ_RANKS`` cards;
    prints each rank's readings and the link rate ``launch/mesh.py``'s
    ``LINK_BW`` takes (the smaller bus bandwidth) beside the card's name
    and power limit."""
    from repro_torch.launch import spmd
    t = time.perf_counter()
    try:
        ranks = spmd.spawn(link_bw_rank, SEQ_RANKS, SEQ_BW_BYTES,
                           backend="nccl", device="cuda", timeout=600)
    except RuntimeError as e:
        fail(f"phase 16 (nccl): {e}")
    for r in ranks:
        print(f"[16] rank {r['rank']} ({r['device']}, {r['name']}): "
              + "; ".join(f"{k} of {SEQ_BW_BYTES} B {r[k]['ms']:.4f} ms, "
                          f"algbw {r[k]['algbw'] / 1e9:.3f} GB/s, busbw "
                          f"{r[k]['busbw'] / 1e9:.3f} GB/s"
                          for k in ("all_reduce", "all_gather"))
              + f" ({card})", flush=True)
    bus = {k: min(r[k]["busbw"] for r in ranks)
           for k in ("all_reduce", "all_gather")}
    link = min(bus.values())
    check(link > 0, "phase 16: no bus bandwidth measured")
    print(f"[16] LINK_BW (the smaller bus bandwidth over the ranks and the "
          f"two collectives): {link:.6e} B/s; all-reduce {bus['all_reduce']:.6e},"
          f" all-gather {bus['all_gather']:.6e}; {time.perf_counter() - t:.1f}"
          f" s ({card})", flush=True)
    return {"link_bw": link, "busbw": bus}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    import fold_timing as ft
    import search_timing as stm
    from repro_torch.configs.minitron_8b import CONFIG as minitron
    from repro_torch.core import device_index as dix
    from repro_torch.core import faults as fl
    from repro_torch.core import plane_check as pc
    from repro_torch.core import skiplist as skx
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.core.splay_cache import SplayVocabCache
    from repro_torch.kernels import build
    from repro_torch.kernels import calibrate
    from repro_torch.kernels import fold
    from repro_torch.kernels import hot_gather as hg
    from repro_torch.kernels import ops
    from repro_torch.kernels import splay_search as ssk
    from repro_torch.kernels import state_walk as sw
    from repro_torch.kernels.ref import take_index
    from repro_torch.serve.kv_cache import PagedKVPool

    clock = PhaseClock.running = PhaseClock()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, flush=True)

    # ---- phase 1: build ------------------------------------------------
    clock.start("1")
    t = time.perf_counter()
    logs = build.build()
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"    {name}: {line.strip()}")

    # ---- phase 2: each kernel against its plain version ----------------
    clock.start("2")
    errs = {}

    def fixture_plane(width, n_levels, nq, seed):
        keys, heights, qs = wl.zipf_level_fixture(width, 1.0, nq, seed=seed)
        plane = dix.build_device(torch.as_tensor(keys, device=dev),
                                 torch.as_tensor(heights, device=dev),
                                 n_levels)
        return plane, torch.as_tensor(qs, device=dev)

    # B1 at each block size and B2 on clusters of 1 to 8 CTAs a query
    # block (the default first)
    plane, qs = fixture_plane(131072, 24, 65536, 0)
    qs = torch.cat([qs, torch.as_tensor(
        [ssk.NEG_INF_KEY, -1, 2 ** 24, ssk.PAD_KEY - 1], device=dev,
        dtype=torch.int32)])
    want = ssk.splay_search_tiered_plain(
        plane.keys, plane.rank_map, plane.widths, ssk._pad_queries(qs, 256))
    b1_err = 0
    for block in (None, 32, 128, 256):
        got = ssk._splay_search_arrays(plane.keys, qs, 256, plane.rank_map,
                                       plane.widths, _block=block)
        torch.cuda.synchronize()
        e = max_abs_err(got, (w[:qs.shape[0]] for w in want))
        check(e == 0, f"B1 (block {block}) disagrees with its plain version "
              f"(err {e})")
        b1_err = max(b1_err, e)
    errs["splay_search_tiered"] = b1_err
    print(f"[2] B1 W=131072 L=24 q={qs.shape[0]}: equal at blocks of "
          f"{ssk._TIERED_BLOCK} (default), 32, 128 and 256 threads",
          flush=True)

    b2_err = 0
    for width, n_levels, nq, qb in ((16384, 24, 8192, 256),
                                    (1008, 24, 4096, 256),
                                    (1008, 12, 1001, 128)):
        plane, qs = fixture_plane(width, n_levels, nq, width + nq)
        check(width // math.gcd(width, 256) <= 64, "B2 shape falls back")
        want = ssk.splay_search_pipelined_plain(
            plane.keys, plane.rank_map, plane.widths, plane.bot_rank,
            ssk._pad_queries(qs, qb), nq, qb)
        for cluster in (None, 1, 2, 8):
            got = ssk._splay_search_pipelined_arrays(
                plane.keys, qs, qb, plane.rank_map, plane.widths,
                plane.bot_rank, _cluster=cluster)
            torch.cuda.synchronize()
            e = max_abs_err(got, (*(w[:nq] for w in want[:3]), want[3]))
            check(e == 0, f"B2 W={width} q={nq} (cluster {cluster}) "
                  f"disagrees (err {e})")
            b2_err = max(b2_err, e)
        print(f"[2] B2 W={width} L={n_levels} q={nq} qb={qb}: equal on "
              f"clusters of {ssk.pipe_cluster(qb)} (default), 1, 2 and 8 "
              f"CTAs (bytes/block mean "
              f"{got[3].float().mean().item():.0f})", flush=True)
    errs["splay_search_pipelined"] = b2_err

    def cpu_state(st):
        return sx.SplayState(*(t.cpu() for t in st))

    def state_err(a, b):
        return max_abs_err(list(a), list(b))

    rng = np.random.default_rng(7)
    pool = rng.permutation(8000)[:2000].astype(np.int32)
    g = sx.make(4098, 24, device=dev)
    c = cpu_state(g)
    ins = (np.ones(2000, np.int32), pool, np.ones(2000, bool))
    g_out = sx.run_ops(g, *ins)
    c_out = sx.run_ops(c, *ins)
    f_err = max(state_err(g_out[0], c_out[0]),
                max_abs_err(g_out[1:], c_out[1:]))
    g, c = g_out[0], c_out[0]
    for epoch in range(4):
        kinds = rng.choice(3, 512, p=[0.6, 0.25, 0.15]).astype(np.int32)
        keys = rng.integers(0, 8000, 512).astype(np.int32)
        upd = rng.random(512) < 0.5
        g_out = sx.run_ops(g, kinds, keys, upd)
        c_out = sx.run_ops(c, kinds, keys, upd)
        f_err = max(f_err, state_err(g_out[0], c_out[0]),
                    max_abs_err(g_out[1:], c_out[1:]))
        g, c = g_out[0], c_out[0]
    for aggregate in (False, True):
        qk = rng.choice(pool, 1024).astype(np.int32)
        up = rng.random(1024) < 0.5
        g_out = sx.run_contains_batch(g, qk, up, aggregate)
        c_out = sx.run_contains_batch(c, qk, up, aggregate)
        f_err = max(f_err, state_err(g_out[0], c_out[0]),
                    max_abs_err(g_out[1:], c_out[1:]))
    # the five op kinds in one list: the ordered kinds (OP_PRED, OP_RANGE)
    # read the live slots with the whole warp, after the deletes and
    # inserts before them in the same launch
    orng = np.random.default_rng(8)
    kinds = orng.choice(5, 1024, p=[0.2, 0.15, 0.25, 0.2, 0.2]).astype(
        np.int32)
    keys = np.where(orng.random(1024) < 0.8, orng.choice(pool, 1024),
                    orng.integers(-5, 8005, 1024)).astype(np.int32)
    upd = orng.random(1024) < 0.5
    g_out = sx.run_ops(g, kinds, keys, upd)
    c_out = sx.run_ops(c, kinds, keys, upd)
    ordered_err = max(state_err(g_out[0], c_out[0]),
                      max_abs_err(g_out[1:], c_out[1:]))
    torch.cuda.synchronize()
    check(f_err == 0, f"F disagrees with its plain version (err {f_err})")
    check(ordered_err == 0, f"F disagrees with its plain version on the "
          f"five-kind list (err {ordered_err})")
    errs["splay_fold"] = f_err
    print("[2] F 2000-key prefill + 4 mixed epochs + both contains "
          "folds + a 1024-op list of all five kinds: equal", flush=True)

    # S against its plain fold: a 4096-key populate (heights from
    # sample_heights), then two mixed lists of contains, inserts and
    # deletes (present and absent keys; the second list revives what the
    # first deleted); then the raise at capacity, on the card and in the
    # plain fold, leaving the caller's state as it was
    srng = np.random.default_rng(11)
    s_pool = srng.permutation(20000)[:4096].astype(np.int32)
    s_h = skx.sample_heights(np.random.default_rng(0), 4096, 20,
                             device="cpu").numpy()
    sg = skx.make(2 * 4096 + 4, 20, device=dev)
    sc = skx.SkipState(*(t.cpu() for t in sg))
    lists = [(np.ones(4096, np.int32), s_pool, s_h)]
    for i in range(2):
        lists.append((
            srng.choice(3, 4096, p=[0.4, 0.3, 0.3]).astype(np.int32),
            np.where(srng.random(4096) < 0.8, srng.choice(s_pool, 4096),
                     srng.integers(20000, 24000, 4096)).astype(np.int32),
            skx.sample_heights(np.random.default_rng(1 + i), 4096, 20,
                               device="cpu").numpy()))
    s_err, revived = 0, 0
    for args in lists:
        was_deleted = sc.deleted.clone()
        g_out = skx.run_ops(sg, *args)
        c_out = skx.run_ops(sc, *args)
        s_err = max(s_err, state_err(g_out[0], c_out[0]),
                    max_abs_err(g_out[1:], c_out[1:]))
        revived += int((was_deleted & ~c_out[0].deleted).sum())
        sg, sc = g_out[0], c_out[0]
    check(s_err == 0, f"S disagrees with its plain version (err {s_err})")
    check(revived > 0, "S's mixed lists revived no key")
    small = skx.make(4, 4, device=dev)
    for st_c in (small, skx.SkipState(*(t.cpu() for t in small))):
        try:
            skx.run_ops(st_c, [1, 1, 1], [10, 20, 30], [0, 1, 0])
            fail(f"S on {st_c.device}: an insert past the capacity did "
                 "not raise")
        except RuntimeError as e:
            check("exhausted at op 2" in str(e), f"S's raise: {e}")
        check(int(st_c.n_alloc) == 2 and bool((st_c.nxt[:, 2:] == -1)
                                               .all()),
              f"S on {st_c.device}: the raise changed the caller's state")
    torch.cuda.synchronize()
    errs["skip_fold"] = s_err
    print(f"[2] S 4096-key populate + two 4096-op mixed lists ({revived} "
          f"revives): equal; an insert past the capacity raises on the "
          f"card and in the plain fold, the state untouched", flush=True)

    # B3, B4 and the fused two-tier gather on every dtype and copy path
    # (d=4096 rows take TMA bulk copies, d=1001 and 37 the vector words),
    # out-of-range ids, int64 ids with high bits set (they keep their low
    # 32 bits), and all-hot and all-cold batches for the fused gather
    gen = torch.Generator(device=dev).manual_seed(0)
    g_err = {"gather_rows": 0.0, "gather_hot": 0.0, "hot_gather": 0.0}
    oob = torch.as_tensor([-1, 5000, -5007, 2 ** 31 - 1], device=dev,
                          dtype=torch.int32)

    def gather_case(name, got, want, what):
        torch.cuda.synchronize()
        e = row_err(got, want)
        check(torch.equal(got, want), f"{name} {what} disagrees with its "
              f"plain version (err {e})")
        g_err[name] = max(g_err[name], e)

    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        for d in (4096, 1001, 37):
            if dtype.is_floating_point:
                src = torch.randn((5000, d), generator=gen, device=dev,
                                  dtype=dtype)
            else:
                lo, hi = (0, 256) if dtype == torch.uint8 else (-10 ** 6,
                                                                10 ** 6)
                src = torch.randint(lo, hi, (5000, d), generator=gen,
                                    device=dev, dtype=dtype)
            hot_ids = torch.randperm(5000, generator=gen, device=dev)[:512]
            hot_rank = torch.full((5000,), -1, dtype=torch.int32, device=dev)
            hot_rank[hot_ids] = torch.arange(512, dtype=torch.int32,
                                             device=dev)
            hot_buf = hg.gather_rows_ref(src, hot_ids)
            cold_ids = torch.nonzero(hot_rank < 0).flatten()
            batches2 = {}
            for nq in (0, 1, 333, 8192):
                ids = torch.randint(0, 5000, (nq,), generator=gen,
                                    device=dev, dtype=torch.int32)
                k = min(nq, 4)
                ids[:k] = oob[:k]
                batches2[f"q={nq}"] = ids
            pick = torch.randint(0, 512, (8192,), generator=gen, device=dev)
            batches2["all-hot"] = hot_ids[pick].to(torch.int32)
            pick = torch.randint(0, cold_ids.numel(), (8192,),
                                 generator=gen, device=dev)
            batches2["all-cold"] = cold_ids[pick].to(torch.int32)
            high = torch.randint(-2 ** 20, 2 ** 20, (8192,), generator=gen,
                                 device=dev, dtype=torch.int64) << 32
            batches2["int64"] = batches2["q=8192"].long() + high
            paths = {}
            for case, ids in batches2.items():
                ids32 = ids.to(torch.int32)
                want = hg.gather_rows_ref(src, ids32)
                what = f"{dtype} d={d} {case}"
                for name in hg.LAST_PATH:
                    hg.LAST_PATH[name] = None
                for name, fn in (("gather_rows", hg.gather_rows),
                                 ("gather_hot", hg.gather_hot)):
                    gather_case(name, fn(src, ids), want, what)
                got = hg.hot_gather(src, hot_buf, hot_rank, ids)
                gather_case("hot_gather", got, hg.hot_gather_ref(
                    src, hot_buf, hot_rank, ids32), what)
                check(torch.equal(got, want), f"hot_gather {what} differs "
                      "from table[ids]")
                taken = {hg.LAST_PATH[n] for n in
                         ("gather_rows", "gather_hot", "hot_gather")}
                check(ids.numel() == 0 or taken == {
                    "bulk" if d == 4096 else hg.copy_path(
                        d * src.element_size(), src, hot_buf)},
                      f"{what}: copy paths {taken}")
                paths.setdefault(
                    "/".join(str(hg.LAST_PATH[n]) for n in
                             ("gather_rows", "gather_hot", "hot_gather")),
                    []).append(case)
            print(f"[2] B4/B3/fused {str(dtype)[6:]} d={d}: equal; copy "
                  "paths " + "; ".join(f"{k} on {', '.join(v)}"
                                       for k, v in paths.items()),
                  flush=True)
    errs.update(g_err)

    plane, qs = fixture_plane(16384, 24, 2048, 5)
    qs = torch.cat([qs, torch.as_tensor(
        [ssk.NEG_INF_KEY, -1, ssk.PAD_KEY - 1, ssk.PAD_KEY], device=dev,
        dtype=torch.int32)])
    got = ssk._splay_search_full_arrays(plane.keys, qs, 256)
    want = ssk.splay_search_full_plain(plane.keys,
                                       ssk._pad_queries(qs, 256), 256)
    torch.cuda.synchronize()
    e = max_abs_err(got, (w[:qs.shape[0]] for w in want))
    check(e == 0, f"B5 disagrees with its plain version (err {e})")
    check(bool(got[0][-1]), "B5 does not report PAD_KEY found")
    errs["splay_search_full"] = e
    print(f"[2] B5 W=16384 L=24 q={qs.shape[0]}: equal", flush=True)

    path_launches = {}

    def read_launches(path, kernels):
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        path_launches[path] = counts
        print(f"    launches on path {path}: {counts}", flush=True)
        for name in kernels:
            check(counts[name] > 0, f"kernel {name} never launched on "
                  f"path {path}")

    # ---- phase 3: the main path at the paper's scale -------------------
    clock.start("3")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    E, B, N = ft.PAPER_E, ft.PAPER_B, ft.PAPER_N
    stream, pre_args = ft.paper_prefill(sx, wl)
    st = sx.make(capacity=ft.PAPER_CAPACITY, max_level=ft.PAPER_LEVELS,
                 device=dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    e0.record()
    st, res, pre_plen = sx.run_ops(st, *pre_args)
    e1.record()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_ms = e0.elapsed_time(e1)
    pre_steps = int(pre_plen.sum())
    check(bool((res == 1).all()) and int(st.size) == N, "prefill lost keys")
    t = time.perf_counter()
    plane0 = dix.from_state_device(st, n_levels=24, width=131072)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    print(f"[3] prefill {N} inserts {prefill_s:.3f} s "
          f"({N / prefill_s:.0f} ops/s; run_ops by events "
          f"{prefill_ms:.3f} ms: a state clone and one F launch); "
          f"from_state_device {build_s:.4f} s;"
          f" zl={int(st.zl)} max rel height "
          f"{int((st.top[2:N + 2] - st.zl).max())}", flush=True)

    kinds = np.zeros((E, B), np.int32)
    keys = stream.keys.reshape(E, B)
    upd = stream.upd.reshape(E, B)
    t = time.perf_counter()
    out = sx.run_serving(st, plane0, kinds, keys, upd, aggregate=True,
                         plane_search=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    read_launches("paper_serving", ("splay_search_tiered", "splay_fold",
                                    "splay_walk"))
    peak = torch.cuda.max_memory_allocated()
    print(f"    max_memory_allocated {peak} B", flush=True)
    walk = sx.run_serving(st, plane0, kinds, keys, upd, aggregate=True)
    torch.cuda.synchronize()
    check(torch.equal(out[2], walk[2]),
          "plane verdicts differ from the state walk")
    check(state_err(out[0], walk[0]) == 0, "plane-search fold diverged")
    check(state_err(out[1], walk[1]) == 0, "planes diverged")
    hit_rate = out[2].float().mean().item()
    check(hit_rate == 1.0, f"hit rate {hit_rate} != 1.0")
    check(int(out[4].sum()) == 0, f"overflow {out[4].tolist()}")
    st3, plane3 = out[0], out[1]
    served3 = out               # phase 9's reference
    outside = np.concatenate([np.arange(N, N + 2048),
                              np.arange(-2048, 0)]).astype(np.int32)
    miss = sx.run_epoch(st3, plane3, np.zeros(4096, np.int32), outside,
                        np.zeros(4096, bool), aggregate=True,
                        plane_search=True)
    check(int(miss[2].sum()) == 0, "keys outside the key space answered 1")
    mean_level = out[3].float().mean(1)
    print(f"[3] serving E={E} B={B}: {serve_s:.3f} s, "
          f"{E * B / serve_s:.0f} ops/s, epoch {1e3 * serve_s / E:.2f} ms;"
          f" hit rate {hit_rate}; plane == state walk in every epoch",
          flush=True)
    print(f"    mean level_found per epoch: "
          f"{[round(x, 3) for x in mean_level.tolist()]}")
    print(f"    overflow per epoch: {out[4].tolist()}")

    # ---- phase 4: membership epochs -------------------------------------
    clock.start("4")
    E4 = 4
    fresh = np.arange(N, N + E4 * B // 10 + 64, dtype=np.int32)
    victims = rng.permutation(stream.populate)[:E4 * B // 20 + 64]
    kinds4 = np.zeros((E4, B), np.int32)
    keys4 = rng.choice(stream.keys, (E4, B)).astype(np.int32)
    n_ins, n_del = B // 10, B // 20
    inserted, deleted = [], []
    for e in range(E4):
        lanes = rng.permutation(B)
        ins_l, del_l = lanes[:n_ins], lanes[n_ins:n_ins + n_del]
        kinds4[e, ins_l] = sx.OP_INSERT
        keys4[e, ins_l] = fresh[e * n_ins:(e + 1) * n_ins]
        kinds4[e, del_l] = sx.OP_DELETE
        keys4[e, del_l] = victims[e * n_del:(e + 1) * n_del]
        inserted += keys4[e, ins_l].tolist()
        deleted += keys4[e, del_l].tolist()
    # a contains lane of a key deleted earlier in the same stream keeps
    # its state-walk verdict; only inserts/deletes are checked below
    upd4 = rng.random((E4, B)) < 0.01
    # F's op fold on the main path's own state, against its plain version
    g, c = st3, cpu_state(st3)
    f_err4, plain_s = 0, 0.0
    for e in range(E4):
        g_out = sx.run_ops(g, kinds4[e], keys4[e], upd4[e])
        t = time.perf_counter()
        c_out = sx.run_ops(c, kinds4[e], keys4[e], upd4[e])
        plain_s += time.perf_counter() - t
        f_err4 = max(f_err4, state_err(g_out[0], c_out[0]),
                     max_abs_err(g_out[1:], c_out[1:]))
        g, c = g_out[0], c_out[0]
    check(f_err4 == 0, f"F disagrees with its plain version on the "
          f"paper-scale state (err {f_err4})")
    errs["splay_fold"] = max(errs["splay_fold"], f_err4)
    # phase 2's five-kind check at the main path's scale: a list of all
    # five kinds on the served paper-scale state
    orng = np.random.default_rng(12)
    kinds5 = orng.choice(5, 512, p=[0.2, 0.1, 0.1, 0.3, 0.3]).astype(
        np.int32)
    keys5 = orng.integers(-50, N + 50, 512).astype(np.int32)
    upd5 = orng.random(512) < 0.5
    g_out = sx.run_ops(st3, kinds5, keys5, upd5)
    c_out = sx.run_ops(cpu_state(st3), kinds5, keys5, upd5)
    ordered_err = max(ordered_err, state_err(g_out[0], c_out[0]),
                      max_abs_err(g_out[1:], c_out[1:]))
    check(ordered_err == 0, f"F disagrees with its plain version on the "
          f"paper-scale five-kind list (err {ordered_err})")
    errs["splay_fold"] = max(errs["splay_fold"], ordered_err)
    print("[4] F list of 512 ops of all five kinds on the paper-scale "
          "state: equal to the plain fold", flush=True)
    print(f"[4] F op fold of {E4}x{B} mixed ops on the paper-scale state: "
          f"equal to the plain fold ({plain_s:.1f} s on the host CPU)",
          flush=True)
    ops.reset_launch_counts()
    t = time.perf_counter()
    out4 = sx.run_serving(st3, plane3, kinds4, keys4, upd4)
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t
    read_launches("membership", ("splay_fold",))
    res4 = out4[2].cpu().numpy()
    check(bool((res4[kinds4 != sx.OP_CONTAINS] == 1).all()),
          "an insert of a fresh key or a delete of a live key failed")
    st4, plane4 = out4[0], out4[1]
    probe = np.asarray(inserted + deleted, np.int32)
    expect = np.concatenate([np.ones(len(inserted), np.int32),
                             np.zeros(len(deleted), np.int32)])
    chk = sx.run_epoch(st4, plane4, np.zeros(len(probe), np.int32), probe,
                       np.zeros(len(probe), bool), aggregate=True,
                       plane_search=True)
    walk_res = sx.fold_entries(st4, probe, np.zeros(len(probe), bool))[1]
    check(np.array_equal(chk[2].cpu().numpy(), expect),
          "plane misses an insert or still holds a delete")
    check(np.array_equal(walk_res.cpu().numpy().astype(np.int32), expect),
          "state walk disagrees on the membership probe")
    print(f"[4] membership E={E4} B={B} ({n_ins} inserts, {n_del} deletes"
          f" per epoch): {mem_s:.3f} s, {E4 * B / mem_s:.0f} ops/s; "
          f"overflow {out4[4].tolist()}; size {int(st4.size)}; probe of "
          f"{len(probe)} inserted/deleted keys exact", flush=True)

    # ---- phase 5: serving at W=16384, answered by B2 --------------------
    clock.start("5")
    E5, B5, N5 = 8, 2048, 10_000
    s5 = wl.zipf_workload(n=N5, ops=E5 * B5, s=1.0, p=0.01, seed=5)
    ops.reset_launch_counts()
    st5 = sx.make(capacity=16386, max_level=24, device=dev)
    st5, _, _ = sx.run_ops(
        st5, np.full(N5, sx.OP_INSERT, np.int32),
        np.random.default_rng(6).permutation(s5.populate),
        np.ones(N5, bool))
    plane5 = dix.from_state_device(st5, n_levels=24, width=16384)
    args5 = (np.zeros((E5, B5), np.int32), s5.keys.reshape(E5, B5),
             s5.upd.reshape(E5, B5))
    t = time.perf_counter()
    out5 = sx.run_serving(st5, plane5, *args5, aggregate=True,
                          plane_search=True)
    torch.cuda.synchronize()
    s5_s = time.perf_counter() - t
    read_launches("w16384_serving", ("splay_search_pipelined",
                                     "splay_fold"))
    walk5 = sx.run_serving(st5, plane5, *args5, aggregate=True)
    check(torch.equal(out5[2], walk5[2]), "W=16384 plane verdicts differ")
    check(bool((out5[2] == 1).all()), "W=16384 hit rate != 1.0")
    print(f"[5] serving W=16384 E={E5} B={B5}: {s5_s:.3f} s, "
          f"{E5 * B5 / s5_s:.0f} ops/s; plane == state walk", flush=True)

    # the seed baseline search (B5) over the served plane
    pl5 = out5[1]
    q5s = [torch.as_tensor(args5[1][e], device=dev) for e in range(E5)]
    ops.reset_launch_counts()
    t = time.perf_counter()
    full5 = [ops.splay_search_full(pl5, q) for q in q5s]
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    read_launches("full_search", ("splay_search_full",))
    f5_err = 0
    for q, got in zip(q5s, full5):
        want = ssk.splay_search_full_plain(pl5.keys, ssk._pad_queries(q, 256),
                                           256)
        f5_err = max(f5_err, max_abs_err(got, (w[:B5] for w in want)))
        check(all(torch.equal(a, b) for a, b in
                  zip(got, ops.splay_search(pl5, q))),
              "B5 and B2 disagree on the served plane")
    check(f5_err == 0, f"B5 disagrees with its plain version on the "
          f"served plane (err {f5_err})")
    errs["splay_search_full"] = max(errs["splay_search_full"], f5_err)
    print(f"[5] B5 over the served plane, {E5} x {B5}: {full_s:.3f} s; "
          f"equal to its plain version and to B2", flush=True)

    # ---- phase 5b: the splay vocab tier at minitron-8b width ------------
    clock.start("5b")
    V, D, H = minitron.vocab_padded, minitron.d_model, minitron.hot_vocab
    check(minitron.dtype == "bfloat16", "minitron-8b dtype changed")
    torch.cuda.reset_peak_memory_stats()
    table = torch.randn((V, D), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    cache = SplayVocabCache(V, hot_size=H, update_prob=0.01,
                            refresh_every=64, seed=0, device=dev)
    trng = np.random.default_rng(1)
    # engine: stream_epochs x lanes, flushes
    E6, B6, F6 = ft.TIER_EPOCHS, ft.TIER_LANES, ft.TIER_FLUSHES
    flushes = ft.tier_flushes(wl, trng, V)
    decode = [wl.zipf_token_ids(trng, V, (B6,)) for _ in range(64)]
    prefill = [wl.zipf_token_ids(trng, V, (8192,)) for _ in range(4)]
    batches = [torch.as_tensor(x, device=dev) for x in decode + prefill]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    flush_ms, refreshed = [], []
    for toks in flushes:
        prev = cache.hot_ids.copy()
        steps = cache.steps
        t = time.perf_counter()
        cache.observe_serving(toks)
        torch.cuda.synchronize()
        flush_ms.append(1e3 * (time.perf_counter() - t))
        if cache.steps // 64 != steps // 64:
            refreshed.append((prev, cache.counts.copy(), cache.m,
                              cache.hot_ids.copy(),
                              cache.hot_rank.cpu().numpy()))
    lookups, look_ms = [], []
    for ids in batches:
        t = time.perf_counter()
        lookups.append(cache.lookup(table, ids))
        torch.cuda.synchronize()
        look_ms.append(1e3 * (time.perf_counter() - t))
    read_launches("vocab_tier", ("hot_gather", "gather_rows",
                                 "splay_fold"))
    vc = path_launches["vocab_tier"]
    check(vc["hot_gather"] == len(batches), f"the fused gather launched "
          f"{vc['hot_gather']} times for {len(batches)} lookups")
    lookup_path = hg.LAST_PATH["hot_gather"]
    check(lookup_path == "bulk", f"lookups took the {lookup_path} path")
    check(vc["splay_fold"] >= F6 * E6, f"F launched {vc['splay_fold']} "
          f"times over {F6 * E6} stream epochs")
    vocab_peak = torch.cuda.max_memory_allocated()
    for ids, out in zip(batches, lookups):
        check(out.shape == (ids.shape[0], D) and torch.equal(
            out, table[ids.long()]), "a lookup differs from table[ids]")
    check(len(refreshed) == 2, f"{len(refreshed)} hot-set refreshes")
    for prev, counts, m, hot_ids, hot_rank in refreshed:
        oracle = SplayVocabCache(V, hot_size=H, refresh_on_device=False,
                                 device=dev)
        oracle.counts, oracle.m, oracle.hot_ids = counts, m, prev
        oracle.refresh()
        check(np.array_equal(oracle.hot_ids, hot_ids) and np.array_equal(
            oracle.hot_rank.cpu().numpy(), hot_rank),
            "device hot set differs from the numpy oracle's")
    check(len(cache.hot_ids) == H, f"hot set of {len(cache.hot_ids)}")
    all_ids = np.concatenate(decode + prefill)
    hit = cache.hit_rate(all_ids)
    print(f"[5b] vocab tier V={V} d={D} hot={H} bf16: {F6} flushes of "
          f"{E6}x{B6} ({cache.stream_epochs} epochs, m={cache.m}, "
          f"{int((cache.counts > 0).sum())} distinct tokens): "
          f"{np.mean(flush_ms):.3f} ms per flush (first "
          f"{flush_ms[0]:.3f}); hot set == numpy oracle at both "
          f"refreshes", flush=True)
    print(f"[5b] lookups: hot-tier hit rate {hit:.4f}; "
          f"{np.mean(look_ms[:64]):.4f} ms per decode batch of {B6}, "
          f"{np.mean(look_ms[64:]):.4f} ms per prefill chunk of 8192; "
          f"every lookup == table[ids]; copy path {lookup_path}; "
          f"{vc['gather_rows']} hot-buffer build(s) through B4; "
          f"max_memory_allocated {vocab_peak} B", flush=True)

    # ---- phase 5c: ordered ops and the audit at paper scale -------------
    clock.start("5c")
    # phase 3's served state and plane (10^5 live keys, L=24, W=131072);
    # host clocks and CUDA events only: a profiler session before phases
    # 7 and 8 has lost device activity there
    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps, out

    def same(got, want, what):
        got = tuple(g.cpu().numpy() for g in got)
        check(len(got) == len(want) and all(
            g.shape == np.shape(w) and np.array_equal(g, w)
            for g, w in zip(got, want)), f"{what} differs from the oracle")

    PAD, NEG = ssk.PAD_KEY, ssk.NEG_INF_KEY
    live = plane3.keys[-1, :int(plane3.widths[-1])].cpu().numpy()
    slot_keys = dix._alive_slots(st3)[0].cpu().numpy()
    live_slots = np.nonzero(slot_keys != PAD)[0]
    by_key = np.argsort(slot_keys[live_slots])
    check(np.array_equal(live, slot_keys[live_slots][by_key]),
          "the served plane's bottom row is not the state's live set")
    n_live = live.size
    orng = np.random.default_rng(21)
    # Zipf queries (epoch 1 of the stream) moved by -1, 0 or 1, a quarter
    # of them spread past both ends of the key space
    zq = keys[1].astype(np.int64) + orng.integers(-1, 2, B)
    spread = orng.random(B) < 0.25
    zq = np.where(spread, orng.integers(-2000, N + 2000, B), zq)
    q = zq.astype(np.int32)
    lo = q
    hi = (zq + orng.integers(-4, 100, B)).astype(np.int32)
    ranks_q = orng.integers(-8, n_live + 8, B).astype(np.int32)
    i_r = np.searchsorted(live, zq, side="right")
    i_l = np.searchsorted(live, zq, side="left")
    start = np.searchsorted(live, lo.astype(np.int64), side="left")
    cnt = np.maximum(np.searchsorted(live, hi.astype(np.int64),
                                     side="right") - start, 0)
    offs = np.arange(64)[None, :]
    scan = np.where(offs < np.minimum(cnt, 64)[:, None],
                    live[np.clip(start[:, None] + offs, 0, n_live - 1)], PAD)
    hits_rank = st3.selfhits.cpu().numpy()[live_slots][by_key].astype(
        np.int32)
    top = np.lexsort((np.arange(n_live), -hits_rank))[:256]
    qd, lod, hid, rkd = (torch.as_tensor(x, device=dev)
                         for x in (q, lo, hi, ranks_q))
    ordered = {
        "rank": (lambda: (ops.splay_rank(plane3, qd),), (i_r,)),
        "predecessor": (lambda: ops.splay_predecessor(plane3, qd), (
            np.where(i_r > 0, live[np.maximum(i_r - 1, 0)], NEG), i_r - 1)),
        "successor": (lambda: ops.splay_successor(plane3, qd), (
            np.where(i_l < n_live, live[np.minimum(i_l, n_live - 1)], PAD),
            i_l)),
        "select": (lambda: (ops.splay_select(plane3, rkd),), (np.where(
            (ranks_q >= 0) & (ranks_q < n_live),
            live[np.clip(ranks_q, 0, n_live - 1)], PAD),)),
        "range_count": (lambda: (ops.splay_range_count(plane3, lod, hid),),
                        (cnt,)),
        "range_scan": (lambda: ops.splay_range_scan(plane3, lod, hid, 64),
                       (scan, cnt, np.maximum(cnt - 64, 0))),
        "top_k": (lambda: ops.splay_top_k(plane3, st3.selfhits, 256),
                  (live[top], hits_rank[top], top)),
    }
    ordered_ms = {}
    for name, (fn, want) in ordered.items():
        ms, got = host_ms(fn)
        same(got, tuple(np.asarray(w, np.int32) for w in want), name)
        ordered_ms[name] = round(ms, 4)
    print(f"[5c] ordered ops on the served plane (n={n_live}, L="
          f"{plane3.keys.shape[0]}, W={plane3.keys.shape[1]}), q={B} Zipf "
          f"queries (top-k k=256, range scans of "
          f"at most 64, {int((cnt > 64).sum())} truncated): every answer "
          f"equals the numpy oracle on the sorted live set; host ms per "
          f"call {ordered_ms}", flush=True)

    # one ordered run over 4 x 4096 lanes (contains, predecessor and
    # prefix count, a third each) beside the membership-only run of the
    # same keys; then the same lanes through run_ops (kernel F's list)
    E5c = 4
    kinds_o = orng.choice([sx.OP_CONTAINS, sx.OP_PRED, sx.OP_RANGE],
                          (E5c, B)).astype(np.int32)
    zk = stream.keys[:E5c * B].astype(np.int64) + orng.integers(
        -1, 2, E5c * B)
    keys_o = np.where(orng.random(E5c * B) < 0.25,
                      orng.integers(-2000, N + 2000, E5c * B), zk).astype(
        np.int32).reshape(E5c, B)
    upd_o = orng.random((E5c, B)) < 0.01
    ops.reset_launch_counts()
    t = time.perf_counter()
    out_o = sx.run_serving(st3, plane3, kinds_o, keys_o, upd_o,
                           aggregate=True, plane_search=True, ordered=True)
    torch.cuda.synchronize()
    ord_s = [time.perf_counter() - t]
    read_launches("ordered_serving", ("splay_search_tiered", "splay_fold"))
    mem_o = []
    for _ in range(2):
        t = time.perf_counter()
        sx.run_serving(st3, plane3, np.zeros_like(kinds_o), keys_o, upd_o,
                       aggregate=True, plane_search=True)
        torch.cuda.synchronize()
        mem_o.append(time.perf_counter() - t)
        t = time.perf_counter()
        again = sx.run_serving(st3, plane3, kinds_o, keys_o, upd_o,
                               aggregate=True, plane_search=True,
                               ordered=True)
        torch.cuda.synchronize()
        ord_s.append(time.perf_counter() - t)
        check(torch.equal(again[2], out_o[2]), "ordered runs differ")
    ko = keys_o.astype(np.int64)
    io = np.searchsorted(live, ko, side="right")
    want_o = np.where(kinds_o == sx.OP_PRED,
                      np.where(io > 0, live[np.maximum(io - 1, 0)], NEG),
                      np.where(kinds_o == sx.OP_RANGE, io,
                               np.isin(ko, live))).astype(np.int32)
    check(np.array_equal(out_o[2].cpu().numpy(), want_o),
          "the ordered epochs differ from the oracle")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    by_f = sx.run_ops(st3, kinds_o.ravel(), keys_o.ravel(),
                      (upd_o & (kinds_o == sx.OP_CONTAINS)).ravel())
    e1.record()
    torch.cuda.synchronize()
    f_list_ms = e0.elapsed_time(e1)
    check(torch.equal(by_f[1], out_o[2].reshape(-1)),
          "run_ops (F with the ordered kinds) differs from the ordered "
          "epochs")
    n_ord = int((kinds_o != sx.OP_CONTAINS).sum())
    print(f"[5c] ordered run_serving E={E5c} B={B}: "
          f"{1e3 * np.mean(ord_s) / E5c:.3f} ms per epoch (runs "
          f"{[round(1e3 * x / E5c, 3) for x in ord_s]}), membership-only "
          f"epochs of the same keys {1e3 * np.mean(mem_o) / E5c:.3f} ms "
          f"(runs {[round(1e3 * x / E5c, 3) for x in mem_o]}); answers == "
          f"oracle == run_ops of the same {E5c * B} lanes through F "
          f"({n_ord} ordered ops, {f_list_ms:.1f} ms by events)",
          flush=True)

    # F's time per ordered op: 256 ops of one launch, predecessor and
    # prefix count in turn, beside the same keys as read-only contains
    # (the find walk alone); bound: the key and deleted arrays read once
    nk = 256
    fk = torch.as_tensor(keys_o.ravel()[:nk], device=dev)
    f_res = torch.zeros(nk, dtype=torch.int32, device=dev)
    f_plen = torch.zeros_like(f_res)
    no_upd = torch.zeros(nk, dtype=torch.bool, device=dev)
    f_st = sx.clone(st3)
    per_op = {}
    for name, kd in (("ordered", np.where(np.arange(nk) % 2 == 0,
                                          sx.OP_PRED, sx.OP_RANGE)),
                     ("find_only", np.zeros(nk))):
        kt = torch.as_tensor(kd.astype(np.int32), device=dev)
        fold.fold_ops(f_st, kt, fk, no_upd, f_res, f_plen, 0)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(3):
            fold.fold_ops(f_st, kt, fk, no_upd, f_res, f_plen, 0)
        e1.record()
        torch.cuda.synchronize()
        per_op[name] = e0.elapsed_time(e1) / (3 * nk)
    n_alloc3 = int(st3.n_alloc)
    ord_bound = 1e3 * 5 * (n_alloc3 - 2) / MEM_BW
    print(f"[5c] F per ordered op (one warp over {n_alloc3 - 2} slots): "
          f"{per_op['ordered']:.5f} ms; the find walk alone "
          f"{per_op['find_only']:.5f} ms; bound {ord_bound:.6f} ms (5 B a "
          f"slot over {MEM_BW:.3g} B/s)", flush=True)

    # the audit: clean, then one flip in each field caught in it and
    # repaired by one rebuild epoch (an all-pad, read-only batch)
    audit_ms, a0 = host_ms(lambda: pc.audit_plane(st3, plane3))
    check(a0 == pc.PlaneAudit(*([0] * len(pc.PlaneAudit._fields))),
          f"the served plane audits {pc.audit_summary(a0)}")
    caught_in = {"keys": ("row_unsorted", "rank_map_bad", "bot_rank_bad",
                          "state_missing", "state_extra"),
                 "heights": ("heights_bad",), "rank_map": ("rank_map_bad",),
                 "bot_rank": ("bot_rank_bad",)}
    pad_batch = sx.pad_op_batch([], [], [], 256)[:3]
    flips = []
    for i, field in enumerate(fl.BITFLIP_FIELDS):
        bad, recs = fl.flip_plane_bits(plane3, np.random.default_rng(100 + i),
                                       1, fields=(field,))
        a = pc.audit_plane(st3, bad)
        check(len(recs) == 1 and any(getattr(a, f) for f in
                                     caught_in[field]),
              f"a flip in {field} was not caught there: "
              f"{pc.audit_summary(a)}")
        fixed = sx.run_epoch(st3, bad, *pad_batch, rebuild=True)
        a2 = pc.audit_plane(fixed[0], fixed[1])
        check(pc.audit_ok(a2) and torch.equal(fixed[1].keys, plane3.keys),
              f"the rebuild epoch left {pc.audit_summary(a2)}")
        flips.append(f"{field} {recs[0][1]} bit {recs[0][2]}: "
                     f"{pc.audit_summary(a)}")
    print(f"[5c] audit of the served plane: {audit_ms:.3f} ms, audit OK; "
          f"each flip caught in its field and repaired by one rebuild "
          f"epoch: {'; '.join(flips)}", flush=True)

    # ---- phase 5d: the KV page index at a real size -------------------
    clock.start("5d")
    # the pool as the JAX package sizes it for minitron-8b on this card:
    # 32 layers x 8 kv heads x 128 x (K, V) x bf16 = 128 KiB a token;
    # 28672 pages of 16 tokens (56 GiB of KV beside 16 GB of weights);
    # index_width from n_pages, epochs of 256
    kv_tok = minitron.n_layers * minitron.n_kv * minitron.head_dim * 2 * 2
    n_pages, page_size = KV_PAGES, KV_PAGE_SIZE
    plan = fl.FaultPlan(seed=11, events=[
        fl.FaultEvent(47, fl.FAULT_BITFLIP, 1),     # an audited epoch
        fl.FaultEvent(60, fl.FAULT_TELEMETRY, 4)])
    dpool = PagedKVPool(n_pages, page_size, device=True, index_batch=256,
                        audit_every=16, fault_plan=plan, torch_device=dev)
    hpool = PagedKVPool(n_pages, page_size)
    check(dpool.index_width == n_pages, f"index width {dpool.index_width}")
    kv_ms = {"flush": [], "lookup": [], "predecessor": [], "range": []}
    kv_log = []                 # the host pool's answers, for phase 9
    rpool = None                # the pool restored from a snapshot
    snap_launches = {}          # the launches the restored pool made
    kv_snap = util = None

    def both(fn, timed=None):
        t = time.perf_counter()
        got = fn(dpool)
        torch.cuda.synchronize()
        if timed:
            kv_ms[timed].append(1e3 * (time.perf_counter() - t))
        got, want = as_plain(got), as_plain(fn(hpool))
        kv_log.append(want)
        check(got == want, f"the device pool answers {got} where the host "
              f"pool answers {want}")
        if rpool is not None:
            before = ops.launch_counts()
            again = fn(rpool)
            torch.cuda.synchronize()
            for k, v in ops.launch_counts().items():
                snap_launches[k] = snap_launches.get(k, 0) + v - before[k]
            again = as_plain(again)
            check(again == got, f"the restored pool answers {again} where "
                  f"the uninterrupted one answers {got}")
        return got

    def on_step(step):
        nonlocal rpool, kv_snap, util
        if step == "admitted":
            util = dpool.utilization
        elif step == 34:
            # midway, four ops buffered and the audit cadence at its
            # start (the snapshot does not carry the lookups since the
            # last audit; here there are none), after both faults fired
            check(len(dpool._pending) == 4 and dpool._since_audit == 0,
                  f"snapshot point: {len(dpool._pending)} pending ops, "
                  f"{dpool._since_audit} lookups since the last audit")
            rpool, kv_snap = snapshot_round_trip(torch, dpool, dev)

    ops.reset_launch_counts()
    t5d = time.perf_counter()
    n_scan = kv_drive(both, wl, on_step)
    kv_s = time.perf_counter() - t5d
    read_launches("kv_index", ("splay_search_tiered", "splay_fold"))
    path_launches["kv_index"] = {k: v - snap_launches.get(k, 0) for k, v
                                 in path_launches["kv_index"].items()}
    path_launches["snapshot"] = dict(snap_launches)
    print(f"    launches on path kv_index without the restored pool's: "
          f"{path_launches['kv_index']}", flush=True)
    check(sorted(dpool.chains) == sorted(hpool.chains) and all(
        dpool.chains[s] == hpool.chains[s] for s in hpool.chains),
          "the pools' chains differ")
    check(rpool.chains == dpool.chains and rpool.free == dpool.free
          and rpool.stats == dpool.stats,
          f"after the trace the restored pool's chains, free list or stats "
          f"differ from the uninterrupted pool's: {rpool.stats} != "
          f"{dpool.stats}")
    check(snap_launches["splay_fold"] > 0 and
          snap_launches["splay_search_tiered"] > 0,
          f"the restored pool did not launch B1 and F: {snap_launches}")
    print(f"[5d] snapshot at decode step 34 (lookup epoch "
          f"{kv_snap['lookup_no']}, {kv_snap['pending']} ops buffered): "
          f"{kv_snap['bytes']} B on disk in {kv_snap['files']} files; save "
          f"{kv_snap['sync_ms']:.3f} ms to the host then "
          f"{kv_snap['write_ms']:.3f} ms to write, restore "
          f"{kv_snap['restore_ms']:.3f} ms (load, SHA-256, to the card); "
          f"the restored pool answered the rest of the trace, every verdict "
          f"equal to the uninterrupted pool's and the host pool's; chains, "
          f"free list and stats equal; its launches {snap_launches}",
          flush=True)
    st5d = dict(dpool.stats)
    check(st5d["audit_failures"] >= 1 and st5d["repairs"] >= 1
          and st5d["faults_injected"] == 2 and st5d["telemetry_dropped"] >= 1,
          f"the fault ladder did not run: {st5d}")
    kv_audit_ms, _ = host_ms(dpool.audit)
    print(f"[5d] KV page index (minitron-8b: {kv_tok} B of KV a token, "
          f"{n_pages} pages x {page_size} = "
          f"{n_pages * page_size * kv_tok / 2 ** 30:.1f} GiB; index width "
          f"{dpool.index_width}, epochs of 256): 3584 sessions of 7 pages "
          f"admitted (utilization {util:.4f}), 64 decode steps of 256 Zipf "
          f"lookups with 2 creates and 2 releases, a {n_scan}-op "
          f"scan trace; {kv_s:.1f} s; every answer and the chains equal "
          f"the host pool's, under a bitflip at lookup epoch 47 and a "
          f"telemetry blackout at 60", flush=True)
    print(f"[5d] ms per lookup batch of 256 {np.mean(kv_ms['lookup']):.3f},"
          f" per flush epoch {np.mean(kv_ms['flush']):.3f}, per audit "
          f"{kv_audit_ms:.3f}, per predecessor {np.mean(kv_ms['predecessor']):.3f}"
          f", per range query {np.mean(kv_ms['range']):.3f} (host clock, "
          f"synchronised); stats {st5d}", flush=True)

    # ---- phase 5e: the model zoo and the serving engine -----------------
    clock.start("5e")
    job13 = models_phase(torch, dev, read_launches, path_launches, minitron)

    # ---- phase 13: the models on a mesh (on 5e's weights) ---------------
    clock.start("13")
    mesh_by_rank = mesh_phase(torch, dev, job13, "gloo")
    del job13

    # phase 15's CPU side runs from here, beside phases 14 to 12
    cpu15 = kernels_bench_cpu()

    # ---- phase 14: the other model families on a mesh -------------------
    clock.start("14")
    phi14, others14 = family_configs()
    moe_by_rank = family_phase(
        torch, dev, family_job(torch, dev, phi14, others14, card),
        "gloo")

    # ---- phase 5f: training ---------------------------------------------
    clock.start("5f")
    train_phase(torch, dev, read_launches, card)

    # ---- phase 6: timings at the main path's shapes ---------------------
    clock.start("6")
    kernels = []

    int_ops, n_sm, max_mhz = int_rate(torch)
    print(f"[6] int32 rate {int_ops:.4e} ops/s ({n_sm} SMs x "
          f"{INT32_PER_SM_CLK} x {max_mhz} MHz, clocks.max.sm)", flush=True)

    def bound(nbytes, nops):
        b_ms, o_ms = 1e3 * nbytes / MEM_BW, 1e3 * nops / int_ops
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    def entry(name, path, source, replaces, ms, plain_ms, nbytes, nops,
              library_ms=None, **extra):
        bound_ms, bound_by = bound(nbytes, nops)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches[path][name], path=path,
            launches_by_path={p: c[name] for p, c in path_launches.items()},
            max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, **extra))

    # one thread chasing i = next[i] through a random cycle (phase 8 uses
    # it too): ns per dependent load from an array that stays in L2 (4 MB,
    # read once first) and from one five times the L2 (256 MB).
    # B1 and B2 on the main path's inputs (scripts/search_timing.py): the
    # device time per launch from a trace (ms), per call by CUDA-graph
    # replay, and the eager loop of wrapper calls; beside them the
    # plane's widths, the rows each query and each warp walks, and the
    # chain figure: the longest chain of dependent global loads of one
    # lane x the chase's ns per dependent load in L2.  Bound: the
    # queries, the outputs, the widths and the distinct plane entries the
    # lanes' windows hold in the arrays the kernel reads, and one compare
    # per candidate plus the hit's per row walked
    chase = {"l2": calibrate.chase_ns(1 << 20, 20000),
             "hbm": calibrate.chase_ns(1 << 26, 20000)}
    q1 = torch.as_tensor(keys[0], device=dev)
    q5 = q5s[0]
    for name, path, pl, q, call, plain_fn, line, arrays, n_blocks in (
            ("splay_search_tiered", "paper_serving", plane3, q1, stm.b1_call,
             lambda: ssk.splay_search_tiered_plain(
                 plane3.keys, plane3.rank_map, plane3.widths, q1), 272, 2,
             0),
            ("splay_search_pipelined", "w16384_serving", pl5, q5,
             stm.b2_call, lambda: ssk.splay_search_pipelined_plain(
                 pl5.keys, pl5.rank_map, pl5.widths, pl5.bot_rank, q5, B5,
                 256), 480, 3, B5 // 256)):
        fn = call(ssk, pl, q)
        traced_k, n_traced = stm.traced_ms(torch, fn)
        g_ms = stm.graph_ms(torch, fn)
        eager = stm.eager_ms(torch, fn, 50)
        plain = stm.eager_ms(torch, plain_fn, 3, 1)
        got, want = fn(), plain_fn()
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"{name} disagrees on the main path's inputs (err {e})")
        widths = pl.widths.tolist()
        st_ = stm.descent_stats(torch, pl, q, exits=arrays == 3)
        nq = q.shape[0]
        nbytes = 13 * nq + 4 * len(widths) + 4 * arrays * st_["entries"] \
            + 4 * n_blocks
        chain = stm.chain_us(st_["chain_loads"], chase["l2"])
        entry(name, path, "src/repro_torch/kernels/csrc/splay_search.cu",
              f"src/repro/kernels/splay_search.py:{line}", traced_k, plain,
              nbytes, st_["compares"], ms_is="device time per launch, "
              "traced", graph_ms=g_ms, eager_ms=eager,
              traced_launches=n_traced, chain_loads=st_["chain_loads"],
              chain_us=chain, rows_walked_mean=st_["rows_mean"],
              warp_rows_max_mean=st_["warp_max_mean"],
              warps_to_bottom=st_["warps_to_bottom"])
        k = kernels[-1]
        print(f"[6] {name} W={pl.keys.shape[1]} L={len(widths)} q={nq}: "
              f"{traced_k:.5f} ms per launch (traced, {n_traced} launches), "
              f"{g_ms:.5f} by graph replay, eager loop {eager:.5f}; plain "
              f"{plain:.3f} ms; bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}); widths {widths}; rows walked until "
              f"resolved per query {st_['rows_mean']:.3f}, per warp (max) "
              f"{st_['warp_max_mean']:.3f}, warps reaching the bottom row "
              f"{st_['warps_to_bottom']:.3f}; longest chain "
              f"{st_['chain_loads']} dependent loads x {chase['l2']:.1f} ns "
              f"= {chain:.3f} us (the parent's binary walk "
              f"{st_['parent_chain_loads']} loads = "
              f"{stm.chain_us(st_['parent_chain_loads'], chase['l2']):.3f}"
              " us)", flush=True)

    # B5: one batch over the served W=16384 plane; its work is one int32
    # compare for each element of every row the reference's block runs
    # (all rows until the block's lanes are all found, then the bottom
    # row), per query.  The count of a row's compares needs no add per
    # element (a warp ballot and popc count 32 at once), so the bound
    # counts the compares alone; the bound with an add beside each
    # compare, and the fp32-rate bound of the earlier runs, are printed
    # beside it
    ms = stm.eager_ms(torch, lambda: ssk._splay_search_full_arrays(
        pl5.keys, q5, 256), 20)
    q5p = ssk._pad_queries(q5, 256)
    plain = stm.eager_ms(torch, lambda: ssk.splay_search_full_plain(
        pl5.keys, q5p, 256), 3, 1)
    f_got = ssk._splay_search_full_arrays(pl5.keys, q5, 256)
    f_want = ssk.splay_search_full_plain(pl5.keys, q5p, 256)
    e = max_abs_err(f_got, (w[:B5] for w in f_want))
    check(e == 0, f"B5 disagrees on the main path's inputs (err {e})")
    n_lv, w5 = pl5.keys.shape
    lv_b = f_want[2].view(-1, 256)
    rows_run = torch.where(f_want[0].view(-1, 256).all(1),
                           torch.clamp(lv_b.max(1).values + 2, max=n_lv),
                           n_lv)
    compares = int(rows_run.sum()) * 256 * w5
    b5_bytes = 4 * n_lv * w5 + 13 * B5
    old_bound = max(1e3 * b5_bytes / MEM_BW, 1e3 * compares / FP32_OPS)
    add_bound = bound(b5_bytes, 2 * compares)[0]
    plan5 = ssk.full_plan(w5, n_lv)
    entry("splay_search_full", "full_search", "src/repro_torch/kernels/"
          "csrc/splay_search.cu", "src/repro/kernels/splay_search.py:1284",
          ms, plain, b5_bytes, compares, compares=compares,
          compare_add_bound_ms=add_bound, fp32_bound_ms=old_bound,
          cluster=plan5.cluster,
          slice=plan5.slice, smem=plan5.smem)
    b5 = kernels[-1]
    print(f"[6] B5 W={w5} L={n_lv} q={B5}: {ms:.4f} ms, plain {plain:.4f} "
          f"ms; {compares} compares the reference's row rule runs "
          f"({int(rows_run.sum())} of {n_lv * B5 // 256} block-rows); bound "
          f"{b5['bound_ms']:.4f} ms (one compare each at the int32 rate, "
          f"{b5['bound_by']}; {b5['bound_ms'] / ms:.3f} of it reached); "
          f"with an add beside each compare {add_bound:.4f} ms; the "
          f"fp32-rate bound {old_bound:.4f} ms (one op each at "
          f"{FP32_OPS:.0e}/s); cluster {plan5.cluster} x {plan5.slice} "
          f"columns, {plan5.smem} B shared memory a CTA", flush=True)

    # B4, B3 and the fused gather on the vocab tier's lookups; bytes: the
    # ids, each distinct row read once (a hot row is a table row), every
    # output row written once, and for the fused gather one hot-rank entry
    # per distinct id.  B4 and B3 run on the operands the reference's
    # composition (ops.hot_gather: B3 + B4 + a where-merge) hands them,
    # one prefill chunk (q=8192, d=4096, bfloat16).  Times are device
    # times per call from CUDA-graph replays (graph_ms); eager_ms is the
    # event-timed loop of eager calls (cuda_ms), as the other kernels are
    # timed, which also counts the host's launch cost.
    hot_buf = cache.hot_buffer(table)
    hot_rank = cache.hot_rank
    row_b = D * table.element_size()

    def composition(ids):
        r = hot_rank[take_index(ids, hot_rank.shape[0])]
        is_hot = r >= 0
        hot_out = hg.gather_hot(hot_buf, torch.clamp(r, min=0))
        cold_out = hg.gather_rows(table, torch.where(is_hot, 0, ids))
        return torch.where(is_hot[:, None], hot_out, cold_out)

    def distinct_rows(src_rows, idx):
        return int(torch.unique(take_index(idx, src_rows)).numel())

    pids = batches[-1]
    r = hot_rank[pids.long()]
    cold = torch.where(r >= 0, 0, pids)
    ranks = torch.clamp(r, min=0)
    ops.reset_launch_counts()
    comp_eager = stm.eager_ms(torch, lambda: composition(pids), 50)
    read_launches("composition", ("gather_hot", "gather_rows"))
    for name, fn, src, idx, path in (
            ("gather_rows", hg.gather_rows, table, cold, "vocab_tier"),
            ("gather_hot", hg.gather_hot, hot_buf, ranks, "composition")):
        idx_l = idx.long()
        eager = stm.eager_ms(torch, lambda: fn(src, idx), 50)
        ms = stm.graph_ms(torch, lambda: fn(src, idx))
        plain = stm.graph_ms(torch, lambda: hg.gather_rows_ref(src, idx))
        lib = stm.graph_ms(torch, lambda: torch.index_select(src, 0, idx_l))
        e = row_err(fn(src, idx), torch.index_select(src, 0, idx_l))
        check(e == 0.0, f"{name} disagrees with index_select (err {e})")
        n_rows = distinct_rows(src.shape[0], idx)
        entry(name, path, "src/repro_torch/kernels/csrc/"
              "hot_gather.cu", "src/repro/kernels/hot_gather.py:"
              + ("27" if name == "gather_rows" else "56"), ms, plain,
              4 * idx.numel() + (n_rows + idx.numel()) * row_b, 0, lib,
              eager_ms=eager, copy_path=hg.LAST_PATH[name])
        print(f"[6] {name} q={idx.numel()} d={D} bf16: {n_rows} distinct "
              f"rows; {ms:.4f} ms (eager loop {eager:.4f}), plain "
              f"{plain:.4f}, index_select {lib:.4f} ms; copy path "
              f"{hg.LAST_PATH[name]}", flush=True)

    # the fused gather on a prefill chunk and a decode batch, beside its
    # plain version, the reference's composition and index_select(table,
    # 0, ids) (the same function: the hot buffer holds table rows)
    fused = {}
    for ids in (pids, batches[0]):
        ids_l = ids.long()
        nq = ids.numel()
        eager = stm.eager_ms(torch, lambda: hg.hot_gather(
            table, hot_buf, hot_rank, ids), 50)
        ms = stm.graph_ms(torch, lambda: hg.hot_gather(
            table, hot_buf, hot_rank, ids))
        plain = stm.graph_ms(torch, lambda: hg.hot_gather_ref(
            table, hot_buf, hot_rank, ids))
        comp = stm.graph_ms(torch, lambda: composition(ids))
        lib = stm.graph_ms(torch, lambda: torch.index_select(table, 0, ids_l))
        got = hg.hot_gather(table, hot_buf, hot_rank, ids)
        check(torch.equal(got, torch.index_select(table, 0, ids_l)),
              f"the fused gather q={nq} differs from index_select")
        check(torch.equal(composition(ids), got),
              f"the composition q={nq} differs from the fused gather")
        n_ids = distinct_rows(V, ids)
        nbytes = ids.numel() * ids.element_size() + 4 * n_ids \
            + (n_ids + nq) * row_b
        b_ms, _ = bound(nbytes, 0)
        fused[nq] = dict(ms=ms, eager_ms=eager, plain_ms=plain,
                         composition_ms=comp, library_ms=lib, bound_ms=b_ms,
                         nbytes=nbytes)
        hit = float((hot_rank[ids_l] >= 0).float().mean())
        print(f"[6] hot_gather (fused) q={nq} d={D} bf16: {n_ids} distinct "
              f"rows, hit rate {hit:.4f}; {ms:.4f} ms (eager loop "
              f"{eager:.4f}), plain {plain:.4f} ms, the reference's "
              f"composition "
              f"{comp:.4f} ms (eager loop {comp_eager:.4f} at q=8192), "
              f"index_select {lib:.4f} ms, bound {b_ms:.4f} ms; copy path "
              f"{hg.LAST_PATH['hot_gather']}", flush=True)
    f8 = fused[pids.numel()]
    entry("hot_gather", "vocab_tier", "src/repro_torch/kernels/csrc/"
          "hot_gather.cu", "src/repro/kernels/ops.py:148 (over "
          "src/repro/kernels/hot_gather.py:27 and :56)", f8["ms"],
          f8["plain_ms"], f8["nbytes"], 0, f8["library_ms"],
          eager_ms=f8["eager_ms"], composition_ms=f8["composition_ms"],
          copy_path=hg.LAST_PATH["hot_gather"],
          q256={k: v for k, v in fused[batches[0].numel()].items()
                if k != "nbytes"})

    # L2 residency of the hot buffer: an all-hot chunk (q=8192 ids drawn
    # uniformly over the 4096 hot ids) right after an all-cold chunk of
    # 8192 distinct rows, so each starts after 67 MB of output and 67 MB
    # of cold rows went through L2; by difference of the pair and the
    # cold chunk alone.  The same with index_select over the hot buffer's
    # rows in place of the fused gather, and beside both, the card's own
    # write and copy rates (zero_ and copy_ of a 67 MB block)
    hot_ids_t = torch.as_tensor(cache.hot_ids, device=dev)
    l2_gen = torch.Generator(device=dev).manual_seed(3)
    hot_chunk = hot_ids_t[torch.randint(0, H, (8192,), generator=l2_gen,
                                        device=dev)].to(torch.int32)
    cold_pool = torch.nonzero(hot_rank < 0).flatten()
    cold_chunk = cold_pool[torch.randperm(
        cold_pool.numel(), generator=l2_gen, device=dev)[:8192]].to(
            torch.int32)
    hot_ranks_l = hot_rank[hot_chunk.long()].long()

    def cold_call():
        hg.hot_gather(table, hot_buf, hot_rank, cold_chunk)

    cold_only = stm.graph_ms(torch, cold_call)
    l2 = {}
    for name, fn in (
            ("fused", lambda: hg.hot_gather(table, hot_buf, hot_rank,
                                            hot_chunk)),
            ("index_select", lambda: torch.index_select(hot_buf, 0,
                                                        hot_ranks_l))):
        def pair():
            cold_call()
            fn()
        l2[name] = (stm.graph_ms(torch, pair) - cold_only,
                    stm.graph_ms(torch, fn))
    block = torch.empty((8192, D), dtype=table.dtype, device=dev)
    zero_ms = stm.graph_ms(torch, lambda: block.zero_())
    copy_ms = stm.graph_ms(torch, lambda: block.copy_(table[:8192]))
    n_hot_rows = int(torch.unique(hot_chunk).numel())
    print(f"[6] L2 probe (all-hot chunk, {n_hot_rows} distinct hot rows): "
          f"after an all-cold chunk (by difference; cold chunk alone "
          f"{cold_only:.4f} ms) fused {l2['fused'][0]:.4f} ms, index_select "
          f"{l2['index_select'][0]:.4f} ms; alone fused {l2['fused'][1]:.4f}"
          f" ms, index_select {l2['index_select'][1]:.4f} ms; write-only "
          f"bound {bound(8192 * row_b, 0)[0]:.4f} ms, with the rows from "
          f"HBM {bound((8192 + n_hot_rows) * row_b, 0)[0]:.4f} ms; the card's"
          f" zero_ of 67.1 MB {zero_ms:.4f} ms, copy_ of 67.1 MB "
          f"{copy_ms:.4f} ms", flush=True)
    del block

    # F's inputs for phases 7 and 8: one paper-scale serving epoch's fold
    # list, and the vocab tier's stream state after its 32 flushes
    # (phase 7 flushes again; run_serving leaves this state as it is)
    entries = sx.fold_entries(st3, keys[0], upd[0], aggregate=True)[0]
    vst = cache._stream_st

    # ---- phase 7: where a paper-scale serving epoch's time goes ---------
    clock.start("7")
    k0 = torch.as_tensor(keys[0], device=dev)
    u0 = torch.as_tensor(upd[0], device=dev)
    work = sx.clone(st3)
    layers = {
        "search": lambda: ops.splay_search(plane3, k0),
        "W (find_batch)": lambda: sx.find_batch(st3, k0),
        "fold_entries": lambda: sx.fold_entries(st3, k0, u0, True),
        "state_clone": lambda: sx.clone(st3),
        "fold_kernel": lambda: fold.fold_weighted(sx.clone(work), *entries),
        "refresh": lambda: dix.refresh_device(work, plane3, max_new=B,
                                              return_overflow=True),
        "epoch": lambda: sx.run_epoch(st3, plane3, kinds[0], keys[0],
                                      upd[0], aggregate=True,
                                      plane_search=True),
    }
    split = {}
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        split[name] = round(1e3 * (time.perf_counter() - t) / 5, 4)
    print(f"[7] one epoch, host clock ms (fold_kernel includes a state "
          f"clone; fold_entries includes W): {split}", flush=True)
    traced(torch, "epoch", layers["epoch"], split["epoch"])

    # the vocab tier: one prefill-chunk lookup (one fused gather), the
    # same chunk through the reference's composition, and one stream flush
    tier = {"lookup": lambda: cache.lookup(table, batches[-1]),
            "lookup as the reference composes it":
                lambda: composition(batches[-1]),
            "flush": lambda: cache.observe_serving(flushes[0])}
    for name, fn in tier.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        traced(torch, f"vocab-tier {name}", fn,
               round(1e3 * (time.perf_counter() - t) / 5, 4))

    # ---- phase 8: kernel F on its three paths, traced ------------------
    clock.start("8")
    # Last, after phase 7's traces: on the H100 a profiler session that
    # follows earlier ones in the process has missed its first device
    # activity (one launch of ten here; phase 7's one-kernel lookup
    # trace came out empty), so F's traces run after phase 7's.  The
    # prefill (one launch) again on a fresh state; then, twice, one
    # serving epoch's aggregated fold list on the paper-scale state and
    # its w > 0 subset, and one vocab-tier stream epoch's op list on the
    # tier's state (V + 2 slots, 33 levels)
    st8 = sx.make(capacity=ft.PAPER_CAPACITY, max_level=ft.PAPER_LEVELS,
                  device=dev)
    _, pre_k = ft.kernel_ms(torch, lambda: sx.run_ops(st8, *pre_args))
    check(len(pre_k) == 1, f"the prefill's trace holds {len(pre_k)} F "
          "launches of 1")
    prefill_k = pre_k[0]
    del st8
    vops = ft.tier_epoch_ops(torch, sx, wl, V, dev)
    f_runs = {}
    f_states = []
    for _ in range(2):
        out_f, f_steps = ft.fold_paths(torch, sx, fold, st3, entries, vst,
                                       vops)
        for name, r in out_f.items():
            f_runs.setdefault(name, []).append(r)
            f_states.append((name, r["state"]))
            check(r["launches"] > 0, f"the trace of F on {name} holds "
                  "no launch of the kernel")
    changed = sum(int((a != b).sum()) * a.element_size()
                  for a, b in zip(st3, f_states[0][1]))
    n_entries = int(entries[0].shape[0])
    n_weighted = int((entries[1] > 0).sum())
    t = time.perf_counter()
    plain_st = cpu_state(st3)
    fold.fold_weighted(plain_st, *(x.cpu() for x in entries))
    f_plain = 1e3 * (time.perf_counter() - t)
    plain_v = cpu_state(vst)
    vres = torch.zeros((B6,), dtype=torch.int32)
    fold.fold_ops(plain_v, *(x.cpu() for x in vops), vres,
                  torch.zeros_like(vres))
    for name, got in f_states:
        want = plain_v if name == "vocab_epoch" else plain_st
        e = state_err(got, want)
        check(e == 0, f"F disagrees with its plain version on {name} "
              f"(err {e})")
    f_k = {k: [r["kernel_ms"] for r in v] for k, v in f_runs.items()}
    f_n = {k: [r["launches"] for r in v] for k, v in f_runs.items()}
    f_call = {k: [r["call_ms"] for r in v] for k, v in f_runs.items()}
    fm = {k: float(np.mean(v)) for k, v in f_k.items()}
    ns_step = {"epoch": 1e6 * fm["epoch_full"] / f_steps["epoch"],
               "vocab_epoch": 1e6 * fm["vocab_epoch"]
               / f_steps["vocab_epoch"],
               "prefill": 1e6 * prefill_k / pre_steps}

    entry("splay_fold", "paper_serving", "src/repro_torch/kernels/csrc/"
          "splay_fold.cu", "src/repro/core/splaylist.py:629",
          fm["epoch_full"], f_plain, 12 * n_entries + 2 * changed, 0,
          ms_is="device time per launch, traced",
          call_ms=float(np.mean(f_call["epoch_full"])),
          subset_ms=fm["epoch_subset"], vocab_epoch_ms=fm["vocab_epoch"],
          prefill_ms=prefill_k, ns_per_step=ns_step,
          walk_steps=dict(f_steps, prefill=pre_steps), chase_ns=chase,
          ordered_list_err=ordered_err, ordered_op_ms=per_op["ordered"],
          find_only_op_ms=per_op["find_only"],
          ordered_op_bound_ms=ord_bound)

    def rnd(xs):
        return [round(x, 4) for x in xs]

    print(f"[8] F epoch fold: {n_entries} entries, {n_weighted} weighted; "
          f"device ms per launch (traced): full list {fm['epoch_full']:.4f}"
          f", its w > 0 subset {fm['epoch_subset']:.4f} (runs "
          f"{rnd(f_k['epoch_full'])} / {rnd(f_k['epoch_subset'])}, over "
          f"{f_n['epoch_full']} / {f_n['epoch_subset']} traced launches of "
          f"10); ms per wrapper call (events over a loop): "
          f"{rnd(f_call['epoch_full'])} / {rnd(f_call['epoch_subset'])}; "
          f"plain fold {f_plain:.1f} ms on the host CPU (a scalar loop)",
          flush=True)
    print(f"[8] F vocab-tier epoch fold {fm['vocab_epoch']:.4f} ms per "
          f"launch (runs {rnd(f_k['vocab_epoch'])}, over "
          f"{f_n['vocab_epoch']} traced launches of 10; per call "
          f"{rnd(f_call['vocab_epoch'])}); prefill launch {prefill_k:.3f} "
          f"ms (traced; {prefill_ms:.3f} ms by events in phase 3); ns per "
          f"walk step: epoch "
          f"{ns_step['epoch']:.1f} ({f_steps['epoch']} find steps of the "
          f"weighted keys), vocab epoch {ns_step['vocab_epoch']:.1f} "
          f"({f_steps['vocab_epoch']} plen steps), prefill "
          f"{ns_step['prefill']:.1f} ({pre_steps} plen steps; an insert "
          f"walks about three times)", flush=True)
    print(f"[8] pointer chase, one thread: {chase['l2']:.1f} ns per "
          f"dependent load in L2 (4 MB), {chase['hbm']:.1f} ns from a "
          f"256 MB array; all F states equal their plain folds, so the "
          f"full list's equal the subset's", flush=True)

    # ---- phase 5f's traced train step, after the other traces -----------
    clock.start("5f trace")
    import train_step_profile as tsp
    tr = tsp.profile_train_step(torch, dev)
    busy = ("not measured (the trace held no device activity)"
            if tr["device_busy_ms"] is None else
            f"{tr['device_busy_ms']:.4f} ms over {tr['kernels_per_step']} "
            f"kernels, idle share {tr['idle_share']:.4f}; top kernels "
            + "; ".join(f"{k} x{c} {ms:.4f} ms"
                        for k, c, ms in tr["top_kernels"][:5]))
    print(f"[5f] one qwen2-0.5b train step, 8 x 512 "
          f"(scripts/train_step_profile.py): host {tr['host_ms']:.4f} ms, "
          f"events {tr['event_ms']:.4f} ms (medians of {tr['steps']}), "
          f"{tr['aten_ops_per_step']} ATen ops, traced device busy {busy}; "
          f"6NT bound {tr['bound_ms']:.4f} ms", flush=True)

    # ---- phase 9: the width-sharded index -------------------------------
    clock.start("9")
    job = sharded_job(torch, dev, served3, kv_log, dict(hpool.chains))
    by_rank = sharded_phase(torch, dev, job, "gloo")

    # ---- phase 10: the paper's Figs. 3-5 on the card --------------------
    clock.start("10")
    sc10 = scaling_phase(torch, dev, read_launches)

    # ---- phase 11: kernel W, the state walk -----------------------------
    clock.start("11")
    w11 = walk_phase(torch, dev, st3, k0, sc10["starts"], chase["l2"],
                     stm.graph_ms, stm.eager_ms)
    errs.update(w11["errs"])

    # ---- phase 12: the example entry points ------------------------------
    clock.start("12")
    ex_by_rank = examples_phase(torch, dev, read_launches)

    # ---- phase 15: the benchmark twins ---------------------------------
    clock.start("15")
    drivers_by_path = drivers_phase(torch, dev, read_launches, card,
                                    cpu=cpu15)

    # ---- phases 16-17: the sequence layouts, the dry-run, the sharded
    # train step (one world) ------------------------------------------------
    clock.start("16+17")
    seq_ranks = seq_phase(torch, dev, card)
    clock.start("entries")

    pop, mix = sc10["populate"], sc10["mixed"]
    for k in kernels:
        for path in ("paper_scaling", "examples_quickstart",
                     "examples_workloads", "examples_train",
                     "examples_serve_engine"):
            k["launches_by_path"][path] = path_launches[path][k["name"]]
    # bound: the op list read (kind, key, height) and the answers written
    # (res, plen), and the state entries the fold changed, read and
    # written
    # S's latency floor: (the finds' path lengths + 2 x the inserts)
    # dependent loads x the chase's ns in L2 (a populate has no finds)
    s_floor = {k: (sc10[k].get("walk_steps", 0) + 2 * sc10[k].get(
        "inserts", sc10[k]["ops"])) * chase["l2"] * 1e-6
        for k in ("populate", "descending", "shuffled", "mixed")}
    print(f"[10] S latency floor, (find steps + 2 x inserts) x "
          f"{chase['l2']:.1f} ns: " + ", ".join(
              f"{k} {v:.3f} ms (measured {sc10[k]['ms']:.3f})"
              for k, v in s_floor.items()), flush=True)
    entry("skip_fold", "paper_scaling", "src/repro_torch/kernels/csrc/"
          "skip_fold.cu", "src/repro/core/skiplist.py:253", pop["ms"],
          pop["plain_ms"], 17 * pop["ops"] + 2 * pop["changed"], 0,
          ms_is="one populate launch of 10^5 sorted inserts, events",
          latency_floor_ms=s_floor["populate"],
          descending_ms=sc10["descending"]["ms"],
          shuffled_ms=sc10["shuffled"]["ms"],
          mixed_ms=mix["ms"], mixed_plain_ms=mix["plain_ms"],
          mixed_ops=mix["ops"], mixed_walk_steps=mix["walk_steps"],
          mixed_bound_ms=bound(17 * mix["ops"] + 2 * mix["changed"], 0)[0],
          mixed_latency_floor_ms=s_floor["mixed"],
          splay_over_skip_ops_s=sc10["ratio"])
    # W: device time per launch by graph replay; bound: the keys read,
    # the slots and steps written and each distinct state entry the
    # walks read, once (walk_footprint); beside it the latency floor
    for name, path, shape, line in (
            ("splay_walk", "paper_serving", "phase7",
             "src/repro/core/splaylist.py:157 (find, _eff_next :119)"),
            ("skip_walk", "paper_scaling", "99-1/B256",
             "src/repro/core/skiplist.py:160 (find)")):
        r = w11[name][shape]
        entry(name, path, "src/repro_torch/kernels/csrc/state_walk.cu",
              line, r["ms"], r["plain_ms"], r["nbytes"], 0,
              ms_is=f"device time per launch, graph replay, at {shape} "
              f"(q={r['nq']})", call_ms=r["call_ms"],
              longest_lane=r["longest"], latency_floor_ms=r["floor_ms"],
              serial_latency_floor_ms=r["serial_floor_ms"], block=sw.BLOCK,
              by_shape={k: {f: v[f] for f in ("ms", "longest", "floor_ms",
                                              "nq")}
                        for k, v in w11[name].items()})
    for k in kernels:
        k["launches_by_path"]["sharded"] = by_rank.get(k["name"], {})
        k["launches_by_path"]["examples_sharded"] = ex_by_rank.get(
            k["name"], {})
        k["launches_by_path"]["model_mesh_moe"] = moe_by_rank.get(
            k["name"], {})
        k["launches_by_path"]["model_mesh"] = mesh_by_rank.get(
            k["name"], {})
        k["launches_by_path"]["drivers_kernels"] = path_launches[
            "drivers_kernels"][k["name"]]
        for path, ranks in drivers_by_path.items():
            k["launches_by_path"][path] = {
                f"rank{i}": c[k["name"]] for i, c in enumerate(ranks)}
        k["launches_by_path"]["train_mesh"] = {
            f"rank{r['rank']}": r["t17_launches"].get(k["name"], 0)
            for r in seq_ranks}

    print(clock.line(), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase9_only(backend: str) -> None:
    """Phase 9 alone (``--phase9``), its references computed here: with
    ``--backend nccl`` one rank a card, so the machine needs four."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import build
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} device(s)", flush=True)
    if backend == "nccl" and torch.cuda.device_count() < SHARDED_RANKS:
        fail(f"--backend nccl needs {SHARDED_RANKS} cards")
    build.build()
    dev = torch.device("cuda")
    by_rank = sharded_phase(torch, dev, sharded_job(torch, dev), backend)
    print(json.dumps({"sharded_launches": by_rank}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase13_only(backend: str) -> None:
    """Phase 13 alone (``--phase13``), its inputs computed here as phase
    5e computes them (:func:`minitron16`, its device-indexed
    engine on the 8 requests): with ``--backend nccl`` one rank a card,
    so the machine needs four."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs.minitron_8b import CONFIG as minitron
    from repro_torch.core import workload as wl
    from repro_torch.kernels import build
    from repro_torch.serve.engine import Engine, Request
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} device(s)", flush=True)
    if backend == "nccl" and torch.cuda.device_count() < MESH_RANKS:
        fail(f"--backend nccl needs {MESH_RANKS} cards")
    build.build()
    dev = torch.device("cuda")
    cfg16, params = minitron16(torch, dev, minitron)
    arr = wl.poisson_zipf_arrivals(8, float("inf"), minitron.vocab,
                                   prompt_len=(2, 7), max_new=8, seed=0)
    eng = Engine(cfg16, params, max_batch=4, max_seq=128,
                 device_index=True, device=dev)
    for i in range(len(arr.seq_ids)):
        n_i = int(arr.prompt_lens[i])
        eng.submit(Request(seq_id=int(arr.seq_ids[i]),
                           prompt=arr.prompts[i, :n_i].copy(),
                           max_new=int(arr.max_new[i]),
                           arrival=int(arr.arrival[i])))
    with torch.no_grad():
        res = eng.run()
    job = mesh_job(torch, dev, params, cfg16, arr, eng, res, card)
    del params, eng
    by_rank = mesh_phase(torch, dev, job, backend)
    print(json.dumps({"model_mesh_launches": by_rank}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase14_only(backend: str) -> None:
    """Phase 14 alone (``--phase14``): with ``--backend nccl`` one rank
    a card, so the machine needs four."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import build
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} device(s)", flush=True)
    if backend == "nccl" and torch.cuda.device_count() < MESH_RANKS:
        fail(f"--backend nccl needs {MESH_RANKS} cards")
    build.build()
    dev = torch.device("cuda")
    t = time.perf_counter()
    phi, others = family_configs()
    by_rank = family_phase(torch, dev,
                           family_job(torch, dev, phi, others, card),
                           backend)
    print(f"[14] phase 14 alone: {time.perf_counter() - t:.1f} s ({card})",
          flush=True)
    print(json.dumps({"model_mesh_moe_launches": by_rank}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase15_only(backend: str) -> None:
    """Phase 15 alone (``--phase15``): with ``--backend nccl`` one rank
    a card, so the machine needs four."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} device(s)", flush=True)
    if backend == "nccl" and torch.cuda.device_count() < DRIVER_RANKS:
        fail(f"--backend nccl needs {DRIVER_RANKS} cards")
    build.build()
    path_launches = {}

    def read_launches(path, kernels):
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        path_launches[path] = counts
        print(f"    launches on path {path}: {counts}", flush=True)
        for name in kernels:
            check(counts[name] > 0, f"kernel {name} never launched on "
                  f"path {path}")

    by_path = drivers_phase(torch, torch.device("cuda"), read_launches,
                            card, backend)
    print(json.dumps({"drivers_launches": dict(
        by_path, drivers_kernels=path_launches["drivers_kernels"])}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase16_only(backend: str) -> None:
    """Phase 16 alone (``--phase16``); with ``--backend nccl`` only the
    link bandwidth over ``SEQ_RANKS`` cards (one rank a card)."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    card = card_line()
    print(f"card: {card}; {torch.cuda.device_count()} device(s)", flush=True)
    if backend == "nccl":
        if torch.cuda.device_count() < SEQ_RANKS:
            fail(f"--backend nccl needs {SEQ_RANKS} cards")
        print(json.dumps({"link_bw": link_bw_phase(torch, card)}))
    else:
        from repro_torch.kernels import build
        build.build()
        seq_phase(torch, torch.device("cuda"), card, parts=("16",))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase17_only() -> None:
    """Phase 17 alone (``--phase17``): its references, then the sharded
    train steps in a world of ``SEQ_RANKS`` gloo ranks of the card."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    card = card_line()
    print(f"card: {card}", flush=True)
    t = time.perf_counter()
    seq_phase(torch, torch.device("cuda"), card, parts=("17",))
    print(f"[17] phase 17 alone: {time.perf_counter() - t:.1f} s ({card})",
          flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase9", action="store_true",
                    help="run only phase 9, the width-sharded index")
    ap.add_argument("--phase13", action="store_true",
                    help="run only phase 13, the models on a mesh")
    ap.add_argument("--phase14", action="store_true",
                    help="run only phase 14, the other model families on "
                         "a mesh")
    ap.add_argument("--phase15", action="store_true",
                    help="run only phase 15, the benchmark twins")
    ap.add_argument("--phase16", action="store_true",
                    help="run only phase 16, the sequence layouts and the "
                         "dry-run (--backend nccl: the link bandwidth)")
    ap.add_argument("--phase17", action="store_true",
                    help="run only phase 17, the sharded train step")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the process-group backend of --phase9, --phase13, "
                         "--phase14, --phase15 and --phase16: gloo (every "
                         "rank on the one card) or nccl (one rank a card)")
    cli = ap.parse_args()
    try:
        if cli.phase9:
            phase9_only(cli.backend)
        elif cli.phase13:
            phase13_only(cli.backend)
        elif cli.phase14:
            phase14_only(cli.backend)
        elif cli.phase15:
            phase15_only(cli.backend)
        elif cli.phase16:
            phase16_only(cli.backend)
        elif cli.phase17:
            phase17_only()
        else:
            main()
    except CheckFailed as e:      # a failed check of scripts/card_checks.py
        fail(str(e))
