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
   OP_RANGE included); B3,
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
   greedy tokens; then minitron-8b at full width in bfloat16 (19.8 GB)
   served through ``Engine`` (max_batch 4, max_seq 128, 8 requests
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
   width with float32 compute (batch 1 x 64), on the card against the
   CPU (loss, grad_norm and each gradient leaf by ``Agreement``, the
   float64 witness being the CPU's run in float64); then qwen2-0.5b at
   full width as configured (bf16 compute, remat per block) through
   ``launch/train.main`` at batch 8 x 512: run A (10 steps), run B (6
   steps, a checkpoint at 6) and run C (resumed at 6, to 10), into a
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
7. one paper-scale epoch layer by layer (host clock), and once under
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
   after phase 7's, which they would otherwise disturb.

Each path reads its own launch counts: they are zeroed just before it
(phase 3's prefill and serving run, phase 4's ``run_serving``, phase
5's prefill and serving run, phase 5's full-width searches, phase 5b's
flushes and lookups, phase 5c's ordered run, phase 5d's pool, phase
5e's device-indexed engine, phase 5f's run A, phase 6's timed
composition) and read just after it, before any check or reference
run; the launches of the pools restored from snapshots (phases 5d and
5e) are counted apart, as path ``snapshot``.  Every kernel of a path must
have run on it; on the vocab tier the fused gather runs once per
lookup, B4 builds the hot buffer, and F runs at least once per stream
epoch.  The kernels line reports each kernel's launches on the path it
serves (B1 and F: phase 3, the main path; B2: phase 5; B5: phase 5's
full-width searches; B4 and the fused gather: phase 5b; B3, whose only
caller in the reference is the composition: phase 6's timed
composition); ``launches_by_path`` adds every other path, the
engine's, ``snapshot`` and ``train`` (which launches none of them)
among them.  Prints that JSON line, the card's ``name, power.limit``,
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
    end a caller that keeps only the error stream still sees), exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def train_phase(torch, dev, read_launches, card):
    """Phase 5f: training (host clocks and CUDA events only).  The ten
    archs at smoke width and qwen2-0.5b at full width in float32, one
    train step on the card against the CPU; then qwen2-0.5b at full
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
    agree = Agreement(torch, "qwen2-0.5b full width float32")
    t = time.perf_counter()
    share, leaf = train_step_check(
        torch, cfg32, p_cpu, train_batch(cfg32, np.random.default_rng(5),
                                         1, 64), dev, agree)
    rows.append(("qwen2-0.5b full width", agree, share, leaf))
    print(f"[5f] qwen2-0.5b at full width, float32 compute, batch 1 x 64: "
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
            lb = tmain.main(base + ["--steps", "6", "--ckpt-dir", d,
                                    "--ckpt-every", "6"])
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
          f"{[round(x, 1) for x in io['sync']]} ms to the host (the second "
          f"of run B also waits for the first write), writes "
          f"{[round(x, 1) for x in io['write']]} ms (runs B, B's final "
          f"re-save, C), load with SHA-256 {load_ms:.1f} ms; run B losses "
          f"{[round(x, 4) for x in lb]}; run C resumed at 6: first loss "
          f"{lc[0]!r} == one step from step 6's parameters on batch_at(6); "
          f"C's losses {[round(x, 4) for x in lc]} beside A's "
          f"{[round(x, 4) for x in la[6:]]} (AdamW's moments restart on "
          f"resume, as in the reference)", flush=True)


def models_phase(torch, dev, read_launches, path_launches, minitron):
    """Phase 5e: the model zoo and the serving engine (host clocks and
    CUDA events only).  Frees everything it builds."""
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
    cfg16 = dataclasses.replace(minitron, param_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    params = zoo.build_params(cfg16, seed=0, device=dev)
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
    print(f"[5e] minitron-8b bf16 full width through the engine "
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
        for k in ("splay_search_tiered", "splay_search_pipelined",
                  "splay_fold"):
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
        hand = ("splay_search_tiered", "splay_search_pipelined",
                "splay_fold")
        print(f"[9]   rank {r['rank']} launches (B1, B2, F) by run: "
              + "; ".join(f"{run} {[c[k] for k in hand]}"
                          for run, c in r["launches"].items()), flush=True)
        print(f"[9]   rank {r['rank']} memory: {r['memory']}", flush=True)
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
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.core.splay_cache import SplayVocabCache
    from repro_torch.kernels import build
    from repro_torch.kernels import calibrate
    from repro_torch.kernels import fold
    from repro_torch.kernels import hot_gather as hg
    from repro_torch.kernels import ops
    from repro_torch.kernels import splay_search as ssk
    from repro_torch.kernels.ref import take_index
    from repro_torch.serve.kv_cache import PagedKVPool

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, flush=True)

    # ---- phase 1: build ------------------------------------------------
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
    read_launches("paper_serving", ("splay_search_tiered", "splay_fold"))
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
    models_phase(torch, dev, read_launches, path_launches, minitron)

    # ---- phase 5f: training ---------------------------------------------
    train_phase(torch, dev, read_launches, card)

    # ---- phase 6: timings at the main path's shapes ---------------------
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
    k0 = torch.as_tensor(keys[0], device=dev)
    u0 = torch.as_tensor(upd[0], device=dev)
    work = sx.clone(st3)
    layers = {
        "search": lambda: ops.splay_search(plane3, k0),
        "find_batch": lambda: sx.find_batch(st3, k0),
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
          f"clone; fold_entries includes find_batch): {split}", flush=True)
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
    job = sharded_job(torch, dev, served3, kv_log, dict(hpool.chains))
    by_rank = sharded_phase(torch, dev, job, "gloo")
    for k in kernels:
        k["launches_by_path"]["sharded"] = by_rank.get(k["name"], {})

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


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase9", action="store_true",
                    help="run only phase 9, the width-sharded index")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="phase 9's process-group backend: gloo (every "
                         "rank on the one card) or nccl (one rank a card)")
    cli = ap.parse_args()
    try:
        if cli.phase9:
            phase9_only(cli.backend)
        else:
            main()
    except CheckFailed as e:      # a failed check of scripts/card_checks.py
        fail(str(e))
