#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases:

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print what ``-Xptxas -v`` reports;
2. each kernel against its plain PyTorch version on the same inputs,
   bit-exact on every output (the pipelined search's byte counter
   included): B1 tiered search at W=131072, L=24, q=65536; B2 pipelined
   search at W=16384 (64 tiles), W=1008 (16-lane tiles) and an odd
   batch; F update fold on a 2,000-key prefill plus 4 mixed epochs; B3,
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
   epoch over the inserted and deleted keys;
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
6. timings of each kernel at the main path's shapes beside its plain
   version, its bound and, where one PyTorch call computes the same
   function (``index_select`` for B3, B4 and the fused gather), that
   call; the fused gather at q=8192 and q=256 also beside the
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
   vocab-tier stream epoch; each with its ns per walk step, beside a
   one-thread pointer chase (``kernels/calibrate.py``: ns per
   dependent load in L2 and from a 256 MB array).  Its traces come
   after phase 7's, which they would otherwise disturb.

Each path reads its own launch counts: they are zeroed just before it
(phase 3's prefill and serving run, phase 4's ``run_serving``, phase
5's prefill and serving run, phase 5's full-width searches, phase 5b's
flushes and lookups, phase 6's timed composition) and read just after
it, before any check or reference run.  Every kernel of a path must
have run on it; on the vocab tier the fused gather runs once per
lookup, B4 builds the hot buffer, and F runs at least once per stream
epoch.  The kernels line reports each kernel's launches on the path it
serves (B1 and F: phase 3, the main path; B2: phase 5; B5: phase 5's
full-width searches; B4 and the fused gather: phase 5b; B3, whose only
caller in the reference is the composition: phase 6's timed
composition).  Prints that JSON line, the card's ``name,
power.limit``, and as the last line ``{"ok": true, "device":
{...}}``.  Exits nonzero, with no result line, on any failed check or
without a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s
FP32_OPS = 67e12          # H100 SXM non-tensor fp32 rate (the old bound)
INT32_PER_SM_CLK = 64     # int32 adds/compares per SM per clock (cc 9.0)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


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


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``rounds`` times between two events.  The host's cost
    of a call (tens of microseconds for a Python wrapper, as long as a
    gather of a few MB runs) stays out of it; :func:`cuda_ms` measures
    the longer of the two."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * rounds)


def traced(torch, name: str, fn, unprofiled_ms: float) -> None:
    """Run ``fn`` once under ``torch.profiler`` and print the device's
    busy time: the union of the intervals of the traced device
    activities (kernels, copies, memsets; an op's CPU event also carries
    its kernels' time and would count it twice), and its idle share of
    ``unprofiled_ms``, the same call's host-clock time unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kev)
    if not spans:
        print(f"[7] traced {name}: the profiler recorded no device "
              "activity (device busy share not measured)", flush=True)
        return
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(b - max(a, end), 0.0)
        end = max(end, b)
    busy_ms = busy_us / 1e3
    span_ms = (end - spans[0][0]) / 1e3
    by_name = {}
    for e in kev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"[7] traced {name}: {len(kev)} device activities, busy "
          f"{busy_ms:.4f} ms (union of their intervals) over a "
          f"{span_ms:.4f} ms device span; traced wall {wall_ms:.4f} ms; "
          f"idle share of the unprofiled call ({unprofiled_ms} ms) "
          f"{1 - busy_ms / unprofiled_ms:.4f}; top: "
          + "; ".join(f"{k[:60]} {us / 1e3:.4f} ms x{n}"
                      for k, (n, us) in top), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(1, str(HERE / "scripts"))
    import fold_timing as ft
    from repro_torch.configs.minitron_8b import CONFIG as minitron
    from repro_torch.core import device_index as dix
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

    plane, qs = fixture_plane(131072, 24, 65536, 0)
    qs = torch.cat([qs, torch.as_tensor(
        [ssk.NEG_INF_KEY, -1, 2 ** 24, ssk.PAD_KEY - 1], device=dev,
        dtype=torch.int32)])
    got = ssk._splay_search_arrays(plane.keys, qs, 256, plane.rank_map,
                                   plane.widths)
    want = ssk.splay_search_tiered_plain(
        plane.keys, plane.rank_map, plane.widths,
        ssk._pad_queries(qs, 256))
    torch.cuda.synchronize()
    e = max_abs_err(got, (w[:qs.shape[0]] for w in want))
    check(e == 0, f"B1 disagrees with its plain version (err {e})")
    errs["splay_search_tiered"] = e
    print(f"[2] B1 W=131072 L=24 q={qs.shape[0]}: equal", flush=True)

    b2_err = 0
    for width, n_levels, nq, qb in ((16384, 24, 8192, 256),
                                    (1008, 24, 4096, 256),
                                    (1008, 12, 1001, 128)):
        plane, qs = fixture_plane(width, n_levels, nq, width + nq)
        check(width // math.gcd(width, 256) <= 64, "B2 shape falls back")
        got = ssk._splay_search_pipelined_arrays(
            plane.keys, qs, qb, plane.rank_map, plane.widths,
            plane.bot_rank)
        want = ssk.splay_search_pipelined_plain(
            plane.keys, plane.rank_map, plane.widths, plane.bot_rank,
            ssk._pad_queries(qs, qb), nq, qb)
        torch.cuda.synchronize()
        e = max_abs_err(got, (*(w[:nq] for w in want[:3]), want[3]))
        check(e == 0, f"B2 W={width} q={nq} disagrees (err {e})")
        b2_err = max(b2_err, e)
        print(f"[2] B2 W={width} L={n_levels} q={nq} qb={qb}: equal "
              f"(bytes/block mean {got[3].float().mean().item():.0f})",
              flush=True)
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
    torch.cuda.synchronize()
    check(f_err == 0, f"F disagrees with its plain version (err {f_err})")
    errs["splay_fold"] = f_err
    print("[2] F 2000-key prefill + 4 mixed epochs + both contains "
          "folds: equal", flush=True)

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

    # ---- phase 6: timings at the main path's shapes ---------------------
    kernels = []

    def search_bytes(pl, nq, arrays, n_blocks=0):
        live = int(pl.widths.sum())
        return 4 * nq + 9 * nq + 4 * pl.n_levels + 4 * arrays * live \
            + 4 * n_blocks

    def search_ops(pl, nq):
        return nq * sum(max(int(w + 1).bit_length(), 1)
                        for w in pl.widths.tolist())

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

    q1 = torch.as_tensor(keys[0], device=dev)
    ms = cuda_ms(torch, lambda: ssk._splay_search_arrays(
        plane3.keys, q1, 256, plane3.rank_map, plane3.widths), 50)
    plain = cuda_ms(torch, lambda: ssk.splay_search_tiered_plain(
        plane3.keys, plane3.rank_map, plane3.widths, q1), 3, 1)
    e = max_abs_err(
        ssk._splay_search_arrays(plane3.keys, q1, 256, plane3.rank_map,
                                 plane3.widths),
        ssk.splay_search_tiered_plain(plane3.keys, plane3.rank_map,
                                      plane3.widths, q1))
    check(e == 0, f"B1 disagrees on the main path's inputs (err {e})")
    entry("splay_search_tiered", "paper_serving", "src/repro_torch/kernels/csrc/"
          "splay_search.cu", "src/repro/kernels/splay_search.py:272", ms,
          plain, search_bytes(plane3, B, 2), search_ops(plane3, B))

    q5 = q5s[0]
    ms = cuda_ms(torch, lambda: ssk._splay_search_pipelined_arrays(
        pl5.keys, q5, 256, pl5.rank_map, pl5.widths, pl5.bot_rank), 50)
    plain = cuda_ms(torch, lambda: ssk.splay_search_pipelined_plain(
        pl5.keys, pl5.rank_map, pl5.widths, pl5.bot_rank, q5, B5, 256),
        3, 1)
    e = max_abs_err(
        ssk._splay_search_pipelined_arrays(pl5.keys, q5, 256, pl5.rank_map,
                                           pl5.widths, pl5.bot_rank),
        ssk.splay_search_pipelined_plain(pl5.keys, pl5.rank_map, pl5.widths,
                                         pl5.bot_rank, q5, B5, 256))
    check(e == 0, f"B2 disagrees on the main path's inputs (err {e})")
    entry("splay_search_pipelined", "w16384_serving", "src/repro_torch/kernels/csrc/"
          "splay_search.cu", "src/repro/kernels/splay_search.py:480", ms,
          plain, search_bytes(pl5, B5, 3, B5 // 256), search_ops(pl5, B5))

    # B5: one batch over the served W=16384 plane; its work is one int32
    # compare for each element of every row the reference's block runs
    # (all rows until the block's lanes are all found, then the bottom
    # row), per query.  The count of a row's compares needs no add per
    # element (a warp ballot and popc count 32 at once), so the bound
    # counts the compares alone; the bound with an add beside each
    # compare, and the fp32-rate bound of the earlier runs, are printed
    # beside it
    ms = cuda_ms(torch, lambda: ssk._splay_search_full_arrays(
        pl5.keys, q5, 256), 20)
    q5p = ssk._pad_queries(q5, 256)
    plain = cuda_ms(torch, lambda: ssk.splay_search_full_plain(
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
    comp_eager = cuda_ms(torch, lambda: composition(pids), 50)
    read_launches("composition", ("gather_hot", "gather_rows"))
    for name, fn, src, idx, path in (
            ("gather_rows", hg.gather_rows, table, cold, "vocab_tier"),
            ("gather_hot", hg.gather_hot, hot_buf, ranks, "composition")):
        idx_l = idx.long()
        eager = cuda_ms(torch, lambda: fn(src, idx), 50)
        ms = graph_ms(torch, lambda: fn(src, idx))
        plain = graph_ms(torch, lambda: hg.gather_rows_ref(src, idx))
        lib = graph_ms(torch, lambda: torch.index_select(src, 0, idx_l))
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
        eager = cuda_ms(torch, lambda: hg.hot_gather(table, hot_buf,
                                                     hot_rank, ids), 50)
        ms = graph_ms(torch, lambda: hg.hot_gather(table, hot_buf, hot_rank,
                                                   ids))
        plain = graph_ms(torch, lambda: hg.hot_gather_ref(
            table, hot_buf, hot_rank, ids))
        comp = graph_ms(torch, lambda: composition(ids))
        lib = graph_ms(torch, lambda: torch.index_select(table, 0, ids_l))
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

    cold_only = graph_ms(torch, cold_call)
    l2 = {}
    for name, fn in (
            ("fused", lambda: hg.hot_gather(table, hot_buf, hot_rank,
                                            hot_chunk)),
            ("index_select", lambda: torch.index_select(hot_buf, 0,
                                                        hot_ranks_l))):
        def pair():
            cold_call()
            fn()
        l2[name] = (graph_ms(torch, pair) - cold_only, graph_ms(torch, fn))
    block = torch.empty((8192, D), dtype=table.dtype, device=dev)
    zero_ms = graph_ms(torch, lambda: block.zero_())
    copy_ms = graph_ms(torch, lambda: block.copy_(table[:8192]))
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
    # one thread chasing i = next[i] through a random cycle: ns per
    # dependent load from an array that stays in L2 (4 MB, read once
    # first) and from one five times the L2 (256 MB)
    chase = {"l2": calibrate.chase_ns(1 << 20, 20000),
             "hbm": calibrate.chase_ns(1 << 26, 20000)}

    entry("splay_fold", "paper_serving", "src/repro_torch/kernels/csrc/"
          "splay_fold.cu", "src/repro/core/splaylist.py:629",
          fm["epoch_full"], f_plain, 12 * n_entries + 2 * changed, 0,
          ms_is="device time per launch, traced",
          call_ms=float(np.mean(f_call["epoch_full"])),
          subset_ms=fm["epoch_subset"], vocab_epoch_ms=fm["vocab_epoch"],
          prefill_ms=prefill_k, ns_per_step=ns_step,
          walk_steps=dict(f_steps, prefill=pre_steps), chase_ns=chase)

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

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
