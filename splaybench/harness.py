"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

Everything that belongs to a configuration, a traffic mix or a
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` (a ``read(ctx)``
that returns the metric's value, or None when the run holds nothing for
it to read).  This module is the same for every cell.

The system under test is ``repro_torch``'s serving loop
(:class:`PortSystem`): ``run_serving`` one batch at a time, threading the
state and the plane from call to call, in a closed loop (batch ``i + 1``
is issued once batch ``i``'s answers are on the host).  A read-only mix
goes through the plane search and the weighted fold
(``aggregate=True, plane_search=True``), any other through the op-list
fold (``aggregate=False``).

The comparison costs the same however fast the program serves: the
reference replays the populate and the window's first
``check_batches`` batches (the traffic file's; the state and plane after
them are read back inside the window), and later batches are held only
to what needs no replay: a seeded sample of their answers against the
membership the writes leave, the final state's live keys, and the final
plane against the one the final state gives.  A traced run traces from
batch ``trace_from`` (the traffic file's; ``check_batches // 4`` where
it gives none) for at most a second, ending by batch ``check_batches``,
so that the work of the traced kernels is counted on the reference's
state.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from splaybench import checks, reference, yardstick
from splaybench.traffic import OP_CONTAINS, OP_INSERT, Traffic, mix_seed

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_BATCHES = 128      # batches the reference replays (``check_batches``)
TRACE_SLICE_S = 1.0      # the traced slice: at most a second, from batch
#                          trace_from, ending by batch check_batches
SAMPLE_EVERY = 16        # read path: one replayed batch in this many has
#                          its rows; past the replay, one batch in this
#                          many has its answers checked
COUNTED_BATCHES = 4      # traced run: batches whose work is counted
READ_SAMPLE = 1 / 8      # op path: share of pure reads the check replays


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_cell(workload: str, root: Path = ROOT):
    """``(bench, cell, config, traffic)`` of ``workload``, each from its
    own file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    bench_dir = root / BENCH_DIR.name
    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return bench, cell, cfg, mix


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if workload in m.get("workloads", [workload]):
            out.append(m)
    return out


def forbidden_loaded(modules) -> list:
    """The names of ``FORBIDDEN`` among the top-level names of
    ``modules``, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_reader(name: str, root: Path = ROOT):
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"splaybench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

class PortSystem:
    """``repro_torch``'s serving loop on one device."""

    def __init__(self, cfg: dict, traffic: Traffic, device):
        from repro_torch.core import device_index as dix
        from repro_torch.core import splaylist as sx
        from repro_torch.kernels import ops
        self.sx, self.dix, self.ops = sx, dix, ops
        self.cfg, self.device = cfg, torch.device(device)
        self.levels = int(cfg["plane"]["levels"])
        self.width = int(cfg["plane"]["width"])
        self.read_path = traffic.read_only
        self.st = self.plane = self.host = None

    def populate(self, order: torch.Tensor):
        """Inserts of ``order`` through ``run_ops``, every coin on, then
        the plane; returns the populate's ``(results, path lengths)``."""
        sx = self.sx
        dt = {"int32": torch.int32, "int64": torch.int64}[
            self.cfg["count_dtype"]]
        st = sx.make(capacity=int(self.cfg["capacity"]),
                     max_level=int(self.cfg["max_level"]), count_dtype=dt,
                     device=self.device)
        n = order.shape[0]
        st, res, plen = sx.run_ops(
            st, torch.full((n,), OP_INSERT, dtype=torch.int32,
                           device=self.device), order,
            torch.ones((n,), dtype=torch.bool, device=self.device))
        self.st = st
        self.plane = self.dix.from_state_device(st, n_levels=self.levels,
                                                width=self.width)
        return res.cpu().numpy(), plen.cpu().numpy()

    def _serve(self, kinds, keys, upd):
        out = self.sx.run_serving(
            self.st, self.plane, kinds[None], keys[None], upd[None],
            aggregate=self.read_path, plane_search=self.read_path)
        B = keys.shape[0]
        flat = torch.cat([out[2].reshape(-1), out[3].reshape(-1),
                          out[4].reshape(-1).to(torch.int32)])
        if self.host is None or self.host.shape != flat.shape:
            # one page-locked buffer the answers land in, batch after batch
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=flat.is_cuda)
        self.host.copy_(flat)
        host = self.host.numpy()
        return out[0], out[1], (host[:B], host[B:2 * B], int(host[2 * B]))

    def serve(self, kinds, keys, upd):
        """One batch: ``(results, path lengths, overflow)`` on the host,
        as views of a buffer the next batch overwrites."""
        self.st, self.plane, answers = self._serve(kinds, keys, upd)
        return answers

    def warm(self, kinds, keys, upd) -> None:
        """One batch whose state and plane are thrown away."""
        self._serve(kinds, keys, upd)

    def launch_counts(self) -> dict:
        return dict(self.ops.launch_counts())

    def read_back(self):
        """``(state, plane)`` as NumPy arrays on the host."""
        return ({f: getattr(self.st, f).cpu().numpy()
                 for f in self.st._fields},
                {f: getattr(self.plane, f).cpu().numpy()
                 for f in checks.PLANE_FIELDS})

    def release(self) -> None:
        self.st = self.plane = None


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _quantiles(xs):
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", make_system=PortSystem, t_start=None,
             root: Path = ROOT, sizes=None):
    """One run; returns ``(the result line's dict, the forbidden
    modules the process holds)``.  ``sizes`` (tests) overrides entries of
    the configuration and the traffic: ``{"config": {...}, "traffic":
    {...}}``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, mix = load_cell(workload, root)
    if sizes:
        cfg = dict(cfg, **sizes.get("config", {}))
        mix = dict(mix, **sizes.get("traffic", {}))
    on_card = torch.device(device).type == "cuda"
    readers = {m["name"]: load_reader(m["name"], root)
               for m in cell_metrics(bench, workload, trace)} if trace \
        else {}

    # ---- set-up: inputs, the populate, the plane, warm-up
    marks = [("start", time.perf_counter() - t_start)]
    traffic = Traffic(cfg, mix, seed, device)
    system = make_system(cfg, traffic, device)
    marks.append(("inputs", time.perf_counter() - t_start))
    pop_order = traffic.populate_order
    pop_res, pop_plen = system.populate(pop_order)
    marks.append(("populate", time.perf_counter() - t_start))
    pop_back = system.read_back()
    for j in range(int(mix.get("warmup_batches", 2))):
        system.warm(*traffic.batch(-2 - j))
    if trace:
        # the profiler's first session in a process starts slowly: take
        # it here, so that the one in the window starts at once
        _start_trace(device)[0].__exit__(None, None, None)
    _sync(device)
    # the set-up's garbage is collected now and its survivors frozen, so
    # that no collection of it lands in the window
    gc.collect()
    gc.freeze()
    marks.append(("warm-up", time.perf_counter() - t_start))
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = system.launch_counts()
    B = traffic.batch_size
    # the reference replays the window's first K batches and is held to
    # the state and plane after them; later batches are checked by what
    # needs no replay, so the check costs the same however fast the
    # program serves
    K = int(mix.get("check_batches", CHECK_BATCHES))
    trace_from = int(mix.get("trace_from", K // 4))
    if not 0 <= trace_from < K:
        raise ValueError(f"trace_from {trace_from} outside the {K} "
                         "replayed batches")
    kept = {}                 # batch -> (answers, path lengths or None)
    snap = None
    lat = []
    overflow = 0
    plen_sum = 0
    prof = traced = summary = None
    trace_i0 = trace_i1 = None

    # ---- the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while True:
        now = time.perf_counter()
        if i and now - t0 >= seconds:
            break
        if (trace and trace_i0 is None and i < K
                and (i >= trace_from
                     or now - t0 >= seconds - TRACE_SLICE_S)):
            prof, mark = _start_trace(device)
            trace_i0, t_trace = i, time.perf_counter()
        kinds, keys, upd = traffic.batch(i)
        a = time.perf_counter()
        if prof is None:
            res, plen, ovf = system.serve(kinds, keys, upd)
        else:
            with torch.profiler.record_function("bench.serve"):
                res, plen, ovf = system.serve(kinds, keys, upd)
        lat.append(time.perf_counter() - a)
        overflow += ovf
        if trace:
            plen_sum += int(plen.sum(dtype=np.int64))
        pick = mix_seed(seed, 1 << 40 | i) % SAMPLE_EVERY == 0
        if i < K:
            rows = not traffic.read_only or pick
            kept[i] = (res.copy(), plen.copy() if rows else None)
        elif pick:
            kept[i] = (res.copy(), None)
        i += 1
        if prof is not None and (
                i == K or time.perf_counter() - t_trace >= TRACE_SLICE_S
                or time.perf_counter() - t0 >= seconds):
            mark.__exit__(None, None, None)
            _sync(device)
            prof.__exit__(None, None, None)
            traced, prof, trace_i1 = prof, None, i
        if i == K:
            snap = system.read_back()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    n_batches = i
    if trace_i1 is not None:
        summary = yardstick.TraceSummary.from_profile(
            traced, trace_i1 - trace_i0)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    launches = {k: v - launches0.get(k, 0)
                for k, v in system.launch_counts().items()}
    final = system.read_back()
    snap = final if snap is None else snap
    system.release()
    del system
    if on_card:
        torch.cuda.empty_cache()
    bad = forbidden_loaded(sys.modules)

    # ---- the reference, after the window
    t_ref = time.perf_counter()
    counted = set()
    if summary is not None:
        span = trace_i1 - trace_i0
        counted = {trace_i0 + (k * span) // COUNTED_BATCHES
                   for k in range(min(COUNTED_BATCHES, span))}
    chk, work = _compare(cfg, traffic, pop_order, pop_res, pop_plen,
                         pop_back, kept, n_batches, K, snap, final,
                         overflow, counted)
    check_s = time.perf_counter() - t_ref

    # ---- the result
    n_ops = n_batches * B
    if trace:
        peak = yardstick.peaks(torch.cuda.get_device_name(device)) \
            if on_card else None
        ctx = dict(summary=summary, launches=launches, batches=n_batches,
                   batch_size=B, path_len_mean=plen_sum / n_ops,
                   work=work, peak=peak)
        metrics = {}
        for m in cell_metrics(bench, workload, True):
            v = readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        mem = window_peak - traffic.table_bytes()
        e2e = {"ops_per_s": n_ops / window_s,
               "batch_ms_p95": 1e3 * float(np.percentile(lat, 95)),
               "peak_dev_mb": mem / 1e6 if on_card else None,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, False)
                   if e2e.get(m["name"]) is not None}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s()
        dev["window_s"] = summary.window_s
    correct = all(v["value"] <= v["limit"] for v in chk.values())
    out = {"correct": correct, "attempted": n_ops,
           "failed": chk["answer_diff"]["value"], "metrics": metrics,
           "device": dev}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    out["checks"] = chk
    q = _quantiles([1e3 * x for x in lat])
    blocks = [round(1e3 * float(np.mean(lat[j:j + 64])), 2)
              for j in range(0, len(lat), 64)]
    log(f"[splaybench] {workload} seed {seed}: {n_batches} batches of {B} "
        f"in {window_s:.3f} s; batch ms quartiles {q}; mean batch ms a "
        f"block of 64 {blocks}; set-up "
        f"{setup_s:.3f} s (seconds from the start: {marks}); check "
        f"{check_s:.3f} s; launches {launches}")
    return out, bad


def _start_trace(device):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    if torch.device(device).type == "cuda":
        # a session can miss its first device activity: give it one
        torch.ones((1,), device=device)
        torch.cuda.synchronize(device)
    mark = record_function("bench.window")
    mark.__enter__()
    return prof, mark


def _compare(cfg, traffic, pop_order, pop_res, pop_plen, pop_back, kept,
             n_batches, K, snap, final, overflow, counted):
    """Replay the run on the reference and count what differs; returns
    the numbers compared (each ``{"value", "limit"}``) and, for the
    batches in ``counted``, each kernel's work.

    The reference replays the populate and the first ``K`` batches and
    is held to their answers and path lengths and to ``snap``, the
    state and plane after them.  Past them, the answers of the batches
    in ``kept`` are held to the membership the writes leave
    (:func:`serial_answers`), the final state's live keys to the
    membership after the last batch, and the final plane to the one
    the final state gives."""
    L = int(cfg["plane"]["levels"])
    W = int(cfg["plane"]["width"])
    seed = traffic.seed
    ref, r_res, r_plen = reference.populate(
        int(cfg["max_level"]), pop_order.cpu().numpy())
    pop = (int(np.count_nonzero(pop_res != r_res))
           + int(np.count_nonzero(pop_plen != r_plen)))
    lk, lh = ref.live_heights()
    pop += (checks.state_diff(pop_back[0], ref)
            + checks.plane_diff(pop_back[1], reference.plane(lk, lh, L, W),
                                pop_back[0]))
    ans = rows = 0
    work = {"search": [], "walk": [], "fold": []}
    # a read-only mix never changes membership: one lookup table serves
    live = np.zeros(int(cfg["key_space"]), bool)
    live[lk] = True
    first_write = np.full(int(cfg["key_space"]), np.iinfo(np.int64).max)
    for i in range(min(K, n_batches)):
        res, plen = kept[i]
        kinds, keys, upd = (t.cpu().numpy() for t in traffic.batch(i))
        count = i in counted
        if count:
            if traffic.read_only:
                lk, lh = ref.live_heights()
                work["search"].append(yardstick.descent_work(
                    reference.plane(lk, lh, L, W), keys))
                work["walk"].append(yardstick.walk_work(ref, keys))
            ref.start_journal()
        if traffic.read_only:
            ans += int(np.count_nonzero(res != live[keys]))
            if plen is not None:
                lk, lh = ref.live_heights()
                rows += int(np.count_nonzero(
                    plen != reference.levels_found(lk, lh, keys, L)))
            n_w = ref.fold_batch(keys, upd)
            entry = (n_w, 12)
        else:
            # every op that writes, every read of a key written earlier
            # in the batch, and a sample of the other pure reads
            n = keys.shape[0]
            pure = (kinds == OP_CONTAINS) & ~upd
            first_write[keys[~pure]] = n
            wi = np.flatnonzero(kinds != OP_CONTAINS)
            np.minimum.at(first_write, keys[wi], wi)
            seen = first_write[keys] < np.arange(n)
            first_write[keys[wi]] = n
            rng = np.random.default_rng(mix_seed(seed, 2 << 40 | i))
            skip = pure & ~seen & (rng.random(n) >= READ_SAMPLE)
            r_res, r_plen = ref.run_ops(kinds, keys, upd, skip)
            ans += int(np.count_nonzero((res != r_res) & ~skip))
            rows += int(np.count_nonzero((plen != r_plen) & ~skip))
            entry = (keys.shape[0], 17)
        if count:
            work["fold"].append(yardstick.fold_work(*entry,
                                                    ref.stop_journal()))
    lk, lh = ref.live_heights()
    state = checks.state_diff(snap[0], ref)
    plane = checks.plane_diff(snap[1], reference.plane(lk, lh, L, W),
                              snap[0])
    log(f"[splaybench] reference after {min(K, n_batches)} batches: "
        f"{ref.rebuilds} rebuilds, m {ref.m}, zl {ref.zero_level}, "
        f"size {ref.size}")
    del ref

    # past the replay: answers by membership, the final state and plane
    present = np.zeros(int(cfg["key_space"]), bool)
    present[lk] = True
    for i in range(K, n_batches):
        if traffic.read_only and i not in kept:
            continue
        kinds, keys, _ = (t.cpu().numpy() for t in traffic.batch(i))
        expect = serial_answers(kinds, keys, present)
        if i in kept:
            ans += int(np.count_nonzero(kept[i][0] != expect))
    fc = checks.canon(final[0])
    fk, fh = checks.live_heights(fc)
    held = np.zeros_like(present)
    held[fk] = True
    member = (int(np.count_nonzero(held != present))
              + int(int(fc["scalars"][3]) != int(present.sum())))
    final_plane = checks.plane_diff(final[1], reference.plane(fk, fh, L, W),
                                    final[0])

    chk = {"populate_diff": pop, "answer_diff": ans, "path_diff": rows,
           "state_diff": state, "plane_diff": plane, "member_diff": member,
           "final_plane_diff": final_plane, "overflow": overflow}
    mean = {k: {f: float(np.mean([w[f] for w in v])) for f in ("bytes",
                                                              "ops")}
            for k, v in work.items() if v}
    return {k: {"value": v, "limit": 0} for k, v in chk.items()}, mean


def serial_answers(kinds, keys, present) -> np.ndarray:
    """Each op's answer when the batch runs serially in order, from the
    membership alone: a contains or a delete answers whether its key is
    present before it, an insert whether it is absent; an insert leaves
    its key present, a delete absent.  ``present`` (bool, by key) is the
    membership at the batch's start and is left as at its end."""
    kinds = np.asarray(kinds)
    keys = np.asarray(keys, np.int64)
    n = keys.shape[0]
    if not np.any(kinds != OP_CONTAINS):
        return present[keys].astype(np.int32)
    pos = np.arange(n)
    order = np.lexsort((pos, keys))
    k_s, kind_s = keys[order], kinds[order]
    write = kind_s != OP_CONTAINS
    last = np.maximum.accumulate(np.where(write, pos, -1))
    prev = np.concatenate([[-1], last[:-1]])
    first = np.concatenate([[True], k_s[1:] != k_s[:-1]])
    start = np.maximum.accumulate(np.where(first, pos, 0))
    was = np.where(prev >= start, kind_s[np.maximum(prev, 0)] == OP_INSERT,
                   present[k_s])
    out = np.empty(n, np.int32)
    out[order] = np.where(kind_s == OP_INSERT, ~was, was)
    end = np.concatenate([first[1:], [True]])
    lw, st = last[end], start[end]
    has = lw >= st
    present[k_s[end][has]] = kind_s[lw[has]] == OP_INSERT
    return out
