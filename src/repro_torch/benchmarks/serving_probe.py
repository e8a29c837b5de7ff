"""Serving probe on the port's SPMD layer: the splay engine end to end
on the device index plane.

    python -m repro_torch.benchmarks.serving_probe --parity   # battery
    python -m repro_torch.benchmarks.serving_probe --bench    # JSON out

Both start 4 ranks (``launch.spmd.spawn``: gloo, every rank on
``cuda:0``; ``--backend nccl`` one rank a card; ``--device cpu`` for a
run on the CPU) and call :func:`run_parity` / :func:`run_bench` on each
with the world mesh.

:func:`run_parity` raises ``AssertionError`` unless (1) the device pool
replays four recorded request traces (creates, lookups, releases, and
the scan traces' range and predecessor queries) exactly as the host
pool does, meshless and on the ``1 x 4`` mesh (routed sharded search,
the route controller in the loop); (2) a tiny pool runs out of pages
and reclaims a released session's; and (3) host-indexed, meshless
device-indexed and ``1 x 4`` device-indexed ``Engine`` runs on one
Poisson/Zipf arrival stream give the same outputs, latencies, stalls,
preemptions and tokens out, with an ample pool and with a tight one
that forces backpressure.  It returns every replay and engine record.

:func:`run_bench` sweeps the offered load (Poisson rates) through the
device-indexed engine on the ``1 x 4`` mesh: p50/p99 latency in decode
steps, tokens/s on the host clock, the index plane's query share, the
spill and its steady state, stalls and preemptions, and the host-
against-device parity flag at the middle rate.

The model is ``ARCH``'s smoke config with ``model_zoo.build_params``
weights from seed 0 unless the caller passes ``cfg=``/``params=`` (the
tests pass the JAX package's weights, converted; ``chip_smoke.py`` the
published config).  The mesh reaches the pool; the model runs whole on
every rank.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import workload as wl
from repro_torch.kernels import ops as kops
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kv_cache import PagedKVPool

SPILL_OK = 0.01
ARCH = "qwen2-0.5b"
N_DEV = 4


def _replay_trace(pool: PagedKVPool, trace: wl.KVTrace,
                  max_range: int = 6):
    """Replay a recorded request trace; returns the full observable
    record (each op's verdict and the pool's accounting)."""
    log = []
    for t in range(len(trace.kinds)):
        k, s = int(trace.kinds[t]), int(trace.seq_ids[t])
        if k == wl.KV_CREATE:
            ok = pool.create(s)
            if ok:
                ok = pool.append_tokens(s, 3) and ok
            log.append(("c", s, ok))
        elif k == wl.KV_LOOKUP:
            chain = pool.lookup(s)
            log.append(("l", s, None if chain is None else tuple(chain)))
        elif k == wl.KV_SCAN:
            hi = int(trace.hi_ids[t])
            ids, cnt, tr = pool.lookup_range(s, hi, max_range=max_range)
            log.append(("s", s, hi, tuple(ids.tolist()), cnt, tr))
        elif k == wl.KV_PRED:
            log.append(("p", s, pool.predecessor(s)))
        else:
            pool.release(s)
            log.append(("r", s, pool.utilization))
    live = sorted(pool.chains)
    verdicts = pool.lookup_batch(live + [10 ** 6, 10 ** 6 + 1]).tolist()
    return log, live, verdicts, pool.utilization


def _build_engine(cfg, params, device_index, dev, mesh=None, n_pages=64,
                  page_size=4, max_batch=4, index_width=64):
    return Engine(cfg, params, max_batch=max_batch, max_seq=64,
                  n_pages=n_pages, page_size=page_size,
                  device_index=device_index, index_batch=8,
                  index_width=index_width, mesh=mesh, stream_epochs=2,
                  device=dev)


def _submit(engine: Engine, arr: wl.ArrivalStream) -> None:
    for i in range(len(arr.seq_ids)):
        L = int(arr.prompt_lens[i])
        engine.submit(Request(
            seq_id=int(arr.seq_ids[i]), prompt=arr.prompts[i, :L].copy(),
            max_new=int(arr.max_new[i]), arrival=int(arr.arrival[i])))


def _engine_record(engine: Engine):
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        results = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return {
        "results": {k: tuple(v) for k, v in results.items()},
        "latencies": dict(engine.latencies),
        "stalls": engine.stalls, "preemptions": engine.preemptions,
        "tokens_out": engine.tokens_out, "wall_s": wall,
        "pool_stats": dict(engine.pool.stats),
    }


def _model(cfg, params, dev):
    cfg = cfg if cfg is not None else registry.get_smoke(ARCH)
    if params is None:
        params = zoo.build_params(cfg, seed=0, device=dev)
    return cfg, params


def _say(mesh, msg: str) -> None:
    if mesh.index == 0:
        print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# --parity: the exactness battery
# ---------------------------------------------------------------------------

def run_parity(mesh, seed=7, params=None, cfg=None) -> dict:
    """The battery on the world ``mesh`` (every rank calls this); raises
    ``AssertionError`` on any violation.  Returns ``{"replays": [...],
    "engines": [...]}``: every ``_replay_trace`` record (host, meshless,
    ``1 x 4`` for each trace) and every ``_engine_record`` without its
    wall time (host, dev, dev-1x4 for the ample then the tight pool), in
    the order they ran."""
    dev = mesh.device
    _say(mesh, f"  mode={kops.exec_mode(dev)}")
    replays, engines = [], []

    # (1) pool traces: host against device, meshless and on the mesh
    traces = [wl.kv_request_trace(200, 24, seed=seed),
              wl.kv_request_trace(120, 6, seed=seed + 1),
              wl.kv_scan_trace(200, 24, seed=seed + 2),
              wl.kv_scan_trace(140, 8, seed=seed + 3, p_scan=0.4,
                               span=16)]
    for trace in traces:
        ref = _replay_trace(PagedKVPool(32, 4), trace)
        replays.append(ref)
        truncs = 0
        for tag, kw in (("meshless", {}), ("1x4-mesh", {"mesh": mesh})):
            pool = PagedKVPool(32, 4, device=True, index_width=64,
                               index_batch=8, torch_device=dev, **kw)
            got = _replay_trace(pool, trace)
            replays.append(got)
            truncs = pool.stats["range_truncated"]
            if got != ref:
                diff = next(((a, b) for a, b in zip(ref[0], got[0])
                             if a != b), (ref[1:], got[1:]))
                raise AssertionError(
                    f"pool trace diverged ({trace.name} {tag}): first "
                    f"diff {diff}")
        n_ord = int(((trace.kinds == wl.KV_SCAN)
                     | (trace.kinds == wl.KV_PRED)).sum())
        extra = (f", {n_ord} ordered ops, truncated={truncs}"
                 if n_ord else "")
        _say(mesh, f"  pool trace {trace.name}: host == device(meshless) "
             f"== device(1x4){extra}")
        if trace.name.startswith("kv_scan") and n_ord == 0:
            raise AssertionError(f"{trace.name} carried no ordered ops")

    # page exhaustion: a partial reservation rolls nothing over
    tiny = PagedKVPool(2, 4, device=True, index_width=8, index_batch=4,
                       torch_device=dev)
    if not (tiny.create(0) and tiny.append_tokens(0, 8)):   # both pages
        raise AssertionError("the tiny pool refused its first session")
    if not tiny.create(1):
        raise AssertionError("the tiny pool refused its second session")
    if tiny.append_tokens(1, 1):
        raise AssertionError("expected page exhaustion")
    if tiny.lookup_batch([0, 1, 2]).tolist() != [True, True, False]:
        raise AssertionError("the tiny pool's verdicts are wrong")
    tiny.release(0)
    if not tiny.append_tokens(1, 1):
        raise AssertionError("freed pages not reclaimed")
    _say(mesh, "  pool exhaustion + reclaim: OK")

    # (2)+(3) the engine end to end, with an ample pool and a tight one
    cfg, params = _model(cfg, params, dev)
    arr = wl.poisson_zipf_arrivals(10, 0.4, cfg.vocab_padded,
                                   prompt_len=(2, 6), max_new=(3, 6),
                                   seed=seed)
    for label, n_pages in (("ample", 64), ("tight", 7)):
        recs = {}
        for tag, device_index, m in (("host", False, None),
                                     ("dev", True, None),
                                     ("dev-1x4", True, mesh)):
            e = _build_engine(cfg, params, device_index, dev, mesh=m,
                              n_pages=n_pages)
            _submit(e, arr)
            recs[tag] = _engine_record(e)
            engines.append({k: v for k, v in recs[tag].items()
                            if k != "wall_s"})
            if tag != "host" and recs[tag]["pool_stats"][
                    "plane_queries"] <= 0:
                raise AssertionError(f"{label}/{tag}: no plane query")
        for tag in ("dev", "dev-1x4"):
            for k in ("results", "latencies", "stalls", "preemptions",
                      "tokens_out"):
                if recs[tag][k] != recs["host"][k]:
                    raise AssertionError(
                        f"{label}/{tag} diverged on {k}: {recs[tag][k]} "
                        f"!= {recs['host'][k]}")
        r = recs["host"]
        if len(r["results"]) != 10:
            raise AssertionError("requests lost")
        if label == "tight" and r["stalls"] + r["preemptions"] == 0:
            raise AssertionError("tight pool exercised no backpressure")
        _say(mesh, f"  engine {label:5s} (pages={n_pages}): host == dev "
             f"== dev-1x4; stalls={r['stalls']} "
             f"preemptions={r['preemptions']} served={len(r['results'])}")
    _say(mesh, "SERVING PARITY OK")
    return {"replays": replays, "engines": engines}


# ---------------------------------------------------------------------------
# --bench: the offered-load sweep
# ---------------------------------------------------------------------------

def run_bench(mesh, n_requests=12, rates=(0.15, 0.4, 1.0), seed=7,
              params=None, cfg=None) -> dict:
    """The sweep on the world ``mesh`` (every rank calls this); returns
    the reference's JSON shape (``arch`` names ``cfg``)."""
    dev = mesh.device
    cfg, params = _model(cfg, params, dev)
    out = {"arch": cfg.name, "shards": mesh.size, "n_requests": n_requests,
           "spill_ok": SPILL_OK, "exec_mode": kops.exec_mode(dev),
           "rates": {}}

    def arrivals(rate):
        return wl.poisson_zipf_arrivals(n_requests, rate, cfg.vocab_padded,
                                        prompt_len=(2, 6), max_new=(4, 8),
                                        seed=seed)

    for rate in rates:
        e = _build_engine(cfg, params, True, dev, mesh=mesh, n_pages=10)
        _submit(e, arrivals(rate))
        rec = _engine_record(e)
        pool = e.pool
        lat = np.sort(np.fromiter(rec["latencies"].values(), np.int64))
        spill = np.asarray(pool.spill_traj, np.float64)
        share = np.asarray(pool.share_traj, np.float64)
        tail = max(len(spill) // 2, 1)        # steady state: last half
        pq = max(rec["pool_stats"]["plane_queries"], 1)
        row = {
            "rate": rate,
            "served": len(rec["results"]),
            "p50_latency_steps": int(lat[len(lat) // 2]),
            "p99_latency_steps": int(lat[min(len(lat) - 1,
                                             int(len(lat) * 0.99))]),
            "tokens_per_sec": round(rec["tokens_out"] / rec["wall_s"], 2),
            "wall_s": round(rec["wall_s"], 2),
            "index_plane_share": round(
                rec["pool_stats"]["plane_queries"]
                / max(rec["pool_stats"]["lookups"], 1), 4),
            "spill_rate": round(float(spill.sum()) / pq, 5),
            "steady_state_spill_rate": round(
                float(spill[-tail:].sum())
                / max(pool.index_batch * tail, 1), 5),
            "max_share_mean": round(float(share.mean()), 4)
            if share.size else 0.0,
            "stalls": rec["stalls"], "preemptions": rec["preemptions"],
            "rebuilds": rec["pool_stats"]["rebuilds"],
        }
        out["rates"][str(rate)] = row
        _say(mesh, f"# rate={rate}: p50={row['p50_latency_steps']} "
             f"p99={row['p99_latency_steps']} tok/s="
             f"{row['tokens_per_sec']} stalls={row['stalls']} "
             f"preempt={row['preemptions']}")

    # parity re-checked at the middle rate; the tail metrics reported
    # from the highest offered load
    mid = rates[len(rates) // 2]
    eh = _build_engine(cfg, params, False, dev, n_pages=10)
    ed = _build_engine(cfg, params, True, dev, mesh=mesh, n_pages=10)
    _submit(eh, arrivals(mid))
    _submit(ed, arrivals(mid))
    rh, rd = _engine_record(eh), _engine_record(ed)
    parity_ok = all(rh[k] == rd[k] for k in
                    ("results", "latencies", "stalls", "preemptions"))
    hi = out["rates"][str(rates[-1])]
    out.update({
        "parity_bit_identical": bool(parity_ok),
        "p50_latency_steps": hi["p50_latency_steps"],
        "p99_latency_steps": hi["p99_latency_steps"],
        "tokens_per_sec": hi["tokens_per_sec"],
        "index_plane_share": hi["index_plane_share"],
        "steady_state_spill_rate": hi["steady_state_spill_rate"],
        "backpressure_stalls": sum(r["stalls"]
                                   for r in out["rates"].values()),
        "backpressure_preemptions": sum(r["preemptions"]
                                        for r in out["rates"].values()),
    })
    return out


def _rank(mesh, parity: bool, bench: bool, n_requests: int) -> dict:
    out = {}
    if parity:
        out["parity"] = run_parity(mesh)
    if bench:
        out["bench"] = run_bench(mesh, n_requests=n_requests)
    return out


def main(argv=None) -> dict:
    from repro_torch.launch import spmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not (args.parity or args.bench):
        ap.error("pass --parity and/or --bench")
    out = spmd.spawn(_rank, N_DEV, args.parity, args.bench, args.requests,
                     backend=args.backend, device=args.device,
                     threads=1 if args.device == "cpu" else None)[0]
    if args.bench:
        print(json.dumps(out["bench"]))
    return out


if __name__ == "__main__":
    main()
