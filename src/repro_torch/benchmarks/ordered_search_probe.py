"""Ordered-operation race on the port's SPMD layer: ``range_scan`` on the
replicated plane against the routed mass-split sharded plane, with the
bytes-touched model against the naive full gather.

    python -m repro_torch.benchmarks.ordered_search_probe --bench

``main`` starts 4 ranks (``launch.spmd.spawn``: gloo, every rank on
``cuda:0``; ``--backend nccl`` one rank a card; ``--device cpu`` for a
run on the CPU), calls :func:`run_bench` on each with the world mesh and
prints rank 0's dict as one JSON line.  The replicated and sharded scans
are asserted equal (keys, counts, truncations).  Timing columns are the
host clock around synchronised calls; the bytes columns are counts of
the descent's design, not readings of the card.  The ordered-op parity
battery (the reference's ``--parity``) is held by the port's tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks.sharded_refresh_probe import sync
from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx
from repro_torch.kernels import ops as kops
from repro_torch.parallel import sharding as shd

N_DEV = 4


def _seed_state(keys, cap, L, device="cuda"):
    st = sx.make(capacity=cap, max_level=L, device=device)
    st, _, _ = sx.run_ops(st, np.full(len(keys), sx.OP_INSERT, np.int32),
                          np.asarray(keys, np.int32),
                          np.ones(len(keys), bool))
    return st


def run_bench(mesh, width=2048, nq=2048, max_range=64, reps=3,
              seed=0) -> dict:
    """``range_scan`` over hot-Zipf ranges on the ``1 x S`` mesh (every
    rank calls this), replicated against routed mass-split.  Returns the
    reference's JSON shape."""
    dev = mesh.device
    S = mesh.size
    n_levels = 14
    rng = np.random.default_rng(seed)
    n_keys = int(width * 0.75)
    keys = rng.choice(np.arange(0, width * 4, dtype=np.int32), n_keys,
                      replace=False)
    st = _seed_state(keys, width + 2, n_levels, dev)
    plane = dix.from_state_device(st, n_levels=n_levels, width=width)
    live = np.sort(keys)

    # hot-Zipf range anchors; spans drawn in rank space (up to
    # 4 * max_range members), so most scans take the counted truncation
    zipf = np.minimum(rng.zipf(1.4, nq) - 1, len(live) - 1)
    lo = live[zipf].astype(np.int32)
    span = rng.integers(1, 4 * max_range, nq)
    hi = live[np.minimum(zipf + span, len(live) - 1)].astype(np.int32)
    lo_t = torch.as_tensor(lo, device=dev)
    hi_t = torch.as_tensor(hi, device=dev)

    pl_s = shd.shard_index_plane(plane, mesh)
    pl_s, ovf = dix.refresh_device_sharded(st, pl_s, mesh=mesh,
                                           split="mass")
    if int(ovf) != 0:
        raise AssertionError(f"mass split overflowed by {int(ovf)}")

    def scan_repl():
        return kops.splay_range_scan(plane, lo_t, hi_t, max_range)

    def scan_shard():
        return kops.splay_range_scan(pl_s, lo_t, hi_t, max_range)

    def _time_min(fn):
        best = float("inf")
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    kr, cr, tr = scan_repl()
    ks_, cs, ts = scan_shard()
    for name, a, b in (("keys", kr, ks_), ("count", cr, cs),
                       ("truncated", tr, ts)):
        if not torch.equal(a, b):
            raise AssertionError(f"range_scan sharded != replicated: {name}")
    t_repl = _time_min(scan_repl)
    t_shard = _time_min(scan_shard)

    # bytes touched a query (itemsize 4): the naive full gather ships
    # the whole [W] bottom row; ours streams 2 rows a live level a query
    # block of the doubled (lo ++ hi) batch, then gathers max_range lanes
    itemsize = 4
    qb = 256
    live_levels = int((plane.widths > 0).sum())
    q_blocks = max((2 * nq) // qb, 1)
    descent_bytes = q_blocks * live_levels * 2 * width * itemsize
    ours_per_query = descent_bytes / nq + max_range * itemsize
    naive_per_query = width * itemsize
    tr_np = tr.cpu().numpy()
    out = {
        "mode": "range_scan", "exec_mode": kops.exec_mode(dev),
        "width": width, "n_levels": n_levels, "live_levels": live_levels,
        "shards": S, "nq": nq, "max_range": max_range,
        "occupied_lanes": n_keys,
        "us_per_scan_replicated": t_repl / nq * 1e6,
        "us_per_scan_sharded": t_shard / nq * 1e6,
        "ratio_sharded_over_replicated": t_shard / t_repl,
        "bytes_per_query_ours": round(ours_per_query, 1),
        "bytes_per_query_naive_full_gather": naive_per_query,
        "bytes_ratio_ours_over_naive":
            round(ours_per_query / naive_per_query, 4),
        "scans_truncated": int((tr_np > 0).sum()),
        "members_truncated": int(tr_np.astype(np.int64).sum()),
        "bit_identical": True,
    }
    if mesh.index == 0:
        print(f"# range_scan: repl {out['us_per_scan_replicated']:.1f}us "
              f"shard {out['us_per_scan_sharded']:.1f}us bytes ratio "
              f"{out['bytes_ratio_ours_over_naive']:.3f} truncated "
              f"{out['scans_truncated']}/{nq}", file=sys.stderr)
    return out


def main(argv=None) -> dict:
    from repro_torch.launch import spmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--max-range", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not args.bench:
        ap.error("pass --bench (the parity battery is held by the tests)")
    out = spmd.spawn(run_bench, N_DEV, args.width, args.nq, args.max_range,
                     backend=args.backend, device=args.device,
                     threads=1 if args.device == "cpu" else None)[0]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
