"""Sharded-search race on the port's SPMD layer: the width-sharded
search (``kernels.splay_search.splay_search_sharded``) against the
replicated descent and the gather-to-replicated dispatch over a Zipf
query batch.

    python -m repro_torch.benchmarks.sharded_search_probe --bench --routed

``main`` starts 4 ranks (``launch.spmd.spawn``: gloo, every rank on
``cuda:0``; ``--backend nccl`` one rank a card; ``--device cpu`` for a
run on the CPU), calls :func:`run_bench` on each with the world mesh and
prints rank 0's dict as one JSON line.  Every variant's (found, rank,
level_found) triple is asserted equal to the replicated search's.  With
``--routed`` the primary sharded measurement is the routed all-to-all
exchange on the mass-split plane and the payload gains the routing
balance (spill, occupancy per shard, Gini, the same after the mass
split) and the residency columns (``assembled_resident``,
``assembled_forced``).  Timing columns are the host clock around
synchronised calls; the rest are counts or exact functions of counts.
The differential battery (the reference's ``--parity``) is held by the
port's tests.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.sharded_refresh_probe import sync, synth_state
from repro_torch.core import device_index as dix
from repro_torch.core import workload as wl
from repro_torch.kernels import ops as kops
from repro_torch.kernels import splay_search as ssk
from repro_torch.parallel import sharding as shd

N_DEV = 4


def _assert_triple(a, b, msg):
    for name, x, y in zip(("found", "rank", "level_found"), a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{msg} field={name}")


def _gini(shares: np.ndarray) -> float:
    """Gini coefficient of the per-shard load vector (0 = perfectly
    balanced, ->1 = all load on one shard)."""
    x = np.sort(np.asarray(shares, np.float64))
    n = x.size
    tot = x.sum()
    if tot == 0 or n < 2:
        return 0.0
    return float((2 * np.arange(1, n + 1) - n - 1).dot(x) / (n * tot))


def _synth_state(keys: np.ndarray, rel_h: np.ndarray, selfhits: np.ndarray,
                 capacity: int, max_level: int = 8, device="cuda"):
    """A state with the fields the refresh and mass-split paths read
    (key, top, selfhits, zl, n_alloc) populated at benchmark widths."""
    return synth_state(keys, rel_h, capacity, max_level=max_level,
                       selfhits=selfhits, device=device)


def run_bench(mesh, width: int = 4096, nq: int = 4096, reps: int = 4,
              routed: bool = True) -> dict:
    """Zipf query batches against a plane at 75% occupancy (serving
    planes keep insert headroom, and a full plane leaves the mass split
    no freedom), sharded on the ``1 x S`` mesh (every rank calls this)
    against the replicated descent and the gather dispatch; asserts
    every output triple equal.  Returns the reference's JSON shape."""
    dev = mesh.device
    S = mesh.size
    n_levels = 8
    n_keys = int(width * 0.75)
    keys, heights, qs = wl.zipf_level_fixture(n_keys, 1.0, nq, seed=3)
    # the access counters the mass split reads: an independent warm-up
    # sample of the same fixture (same keys and ranks, fresh draws)
    _, _, warm = wl.zipf_level_fixture(n_keys, 1.0, 4 * nq, seed=3)
    counts = np.zeros(n_keys, np.int64)
    np.add.at(counts, np.searchsorted(keys, warm), 1)
    st_syn = _synth_state(keys, heights,
                          np.minimum(counts, 2 ** 20).astype(np.int32),
                          capacity=n_keys + 8, max_level=n_levels,
                          device=dev)
    plane = dix.from_state_device(st_syn, n_levels=n_levels, width=width)
    plane_s = shd.shard_index_plane(plane, mesh)
    qsj = torch.as_tensor(qs, device=dev)
    qb = 256

    # the mass-split plane up front, so that every variant is timed
    # interleaved (round-robin, min per variant)
    pm_s, ovm = dix.refresh_device_sharded(st_syn, plane_s, max_new=64,
                                           mesh=mesh, split="mass")
    if int(ovm) != 0:
        raise AssertionError(f"mass split overflowed by {int(ovm)}")
    # the same segmented plane with its residency bit cleared: every
    # descent re-assembles its local sub-plane
    pm_stale = pm_s._replace(local_ok=torch.zeros_like(pm_s.local_ok))

    variants = {
        "routed_mass": lambda: ssk.splay_search_sharded(
            pm_s, qsj, query_block=qb, mesh=mesh),
        "routed_mass_stale": lambda: ssk.splay_search_sharded(
            pm_stale, qsj, query_block=qb, mesh=mesh),
        "routed_lane": lambda: ssk.splay_search_sharded(
            plane_s, qsj, query_block=qb, mesh=mesh),
        "masked": lambda: ssk.splay_search_sharded(
            plane_s, qsj, query_block=qb, mesh=mesh, routed=False),
        "replicated": lambda: ssk.splay_search(
            plane, qsj, query_block=qb, sharded=False),
        "gather": lambda: ssk.splay_search(
            plane_s, qsj, query_block=qb, sharded=False),
    }
    for fn in variants.values():                       # warm up
        fn()
    best = {k: float("inf") for k in variants}
    for _ in range(max(reps, 8)):
        for k, fn in variants.items():
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            best[k] = min(best[k], time.perf_counter() - t0)
    out_re = variants["replicated"]()
    for k, tag in (("routed_mass", "routed-mass"),
                   ("routed_mass_stale", "routed-forced-assemble"),
                   ("routed_lane", "routed-lane"), ("masked", "masked"),
                   ("gather", "gather")):
        _assert_triple(variants[k](), out_re, f"bench {tag}-vs-replicated")
    t_shard = best["routed_mass"] if routed else best["masked"]
    t_repl = best["replicated"]

    # routing balance: the share of the batch each shard owns (a host
    # mirror of the shard bodies' suffix-min routing)
    bot = plane.keys[-1].cpu().numpy()
    wl_ = width // S
    bounds = np.asarray([bot[s * wl_] for s in range(S)], np.int64)
    bounds[0] = -(2 ** 31) + 1
    bounds = np.minimum.accumulate(bounds[::-1])[::-1]
    owner = np.searchsorted(bounds, np.asarray(qs), side="right") - 1
    hist = np.bincount(owner, minlength=S)
    itemsize = 4
    capacity = ssk.route_capacity(nq, S)
    out = {
        "mode": "zipf_search", "exec_mode": kops.exec_mode(dev),
        "width": width, "n_levels": n_levels,
        "shards": S, "lanes_per_shard": wl_, "nq": nq,
        "occupied_lanes": n_keys,
        "query_block": qb, "routed": bool(routed),
        "us_per_query_sharded": t_shard / nq * 1e6,
        "us_per_query_routed_lane_split": best["routed_lane"] / nq * 1e6,
        "us_per_query_masked": best["masked"] / nq * 1e6,
        "us_per_query_replicated": t_repl / nq * 1e6,
        "us_per_query_gather_dispatch": best["gather"] / nq * 1e6,
        "ratio_sharded_over_replicated": t_shard / t_repl,
        "ratio_masked_over_replicated": best["masked"] / t_repl,
        # resident plane state shrinks [L, W] -> [L, W/S]; the routed
        # exchange wires two all-to-alls of [S, cap] per batch (one
        # query word a lane forward, four answer words back)
        "replicated_resident_bytes": n_levels * width * itemsize,
        "sharded_resident_bytes_per_shard": n_levels * wl_ * itemsize,
        "psum_bytes_per_batch": 3 * nq * itemsize,
        "exchange_bytes_per_batch":
            (1 + 4) * S * capacity * itemsize if routed else 0,
        "kernel_batch_per_shard": capacity if routed else nq,
        "routing_per_shard": [int(x) for x in hist],
        "routing_max_share": float(hist.max() / nq),
        "routing_gini": _gini(hist),
        "bit_identical": True,
    }
    if not routed:
        return out

    # the routed exchange's stats from the shard bodies
    *_, stats = ssk.splay_search_sharded(plane_s, qsj, query_block=qb,
                                         mesh=mesh, return_stats=True)
    occ = stats.occupancy.cpu().numpy()
    out.update({
        "route_capacity": capacity,
        "route_slack": ssk.DEFAULT_ROUTE_SLACK,
        "spill_count": int(stats.spill),
        "spill_rate": float(int(stats.spill) / nq),
        "occupancy_per_shard": [int(x) for x in occ],
    })
    # the mass split's routing balance on the same batch
    *_, mstats = ssk.splay_search_sharded(pm_s, qsj, query_block=qb,
                                          mesh=mesh, return_stats=True)
    mocc = mstats.occupancy.cpu().numpy()
    out.update({
        "us_per_query_mass_split": best["routed_mass"] / nq * 1e6,
        "occupancy_per_shard_mass": [int(x) for x in mocc],
        "routing_max_share_mass": float(mocc.max() / max(mocc.sum(), 1)),
        "routing_gini_mass": _gini(mocc),
        "spill_count_mass": int(mstats.spill),
        "spill_rate_mass": float(int(mstats.spill) / nq),
    })
    # residency: the resident segmented descent against the forced
    # re-assembly on the same plane and batch
    *_, sstats = ssk.splay_search_sharded(pm_stale, qsj, query_block=qb,
                                          mesh=mesh, return_stats=True)
    out.update({
        "us_per_query_routed_resident": best["routed_mass"] / nq * 1e6,
        "us_per_query_routed_forced_assemble":
            best["routed_mass_stale"] / nq * 1e6,
        "assemble_overhead_ratio":
            best["routed_mass_stale"] / best["routed_mass"],
        "assembled_resident": int(mstats.assembled),
        "assembled_forced": int(sstats.assembled),
    })
    return out


def main(argv=None) -> dict:
    from repro_torch.launch import spmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--routed", action="store_true",
                    help="bench the routed all-to-all exchange as the "
                         "primary sharded path (+ the balance columns)")
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--nq", type=int, default=4096)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not args.bench:
        ap.error("pass --bench (the parity battery is held by the tests)")
    out = spmd.spawn(run_bench, N_DEV, args.width, args.nq, 4, args.routed,
                     backend=args.backend, device=args.device,
                     threads=1 if args.device == "cpu" else None)[0]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
