"""Kernel races of the port, with the byte models that go with them.

    python -m repro_torch.benchmarks.kernels_bench [--full] \
        [--device cuda|cpu] [--backend gloo|nccl]

Races B1 (the rank-windowed descent, ``splay_search(pipelined=False)``)
against B5 (the seed baseline's full-width compare,
``splay_search_full``) on Zipf query batches, B2 (the pipelined
descent, with its own byte counter per query block) against B1 on the
hot batch, the batched update's aggregation (one weighted fold per
unique key), and the refresh paths: host ``level_arrays.refresh`` plus
the re-upload against ``device_index.refresh_device``.  Each race
asserts its outputs equal.  Then six races on a mesh of 4 ranks
(``launch.spmd.spawn``: gloo on the one card, ``--backend nccl`` a card
a rank): the sharded refresh, the routed sharded search, the ordered
``range_scan``, the drift controller, the serving sweep and the chaos
battery, each the rank-0 dict of a probe twin of this package.

Prints the ``name,us_per_call,derived`` CSV lines as it goes, and the
payload as one JSON line at the end; writes no file (``benchmarks.run
--out DIR`` writes one).  Times are the host clock around synchronised
calls on the run's device.  ``_bytes_model``'s keys are counts of the
reference's TPU design (a resident ``[L, W]`` block against streamed
rows), kept so that the two packages compare; they are not readings of
the card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks import chaos_probe
from repro_torch.benchmarks import drift_probe
from repro_torch.benchmarks import ordered_search_probe
from repro_torch.benchmarks import serving_probe
from repro_torch.benchmarks import sharded_refresh_probe as srp
from repro_torch.benchmarks import sharded_search_probe
from repro_torch.benchmarks.common import emit
from repro_torch.core import device_index as dix
from repro_torch.core import level_arrays as la
from repro_torch.core import splaylist as sx
from repro_torch.core import workload as wl
from repro_torch.kernels import ops
from repro_torch.kernels import splay_search as ssk

ALPHAS = (0.6, 1.0, 1.4)
N_DEV = 4
# columns that read a clock (or name the run's device): everything else
# in the payload is a count or an exact function of counts
TIMED_PREFIXES = ("us_per_", "speedup", "ratio_", "ops_per_sec",
                  "epochs_per_sec", "tokens_per_sec")
TIMED_KEYS = ("exec_mode", "wall_s", "assemble_overhead_ratio")
EXEC_MODES = ("cuda-kernels", "plain-cpu")     # ops.exec_mode's labels


def deterministic(x):
    """``x`` (a payload, or any part of one) without its timing columns
    and execution-mode labels."""
    if isinstance(x, dict):
        return {k: deterministic(v) for k, v in x.items()
                if k not in TIMED_KEYS and not k.startswith(TIMED_PREFIXES)
                and not (isinstance(v, str) and v in EXEC_MODES)}
    if isinstance(x, (list, tuple)):
        return [deterministic(v) for v in x]
    return x


def _zipf_case(width: int, alpha: float, nq: int, seed: int = 0):
    keys, heights, qs = wl.zipf_level_fixture(width, alpha, nq, seed)
    return la.build(keys, heights, min_levels=6), qs


def _time(fn, reps: int, dev) -> float:
    fn()
    srp.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    srp.sync(dev)
    return (time.perf_counter() - t0) / reps


def _mean_level(lv: torch.Tensor) -> float:
    """The mean found level as the reference computes it (``jnp.mean``
    of int32: a float32 sum, exact here, over a float32 count)."""
    return float(np.float32(int(lv.sum())) / np.float32(lv.shape[0]))


def _zipf_races(width: int, nq: int, qb: int, reps: int, device="cuda"):
    """B1 against B5 on a Zipf batch of each of ``ALPHAS`` (its triples
    asserted equal): the rows of the payload's ``zipf_search``, and the
    last alpha's level arrays (for ``_bytes_model``)."""
    dev = sx._device(device)
    rows = []
    for alpha in ALPHAS:
        L, qs = _zipf_case(width, alpha, nq, seed=int(alpha * 10))
        lvk, rm, w = (torch.as_tensor(x, device=dev)
                      for x in (L.keys, L.rank_map, L.widths))
        qsj = torch.as_tensor(qs, device=dev)
        dt_tier = _time(lambda: ssk.splay_search(
            lvk, qsj, query_block=qb, rank_map=rm, widths=w,
            pipelined=False), reps, dev)
        dt_full = _time(lambda: ssk.splay_search_full(
            lvk, qsj, query_block=qb), reps, dev)
        out_t = ssk.splay_search(lvk, qsj, query_block=qb, rank_map=rm,
                                 widths=w, pipelined=False)
        out_f = ssk.splay_search_full(lvk, qsj, query_block=qb)
        for a, b in zip(out_t, out_f):
            if not torch.equal(a, b):
                raise AssertionError(f"B1 disagrees with B5 (alpha "
                                     f"{alpha})")
        mean_lv = _mean_level(out_t[2])
        emit(f"kernel_splay_search_tiered_a{alpha}", dt_tier / nq * 1e6,
             f"full_us={dt_full / nq * 1e6:.3f};"
             f"speedup={dt_full / dt_tier:.2f};mean_level={mean_lv:.2f}")
        rows.append({
            "alpha": alpha,
            "ops_per_sec_tiered": nq / dt_tier,
            "ops_per_sec_seed": nq / dt_full,
            "us_per_query_tiered": dt_tier / nq * 1e6,
            "us_per_query_seed": dt_full / nq * 1e6,
            "speedup": dt_full / dt_tier,
            "mean_level_found": mean_lv,
        })
    return rows, L


def _bytes_model(L: la.LevelArrays, query_block: int, nq: int) -> dict:
    """The reference's bytes-touched model for one batch of ``nq``
    queries: its seed kernel holds the whole ``[L, W]`` matrix as one
    resident block and compares every row full-width; its tiered kernel
    streams one level row and one rank-map row per (query block, live
    level) and probes O(log window) a query.  Counts of that design,
    kept so that the packages compare, not readings of the card."""
    n_levels, width = L.keys.shape
    itemsize = 4
    q_blocks = max(nq // query_block, 1)
    live = int((L.widths > 0).sum())
    per_level_bytes = [int(width * itemsize) for _ in range(n_levels)]
    seed_resident = n_levels * width * itemsize
    tiered_streamed = q_blocks * live * 2 * width * itemsize
    return {
        "n_levels": n_levels,
        "width": width,
        "live_levels": live,
        "per_level_row_bytes": per_level_bytes,
        "seed_vmem_resident_bytes": seed_resident,
        "tiered_vmem_resident_bytes": 2 * width * itemsize,
        "tiered_streamed_bytes_per_batch": tiered_streamed,
        "seed_compares_per_query": n_levels * width,
        "tiered_probes_per_query":
            int(n_levels * (max(int(width).bit_length(), 1))),
    }


def _aggregation_case(quick: bool, device="cuda") -> dict:
    """A duplicate-heavy batch through ``run_contains_batch`` with and
    without aggregation: the folds collapse to the unique-key count, the
    results match."""
    dev = sx._device(device)
    rng = np.random.default_rng(1)
    n_keys = 64 if quick else 256
    B = 512 if quick else 2048
    pool = np.arange(0, 2 * n_keys, 2, dtype=np.int32)
    st = sx.make(capacity=2 * n_keys + 8, max_level=16, device=dev)
    st, _, _ = sx.run_ops(st, np.full((n_keys,), sx.OP_INSERT, np.int32),
                          pool, np.ones((n_keys,), bool))
    hot = pool[: max(n_keys // 16, 1)]
    qs = np.where(rng.random(B) < 0.8, rng.choice(hot, B),
                  rng.choice(pool, B)).astype(np.int32)
    coins = rng.random(B) < 0.75
    n_folds_serial = int(coins.sum())
    n_folds_agg = len(np.unique(qs[coins]))
    qs_t = torch.as_tensor(qs, device=dev)
    coins_t = torch.as_tensor(coins, device=dev)

    t_ser = _time(lambda: sx.run_contains_batch(st, qs_t, coins_t), 3, dev)
    t_agg = _time(lambda: sx.run_contains_batch(st, qs_t, coins_t,
                                                aggregate=True), 3, dev)
    _, res_s, _ = sx.run_contains_batch(st, qs_t, coins_t)
    _, res_a, _ = sx.run_contains_batch(st, qs_t, coins_t, aggregate=True)
    if not torch.equal(res_s, res_a):
        raise AssertionError("aggregated results differ from serialized")
    emit("batch_update_aggregation", t_agg / B * 1e6,
         f"folds_serial={n_folds_serial};folds_agg={n_folds_agg};"
         f"speedup={t_ser / t_agg:.2f}")
    return {
        "batch": B,
        "unique_update_keys": n_folds_agg,
        "folds_serialized": n_folds_serial,
        "folds_aggregated": n_folds_agg,
        "us_per_op_serialized": t_ser / B * 1e6,
        "us_per_op_aggregated": t_agg / B * 1e6,
        "speedup": t_ser / t_agg,
    }


def _synth_state(keys: np.ndarray, rel_h: np.ndarray, capacity: int,
                 max_level: int = 8, device="cuda") -> sx.SplayState:
    """A state with exactly the fields the refresh paths read (key,
    top, deleted, zl, n_alloc) populated, so that epochs are made at
    benchmark widths instead of by replaying op streams."""
    return srp.synth_state(keys, rel_h, capacity, max_level=max_level,
                           device=device)


def _refresh_case(width: int, churn: int, epochs: int, reps: int,
                  seed: int = 2, device="cuda") -> dict:
    """Race the refresh paths over a stream of rebalance epochs.

    ``churn`` keys are deleted and ``churn`` inserted an epoch (the
    membership-changing case: the host pays the state's download, an
    argsort and the plane's re-upload; the device folds the change
    with a bounded sort and a searchsorted merge); ``churn=0`` is the
    height-only epoch.  The epochs evolve one state as the engine does
    (``sharded_refresh_probe.epoch_states``).  The final planes are
    asserted equal: device, host and ``from_state``."""
    dev = sx._device(device)
    states, n_levels = srp.epoch_states(width, churn, epochs, seed, dev)
    prev_h0 = la.from_state(states[0], min_levels=n_levels, width=width)
    prev_d0 = dix.from_state_device(states[0], n_levels=n_levels,
                                    width=width)
    max_new = max(2 * churn, 64)

    def host_fold():
        prev = prev_h0
        up = None
        for st in states[1:]:
            prev = la.refresh(st, prev)
            # the serving loop reads the plane on the device: the host
            # path's re-upload counts every epoch
            up = tuple(torch.as_tensor(x, device=dev) for x in
                       (prev.keys, prev.widths, prev.heights,
                        prev.rank_map))
        return up

    def dev_fold():
        p = prev_d0
        for st in states[1:]:
            p = dix.refresh_device(st, p, max_new=max_new)
        return p

    t_host = srp.time_min(host_fold, reps, dev) / epochs
    t_dev = srp.time_min(dev_fold, reps, dev) / epochs

    final_h = host_fold()
    final_d = dev_fold()
    ref = la.from_state(states[-1], min_levels=n_levels, width=width)
    keys_d = final_d.keys.cpu().numpy()
    if not ((keys_d == ref.keys).all()
            and (final_d.rank_map.cpu().numpy() == ref.rank_map).all()
            and torch.equal(final_h[0], final_d.keys)):
        raise AssertionError(f"refresh planes differ (churn {churn})")

    itemsize = 4
    C, L1 = states[0].key.shape[0], states[0].max_level + 1
    state_download = (2 * L1 * C + 5 * C) * itemsize   # every field
    plane_upload = (2 * n_levels * width + width + n_levels) * itemsize
    mode = "membership" if churn else "height_only"
    emit(f"refresh_{mode}_w{width}", t_dev * 1e6,
         f"host_us={t_host * 1e6:.1f};speedup={t_host / t_dev:.2f};"
         f"churn={churn}")
    return {
        "mode": mode, "width": width, "n_levels": n_levels,
        "churn_per_epoch": int(churn), "epochs": epochs,
        "epochs_per_sec_host": 1.0 / t_host,
        "epochs_per_sec_device": 1.0 / t_dev,
        "us_per_epoch_host": t_host * 1e6,
        "us_per_epoch_device": t_dev * 1e6,
        "speedup_device_over_host": t_host / t_dev,
        "host_bytes_moved_per_epoch": state_download + plane_upload,
        "device_bytes_moved_per_epoch": 0,
    }


def _pipelined_case(width: int, nq: int, qb: int, reps: int,
                    device="cuda") -> dict:
    """B2 against B1 on the hot Zipf batch (alpha 1.4): equal output
    triples, wall clock, and the streamed-bytes race, B2's own counter
    per query block against B1's whole-row model."""
    dev = sx._device(device)
    alpha = 1.4
    L, qs = _zipf_case(width, alpha, nq, seed=14)
    lvk, rm, w = (torch.as_tensor(x, device=dev)
                  for x in (L.keys, L.rank_map, L.widths))
    qsj = torch.as_tensor(qs, device=dev)
    dt_tier = _time(lambda: ssk.splay_search(
        lvk, qsj, query_block=qb, rank_map=rm, widths=w, sharded=False,
        pipelined=False), reps, dev)
    dt_pipe = _time(lambda: ssk.splay_search_pipelined(
        lvk, qsj, query_block=qb, rank_map=rm, widths=w), reps, dev)
    out_t = ssk.splay_search(lvk, qsj, query_block=qb, rank_map=rm,
                             widths=w, sharded=False, pipelined=False)
    f, r, lv, nb = ssk.splay_search_pipelined(lvk, qsj, query_block=qb,
                                              rank_map=rm, widths=w)
    for a, b in zip(out_t, (f, r, lv)):
        if not torch.equal(a, b):
            raise AssertionError("B2 disagrees with B1")
    q_blocks = max(nq // qb, 1)
    live = int((L.widths > 0).sum())
    tiered_bytes = q_blocks * live * 2 * width * 4
    nb = nb.cpu().numpy()
    pipe_bytes = int(nb.sum())
    reduction = tiered_bytes / max(pipe_bytes, 1)
    emit(f"kernel_splay_search_pipelined_a{alpha}", dt_pipe / nq * 1e6,
         f"tiered_us={dt_tier / nq * 1e6:.3f};"
         f"streamed_mb={pipe_bytes / 2**20:.2f}"
         f"(tiered_model={tiered_bytes / 2**20:.2f});"
         f"bytes_reduction={reduction:.2f}")
    return {
        "alpha": alpha, "width": width, "nq": nq, "query_block": qb,
        "live_levels": live,
        "us_per_query_tiered": dt_tier / nq * 1e6,
        "us_per_query_pipelined": dt_pipe / nq * 1e6,
        "streamed_bytes_per_batch_tiered_model": tiered_bytes,
        "streamed_bytes_per_batch_pipelined": pipe_bytes,
        "bytes_reduction": reduction,
        "bytes_per_block": [int(x) for x in nb],
        "bit_identical": True,
    }


def _on_mesh(fn, *args, device="cuda", backend="gloo") -> dict:
    """Rank 0's result of ``fn(mesh, *args)`` on 4 ranks."""
    from repro_torch.launch import spmd
    return spmd.spawn(fn, N_DEV, *args, backend=backend, device=device,
                      threads=1 if device == "cpu" else None)[0]


def _sharded_refresh_case(width: int, device="cuda",
                          backend="gloo") -> dict:
    """The sharded refresh against the replicated one on 4 ranks
    (``sharded_refresh_probe.run_bench``, which asserts the planes
    equal)."""
    out = _on_mesh(srp.run_bench, width, device=device, backend=backend)
    emit(f"refresh_sharded_w{width}", out["us_per_epoch_sharded"],
         f"replicated_us={out['us_per_epoch_replicated']:.1f};"
         f"shards={out['shards']};bit_identical={out['bit_identical']}")
    return out


def _sharded_search_case(width: int, nq: int, device="cuda",
                         backend="gloo") -> dict:
    """The routed sharded search on the mass-split plane against the
    replicated descent on 4 ranks (``sharded_search_probe.run_bench``
    with ``routed``, which asserts every triple equal); the structural
    columns are per-shard resident bytes, the exchange's wire, routing
    balance and spill."""
    out = _on_mesh(sharded_search_probe.run_bench, width, nq, 4, True,
                   device=device, backend=backend)
    emit(f"search_sharded_w{width}", out["us_per_query_sharded"],
         f"replicated_us={out['us_per_query_replicated']:.3f};"
         f"shards={out['shards']};bit_identical={out['bit_identical']};"
         f"spill_rate={out['spill_rate_mass']:.3f};"
         f"max_share={out['routing_max_share']:.2f}"
         f"->{out['routing_max_share_mass']:.2f}(mass)")
    return out


def _ordered_case(width: int, nq: int, device="cuda",
                  backend="gloo") -> dict:
    """``range_scan`` on the replicated against the routed mass-split
    plane on 4 ranks, and its bytes model against the naive full gather
    (``ordered_search_probe.run_bench``)."""
    out = _on_mesh(ordered_search_probe.run_bench, width, nq,
                   device=device, backend=backend)
    emit(f"search_ordered_w{width}", out["us_per_scan_sharded"],
         f"replicated_us={out['us_per_scan_replicated']:.3f};"
         f"bytes_ratio={out['bytes_ratio_ours_over_naive']:.3f};"
         f"truncated={out['scans_truncated']};"
         f"bit_identical={out['bit_identical']}")
    return out


def _drift_case(width: int, nq: int, epochs: int = 10, device="cuda",
                backend="gloo") -> dict:
    """The routing controller against static lanes and static mass
    through the three drift scenarios on 4 ranks
    (``drift_probe.run_bench``)."""
    out = _on_mesh(drift_probe._rank, False, True, width, nq, epochs,
                   device=device, backend=backend)["bench"]
    for name, row in out["scenarios"].items():
        ttr_on = row["controller"]["time_to_recover"]
        ttr_off = row["static_lanes"]["time_to_recover"]
        emit(f"drift_{name}", max(ttr_on, default=0),
             f"ttr_static={ttr_off};"
             f"share_on={row['controller']['peak_share_post']:.2f};"
             f"share_static={row['static_lanes']['peak_share_post']:.2f};"
             f"retraces={row['controller']['retraces']}")
    return out


def _serving_case(n_requests: int, device="cuda", backend="gloo") -> dict:
    """The engine's offered-load sweep through ``Engine(mesh=...)`` on
    4 ranks (``serving_probe.run_bench``): latency in decode steps,
    tokens/s, the index plane's share, the steady-state spill, the
    backpressure counters and the host-against-device parity flag."""
    out = _on_mesh(serving_probe._rank, False, True, n_requests,
                   device=device, backend=backend)["bench"]
    emit("serving_engine", out["p99_latency_steps"],
         f"p50={out['p50_latency_steps']};"
         f"tok_s={out['tokens_per_sec']};"
         f"plane_share={out['index_plane_share']:.2f};"
         f"spill={out['steady_state_spill_rate']:.4f};"
         f"parity={out['parity_bit_identical']}")
    return out


def _chaos_case(device="cuda", backend="gloo") -> dict:
    """The fault-injection battery on 4 ranks
    (``chaos_probe.run_battery``), held to its four assertions."""
    with tempfile.TemporaryDirectory(prefix="chaos-") as tmp:
        out = _on_mesh(chaos_probe.run_battery, tmp, device=device,
                       backend=backend)
    chaos_probe.check(out)
    emit("chaos_recovery", out["recovery_epochs_max"],
         f"detected={out['detected']}/{out['injected']};"
         f"wrong={out['wrong_verdicts']};"
         f"restore_ok={out['restore_bit_identical']};"
         f"replay_once={out['replay_exactly_once']}")
    return out


def run(quick: bool = False, device="cuda", backend="gloo") -> dict:
    dev = sx._device(device)
    mesh_kw = dict(device=dev.type, backend=backend)
    width = 4096 if quick else 8192
    nq = 1024 if quick else 4096
    qb = 256
    reps = 3 if quick else 5

    payload = {
        "bench": "kernels",
        "config": {"width": width, "nq": nq, "query_block": qb,
                   "alphas": list(ALPHAS), "quick": quick,
                   "mode": ops.exec_mode(dev)},
    }
    payload["zipf_search"], L = _zipf_races(width, nq, qb, reps, dev)
    payload["bytes_model"] = _bytes_model(L, qb, nq)
    payload["aggregation"] = _aggregation_case(quick, device=dev)
    # the refresh race: always at width 4096, the full profile adds the
    # wide pair
    r_epochs = 4 if quick else 8
    r_reps = 6 if quick else 8
    refresh_widths = (4096,) if quick else (4096, width)
    payload["refresh_path"] = [
        _refresh_case(w_, churn=c, epochs=r_epochs, reps=r_reps,
                      device=dev)
        for w_ in refresh_widths for c in (64, 0)]
    payload["refresh_sharded"] = _sharded_refresh_case(
        1024 if quick else 4096, **mesh_kw)
    # the routed sharded search at width 4096 and nq 8192, where the
    # batch amortizes the collectives' fixed cost
    payload["search_sharded"] = _sharded_search_case(4096, 8192, **mesh_kw)
    payload["search_ordered"] = _ordered_case(
        1024 if quick else 2048, 1024 if quick else 2048, **mesh_kw)
    payload["search_pipelined"] = _pipelined_case(width, nq, qb, reps,
                                                  device=dev)
    payload["routing_controller"] = _drift_case(4096, 8192, **mesh_kw)
    payload["serving_engine"] = _serving_case(8 if quick else 16,
                                              **mesh_kw)
    payload["chaos_recovery"] = _chaos_case(**mesh_kw)

    # the vocab tier's bytes model: hot hits skip the table; the hot
    # set comes from observed counts, as the splay heights do
    payload["hot_gather_model"] = _hot_gather_model(width, nq)
    return payload


def _hot_gather_model(v: int, nq: int, h: int = 2048, d: int = 512) -> dict:
    """The two-tier gather's bytes model: a Zipf batch's share of hot
    hits, and the table bytes a flat and a tiered gather read."""
    rng = np.random.default_rng(0)
    warm = wl.zipf_token_ids(rng, v, (8 * nq,))
    counts = np.bincount(warm.ravel(), minlength=v)
    hot_rank = np.full(v, -1, np.int32)
    hot_ids = np.argsort(-counts)[:h]
    hot_rank[hot_ids] = np.arange(h)
    ids = wl.zipf_token_ids(rng, v, (nq,))
    hit = float(np.mean(hot_rank[ids] >= 0))
    emit("kernel_hot_gather_model", 0.0,
         f"zipf_hot_hit={hit:.2f};hbm_bytes_saved={hit:.2f}")
    return {
        "vocab": v, "hot_rows": h, "dim": d, "zipf_hot_hit": hit,
        "hbm_bytes_flat": nq * d * 2,
        "hbm_bytes_tiered": int((1 - hit) * nq * d * 2),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the full profile (width 8192, nq 4096)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    out = run(quick=not args.full, device=args.device, backend=args.backend)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
