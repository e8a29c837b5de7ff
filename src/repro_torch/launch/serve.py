"""Serving driver: continuous batching with the splay-adaptive engine
(the twin of ``repro.launch.serve``; the engine on one device).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The weights are random, drawn from ``--seed`` on the device (bfloat16
when the config says so).  ``--splay-demo`` instead drives the
ordered-map serving substrate directly: build a splay-list state and its
device index plane, run serving epochs (``splaylist.run_serving``: op
batches plus the incremental plane refresh with the overflow/rebuild
state machine), and audit the plane before and after.  With ``--ranks
S`` (S > 1) the launcher (``launch.spmd``) starts S ranks, one process
each (``--backend gloo``: all on the one card or the CPU; ``nccl``: one
card a rank), and every rank also runs the serving loop sharded end to
end over them: the routed sharded search answering the batches and the
sharded refresh, under the equal-lane and the mass-weighted splits, the
search sharded against gathered, the sharded refresh against the
replicated one, and the routing controller, each checked bit-identical
to the replicated loop:

  PYTHONPATH=src python -m repro_torch.launch.serve --splay-demo --ranks 4

``--snapshot-dir`` publishes a serving snapshot after the run, and with
``--resume`` the latest one there is restored before the requests
arrive.  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import workload
from repro_torch.models import model_zoo as zoo
from repro_torch.serve import snapshot as snap
from repro_torch.serve.engine import Engine, Request
from repro_torch.train.checkpoint import CheckpointManager


def splay_demo(args, mesh=None) -> dict:
    """Build plane -> run_serving -> read results, with the plane audit
    at both ends; with ``--ranks S`` (S > 1) the ranks are started here
    and each also runs the sharded loop on ``mesh`` (rank 0 prints and
    its result is returned)."""
    ranks = getattr(args, "ranks", 1)
    if mesh is None and ranks > 1:
        from repro_torch.launch import spmd
        return spmd.spawn(_demo_rank, ranks, args, backend=args.backend,
                          device="cuda" if args.device.startswith("cuda")
                          else "cpu")[0]
    from repro_torch.core import device_index as dix
    from repro_torch.core import plane_check as pc
    from repro_torch.core import splaylist as sx
    from repro_torch.kernels import ops as kops

    dev = mesh.device if mesh is not None else sx._device(args.device)
    say = print if mesh is None or mesh.index == 0 else (
        lambda *a, **k: None)
    say(f"splay demo: mode={kops.exec_mode(dev)}")
    rng = np.random.default_rng(args.seed)
    cap, L = 2050, 16
    W = cap - 2                      # 2048: divides 2/4/8-way meshes
    st = sx.make(capacity=cap, max_level=L, device=dev)
    pool = np.arange(0, 2000, 2, dtype=np.int32)
    st, _, _ = sx.run_ops(st, np.full((len(pool),), sx.OP_INSERT, np.int32),
                          pool, np.ones((len(pool),), bool))
    plane = dix.from_state_device(st, n_levels=L, width=W)
    # a clean plane prints exactly "audit OK"
    say(f"build {pc.audit_summary(pc.audit_plane(st, plane))}")

    E, B = args.epochs, args.batch
    hot = rng.choice(pool, max(B // 16, 1))
    kinds = rng.choice([sx.OP_CONTAINS, sx.OP_CONTAINS, sx.OP_INSERT],
                       (E, B)).astype(np.int32)
    keys = np.where(rng.random((E, B)) < 0.8,
                    rng.choice(hot, (E, B)),
                    rng.integers(0, 4000, (E, B))).astype(np.int32)
    ups = rng.random((E, B)) < 0.5

    st2, plane2, res, plen, ovf, _, _ = sx.run_serving(
        st, plane, kinds, keys, ups)
    out = {
        "epochs": E, "batch": B, "exec_mode": kops.exec_mode(dev),
        "hit_rate": float(res.cpu().numpy().mean()),
        "mean_path": float(plen.cpu().numpy().mean()),
        "overflow_epochs": int((ovf > 0).sum()),
        "alive": int(st2.size),
    }
    say(f"splay serving: {E} epochs x {B} ops, hit rate "
        f"{out['hit_rate']:.2f}, mean path {out['mean_path']:.1f}, "
        f"overflow epochs {out['overflow_epochs']}, "
        f"alive {out['alive']}/{W}")
    out["audit"] = pc.audit_summary(pc.audit_plane(st2, plane2))
    say(f"serving {out['audit']}")
    if mesh is None or mesh.size < 2 or W % mesh.size:
        say("sharded serving skipped (one rank; --ranks S starts S)")
        return out
    out["sharded"] = _sharded_demo(mesh, st, plane, kinds, keys, ups, B,
                                   say)
    return out


def _demo_rank(mesh, args) -> dict:
    return splay_demo(args, mesh)


def _sharded_demo(mesh, st, plane, kinds, keys, ups, B, say) -> dict:
    """The reference's sharded loop, on every rank of ``mesh``: each
    piece against the replicated loop on this rank's own copy."""
    import torch
    from repro_torch.core import device_index as dix
    from repro_torch.core import plane_check as pc
    from repro_torch.core import route_controller as rc
    from repro_torch.core import splaylist as sx
    from repro_torch.kernels import ops as kops
    from repro_torch.parallel import sharding as shd

    E, S = keys.shape[0], mesh.size
    plane_s = shd.shard_index_plane(plane, mesh)
    ck = np.zeros_like(kinds)
    kw = dict(aggregate=True, plane_search=True)
    fields = ("keys", "widths", "heights", "rank_map")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # contains-only epochs answered by the routed sharded search and
    # refreshed by the sharded refresh, against the replicated loop
    st_r, pl_r, res_r, plen_r, _, _, _ = sx.run_serving(st, plane, ck, keys,
                                                        ups, **kw)
    st_s, pl_s, res_s, plen_s, _, spill_s, occ_s = sx.run_serving(
        st, plane_s, ck, keys, ups, mesh=mesh, **kw)
    g = shd.gather_index_plane(pl_s)
    serve_match = (same((res_s, plen_s), (res_r, plen_r))
                   and same([getattr(g, f) for f in fields],
                            [getattr(pl_r, f) for f in fields]))
    # the mass-weighted re-split: the plane goes segmented, so only the
    # answers and the state are compared
    st_m, _, res_m, plen_m, _, spill_m, occ_m = sx.run_serving(
        st, plane_s, ck, keys, ups, mesh=mesh, split="mass", **kw)
    mass_match = same((res_m, plen_m, st_m.key), (res_r, plen_r, st_r.key))
    occ_s, occ_m = occ_s.cpu().numpy(), occ_m.cpu().numpy()
    for e in range(E):
        say(f"  epoch {e}: spill {int(spill_s[e]):4d}/{int(spill_m[e]):4d} "
            f"(lanes/mass), max-share {rc.max_share(occ_s[e]):.2f}/"
            f"{rc.max_share(occ_m[e]):.2f}, gini "
            f"{rc.routing_gini(occ_s[e]):.2f}/"
            f"{rc.routing_gini(occ_m[e]):.2f}")

    # the search alone, sharded against gathered
    qs = torch.as_tensor(keys[0], device=mesh.device)
    search_match = same(kops.splay_search_sharded(pl_s, qs, mesh=mesh),
                        kops.splay_search(pl_s, qs, sharded=False))

    # one mixed op batch, then the refresh sharded against replicated
    st3, _, _ = sx.run_ops(st, kinds[0], keys[0], ups[0])
    ps, ov_s = dix.refresh_device_sharded(st3, plane_s, max_new=B,
                                          mesh=mesh)
    pr, ov_r = dix.refresh_device(st3, plane, max_new=B,
                                  return_overflow=True)
    g = shd.gather_index_plane(ps)
    refresh_match = same([getattr(g, f) for f in fields],
                         [getattr(pr, f) for f in fields])
    say(f"sharded refresh {pc.audit_summary(pc.audit_plane(st3, ps))}")

    # the closed loop: the controller steering slack, split and rebuild
    cfg, c0 = rc.init_controller(S)
    st_c, _, res_c, plen_c, _, spl_c, occ_c, cstates = \
        rc.run_serving_controlled(st, plane_s, ck, keys, ups, mesh=mesh,
                                  cfg=cfg, state=c0, **kw)
    ctrl_match = same((res_c, plen_c), (res_r, plen_r))
    cfin = cstates[-1]
    say(f"controller: bit_identical={ctrl_match}, slack "
        f"{c0.slack_of(cfg)} -> {cfin.slack_of(cfg)}, split -> "
        f"{cfin.split}, retraces {cfin.retraces}, escalations "
        f"{cfin.escalations}, spill {int(spl_c.sum())}, final max-share "
        f"{cfin.last_share:.2f}, gini {cfin.last_gini:.2f}")
    out = {
        "shards": S, "backend": mesh.backend,
        "serving_bit_identical": serve_match,
        "mass_split_bit_identical": mass_match,
        "search_bit_identical": search_match,
        "refresh_bit_identical": refresh_match,
        "overflow": int(ov_s),
        "routed_spill": int(spill_s.sum()),
        "routed_spill_mass": int(spill_m.sum()),
        "max_share_lanes": rc.max_share(occ_s.sum(0)),
        "max_share_mass": rc.max_share(occ_m.sum(0)),
        "routing_gini_lanes": rc.routing_gini(occ_s.sum(0)),
        "routing_gini_mass": rc.routing_gini(occ_m.sum(0)),
        "controller_bit_identical": ctrl_match,
        "controller_retraces": int(cfin.retraces),
        "controller_escalations": int(cfin.escalations),
        "controller_spill": int(spl_c.sum())}
    say(f"sharded serving on {S} shards ({mesh.backend}): "
        f"epochs bit_identical={serve_match}, "
        f"mass-split bit_identical={mass_match}, "
        f"search bit_identical={search_match}, "
        f"refresh bit_identical={refresh_match}, "
        f"overflow={int(ov_s)} (replicated {int(ov_r)}), "
        f"controller bit_identical={ctrl_match}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model, the caches and the "
                         "index (default: the card)")
    ap.add_argument("--splay-demo", action="store_true",
                    help="drive the splay index-plane serving loop "
                         "instead of the LM engine")
    ap.add_argument("--ranks", type=int, default=1,
                    help="--splay-demo: start this many ranks (one process "
                         "each) and run the sharded serving loop over them")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of --ranks: gloo puts "
                         "every rank on the one card (or the CPU), nccl "
                         "one rank on each card")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device-index", action="store_true",
                    help="answer session lookups from the device index "
                         "plane instead of the host splay-list")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests per decode "
                         "step (0 = a burst at time zero)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="publish a crash-consistent serving snapshot "
                         "(pool + index + controller + engine queue) "
                         "here after the run")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot from "
                         "--snapshot-dir before serving (auto-resume; "
                         "a fresh start if the directory is empty)")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run the plane fsck every K lookup epochs on "
                         "the device index (0 = off)")
    args = ap.parse_args(argv)

    if args.splay_demo:
        return splay_demo(args)

    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    params = zoo.build_params(cfg, seed=args.seed, device=args.device)
    eng = Engine(cfg, params, max_batch=args.max_batch, max_seq=128,
                 device_index=args.device_index,
                 audit_every=args.audit_every, device=args.device)
    mgr = None
    if args.snapshot_dir:
        mgr = CheckpointManager(args.snapshot_dir)
        if args.resume and mgr.latest_step() is not None:
            pool, eng_state, summary = snap.restore_serving_snapshot(
                mgr, audit_every=args.audit_every or None,
                device=args.device)
            eng.pool = pool
            snap.apply_engine_state(eng, eng_state)
            print(summary)
    arrivals = workload.poisson_zipf_arrivals(
        args.requests, args.rate if args.rate > 0 else float("inf"),
        cfg.vocab, prompt_len=(2, 7), max_new=args.max_new,
        seed=args.seed)
    for i in range(args.requests):
        L = int(arrivals.prompt_lens[i])
        eng.submit(Request(
            seq_id=int(arrivals.seq_ids[i]),
            prompt=arrivals.prompts[i, :L].copy(),
            max_new=int(arrivals.max_new[i]),
            arrival=int(arrivals.arrival[i])))
    results = eng.run()
    for sid in sorted(results):
        print(f"seq {sid}: {results[sid]}")
    lat = sorted(eng.latencies.values())
    p50 = lat[len(lat) // 2] if lat else 0
    print(f"served {len(results)} sequences; pool util "
          f"{eng.pool.utilization:.2f}; p50 latency {p50} steps; "
          f"stalls {eng.stalls}; preemptions {eng.preemptions}; "
          f"degraded retries {eng.degraded_retries}")
    if eng.pool.device and args.audit_every:
        from repro_torch.core import plane_check as pc
        print(pc.audit_summary(eng.pool.audit()))
    if mgr is not None:
        snap.save_serving_snapshot(mgr, eng.clock, eng.pool, engine=eng)
        print(f"saved serving snapshot step {eng.clock} "
              f"to {args.snapshot_dir}")
    return results


if __name__ == "__main__":
    main()
