"""Serving driver: continuous batching with the splay-adaptive engine
(the twin of ``repro.launch.serve``, on one device).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The weights are random, drawn from ``--seed`` on the device (bfloat16
when the config says so).  ``--splay-demo`` instead drives the
ordered-map serving substrate directly: build a splay-list state and its
device index plane, run serving epochs (``splaylist.run_serving``: op
batches plus the incremental plane refresh with the overflow/rebuild
state machine), and audit the plane before and after.  The sharded
serving loop of the reference needs several devices and arrives with
the multi-device slice; on one device it is skipped, as the reference
skips it.  ``--snapshot-dir`` publishes a serving snapshot after the
run, and with ``--resume`` the latest one there is restored before the
requests arrive.  Runs on the card unless ``--device cpu`` is given.
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


def splay_demo(args) -> dict:
    """Build plane -> run_serving -> read results, with the plane audit
    at both ends."""
    import torch
    from repro_torch.core import device_index as dix
    from repro_torch.core import plane_check as pc
    from repro_torch.core import splaylist as sx
    from repro_torch.kernels import ops as kops

    dev = sx._device(args.device)
    print(f"splay demo: mode={kops.exec_mode(dev)}")
    rng = np.random.default_rng(args.seed)
    cap, L = 2050, 16
    W = cap - 2
    st = sx.make(capacity=cap, max_level=L, device=dev)
    pool = np.arange(0, 2000, 2, dtype=np.int32)
    st, _, _ = sx.run_ops(st, np.full((len(pool),), sx.OP_INSERT, np.int32),
                          pool, np.ones((len(pool),), bool))
    plane = dix.from_state_device(st, n_levels=L, width=W)
    # a clean plane prints exactly "audit OK"
    print(f"build {pc.audit_summary(pc.audit_plane(st, plane))}")

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
    print(f"splay serving: {E} epochs x {B} ops, hit rate "
          f"{out['hit_rate']:.2f}, mean path {out['mean_path']:.1f}, "
          f"overflow epochs {out['overflow_epochs']}, "
          f"alive {out['alive']}/{W}")
    out["audit"] = pc.audit_summary(pc.audit_plane(st2, plane2))
    print(f"serving {out['audit']}")
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"sharded serving skipped ({n_dev} device(s); the sharded loop "
          f"arrives with the multi-device slice)")
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
