"""Serving example: continuous batching with the splay-indexed page pool
and the adaptive hot-vocab tier, then the routed width-sharded serving
loop end to end over ``SERVE_SHARDS`` ranks (the twin of the reference's
``examples/serve_adaptive.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_adaptive
      [--device cpu] [--backend nccl]

The engine demo runs meshless on one device.  The second half starts
``SERVE_SHARDS`` ranks (default 4; ``launch.spmd``, one process each:
gloo puts them all on the one card or the CPU, ``--backend nccl`` one
card a rank), shards the splay index plane over them, serves
contains-only epochs answered by the *routed* sharded plane search,
refreshed by the sharded refresh under the mass-weighted boundary
re-split, and prints the spill/occupancy picture next to the answers;
then the routing controller steers a stream whose hot set migrates.
Every rank runs the same calls; rank 0 prints.  ``main`` returns the
engine demo's printed lines and each rank's result (its printed lines,
its device and its kernels' launches).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import model_zoo as zoo
from repro_torch.serve.engine import Engine, Request

N_SHARDS = int(os.environ.get("SERVE_SHARDS", "4"))


def engine_demo(device="cuda", params=None, say=print) -> None:
    """minitron-8b's smoke config through ``Engine``: 8 requests of
    random prompts.  ``params`` defaults to ``zoo.build_params`` with
    seed 0."""
    cfg = registry.get_smoke("minitron-8b")
    if params is None:
        params = zoo.build_params(cfg, seed=0, device=device)
    eng = Engine(cfg, params, max_batch=4, max_seq=64, device=device)

    rng = np.random.default_rng(0)
    for i in range(8):
        prompt = rng.integers(1, cfg.vocab, rng.integers(2, 6))
        eng.submit(Request(seq_id=i, prompt=prompt, max_new=8))
    results = eng.run()
    for sid, toks in sorted(results.items()):
        say(f"seq {sid}: generated {toks}")
    say(f"page pool utilization after drain: {eng.pool.utilization:.2f}")
    if eng.vocab_cache is not None:
        say(f"vocab cache: m={eng.vocab_cache.m}, "
            f"hot={len(eng.vocab_cache.hot_ids)} ids")


def _populated(mesh, keys, cap, L):
    from repro_torch.core import splaylist as sx
    st = sx.make(capacity=cap, max_level=L, device=mesh.device)
    st, _, _ = sx.run_ops(st, np.full((len(keys),), sx.OP_INSERT, np.int32),
                          keys, np.ones((len(keys),), bool))
    return st


def routed_sharded_serving_demo(mesh, say=print) -> None:
    """Splay state -> width-sharded plane -> epochs of Zipf-skewed
    contains batches answered by the routed sharded search, refreshed
    with the mass-weighted boundary re-split."""
    from repro_torch.core import device_index as dix
    from repro_torch.core import plane_check as pc
    from repro_torch.core import route_controller as rc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import splay_search as ssk
    from repro_torch.core import splaylist as sx
    from repro_torch.parallel import sharding as shd

    n_dev = mesh.size
    cap, L = 1026, 12
    W = cap - 2                                   # 1024: divides 2/4/8
    if n_dev < 2 or W % n_dev:
        say(f"routed sharded serving skipped ({n_dev} device(s))")
        return

    rng = np.random.default_rng(0)
    pool = np.sort(rng.choice(20 * W, int(W * 0.75),
                              replace=False)).astype(np.int32)
    st = _populated(mesh, pool, cap, L)
    plane = dix.from_state_device(st, n_levels=L, width=W)
    plane_s = shd.shard_index_plane(plane, mesh)
    # the plane audit at each refresh boundary: clean planes print
    # exactly "audit OK"
    say(f"build {pc.audit_summary(pc.audit_plane(st, plane))}")

    # Zipf-skewed contains epochs, hotness scattered across the key
    # space (ranks permuted), enough volume for the accumulated hits to
    # outweigh the mass formula's floor of 1 per key
    E, B = 8, 512
    ranks = rng.permutation(len(pool))
    p = 1.0 / (1 + ranks) ** 1.0
    p /= p.sum()
    keys = rng.choice(pool, (E, B), p=p).astype(np.int32)
    kinds = np.zeros((E, B), np.int32)            # contains-only
    ups = rng.random((E, B)) < 0.7

    st2, plane2, res, plen, ovf, spill, occ_e = sx.run_serving(
        st, plane_s, kinds, keys, ups, aggregate=True, plane_search=True,
        mesh=mesh, split="mass")
    nseg = n_dev if dix.plane_is_segmented(plane2) else 1
    say(f"serving "
        f"{pc.audit_summary(pc.audit_plane(st2, plane2, n_segments=nseg))}")

    # the routed exchange's balance on the final (re-split) plane
    _, _, _, stats = kops.splay_search_sharded(
        plane2, torch.as_tensor(keys[-1], device=mesh.device), mesh=mesh,
        return_stats=True)
    occ = stats.occupancy.cpu().numpy()
    res, plen = res.cpu().numpy(), plen.cpu().numpy()
    ovf, spill = ovf.cpu().numpy(), spill.cpu().numpy()
    occ_e = occ_e.cpu().numpy()
    say(f"routed sharded serving on {n_dev} shards: {E} epochs x {B} "
        f"contains, hit rate {float(res.mean()):.2f}, "
        f"mean level-found {float(plen.mean()):.1f}")
    say(f"  overflow epochs {int((ovf > 0).sum())}, "
        f"spill per epoch {spill.tolist()} "
        f"(capacity {ssk.route_capacity(B, n_dev)}/shard — watch it "
        f"fall as the re-split adapts)")
    for e in range(E):
        say(f"  epoch {e}: spill {int(spill[e]):3d}, "
            f"max-share {rc.max_share(occ_e[e]):.2f}, "
            f"gini {rc.routing_gini(occ_e[e]):.2f}")
    say(f"  post-re-split occupancy per shard: {occ.tolist()} "
        f"(max share {occ.max() / max(occ.sum(), 1):.2f}, "
        f"ideal {1 / n_dev:.2f})")
    # the adaptivity contract: once the mass re-split has had epochs of
    # hit counters to work with, the exchange fits in capacity again
    tail = spill[E // 2:] / B
    if not (tail <= 0.01).all():
        raise RuntimeError(f"mass re-split failed to absorb the skew: "
                           f"tail spill {tail}")
    say(f"  re-split recovery: tail spill rate "
        f"{float(tail.max()):.4f} <= 0.01 ✓")


def controlled_serving_demo(mesh, say=print) -> None:
    """The closed loop: the same Zipf stream with its hot set MIGRATING
    mid-run, steered by the routing controller (slack ladder and
    lanes->mass escalation driven by the spill/occupancy feedback),
    recovery checked."""
    from repro_torch.core import device_index as dix
    from repro_torch.core import route_controller as rc
    from repro_torch.core import workload as wl
    from repro_torch.parallel import sharding as shd

    n_dev = mesh.size
    cap, L = 1026, 12
    W = cap - 2
    if n_dev < 2 or W % n_dev:
        say(f"controlled serving skipped ({n_dev} device(s))")
        return

    E, B = 10, 512
    drift = wl.rotating_hotset_workload(int(W * 0.75), E, B, period=5,
                                        seed=3)
    st = _populated(mesh, drift.populate, cap, L)
    plane_s = shd.shard_index_plane(
        dix.from_state_device(st, n_levels=L, width=W), mesh)

    cfg, c0 = rc.init_controller(n_dev)
    _, _, res, _, _, spl, occ, states = rc.run_serving_controlled(
        st, plane_s, drift.kinds, drift.keys, drift.upd, aggregate=True,
        plane_search=True, mesh=mesh, cfg=cfg, state=c0)
    spl, occ = spl.cpu().numpy(), occ.cpu().numpy()
    say(f"controlled serving on {n_dev} shards: {E} epochs x {B}, "
        f"hot set migrates at {list(drift.transitions)}, hit rate "
        f"{float(res.cpu().numpy().mean()):.2f}")
    for e, s in enumerate(states):
        mark = " <- transition" if e in drift.transitions else ""
        say(f"  epoch {e}: spill {int(spl[e]):3d}, "
            f"max-share {rc.max_share(occ[e]):.2f}, "
            f"slack {s.slack_of(cfg)}, split {s.split}{mark}")
    # recovery contract: within the ladder-length bound of each
    # migration, spill is back under 1% of the batch
    k = len(cfg.slack_ladder)
    sr = spl / B
    for t in drift.transitions:
        win = sr[t:min(t + k + 1, E)]
        if not (win <= 0.01).any():
            raise RuntimeError(f"no recovery within {k} epochs of "
                               f"transition {t}: {sr}")
    say(f"  controller recovery: <=1% spill within {k} epochs of "
        f"every migration ✓ (retraces {states[-1].retraces}, "
        f"escalations {states[-1].escalations})")


def sharded_demos(mesh) -> dict:
    """Both sharded demos on this rank: the lines it printed (rank 0's
    only), its device, and the launches of each kernel in this rank's
    process."""
    from repro_torch.kernels import ops
    lines = []
    say = lines.append if mesh.index == 0 else (lambda line: None)
    routed_sharded_serving_demo(mesh, say)
    controlled_serving_demo(mesh, say)
    return {"lines": lines, "device": str(mesh.device),
            "launches": ops.launch_counts()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the engine's device and the ranks' (default: "
                         "the card)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the ranks' process-group backend: gloo puts "
                         "every rank on the one card (or the CPU), nccl "
                         "one rank on each card")
    args = ap.parse_args(argv)
    from repro_torch.core.splaylist import _device
    from repro_torch.launch import spmd
    dev = _device(args.device)
    out = {"engine": []}

    def say(line):
        out["engine"].append(line)
        print(line, flush=True)

    engine_demo(dev, say=say)
    out["ranks"] = spmd.spawn(
        sharded_demos, N_SHARDS, backend=args.backend,
        device="cpu" if dev.type == "cpu" else "cuda")
    for line in out["ranks"][0]["lines"]:
        print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
