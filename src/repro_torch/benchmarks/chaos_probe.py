"""Chaos probe on the port's SPMD layer: fault injection, the plane's
audit, and crash recovery.

    python -m repro_torch.benchmarks.chaos_probe --parity   # the battery
    python -m repro_torch.benchmarks.chaos_probe --bench    # JSON out

Both start 4 ranks (``launch.spmd.spawn``: gloo, every rank on
``cuda:0``; ``--backend nccl`` one rank a card; ``--device cpu`` for a
run on the CPU), call :func:`run_battery` on each with the world mesh
and a snapshot directory they share, and hold rank 0's dict to the four
assertions of :func:`check`; ``--parity`` then prints ``CHAOS RECOVERY
OK``, ``--bench`` the dict as one JSON line.  The battery:

  (1) the clean planes audit clean: meshless, lanes-sharded and
      mass-split (segmented) planes from the real build and refresh
      paths return an all-zero ``PlaneAudit``;
  (2) every ``core.faults`` bit-flip family is detected on the packed
      and the segmented layouts;
  (3) device pools replay request traces under bit-flip, telemetry and
      shard-loss chaos with every verdict equal to an undisturbed host
      pool's (meshless and on the 1 x 4 mesh), down the routed ->
      masked -> host ladder and back to routed within
      ``RECOVERY_BOUND`` lookup epochs of every injection;
  (4) an ``InjectedCrash`` between flush and lookup, restored from the
      latest snapshot, replays the pending ops exactly once;
  (5) host, meshless and 1 x 4 pools continue a half-replayed trace
      identically after a snapshot and a restore, and so do a 4 -> 2
      restore (``elastic.remesh``) and a mesh -> meshless one.

A snapshot of a pool on the mesh is written by the mesh's first rank
into the shared directory; a meshless pool's goes to a directory of
its rank.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.core import device_index as dix
from repro_torch.core import faults as fl
from repro_torch.core import plane_check as pc
from repro_torch.core import splaylist as sx
from repro_torch.core import workload as wl
from repro_torch.parallel import sharding as shd
from repro_torch.serve import snapshot as snap
from repro_torch.serve.kv_cache import PagedKVPool
from repro_torch.train import elastic
from repro_torch.train.checkpoint import CheckpointManager

RECOVERY_BOUND = 4          # lookup epochs from injection back to routed
WIDTH = 32                  # divisible by 1/2/4 (shard-loss shrink path)
BATCH = 16
N_PAGES = 48
PAGE = 8
N_DEV = 4


def _mesh(world, n=N_DEV):
    """The world mesh, or (every rank calls it) the ``1 x n`` mesh of
    its first ``n`` ranks, ``None`` on the others."""
    if n == world.size:
        return world
    return elastic.remesh(list(range(n)), model_parallel=n,
                          device=world.device)


def _pool(world, mesh=None, **kw):
    return PagedKVPool(N_PAGES, PAGE, mesh=mesh, torch_device=world.device,
                       **kw)


def _dev_pool(world, mesh=None, **kw):
    return _pool(world, mesh, device=True, index_width=WIDTH,
                 index_batch=BATCH, **kw)


def _seeded_state(device, n_keys=20, seed=11):
    rng = np.random.default_rng(seed)
    keys = rng.choice(10_000, n_keys, replace=False).astype(np.int32)
    st = sx.make(WIDTH + 2, max_level=8, device=device)
    st, _, _ = sx.run_ops(st, np.full(n_keys, sx.OP_INSERT, np.int32),
                          keys, np.ones(n_keys, bool))
    for _ in range(4):
        q = rng.choice(keys, n_keys).astype(np.int32)
        st, _, _ = sx.run_contains_batch(st, q, np.ones(n_keys, bool),
                                         aggregate=True)
    return st


def _planes(world, st):
    """(name, plane, n_segments) triples from the real layout paths."""
    packed = dix.from_state_device(st, n_levels=8, width=WIDTH)
    sharded = shd.shard_index_plane(packed, world)
    lanes, _ = dix.refresh_device_sharded(st, sharded, max_new=4,
                                          mesh=world, split="lanes")
    mass, _ = dix.refresh_device_sharded(st, sharded, max_new=4,
                                         mesh=world, split="mass")
    return [("meshless", packed, 1), ("lanes4", lanes, 1),
            ("mass4", mass, world.size)]


def audit_battery(world) -> dict:
    """Parts (1)-(2): clean planes audit clean; every bit-flip family
    is detected on packed and segmented layouts."""
    st = _seeded_state(world.device)
    out = {"clean": {}, "families": {}}
    planes = _planes(world, st)
    for name, plane, nseg in planes:
        a = pc.audit_plane(st, plane, n_segments=nseg)
        out["clean"][name] = pc.audit_ok(a)
        if not pc.audit_ok(a):
            raise AssertionError(f"clean {name} plane failed: {a}")
    for fi, field in enumerate(fl.BITFLIP_FIELDS):
        inj = det = 0
        for name, plane, nseg in planes:
            for trial in range(6):
                bad, recs = fl.flip_plane_bits(
                    plane, np.random.default_rng([trial, fi]), 1,
                    fields=(field,))
                if not recs:
                    continue
                inj += 1
                a = pc.audit_plane(st, bad, n_segments=nseg)
                det += int(not pc.audit_ok(a))
        out["families"][field] = {"injected": inj, "detected": det}
        if det != inj:
            raise AssertionError(f"{field}: {det}/{inj} detected")
    return out


def _replay_chaos(dev: PagedKVPool, host: PagedKVPool,
                  trace: wl.KVTrace, plan) -> dict:
    """Replay a trace on a chaos-injected device pool and an
    undisturbed host mirror; every lookup verdict must match, and the
    rung trajectory must return to 0 within RECOVERY_BOUND lookups of
    every injection."""
    kinds, sids = np.asarray(trace.kinds), np.asarray(trace.seq_ids)
    wrong = 0
    rung_traj = []
    for t in range(kinds.size):
        k, s = int(kinds[t]), int(sids[t])
        if k == wl.KV_CREATE:
            a, b = dev.create(s), host.create(s)
            if a != b:
                raise AssertionError(f"create disagreement at op {t}")
        elif k == wl.KV_RELEASE:
            dev.release(s)
            host.release(s)
        else:
            va = bool(dev.lookup_batch([s])[0])
            vb = bool(host.lookup_batch([s])[0])
            wrong += int(va != vb)
            rung_traj.append(int(dev._rung))
    # recovery: after each degraded lookup the rung returns to 0 within
    # RECOVERY_BOUND lookups
    rec_max = 0
    arr = np.asarray(rung_traj)
    for i in np.nonzero(arr)[0]:
        back = arr[i:i + RECOVERY_BOUND + 1]
        steps = int(np.argmax(back == 0)) if (back == 0).any() else 10 ** 9
        rec_max = max(rec_max, steps)
    return {"wrong_verdicts": wrong, "recovery_epochs_max": rec_max,
            "injected": int(dev.stats["faults_injected"]),
            "audit_failures": int(dev.stats["audit_failures"]),
            "repairs": int(dev.stats["repairs"]),
            "degraded_masked": int(dev.stats["degraded_masked"]),
            "degraded_host": int(dev.stats["degraded_host"]),
            "remeshes": int(dev.stats["remeshes"]),
            "telemetry_dropped": int(dev.stats["telemetry_dropped"])}


def chaos_serving(world) -> dict:
    """Part (3): bit-flip and telemetry chaos meshless and on the 1 x 4
    mesh, plus mid-serving shard loss 4 -> 2 -> replicated."""
    out = {}
    plan = fl.FaultPlan(seed=2, events=[
        fl.FaultEvent(3, fl.FAULT_BITFLIP, 2),
        fl.FaultEvent(8, fl.FAULT_TELEMETRY, 2),
        fl.FaultEvent(13, fl.FAULT_BITFLIP, 1)])
    dev = _dev_pool(world, audit_every=1, fault_plan=plan)
    host = _pool(world)
    out["meshless"] = _replay_chaos(
        dev, host, wl.kv_request_trace(150, 24, seed=5), plan)

    plan4 = fl.FaultPlan(seed=4, events=[
        fl.FaultEvent(3, fl.FAULT_BITFLIP, 2),
        fl.FaultEvent(9, fl.FAULT_SHARD_LOSS, 2),
        fl.FaultEvent(15, fl.FAULT_SHARD_LOSS, 3)])  # 3 !| 32: replicated
    dev4 = _dev_pool(world, _mesh(world), audit_every=1, fault_plan=plan4)
    host4 = _pool(world)
    out["mesh4"] = _replay_chaos(
        dev4, host4, wl.kv_request_trace(150, 24, seed=6), plan4)
    for name, r in out.items():
        if r["wrong_verdicts"]:
            raise AssertionError(f"{name}: wrong verdicts")
        if r["audit_failures"] < 1:
            raise AssertionError(f"{name}: chaos went undetected")
        if r["recovery_epochs_max"] > RECOVERY_BOUND:
            raise AssertionError(f"{name}: recovery took "
                                 f"{r['recovery_epochs_max']} epochs")
        if r["degraded_masked"] < 1:
            raise AssertionError(f"{name}: masked rung never exercised")
    if out["mesh4"]["remeshes"] != 2:
        raise AssertionError(f"mesh4: {out['mesh4']['remeshes']} remeshes")
    if out["meshless"]["telemetry_dropped"] < 1:
        raise AssertionError("meshless: no telemetry dropped")

    # rung 2 (the host oracle): hold the ladder at its bottom, check the
    # oracle's verdicts, then the climb back takes one clean pass a rung
    live = sorted(host.chains)[:6]
    probes = live + [10 ** 6, 10 ** 6 + 1]      # present and absent ids
    before = int(dev.stats["degraded_host"])
    for s in probes:
        dev._rung = 2
        va = bool(dev.lookup_batch([s])[0])
        vb = bool(host.lookup_batch([s])[0])
        if va != vb:
            raise AssertionError(f"host-oracle rung wrong verdict for {s}")
    if dev.stats["degraded_host"] - before != len(probes):
        raise AssertionError("the host-oracle rung was not taken")
    for s in probes[:3]:                         # release: climb back
        dev.lookup_batch([s])
    if dev._rung != 0:
        raise AssertionError(f"ladder climb stalled at rung {dev._rung}")
    out["meshless"]["degraded_host"] = int(dev.stats["degraded_host"])
    return out


def _drive(pool, trace, lo, hi, record):
    kinds, sids = np.asarray(trace.kinds), np.asarray(trace.seq_ids)
    for t in range(lo, hi):
        k, s = int(kinds[t]), int(sids[t])
        if k == wl.KV_CREATE:
            pool.create(s)
        elif k == wl.KV_RELEASE:
            pool.release(s)
        else:
            record.append((t, bool(pool.lookup_batch([s])[0])))


def crash_replay(world, tmp: str) -> dict:
    """Part (4): snapshot every 20 ops, crash mid-trace between flush
    and lookup, restore from the latest snapshot and re-drive: the
    verdict stream and final live set equal the uninterrupted run's
    (pending ops replayed exactly once).  Meshless: each rank in a
    directory of its own under ``tmp``."""
    trace = wl.kv_request_trace(120, 20, seed=9)
    ref = _dev_pool(world)
    ref_rec = []
    _drive(ref, trace, 0, 120, ref_rec)

    crash_at = 17                         # lookup epoch of the kill
    plan = fl.FaultPlan(seed=1, events=[
        fl.FaultEvent(crash_at, fl.FAULT_CRASH)])
    pool = _dev_pool(world, fault_plan=plan)
    rec = []
    mgr = CheckpointManager(os.path.join(tmp, f"crash-rank{world.index}"),
                            keep=2)
    kinds, sids = np.asarray(trace.kinds), np.asarray(trace.seq_ids)
    crashed_op = None
    pending_at_snap = 0
    t = 0
    while t < 120:
        k, s = int(kinds[t]), int(sids[t])
        try:
            if k == wl.KV_CREATE:
                pool.create(s)
            elif k == wl.KV_RELEASE:
                pool.release(s)
            else:
                rec.append((t, bool(pool.lookup_batch([s])[0])))
        except fl.InjectedCrash:
            crashed_op = t
            # the machine is gone: restore the latest snapshot onto a
            # fresh pool and re-drive from its trace cursor
            pool, _, _ = snap.restore_serving_snapshot(mgr,
                                                       device=world.device)
            _, extra = mgr.load(mgr.latest_step())
            t = int(extra["user"]["next_op"])
            rec = [x for x in rec if x[0] < t]
            continue
        t += 1
        if t % 20 == 0:
            pending_at_snap = max(pending_at_snap, len(pool._pending))
            snap.save_serving_snapshot(mgr, t, pool,
                                       user_extra={"next_op": t})
    if crashed_op is None:
        raise AssertionError("crash event never fired")
    if rec != ref_rec:
        raise AssertionError("post-restore verdicts diverged")
    if sorted(pool.chains) != sorted(ref.chains):
        raise AssertionError("post-restore live set diverged")
    return {"crashed_at_op": crashed_op,
            "pending_at_snapshot": pending_at_snap,
            "replay_exactly_once": rec == ref_rec}


def restore_matrix(world, tmp: str) -> dict:
    """Part (5): snapshot -> restore bit-identity on host, meshless and
    1 x 4 pools, plus 4 -> 2 and 4 -> meshless restores."""
    trace = wl.kv_request_trace(100, 20, seed=13)
    out = {}

    def roundtrip(make_pool, restore_kw, tag):
        ref = make_pool()
        ref_rec = []
        _drive(ref, trace, 0, 50, ref_rec)
        on_mesh = ref.device and ref.mesh is not None
        d = os.path.join(tmp, tag if on_mesh else
                         f"{tag}-rank{world.index}")
        mgr = CheckpointManager(d)
        snap.save_serving_snapshot(mgr, 50, ref)
        pool, _, summary = snap.restore_serving_snapshot(
            mgr, device=world.device, **restore_kw)
        tail_ref, tail_new = list(ref_rec), list(ref_rec)
        _drive(ref, trace, 50, 100, tail_ref)
        _drive(pool, trace, 50, 100, tail_new)
        ok = tail_new == tail_ref and sorted(pool.chains) == \
            sorted(ref.chains)
        out[tag] = {"bit_identical": ok, "summary": summary}
        if not ok:
            raise AssertionError(f"{tag}: restore diverged")

    roundtrip(lambda: _pool(world), {}, "host")
    roundtrip(lambda: _dev_pool(world), {}, "meshless")
    roundtrip(lambda: _dev_pool(world, _mesh(world)),
              {"mesh": _mesh(world)}, "mesh4")
    roundtrip(lambda: _dev_pool(world, _mesh(world)),
              {"mesh": _mesh(world, 2)}, "mesh4_to_2")
    roundtrip(lambda: _dev_pool(world, _mesh(world)), {},
              "mesh4_to_meshless")
    return out


def run_battery(world, tmp: str) -> dict:
    """The whole battery on the world mesh (every rank calls this, with
    the same ``tmp``); this rank's counts and flags."""
    t0 = time.time()
    audits = audit_battery(world)
    chaos = chaos_serving(world)
    crash = crash_replay(world, tmp)
    restores = restore_matrix(world, tmp)
    injected = sum(f["injected"] for f in audits["families"].values())
    detected = sum(f["detected"] for f in audits["families"].values())
    serving_injected = sum(r["injected"] for r in chaos.values()) + 1
    return {
        "backends": ["host", "meshless", "mesh4"],
        "shards": world.size,
        "fault_families": list(fl.FAULT_FAMILIES),
        "injected": injected + serving_injected,
        "detected": detected + serving_injected,
        "detection_within_epochs": 1,
        "wrong_verdicts": sum(r["wrong_verdicts"] for r in chaos.values()),
        "recovery_bound_epochs": RECOVERY_BOUND,
        "recovery_epochs_max": max(r["recovery_epochs_max"]
                                   for r in chaos.values()),
        "restore_bit_identical": all(r["bit_identical"]
                                     for r in restores.values()),
        "replay_exactly_once": crash["replay_exactly_once"],
        "audit_matrix": audits,
        "chaos": chaos,
        "crash": crash,
        "restores": {k: v["bit_identical"] for k, v in restores.items()},
        "wall_s": round(time.time() - t0, 1),
    }


def check(out: dict) -> None:
    """The battery's four gates: detected == injected, no wrong
    verdict, recovery within the bound, restores and replay exact."""
    if out["detected"] != out["injected"]:
        raise AssertionError(f"detected {out['detected']} of "
                             f"{out['injected']} injected faults")
    if out["wrong_verdicts"] != 0:
        raise AssertionError(f"{out['wrong_verdicts']} wrong verdicts")
    if out["recovery_epochs_max"] > out["recovery_bound_epochs"]:
        raise AssertionError(f"recovery took {out['recovery_epochs_max']}"
                             f" epochs, bound {out['recovery_bound_epochs']}")
    if not (out["restore_bit_identical"] and out["replay_exactly_once"]):
        raise AssertionError(f"restores {out['restores']}, replay "
                             f"{out['replay_exactly_once']}")


def main(argv=None) -> dict:
    from repro_torch.launch import spmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="chaos-") as tmp:
        out = spmd.spawn(run_battery, N_DEV, tmp, backend=args.backend,
                         device=args.device,
                         threads=1 if args.device == "cpu" else None)[0]
    check(out)
    if args.bench:
        print(json.dumps(out))
        return out
    print(f"faults: {out['detected']}/{out['injected']} detected, "
          f"0 wrong verdicts, recovery <= "
          f"{out['recovery_epochs_max']} epochs, "
          f"restores bit-identical on {list(out['restores'])} "
          f"({out['wall_s']}s)")
    print("CHAOS RECOVERY OK")
    return out


if __name__ == "__main__":
    main()
