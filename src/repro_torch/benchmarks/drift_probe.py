"""Drift probe: the routing controller raced through distribution
shifts, on the port's SPMD layer.

    python -m repro_torch.benchmarks.drift_probe --parity   # the battery
    python -m repro_torch.benchmarks.drift_probe --bench    # JSON out

Both start 4 ranks (``launch.spmd.spawn``: gloo, every rank on
``cuda:0``; ``--backend nccl`` one rank a card; ``--device cpu`` for a
run on the CPU) and call :func:`run_parity` / :func:`run_bench` on each
with the world mesh.

:func:`run_parity` drives the closed-loop serving loop
(``core.route_controller.run_serving_controlled``) through the three
drift scenarios (``core.workload.DRIFT_SCENARIOS``) and raises
``AssertionError`` unless, for each: (1) every answer and path length
equals the meshless replicated ``run_serving``'s, bit for bit (the
controller only moves queries between routing paths); (2) after every
transition the spill returns to at most 1% of the batch within K
epochs, K the slack ladder's length (its top rung clamps the capacity
at q, where nothing can spill); (3) the static controller-off baseline
fails to recover within K somewhere (the scenarios are adversaries);
and (4) a drift-free stream whose pool fills the plane never actuates.

:func:`run_bench` races the controller against static lanes and static
mass through each scenario at the acceptance shape (W 4096, q 8192,
L 14) and returns per-epoch spill, max-share and Gini trajectories,
each transition's time to recover, the peak spill, the peak share after
the transition epoch, and the wall seconds of each policy's run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core import device_index as dix
from repro_torch.core import route_controller as rc
from repro_torch.core import splaylist as sx
from repro_torch.core import workload as wl
from repro_torch.kernels import ops as kops
from repro_torch.parallel import sharding as shd

N_DEV = 4
SPILL_OK = 0.01          # "recovered" = spill rate at or below this


def _require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _seed(pool: np.ndarray, cap: int, max_level: int, device):
    st = sx.make(capacity=cap, max_level=max_level, device=device)
    st, _, _ = sx.run_ops(st, np.full(len(pool), sx.OP_INSERT, np.int32),
                          pool, np.ones(len(pool), bool))
    return st


def _scenarios(n: int, epochs: int, batch: int, seed: int):
    """The three drift adversaries at a shared pool size; transition
    cadence sized so each regime holds long enough to recover in."""
    return [
        wl.rotating_hotset_workload(n, epochs, batch, period=5,
                                    seed=seed),
        wl.flash_crowd_workload(n, epochs, batch, onset=3, duration=5,
                                seed=seed),
        wl.diurnal_zipf_workload(n, epochs, batch, period=8, seed=seed),
    ]


def _recover_windows(transitions, epochs):
    """(transition, window-end) pairs: recovery is judged inside each
    regime, before the next shift re-perturbs the loop."""
    ts = [t for t in transitions if t < epochs]
    return [(t, (ts[i + 1] if i + 1 < len(ts) else epochs))
            for i, t in enumerate(ts)]


def _time_to_recover(spill_rate, t, end, k):
    """Epochs from transition ``t`` until spill first returns under
    ``SPILL_OK`` (capped at ``min(end, t+k+1)``); -1 = did not."""
    for e in range(t, min(end, t + k + 1)):
        if spill_rate[e] <= SPILL_OK:
            return e - t
    return -1


def _traj(spl, occ, batch):
    occ = occ.cpu().numpy()
    spill_rate = (spl.cpu().numpy() / batch).tolist()
    return (spill_rate, [rc.max_share(o) for o in occ],
            [rc.routing_gini(o) for o in occ])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_variants(drift, st, plane_s, mesh, controller_only=False):
    """Race the three routing policies over one drift stream, each from
    the same state and plane: ``(controller, static lanes, static
    mass)``, each a dict of the run's ``spl``, ``occ``, ``res``,
    ``plen`` and ``wall_s`` (the controller's also its ``states``)."""
    common = dict(aggregate=True, plane_search=True)
    cfg, c0 = rc.init_controller(mesh.size)
    dev = st.device

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    out, wall = timed(lambda: rc.run_serving_controlled(
        st, plane_s, drift.kinds, drift.keys, drift.upd, mesh=mesh,
        cfg=cfg, state=c0, **common))
    on = dict(spl=out[5], occ=out[6], res=out[2], plen=out[3],
              states=out[7], state=out[7][-1], cfg=cfg, wall_s=wall)
    if controller_only:
        return on, None, None
    runs = []
    for split in ("lanes", "mass"):
        out, wall = timed(lambda: sx.run_serving(
            st, plane_s, drift.kinds, drift.keys, drift.upd, mesh=mesh,
            split=split, **common))
        runs.append(dict(spl=out[5], occ=out[6], res=out[2], plen=out[3],
                         wall_s=wall))
    return on, runs[0], runs[1]


def _planes(pool, width, L, mesh):
    st = _seed(pool, width + 2, L, mesh.device)
    plane_r = dix.from_state_device(st, n_levels=L, width=width)
    return st, plane_r, shd.shard_index_plane(plane_r, mesh)


def state_dict(state) -> dict:
    """A ``ControllerState`` as plain Python values."""
    return {k: (v.item() if hasattr(v, "item") else v)
            for k, v in state._asdict().items()}


def trajectories(mesh, width=512, batch=256, epochs=8, seed=7) -> dict:
    """Every scenario raced by the three policies on ``mesh`` (every rank
    calls this): per scenario and policy, the per-epoch answers, path
    lengths, spill and occupancy as numpy arrays, and the controller's
    state after each epoch."""
    out = {}
    for drift in _scenarios(int(width * 0.75), epochs, batch, seed):
        st, _, plane_s = _planes(drift.populate, width, 12, mesh)
        runs = run_variants(drift, st, plane_s, mesh)
        out[drift.name] = {
            tag: {k: v[k].cpu().numpy() for k in ("res", "plen", "spl",
                                                    "occ")}
            for tag, v in zip(("controller", "static_lanes",
                               "static_mass"), runs)}
        out[drift.name]["controller"]["states"] = [
            state_dict(s) for s in runs[0]["states"]]
    return out


def run_parity(mesh, width=1024, batch=512, epochs=12, seed=7):
    """The recovery battery on ``mesh`` (every rank of it calls this);
    raises ``AssertionError`` on any violation.  Returns, per scenario,
    the controller's and static lanes' times to recover, the peak share,
    the actuation counts and the wall seconds of each policy, and the
    calm stream's actuation counts."""
    n = int(width * 0.75)
    L = 12
    k_bound = len(rc.default_slack_ladder(mesh.size))
    out = {"width": width, "batch": batch, "epochs": epochs,
           "shards": mesh.size, "recovery_bound_epochs": k_bound,
           "exec_mode": kops.exec_mode(mesh.device), "scenarios": {}}
    for drift in _scenarios(n, epochs, batch, seed):
        st, plane_r, plane_s = _planes(drift.populate, width, L, mesh)
        on, off, _ = run_variants(drift, st, plane_s, mesh)

        # (1) bit-identity with the meshless replicated loop
        ref = sx.run_serving(st, plane_r, drift.kinds, drift.keys,
                             drift.upd, aggregate=True, plane_search=True)
        _require(torch.equal(on["res"], ref[2]),
                 f"{drift.name}: controlled results diverged from "
                 "replicated")
        _require(torch.equal(on["plen"], ref[3]),
                 f"{drift.name}: controlled path lengths diverged")

        sr_on, sh_on, _ = _traj(on["spl"], on["occ"], batch)
        sr_off, _, _ = _traj(off["spl"], off["occ"], batch)
        wins = _recover_windows(drift.transitions, epochs) or \
            [(0, epochs)]
        ttr_on = [_time_to_recover(sr_on, t, e, k_bound) for t, e in wins]
        ttr_off = [_time_to_recover(sr_off, t, e, k_bound)
                   for t, e in wins]
        # (2) the controller recovers inside the structural bound
        _require(all(0 <= d <= k_bound for d in ttr_on),
                 f"{drift.name}: controller-on missed the recovery bound "
                 f"(ttr={ttr_on}, spill={sr_on})")
        # (3) the static baseline fails somewhere
        _require(any(d < 0 for d in ttr_off),
                 f"{drift.name}: controller-off also recovered everywhere "
                 f"(ttr={ttr_off}) — scenario is not an adversary")
        out["scenarios"][drift.name] = {
            "ttr_on": ttr_on, "ttr_off": ttr_off,
            "peak_share": max(sh_on), "retraces": on["state"].retraces,
            "escalations": on["state"].escalations,
            "wall_s": {"controller": on["wall_s"],
                       "static_lanes": off["wall_s"]}}

    # (4) hysteresis: a drift-free balanced stream never actuates.  The
    # pool fills the plane width: a partly filled packed plane leaves
    # the last equal-lane shard mostly pads, a real imbalance the
    # controller rightly escalates on
    rng = np.random.default_rng(seed)
    pool = np.sort(rng.choice(4 * width, width, replace=False)).astype(
        np.int32)
    st, _, plane_s = _planes(pool, width, L, mesh)
    E = 6
    keys = pool[rng.integers(0, width, (E, batch))].astype(np.int32)
    calm = wl.DriftStream(np.zeros((E, batch), np.int32), keys,
                          rng.random((E, batch)) < 0.1, pool, (), "calm")
    on, _, _ = run_variants(calm, st, plane_s, mesh, controller_only=True)
    _require(on["state"].retraces == 0 and on["state"].escalations == 0,
             f"steady state actuated: {on['state']}")
    _require(int(on["spl"].sum()) == 0, "the steady state spilled")
    out["calm"] = {"epochs": E, "retraces": on["state"].retraces,
                   "escalations": on["state"].escalations}
    return out


def run_bench(mesh, width=4096, nq=8192, epochs=10, seed=7):
    """The acceptance-shape race (every rank of ``mesh`` calls this);
    returns the reference's JSON shape."""
    n = int(width * 0.75)
    L = 14
    k_bound = len(rc.default_slack_ladder(mesh.size))
    out = {"width": width, "batch": nq, "epochs": epochs,
           "shards": mesh.size, "recovery_bound_epochs": k_bound,
           "spill_ok": SPILL_OK, "exec_mode": kops.exec_mode(mesh.device),
           "scenarios": {}}
    for drift in _scenarios(n, epochs, nq, seed):
        st, _, plane_s = _planes(drift.populate, width, L, mesh)
        on, off, mass = run_variants(drift, st, plane_s, mesh)
        wins = _recover_windows(drift.transitions, epochs) or \
            [(0, epochs)]
        row = {"transitions": list(drift.transitions)}
        for tag, v in (("controller", on), ("static_lanes", off),
                       ("static_mass", mass)):
            sr, sh, gi = _traj(v["spl"], v["occ"], nq)
            row[tag] = {
                "spill_rate": [round(x, 5) for x in sr],
                "max_share": [round(x, 4) for x in sh],
                "gini": [round(x, 4) for x in gi],
                "time_to_recover": [
                    _time_to_recover(sr, t, e, k_bound)
                    for t, e in wins],
                "peak_spill_rate": round(max(sr), 5),
                # the transition epoch spikes alike for every policy
                # (the shock lands before anyone can act): judge balance
                # from the first epoch a policy could respond
                "peak_share_post": round(max(
                    (sh[e] for t, end in wins
                     for e in range(min(t + 1, end), end)),
                    default=max(sh)), 4),
                "wall_s": round(v["wall_s"], 2),
            }
        row["controller"]["retraces"] = on["state"].retraces
        row["controller"]["escalations"] = on["state"].escalations
        row["controller"]["final_slack"] = on["state"].slack_of(on["cfg"])
        row["controller"]["final_split"] = on["state"].split
        out["scenarios"][drift.name] = row
    return out


def _rank(mesh, parity: bool, bench: bool, width: int, nq: int,
          epochs: int) -> dict:
    out = {}
    if parity:
        out["parity"] = run_parity(mesh)
    if bench:
        out["bench"] = run_bench(mesh, width=width, nq=nq, epochs=epochs)
    return out


def main(argv=None):
    from repro_torch.launch import spmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--nq", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not (args.parity or args.bench):
        ap.error("pass --parity and/or --bench")
    # CPU ranks run a thread each: the four share the host
    ranks = spmd.spawn(_rank, N_DEV, args.parity, args.bench, args.width,
                       args.nq, args.epochs, backend=args.backend,
                       device=args.device,
                       threads=1 if args.device == "cpu" else None)
    out = ranks[0]
    if args.parity:
        for name, s in out["parity"]["scenarios"].items():
            print(f"  {name:16s} ttr on={s['ttr_on']} off={s['ttr_off']} "
                  f"peak_share={s['peak_share']:.2f} "
                  f"retraces={s['retraces']} "
                  f"escalations={s['escalations']}", file=sys.stderr)
        print("drift parity OK", file=sys.stderr)
    if args.bench:
        print(json.dumps(out["bench"]))
    return out


if __name__ == "__main__":
    main()
