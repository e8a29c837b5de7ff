"""Sharded-refresh race on the port's SPMD layer: the width-sharded
refresh (``device_index.refresh_device_sharded``) against the replicated
``refresh_device`` over a membership-changing epoch stream.

    python -m repro_torch.benchmarks.sharded_refresh_probe --bench

``main`` starts 4 ranks (``launch.spmd.spawn``: gloo, every rank on
``cuda:0``; ``--backend nccl`` one rank a card; ``--device cpu`` for a
run on the CPU), calls :func:`run_bench` on each with the world mesh and
prints rank 0's dict as one JSON line.  The race asserts the final
planes equal on ``CMP_FIELDS``.  The timing columns (``us_per_*``,
``epochs_per_sec_*``, ``ratio_*``) are the host clock around
synchronised folds; the structural columns (per-shard lanes and bytes)
are counts of the layout.  The differential battery of the refresh
(the reference's ``--parity``) is held by the port's tests.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import device_index as dix
from repro_torch.core import splaylist as sx
from repro_torch.kernels import ops as kops
from repro_torch.parallel import sharding as shd

N_DEV = 4
CMP_FIELDS = ("keys", "widths", "heights", "rank_map")


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_min(fn, reps: int, dev) -> float:
    """Min-of-reps seconds of ``fn`` after one warm-up call, the device
    synchronised around each run."""
    fn()
    best = float("inf")
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def synth_state(keys: np.ndarray, rel_h: np.ndarray, capacity: int,
                max_level: int = 8, selfhits=None, device="cuda"):
    """A ``SplayState`` with only the fields the refresh and mass-split
    paths read (key, top, zl, n_alloc; ``selfhits`` where given, 1 on
    every other slot) populated, so that epochs can be made directly at
    benchmark widths instead of replaying op streams."""
    st = sx.make(capacity, max_level=max_level, device=device)
    n = len(keys)
    key = np.full((capacity,), sx.POS_INF_32, np.int32)
    key[0] = sx.NEG_INF_32
    key[2:2 + n] = keys
    top = np.zeros((capacity,), np.int32)
    top[2:2 + n] = rel_h
    top[0] = top[1] = max_level
    fields = dict(key=key, top=top)
    if selfhits is not None:
        sh = np.ones((capacity,), np.int32)
        sh[2:2 + n] = selfhits
        fields["selfhits"] = sh
    i32 = dict(dtype=torch.int32, device=st.device)
    return st._replace(
        zl=torch.tensor(0, **i32), n_alloc=torch.tensor(n + 2, **i32),
        **{k: torch.as_tensor(v, device=st.device)
           for k, v in fields.items()})


def epoch_states(width: int, churn: int, epochs: int, seed: int,
                 device="cuda"):
    """``epochs + 1`` synthesized states of one evolving key set, as the
    engine evolves it (mark-delete in place, bump-allocate inserts, so
    the plane's slot map stays live-valid): each epoch marks ``churn``
    live slots deleted, appends ``churn`` fresh keys and redraws every
    height in ``[0, 5]``.  Returns ``(states, n_levels)``."""
    rng = np.random.default_rng(seed)
    n_levels, hmax = 6, 5
    n0 = int(width * 0.9)
    capacity = n0 + epochs * churn + 16
    space = rng.permutation(20 * width).astype(np.int32)
    slot_keys = space[:n0].copy()
    deleted = np.zeros(n0, bool)
    states = []
    for _ in range(epochs + 1):
        if states and churn:               # epoch 0 is the base state
            live = np.nonzero(~deleted)[0]
            deleted[rng.choice(live, churn, replace=False)] = True
            fresh = space[len(slot_keys):len(slot_keys) + churn]
            slot_keys = np.concatenate([slot_keys, fresh])
            deleted = np.concatenate([deleted, np.zeros(churn, bool)])
        h = rng.integers(0, hmax + 1, len(slot_keys)).astype(np.int32)
        st = synth_state(slot_keys, h, capacity, device=device)
        dead = np.concatenate([np.zeros(2, bool), deleted,
                               np.zeros(capacity - 2 - len(deleted), bool)])
        states.append(st._replace(
            deleted=torch.as_tensor(dead, device=st.device)))
    return states, n_levels


def run_bench(mesh, width: int = 4096, churn: int = 64, epochs: int = 4,
              reps: int = 4) -> dict:
    """Membership-changing epoch stream, sharded (the ``1 x S`` mesh,
    every rank calls this) against replicated refresh; asserts the
    final planes equal.  Returns the reference's JSON shape."""
    dev = mesh.device
    S = mesh.size
    states, n_levels = epoch_states(width, churn, epochs, 7, dev)
    p0 = dix.from_state_device(states[0], n_levels=n_levels, width=width)
    p0s = shd.shard_index_plane(p0, mesh)
    max_new = max(2 * churn, 64)

    def repl_fold():
        p = p0
        for st in states[1:]:
            p, _ = dix.refresh_device(st, p, max_new=max_new,
                                      return_overflow=True)
        return p

    def shard_fold():
        p = p0s
        for st in states[1:]:
            p, _ = dix.refresh_device_sharded(st, p, max_new=max_new,
                                              mesh=mesh)
        return p

    t_repl = time_min(repl_fold, reps, dev) / epochs
    t_shard = time_min(shard_fold, reps, dev) / epochs
    fr, fs = repl_fold(), shd.gather_index_plane(shard_fold())
    for f in CMP_FIELDS:
        if not torch.equal(getattr(fs, f), getattr(fr, f)):
            raise AssertionError(f"bench parity field={f}")
    itemsize = 4
    return {
        "mode": "membership", "exec_mode": kops.exec_mode(dev),
        "width": width, "n_levels": n_levels,
        "shards": S, "lanes_per_shard": width // S,
        "churn_per_epoch": churn, "epochs": epochs,
        "us_per_epoch_replicated": t_repl * 1e6,
        "us_per_epoch_sharded": t_shard * 1e6,
        "epochs_per_sec_replicated": 1.0 / t_repl,
        "epochs_per_sec_sharded": 1.0 / t_shard,
        "ratio_sharded_over_replicated": t_shard / t_repl,
        # what each shard touches against the replicated whole: the
        # [L, W] compaction shrinks to [L, W/S]; the exchanged segments
        # are the bottom row only
        "replicated_lane_bytes": n_levels * width * itemsize,
        "sharded_lane_bytes_per_shard": n_levels * (width // S) * itemsize,
        "exchanged_bytes_per_shard":
            3 * (width // S + max_new) * S * itemsize,
        "bit_identical": True,
    }


def main(argv=None) -> dict:
    from repro_torch.launch import spmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if not args.bench:
        ap.error("pass --bench (the parity battery is held by the tests)")
    out = spmd.spawn(run_bench, N_DEV, args.width, backend=args.backend,
                     device=args.device,
                     threads=1 if args.device == "cpu" else None)[0]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
