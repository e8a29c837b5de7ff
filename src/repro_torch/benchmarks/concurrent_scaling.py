"""Figures 3-5: 'concurrent' throughput scaling, on the card.

The paper's threads become batch lanes: a batch of B lock-free searches
runs data-parallel against a state snapshot, and the updates fold
serially, so B plays the role of the thread count.  Races the
splay-list (p = 1/100: ``splaylist.run_contains_batch``, one launch of
kernel W's walk and one of kernel F's weighted fold a batch) against the
skip-list baseline (``skiplist.run_contains_batch``, one W launch a
batch)
on the 90-10 and 99-1 workloads, for B in {16, 64, 256}.  Kernel F
populates the splay-list and kernel S the skip-list, once a workload;
each B races from those states, after the reference's warm-up
batch (applied to the splay state with its coins all off, so it
changes nothing).

Every entry point runs on the card unless the caller passes
``device="cpu"``.  The queries and coins are staged on the device
before the clock starts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.core import skiplist as skx
from repro_torch.core import splaylist as sx
from repro_torch.core import workload as wl
from repro_torch.kernels import ops as kops

BATCHES = (16, 64, 256)
WORKLOADS = ((0.90, 0.10, "90-10"), (0.99, 0.01, "99-1"))
SPLAY_P = 0.01
MAX_LEVEL = 20


def populate_splay(keys, ml, cap, device):
    st = sx.make(capacity=cap, max_level=ml, device=device)
    st, _, _ = sx.run_ops(st, np.full(len(keys), sx.OP_INSERT, np.int32),
                          keys, np.ones(len(keys), bool))
    return st


def populate_skip(keys, ml, cap, device, seed=0):
    st = skx.make(capacity=cap, max_level=ml, device=device)
    h = skx.sample_heights(np.random.default_rng(seed), len(keys), ml,
                           device=device)
    st, _, _ = skx.run_ops(st, np.full(len(keys), skx.OP_INSERT, np.int32),
                           keys, h)
    return st


def splay_coins(n_batches: int, B: int) -> np.ndarray:
    """The splay-list's coins, batch by batch from ``default_rng(1)``
    as the reference draws them."""
    rng = np.random.default_rng(1)
    return np.stack([rng.random(B) < SPLAY_P for _ in range(n_batches)]
                    ) if n_batches else np.zeros((0, B), bool)


def race(engine: str, st, batches, coins=None):
    """Run the batches in order: ``(state, [per-batch path sums],
    [per-batch longest path], every answer True)``, all on the device.
    ``coins`` (splay-list only) is the per-batch update mask.  A batch's
    longest path is the steps of its longest ``find_batch`` lane."""
    sums, longest = [], []
    found = torch.ones((), dtype=torch.bool, device=st.device)
    for i in range(batches.shape[0]):
        if engine == "splay":
            st, res, steps = sx.run_contains_batch(st, batches[i], coins[i])
        else:
            st, res, steps = skx.run_contains_batch(st, batches[i])
        sums.append(steps.sum(dtype=torch.int64))
        longest.append(steps.max())
        found = found & res.all()
    return st, sums, longest, found


def _launches() -> dict:
    c = kops.launch_counts()
    return {k: c[k] for k in ("splay_fold", "skip_fold", "splay_walk",
                              "skip_walk")}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n: int = 4096, total_ops: int = 65536, quick: bool = False,
        device="cuda", keep_start: bool = False):
    """Returns ``{(tag, engine, B): {ops_s, path, psum, batch_psums,
    loop_steps, ms_per_batch, all_found, launches}}`` (``loop_steps``:
    the mean over batches of the longest path, the steps of the batch's
    search loop) plus ``{(tag, "populate"): {splay_ms, skip_ms,
    launches}}``.  ``keep_start`` also keeps each
    race's starting state (and the splay-list's coins) under
    ``"start"``/``"coins"``, for a replay elsewhere."""
    if quick:
        n, total_ops = 2048, 16384
    dev = sx._device(device)
    ml, cap = MAX_LEVEL, 2 * n + 4
    results = {}
    for x, y, tag in WORKLOADS:
        w = wl.xy_workload(n, x, y, total_ops, seed=9)
        keys = np.sort(w.populate)
        pop, pop_ms = {}, {}
        c0 = _launches()
        for name, fn in (("splay", populate_splay), ("skip", populate_skip)):
            _sync(dev)
            t0 = time.perf_counter()
            pop[name] = fn(keys, ml, cap, dev)
            _sync(dev)
            pop_ms[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        c1 = _launches()
        results[(tag, "populate")] = dict(
            pop_ms, launches={k: c1[k] - c0[k] for k in c1})
        for B in BATCHES:
            ops_q = w.keys[:total_ops].reshape(-1, B)
            nb = ops_q.shape[0]
            q = torch.as_tensor(ops_q, device=dev)
            # the engines' entry points return new states and leave the
            # populated ones as they are, so each B starts from them
            for engine in ("splay", "skip"):
                if engine == "splay":
                    st, _, _ = sx.run_contains_batch(
                        pop["splay"], q[0],
                        torch.zeros((B,), dtype=torch.bool, device=dev))
                    coins_np = splay_coins(nb, B)
                    coins = torch.as_tensor(coins_np, device=dev)
                else:
                    st, _, _ = skx.run_contains_batch(pop["skip"], q[0])
                    coins_np = coins = None
                start = st
                _sync(dev)
                c0 = _launches()
                t0 = time.perf_counter()
                st, sums, longest, found = race(engine, st, q, coins)
                _sync(dev)
                dt = time.perf_counter() - t0
                c1 = _launches()
                batch_psums = [int(s) for s in sums]
                psum = sum(batch_psums)
                tput = total_ops / dt
                emit(f"fig_concurrent_{tag}_{engine}_B{B}", 1e6 / tput,
                     f"ops_s={tput:.0f};path={psum/total_ops:.2f}")
                r = dict(ops_s=tput, path=psum / total_ops, psum=psum,
                         batch_psums=batch_psums,
                         loop_steps=float(torch.stack(longest).float()
                                          .mean()),
                         ms_per_batch=1e3 * dt / nb,
                         all_found=bool(found),
                         launches={k: c1[k] - c0[k] for k in c1})
                if keep_start:
                    r.update(start=start, coins=coins_np)
                results[(tag, engine, B)] = r
    return results


if __name__ == "__main__":
    run(quick=True)
