"""Quickstart: the splay-list as a distribution-adaptive ordered map
(the twin of the reference's ``examples/quickstart.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu]

The sequential engines run on the host, as in the reference; the state
engine runs on the card: 500 inserts through kernel F, a batch of 256
searches through kernel W and its update fold through F, then 30
aggregated batches of hot keys.  ``main`` returns the printed numbers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import splaylist as sx
from repro_torch.core import workload as wl
from repro_torch.core.ref_py import SplayList
from repro_torch.core.skiplist import SkipList


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state engine (default: the "
                         "card)")
    args = ap.parse_args(argv)
    dev = sx._device(args.device)
    out = {}

    # --- 1. sequential splay-list: adapts to a skewed workload ---------
    print("== sequential splay-list vs skip-list on a 99-1 workload ==")
    w = wl.xy_workload(n=5000, x=0.99, y=0.01, ops=50_000, p=0.1, seed=0)
    splay, skip = SplayList(max_level=22, p=0.1), SkipList(max_level=22)
    for k in w.populate:
        splay.insert(int(k))
        skip.insert(int(k))
    ps = pk = 0
    for k, coin in zip(w.keys, w.upd):
        splay.contains(int(k), upd=bool(coin))
        ps += splay.last_path_len
        skip.find(int(k))
        pk += skip.last_path_len
    out["splay_path"], out["skip_path"] = ps / len(w.keys), pk / len(w.keys)
    print(f"avg path  splay-list: {out['splay_path']:6.2f}   "
          f"skip-list: {out['skip_path']:6.2f}")

    # --- 2. the state engine: batched lock-free searches ----------------
    print("\n== state engine: batched search + serialized relaxed updates ==")
    st = sx.make(capacity=2048, max_level=18, device=dev)
    keys = np.arange(0, 1000, 2, dtype=np.int32)
    st, _, _ = sx.run_ops(st, np.full((len(keys),), sx.OP_INSERT, np.int32),
                          keys, np.ones((len(keys),), bool))
    queries = np.random.default_rng(0).choice(
        np.arange(0, 1000, 2), 256).astype(np.int32)
    st, found, steps = sx.run_contains_batch(
        st, queries, np.random.default_rng(1).random(256) < 0.1)
    out["found"] = int(found.sum())
    out["mean_path"] = float(steps.to(torch.float32).mean())
    print(f"batch of 256 searches: found={out['found']}, "
          f"mean path={out['mean_path']:.1f}")

    # --- 3. heights reflect popularity ----------------------------------
    # duplicate-heavy batches: aggregate=True dedupes the keys and runs
    # one weighted rebalance fold per unique key
    hot = queries[:16]
    for _ in range(30):
        st, _, _ = sx.run_contains_batch(st, hot, np.ones((16,), bool),
                                         aggregate=True)
    h = sx.heights(st)
    out["hot_height"] = float(np.mean([h[int(k)] for k in hot]))
    out["all_height"] = float(np.mean(list(h.values())))
    print(f"mean height: hammered keys {out['hot_height']:.2f} vs all "
          f"{out['all_height']:.2f}")
    return out


if __name__ == "__main__":
    main()
