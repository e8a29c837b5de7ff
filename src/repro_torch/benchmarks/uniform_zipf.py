"""Figures 11-12: uniform (adaptivity costs, no win) and Zipf(1)
(splay-list matches or outperforms) workloads."""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (emit, make_engine,
                                           run_python_engine)
from repro_torch.core import workload as wl


def run(n: int = 100_000, ops: int = 100_000, quick: bool = False):
    if quick:
        n, ops = 20_000, 40_000
    results = {}
    streams = {
        "uniform": wl.uniform_workload(n, ops, seed=11),
        "zipf1": wl.zipf_workload(n, ops, s=1.0, seed=12),
    }
    for tag, stream in streams.items():
        base = None
        for engine, p in (("skiplist", 1.0), ("splaylist", 0.01),
                          ("splaylist", 0.1), ("cbtree", 0.01)):
            s = stream._replace(
                upd=wl._coins(np.random.default_rng(3), ops, p))
            r = run_python_engine(make_engine(engine, p), s, ops)
            if base is None and engine == "skiplist":
                base = r["ops_per_sec"]
            rel = r["ops_per_sec"] / base
            emit(f"fig_{tag}_{engine}_p{p}", 1e6 / r["ops_per_sec"],
                 f"path={r['avg_path']:.2f};rel={rel:.2f}")
            results[(tag, engine, p)] = dict(r, rel=rel)
    return results


if __name__ == "__main__":
    run(quick=True)
