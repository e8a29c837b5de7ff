"""Tables 1-3: sequential throughput + average path length on the
n-x-y workloads, for skip-list vs splay-list vs CBTree across the
balancing probability p in {1, 1/2, 1/5, 1/10, 1/100, 1/1000}.

Paper reference points (1e5 keys): skip-list path ~31; splay-list path
23.1 / 21.6 / 17.1 on 90-10 / 95-5 / 99-1 with up to 2x throughput at
p=1/100 on 99-1; CBTree paths 7-9."""

from __future__ import annotations

from repro_torch.benchmarks.common import (emit, make_engine,
                                           run_python_engine)
from repro_torch.core import workload as wl

P_VALUES = [1.0, 0.5, 0.2, 0.1, 0.01, 0.001]
WORKLOADS = [(0.90, 0.10, "90-10"), (0.95, 0.05, "95-5"),
             (0.99, 0.01, "99-1")]


def run(n: int = 100_000, ops: int = 100_000, quick: bool = False):
    if quick:
        n, ops = 20_000, 40_000
    results = {}
    for x, y, tag in WORKLOADS:
        stream = wl.xy_workload(n, x, y, ops, p=1.0, seed=42)
        r = run_python_engine(make_engine("skiplist", 1.0), stream, ops)
        base = r["ops_per_sec"]
        emit(f"table_{tag}_skiplist", 1e6 / r["ops_per_sec"],
             f"path={r['avg_path']:.2f};rel=1.00")
        results[(tag, "skiplist", None)] = r
        for engine in ("splaylist", "cbtree"):
            for p in P_VALUES:
                stream = wl.xy_workload(n, x, y, ops, p=p, seed=42)
                r = run_python_engine(make_engine(engine, p), stream,
                                      ops)
                rel = r["ops_per_sec"] / base
                emit(f"table_{tag}_{engine}_p{p}",
                     1e6 / r["ops_per_sec"],
                     f"path={r['avg_path']:.2f};rel={rel:.2f}")
                results[(tag, engine, p)] = dict(r, rel=rel)
    return results


if __name__ == "__main__":
    run(quick=True)
