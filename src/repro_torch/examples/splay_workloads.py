"""Paper-workload explorer: run any n-x-y / zipf workload against all
three sequential engines and print the Tables-1-3-style comparison (the
twin of the reference's ``examples/splay_workloads.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.splay_workloads \\
          --n 20000 --x 0.95 --y 0.05 --ops 50000

The engines are the host ones (``benchmarks/common.py``), as in the
reference, so the ops/s column is the host CPU's.  ``main`` returns each
engine's row: ``(engine, p, ops/s, avg path)``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import make_engine, run_python_engine
from repro_torch.core import workload as wl

ENGINES = (("skiplist", 1.0), ("splaylist", 1.0), ("splaylist", 0.1),
           ("splaylist", 0.01), ("cbtree", 0.01))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--x", type=float, default=0.95)
    ap.add_argument("--y", type=float, default=0.05)
    ap.add_argument("--ops", type=int, default=50000)
    ap.add_argument("--zipf", action="store_true")
    args = ap.parse_args(argv)

    if args.zipf:
        stream = wl.zipf_workload(args.n, args.ops, seed=1)
        name = f"zipf(1) n={args.n}"
    else:
        stream = wl.xy_workload(args.n, args.x, args.y, args.ops, seed=1)
        name = f"{args.n}-{int(args.x*100)}-{int(args.y*100)}"
    print(f"workload {name}, {args.ops} contains ops")
    print(f"{'engine':24s} {'ops/s':>10s} {'avg path':>9s}")
    rows = []
    for engine, p in ENGINES:
        s = stream._replace(upd=stream.upd if p >= 1 else (
            np.random.default_rng(0).random(args.ops) < p))
        r = run_python_engine(make_engine(engine, p), s, args.ops)
        print(f"{engine + f' p={p}':24s} {r['ops_per_sec']:10.0f} "
              f"{r['avg_path']:9.2f}")
        rows.append((engine, p, r["ops_per_sec"], r["avg_path"]))
    return rows


if __name__ == "__main__":
    main()
