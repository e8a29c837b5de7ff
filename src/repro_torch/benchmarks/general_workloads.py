"""Appendix C.3: general read-write workloads n-r-x-y-s.

Paper claim: the read-write overhead vs read-only does not exceed
~15% / 7% / 5% on the 99-1 / 95-5 / 90-10 workloads."""

from __future__ import annotations

from repro_torch.benchmarks.common import (emit, make_engine,
                                           run_python_engine)
from repro_torch.core import workload as wl


def run(n: int = 100_000, ops: int = 100_000, quick: bool = False):
    if quick:
        n, ops = 20_000, 40_000
    results = {}
    for x, y, tag in [(0.90, 0.10, "90-10"), (0.95, 0.05, "95-5"),
                      (0.99, 0.01, "99-1")]:
        ro = wl.general_workload(n, 1.0, x, y, 0.25, ops, p=0.01,
                                 seed=21)
        rw = wl.general_workload(n, 0.98, x, y, 0.25, ops, p=0.01,
                                 seed=21)
        r_ro = run_python_engine(make_engine("splaylist", 0.01), ro, ops)
        r_rw = run_python_engine(make_engine("splaylist", 0.01), rw, ops)
        overhead = 1.0 - r_rw["ops_per_sec"] / r_ro["ops_per_sec"]
        emit(f"general_{tag}_readonly", 1e6 / r_ro["ops_per_sec"],
             f"path={r_ro['avg_path']:.2f}")
        emit(f"general_{tag}_readwrite", 1e6 / r_rw["ops_per_sec"],
             f"path={r_rw['avg_path']:.2f};overhead={overhead:.3f}")
        results[tag] = overhead
    return results


if __name__ == "__main__":
    run(quick=True)
