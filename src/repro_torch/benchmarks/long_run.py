"""Table 4: longer executions — throughput improves as the structure
learns the distribution (paper: +12..30% from 10s to 10min runs).

We measure path length (the hardware-independent measure behind throughput)
over the first vs last decile of a long run at p = 1/100."""

from __future__ import annotations

from repro_torch.benchmarks.common import make_engine, emit
from repro_torch.core import workload as wl


def run(n: int = 100_000, ops: int = 400_000, quick: bool = False):
    if quick:
        n, ops = 20_000, 120_000
    results = {}
    for tag, stream in [
            ("90-10", wl.xy_workload(n, 0.90, 0.10, ops, p=0.01,
                                     seed=31)),
            ("99-1", wl.xy_workload(n, 0.99, 0.01, ops, p=0.01,
                                    seed=32)),
            ("zipf1", wl.zipf_workload(n, ops, p=0.01, seed=33))]:
        sl = make_engine("splaylist", 0.01)
        for k in stream.populate:
            sl.insert(int(k))
        dec = ops // 10
        first = last = 0
        for i in range(ops):
            sl.contains(int(stream.keys[i]), upd=bool(stream.upd[i]))
            if i < dec:
                first += sl.last_path_len
            elif i >= ops - dec:
                last += sl.last_path_len
        gain = first / last - 1.0
        emit(f"longrun_{tag}", 0.0,
             f"path_first={first/dec:.2f};path_last={last/dec:.2f};"
             f"gain={gain:+.1%}")
        results[tag] = gain
    return results


if __name__ == "__main__":
    run(quick=True)
