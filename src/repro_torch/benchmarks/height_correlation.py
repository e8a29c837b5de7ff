"""Figure 13: correlation between key popularity and splay height."""

from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import make_engine, emit
from repro_torch.core import workload as wl


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() /
                 np.sqrt((ra * ra).sum() * (rb * rb).sum() + 1e-12))


def run(n: int = 20_000, ops: int = 2_000_000, quick: bool = False):
    """The paper runs ~300 ops per key before reading heights; keep the
    ratio >= 100x or the post-populate equilibrium never separates from
    the populate-time layout."""
    if quick:
        n, ops = 2_000, 200_000
    results = {}
    for tag, stream in [
            ("95-5", wl.xy_workload(n, 0.95, 0.05, ops, p=0.1,
                                    seed=41)),
            ("zipf1", wl.zipf_workload(n, ops, p=0.1, seed=42))]:
        sl = make_engine("splaylist", 0.1)
        for k in stream.populate:
            sl.insert(int(k))
        counts = {}
        for i in range(ops):
            k = int(stream.keys[i])
            sl.contains(k, upd=bool(stream.upd[i]))
            counts[k] = counts.get(k, 0) + 1
        h = sl.heights()
        # paper (Fig 13): correlation is over *visited* keys; untouched
        # keys keep stale heights until a traversal demotes them
        ks = [k for k, c in counts.items() if k in h and c >= 3]
        pops = np.array([counts[k] for k in ks])
        hts = np.array([h[k] for k in ks])
        rho = _spearman(pops, hts)
        # mean height of top-1% vs the rest of the *visited* keys
        # (untouched keys keep stale heights — the structure adapts on
        # access only; the paper's Fig 13 shows the same scatter)
        order = np.argsort(-pops)
        # n-x-y popularity is binary (uniform within the popular set), so
        # split by count threshold rather than percentile rank
        med = np.median(pops)
        top_idx = [i for i in order if pops[i] > 4 * med][:500] or \
            list(order[:max(len(ks) // 100, 1)])
        rest_idx = list(order[len(ks) // 2:])
        top = hts[top_idx].mean()
        rest = hts[rest_idx].mean()
        # access-cost ground truth: measured path lengths
        p_top = np.mean([sl.find(int(ks[i]))[1] for i in top_idx[:50]])
        p_rest = np.mean([sl.find(int(ks[i]))[1]
                          for i in rest_idx[:50]])
        emit(f"height_corr_{tag}", 0.0,
             f"spearman={rho:.3f};h_top1%={top:.2f};h_rest={rest:.2f};"
             f"path_top1%={p_top:.1f};path_rest={p_rest:.1f}")
        results[tag] = rho
    return results


if __name__ == "__main__":
    run(quick=True)
