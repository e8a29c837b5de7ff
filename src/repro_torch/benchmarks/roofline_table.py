"""The roofline table's CSV lines from the dry-run's JSONs (the twin of
the reference's ``benchmarks/roofline_table.py``): one row per arch x
shape on the single mesh, and the count of multi-mesh cells.  It reads
what ``python -m repro_torch.launch.dryrun_all`` wrote and times
nothing."""

from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks.common import emit


def run(dryrun_dir: str = "build/dryrun", quick: bool = False):
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir,
                                           "*__single.json"))):
        with open(f) as fh:
            d = json.load(fh)
        t = d["roofline"]
        rows.append(d)
        emit(f"roofline_{d['arch']}_{d['shape']}",
             max(t["compute_s"], t["memory_s"], t["collective_s"]) * 1e6,
             f"dom={t['dominant']};compute={t['compute_s']:.3e};"
             f"memory={t['memory_s']:.3e};coll={t['collective_s']:.3e};"
             f"useful={d['useful_flops_ratio']:.2f}")
    multi = len(glob.glob(os.path.join(dryrun_dir, "*__multi.json")))
    emit("dryrun_multi_pod_pass", 0.0, f"cells_compiled={multi}")
    return rows


if __name__ == "__main__":
    run()
