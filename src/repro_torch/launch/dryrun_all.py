"""Sweep driver: every (arch x shape) cell on both production meshes
(the twin of ``repro.launch.dryrun_all``): 32 cells, 64 (cell, mesh)
pairs, the 10 ``train_4k`` cells' whole train step included.

The cells run in this process, one after the other (a meta run holds
no device and little host memory); a cell whose JSON already exists is
skipped, so the sweep is resumable.  The single-mesh runs include the
probes (the roofline table is single-mesh); the multi-mesh runs show
that the ``pod`` axis lays out.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import time
import traceback


def pairs(mesh: str = "both") -> list:
    """The ``(arch, shape, mesh)`` triples of a sweep over ``mesh``
    (``single``, ``multi`` or ``both``), in run order."""
    from repro_torch.launch import dryrun
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[mesh]
    return [(arch, shape, m) for m in meshes
            for arch, shape in dryrun.cells()]


def main(argv=None) -> dict:
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    args = ap.parse_args(argv)

    t0 = time.time()
    done, skipped, failures = [], [], []
    for arch, shape, mesh in pairs(args.mesh):
        out_json = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
        if os.path.exists(out_json):
            print(f"skip {arch} {shape} {mesh} (exists)")
            skipped.append((arch, shape, mesh))
            continue
        print(f"[{time.time() - t0:7.0f}s] {arch} {shape} {mesh} ...",
              flush=True)
        try:
            dryrun.run_cell(arch, shape, mesh == "multi", args.out,
                            probes=mesh == "single")
            done.append((arch, shape, mesh))
        except Exception:                       # noqa: BLE001
            failures.append((arch, shape, mesh))
            print(f"  FAILED:\n{traceback.format_exc()[-3000:]}",
                  flush=True)
    print(f"done in {time.time() - t0:.0f}s: {len(done)} cells written, "
          f"{len(skipped)} skipped; failures: {failures}")
    if failures:
        raise SystemExit(1)
    return {"done": done, "skipped": skipped}


if __name__ == "__main__":
    main()
