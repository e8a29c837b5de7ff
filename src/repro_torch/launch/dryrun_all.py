"""Sweep driver: every (arch x shape) cell on both production meshes
(the twin of ``repro.launch.dryrun_all``).

The cells run in this process, one after the other (a meta run holds
no device and little host memory); a cell whose JSON already exists is
skipped, so the sweep is resumable.  The single-mesh runs include the
probes (the roofline table is single-mesh); the multi-mesh runs show
that the ``pod`` axis lays out.  A ``train_4k`` cell raises
``NotImplementedError`` (the sharded train step is ROADMAP queue A item
4): it is listed apart and is not a failure.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import time
import traceback


def main(argv=None) -> dict:
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    t0 = time.time()
    done, failures, not_implemented = [], [], []
    for mesh in meshes:
        for arch, shape in dryrun.cells():
            out_json = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh}.json")
            if os.path.exists(out_json):
                print(f"skip {arch} {shape} {mesh} (exists)")
                continue
            print(f"[{time.time() - t0:7.0f}s] {arch} {shape} {mesh} ...",
                  flush=True)
            try:
                dryrun.run_cell(arch, shape, mesh == "multi", args.out,
                                probes=mesh == "single")
                done.append((arch, shape, mesh))
            except NotImplementedError as e:
                not_implemented.append((arch, shape, mesh))
                print(f"  not implemented: {e}", flush=True)
            except Exception:                       # noqa: BLE001
                failures.append((arch, shape, mesh))
                print(f"  FAILED:\n{traceback.format_exc()[-3000:]}",
                      flush=True)
    print(f"done in {time.time() - t0:.0f}s: {len(done)} cells written; "
          f"not implemented: {len(not_implemented)}; failures: {failures}")
    if failures:
        raise SystemExit(1)
    return {"done": done, "not_implemented": not_implemented}


if __name__ == "__main__":
    main()
