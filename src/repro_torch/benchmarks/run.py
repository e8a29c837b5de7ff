"""The port's benchmark harness: one module per paper table or figure.

    python -m repro_torch.benchmarks.run [--full] [--only a,b] \
        [--device cuda|cpu] [--out DIR]

Prints ``name,us_per_call,derived`` CSV lines.  ``--full`` runs the
paper's sizes (10^5 keys); the default is the quick profile.  The
sequential tables (``seq_tables``, ``uniform_zipf``,
``general_workloads``, ``long_run``, ``height_correlation``) run the
pure-Python engines on the host CPU; ``concurrent_scaling`` runs the
state engines on ``--device`` (the card unless the caller asks for the
CPU).  With ``--out DIR`` each module's results are also written to
``DIR/<module>.json``; nothing is written elsewhere.
``roofline_table`` reads the dry-run's JSONs under ``build/dryrun``
(``python -m repro_torch.launch.dryrun_all``) and times nothing."""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

MODULES = ("seq_tables", "concurrent_scaling", "uniform_zipf",
           "general_workloads", "long_run", "height_correlation",
           "kernels_bench", "roofline_table")
# the modules that run on ``--device``; the others run on the host CPU
ON_DEVICE = ("concurrent_scaling", "kernels_bench")


def _plain(x):
    """JSON-safe form of a results dict (tuple keys joined by '/')."""
    if isinstance(x, dict):
        return {("/".join(map(str, k)) if isinstance(k, tuple) else str(k)):
                _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    raise TypeError(f"no JSON form for {type(x).__name__}")


def main(argv=None) -> dict:
    import importlib
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated module subset")
    ap.add_argument("--device", default="cuda",
                    help="the device of concurrent_scaling and "
                         "kernels_bench (cuda or cpu)")
    ap.add_argument("--out", default=None,
                    help="directory for one JSON file per module")
    args = ap.parse_args(argv)
    quick = not args.full
    only = args.only.split(",") if args.only else MODULES
    unknown = sorted(set(only) - set(MODULES))
    if unknown:
        ap.error(f"unknown modules {unknown}; choose from {MODULES}")
    out_dir = Path(args.out) if args.out else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    payloads = {}
    for name in MODULES:
        if name not in only:
            continue
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        kw = {"device": args.device} if name in ON_DEVICE else {}
        t0 = time.time()
        print(f"# --- {name} ---", flush=True)
        payloads[name] = mod.run(quick=quick, **kw)
        wall = time.time() - t0
        if out_dir:
            path = out_dir / f"{name}.json"
            path.write_text(json.dumps(
                {"module": name, "quick": quick, "wall_s": wall,
                 "results": _plain(payloads[name])}, indent=1))
            print(f"# wrote {path}", flush=True)
        print(f"# {name} done in {wall:.1f}s", flush=True)
    return payloads


if __name__ == "__main__":
    main()
