"""The benchmark's command: one run of one cell on the card.

    python3 splaybench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  With
``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics.  The last line of standard
output is the result's JSON object; the numbers compared with the
reference, each beside its limit, are the last lines of standard error
and the result's last key.  Without a CUDA card, when the program loads
JAX or the JAX package, or when a file is missing, it exits nonzero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run stays inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from splaybench import harness

    _, cell, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("splaybench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"splaybench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out, bad = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), device="cuda",
                                t_start=T_START)
    if bad:
        print(f"splaybench: the process loaded {', '.join(bad)}; the "
              "benchmark measures repro_torch alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
