"""The controls of the comparison: the reference put in the program's
place with one guarantee of the configuration broken, each the shortcut
that would tempt a later change.  The benchmark's own runs never run
them; they show that the comparison fails a system that breaks the
guarantee.

* read path (``paper-zipf1-1e5``: "every coined hit is folded before
  the next batch"): :class:`DeferredFold` folds each batch's coined hits
  one batch late, after the next batch's search, as a fold overlapped
  with the next search would;
* op path (``paper-rw99-1-1e5``: "an acknowledged insert or delete is
  seen by every later op"): :class:`SnapshotReads` answers each contains
  from the membership at the batch's start, as a search of the whole
  batch against its snapshot would, and applies the writes in order.

Run them at a cell's own size, on the card that makes the inputs:

    python3 splaybench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3

prints, per seed, the numbers compared and whether ``correct`` came out
false (it must).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_root / "src"), str(_root)]

from splaybench import reference  # noqa: E402


class _Control:
    """The reference as the system under test (the harness's interface:
    ``populate``, ``serve``, ``warm``, ``launch_counts``, ``read_back``,
    ``release``)."""

    def __init__(self, cfg: dict, traffic, device):
        self.cfg = cfg
        self.levels = int(cfg["plane"]["levels"])
        self.width = int(cfg["plane"]["width"])
        self.ref = None

    def populate(self, order):
        self.ref, res, plen = reference.populate(int(self.cfg["max_level"]),
                                                 order.cpu().numpy())
        return res, plen

    def warm(self, kinds, keys, upd) -> None:
        pass

    def launch_counts(self) -> dict:
        return {}

    def read_back(self):
        lk, lh = self.ref.live_heights()
        return (self.ref.canon(),
                reference.plane(lk, lh, self.levels, self.width))

    def release(self) -> None:
        self.ref = None


class DeferredFold(_Control):
    """Read path: the plane's answers, each batch's fold one batch late."""

    pending = None

    def serve(self, kinds, keys, upd):
        keys, upd = keys.cpu().numpy(), upd.cpu().numpy()
        lk, lh = self.ref.live_heights()
        live = np.isin(keys, lk)
        rows = reference.levels_found(lk, lh, keys, self.levels)
        if self.pending is not None:
            self.ref.fold_batch(*self.pending)
        self.pending = (keys, upd)
        return live.astype(np.int32), rows.astype(np.int32), 0


class SnapshotReads(_Control):
    """Op path: contains answered from the batch's starting membership."""

    def serve(self, kinds, keys, upd):
        kinds, keys, upd = (t.cpu().numpy() for t in (kinds, keys, upd))
        lk, _ = self.ref.live_heights()
        start = np.isin(keys, lk)
        res, plen = self.ref.run_ops(kinds, keys, upd)
        reads = kinds == reference.OP_CONTAINS
        res[reads] = start[reads]
        return res, plen, 0


def control_for(traffic):
    return DeferredFold if traffic.read_only else SnapshotReads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a cell's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from splaybench import harness

    def make(cfg, traffic, device):
        return control_for(traffic)(cfg, traffic, device)

    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                  device=args.device, make_system=make)
        failed_all &= not out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()}}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
