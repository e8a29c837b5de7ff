#!/usr/bin/env python3
"""Kernels B1 and B2 of two source trees of the PyTorch port, timed in
alternating pairs on one card in one run:

    python3 scripts/torch_search_ab.py --parent PATH/src --change PATH/src
        [--pairs 10] [--sweep] [--probe]

Each ``PATH`` is a checkout of a commit of the port (for example the
parent commit unpacked with ``git archive`` into a git-ignored
directory); its kernels build into its own ``build/`` at first use.
The inputs are made once, by the change tree, from the fixed seeds of
``scripts/search_timing.py`` (the paper plane, L = 24, W = 131072, with
4096 queries for B1; the W = 16384 plane with 2048 queries for B2) and
saved under ``build/``, so both trees search the same tensors.  Then
each pair runs the parent and the change in child processes (the order
alternates: parent, change, change, parent, ...); each child times B1
and B2 per launch from a ``torch.profiler`` trace, per call by
CUDA-graph replay and by an eager loop, and checks its answers against
its own plain version.  ``--sweep`` has the change tree's child also
time B1 over its block sizes and B2 over its cluster sizes;
``--probe`` has each tree's first child time B1 on a batch of one hot
key, the sorted batch, the bottom row alone and the plane's leading k
rows alone (the walk cut at row k - 1).

Prints the descent statistics of both batches (``search_timing.
descent_stats``), then one JSON line: each tree's runs, the medians,
the change's wins per clock and the ratio change / parent of the
median traced times."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import search_timing as stm

HERE = Path(__file__).resolve().parent
FIELDS = ("keys", "rank_map", "widths", "bot_rank")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _import_tree(src: str):
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import build, splay_search
    if not build.lib_path("splay_search").exists():
        build.build(["splay_search"])
    return splay_search


def make_inputs(src: str, path: Path) -> None:
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core import device_index as dix
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    dev = torch.device("cuda")
    out = {}
    for name, fn in (("b1", stm.paper_plane), ("b2", stm.w16384_plane)):
        plane, q = fn(torch, sx, wl, dix, dev)
        out[name] = {f: getattr(plane, f).cpu() for f in FIELDS}
        out[name]["q"] = q.cpu()
    torch.save(out, path)


class _Plane:
    def __init__(self, d, dev):
        for f in FIELDS:
            setattr(self, f, d[f].to(dev))


def child(src: str, inputs: Path, sweep: bool, probe: bool) -> None:
    import torch
    ssk = _import_tree(src)
    dev = torch.device("cuda")
    data = torch.load(inputs)
    out = {"src": src}
    for name, make, plain in (
            ("b1", stm.b1_call, lambda p, q: ssk.splay_search_tiered_plain(
                p.keys, p.rank_map, p.widths, q)),
            ("b2", stm.b2_call, lambda p, q: ssk.splay_search_pipelined_plain(
                p.keys, p.rank_map, p.widths, p.bot_rank, q, q.shape[0],
                256))):
        plane = _Plane(data[name], dev)
        q = data[name]["q"].to(dev)
        fn = make(ssk, plane, q)
        got = fn()
        want = plain(plane, q)
        equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))
        traced, n = stm.traced_ms(torch, fn)
        out[name] = {"traced_ms": traced, "traced_launches": n,
                     "graph_ms": stm.graph_ms(torch, fn),
                     "eager_ms": stm.eager_ms(torch, fn),
                     "equal_plain": equal,
                     "checksum": [int(t.long().sum()) for t in got]}
        if sweep:  # B1's block sizes; B2's cluster sizes
            calls = ([({"_block": b}, make(ssk, plane, q, _block=b))
                      for b in (32, 64, 128, 256)] if name == "b1" else
                     [({"_cluster": c}, make(ssk, plane, q, _cluster=c))
                      for c in (1, 2, 4, 8)])
            rows = []
            for cfg, f in calls:
                ok = all(torch.equal(a.cpu(), b.cpu())
                         for a, b in zip(f()[:3], want[:3]))
                t, n = stm.traced_ms(torch, f)
                rows.append({**cfg, "traced_ms": t, "equal_plain": ok,
                             "graph_ms": stm.graph_ms(torch, f)})
            out[name]["sweep"] = rows
        if probe and name == "b1":
            out["probe"] = _probe(torch, ssk, plane, q)
    print(json.dumps(out), flush=True)


def _probe(torch, ssk, plane, q):
    """B1 (the tree's defaults) by graph replay on variants of its
    inputs: every query the batch's most frequent key (one path, each
    load one sector a warp), the batch sorted (neighbouring lanes on
    neighbouring entries), and the bottom row alone (launch and one
    row)."""
    vals, counts = torch.unique(q, return_counts=True)
    hot = torch.full_like(q, int(vals[counts.argmax()]))
    one = _Plane({f: getattr(plane, f)[-1:] for f in FIELDS}, q.device)
    out = {"hot": stm.graph_ms(torch, stm.b1_call(ssk, plane, hot)),
           "sorted": stm.graph_ms(torch, stm.b1_call(
               ssk, plane, torch.sort(q).values)),
           "bottom_row": stm.graph_ms(torch, stm.b1_call(ssk, one, q))}
    # the plane's leading k rows alone: the same walk, cut at row k - 1
    for k in (1, 8, 10, 12, 14, 16, 18, 20, 22, 24):
        top = _Plane({f: getattr(plane, f)[:k] for f in FIELDS}, q.device)
        out[f"rows_{k}"] = stm.graph_ms(torch, stm.b1_call(ssk, top, q))
    return out


def run_child(src, inputs, sweep=False, probe=False) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", src,
           "--inputs", str(inputs)] + (["--sweep"] if sweep else []) \
        + (["--probe"] if probe else [])
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        sys.exit(f"child {src} failed:\n{p.stdout[-4000:]}\n"
                 f"{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--child")
    ap.add_argument("--inputs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.child:
        child(args.child, Path(args.inputs), args.sweep, args.probe)
        return
    inputs = HERE.parent / "build" / "search_ab_inputs.pt"
    inputs.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, sys.argv[1]); "
                        "import torch_search_ab as ab; "
                        "ab.make_inputs(sys.argv[2], __import__('pathlib')"
                        ".Path(sys.argv[3]))",
                        str(HERE), args.change, str(inputs)],
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        sys.exit(f"making the inputs failed:\n{p.stderr[-4000:]}")
    data = torch.load(inputs)
    dev = torch.device("cuda")
    for name in ("b1", "b2"):
        plane = _Plane(data[name], dev)
        stats = stm.descent_stats(torch, plane, data[name]["q"].to(dev),
                                  exits=name == "b2")
        print(f"{name}: widths {data[name]['widths'].tolist()}; {stats}",
              flush=True)
    runs = {"parent": [], "change": []}
    sweep, probes = None, {}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for who in order:
            src = args.parent if who == "parent" else args.change
            r = run_child(src, inputs, sweep=args.sweep and sweep is None
                          and who == "change", probe=args.probe and i < 2)
            if "sweep" in r.get("b1", {}):
                sweep = {k: r[k].pop("sweep") for k in ("b1", "b2")}
            if "probe" in r:
                probes[who] = r.pop("probe")
            runs[who].append(r)
    summary = {}
    for name in ("b1", "b2"):
        sums = {who: {r[name]["checksum"].__str__() for r in rs}
                for who, rs in runs.items()}
        s = {"same_answers": len(sums["parent"] | sums["change"]) == 1,
             "all_equal_plain": all(r[name]["equal_plain"] for rs in
                                    runs.values() for r in rs)}
        for clock in ("traced_ms", "graph_ms", "eager_ms"):
            par = [r[name][clock] for r in runs["parent"]]
            chg = [r[name][clock] for r in runs["change"]]
            s[clock] = {
                "parent": par, "change": chg,
                "parent_median": float(np.median(par)),
                "change_median": float(np.median(chg)),
                "parent_iqr": float(np.subtract(*np.percentile(par,
                                                               [75, 25]))),
                "change_wins": sum(c < p for c, p in zip(chg, par)),
                "ratio": float(np.median(chg) / np.median(par))}
        summary[name] = s
    print(json.dumps({"card": _card(), "pairs": args.pairs,
                      "parent": args.parent, "change": args.change,
                      "summary": summary, "sweep": sweep,
                      "probe": probes}))


if __name__ == "__main__":
    main()
