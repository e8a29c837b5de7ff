#!/usr/bin/env python3
"""Kernel F of one source tree of the PyTorch port, on its three paths,
so that two trees can be compared in one run on one card:

    python3 scripts/torch_fold_ab.py --src PATH/src [--reps 20]

``PATH`` is a checkout of any commit of the port (for example a parent
commit unpacked with ``git archive`` into a git-ignored directory);
its kernels build into its own ``build/`` (once: a later run loads
them).  The inputs and clocks are those of ``chip_smoke.py``
(``scripts/fold_timing.py``), from fixed seeds, the same for every
tree:

* the paper-scale prefill (10^5 inserts into ``make(131074, 24)``, one
  F launch), twice, each timed by CUDA events around ``run_ops`` and by
  the traced kernel;
* one serving epoch's aggregated fold list on the prefilled state and
  its ``w > 0`` subset, and one vocab-tier stream epoch on the stream
  state of a minitron-8b-width ``SplayVocabCache`` after 32 flushes
  (``fold_timing.fold_paths``: per wrapper call and per traced launch);
* one more flush of that cache, traced: the device ms of its F
  launches (4 stream epochs).

Prints one JSON line."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import fold_timing as ft


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the tree's src/")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    from repro_torch.core.splay_cache import SplayVocabCache
    from repro_torch.kernels import build, fold
    missing = [n for n in build.SOURCES if not build.lib_path(n).exists()]
    if missing:
        build.build(missing)
    dev = torch.device("cuda")

    stream, pre = ft.paper_prefill(sx, wl)
    prefill = []
    for _ in range(2):
        st0 = sx.make(capacity=ft.PAPER_CAPACITY,
                      max_level=ft.PAPER_LEVELS, device=dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)

        def run():
            e0.record()
            out = sx.run_ops(st0, *pre)
            e1.record()
            return out

        (st, _, _), ks = ft.kernel_ms(torch, run)
        prefill.append({"call_ms": e0.elapsed_time(e1), "kernel_ms": ks})
    entries = sx.fold_entries(st, stream.keys[:ft.PAPER_B],
                              stream.upd[:ft.PAPER_B], aggregate=True)[0]

    V = 256000
    cache = SplayVocabCache(V, hot_size=4096, update_prob=0.01,
                            refresh_every=64, seed=0, device=dev)
    flushes = ft.tier_flushes(wl, np.random.default_rng(1), V)
    for toks in flushes:
        cache.observe_serving(toks)
    vops = ft.tier_epoch_ops(torch, sx, wl, V, dev)
    out, steps = ft.fold_paths(torch, sx, fold, st, entries,
                               cache._stream_st, vops, reps=args.reps)
    _, flush_k = ft.kernel_ms(torch, lambda: cache.observe_serving(
        flushes[0]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "src": args.src, "card": card, "prefill": prefill,
        "entries": int(entries[0].shape[0]),
        "weighted": int((entries[1] > 0).sum()),
        **{k: {f: v[f] for f in ("call_ms", "kernel_ms", "launches")}
           for k, v in out.items()},
        "flush_f_ms": flush_k, "steps": steps}))


if __name__ == "__main__":
    main()
