#!/usr/bin/env python3
"""Kernels W (the state walk of both engines' ``find_batch``) and S (the
skip-list's op fold) of one source tree of the PyTorch port, so that
two trees can be compared in turns in one run on one card:

    python3 scripts/torch_walk_ab.py --src PATH/src --inputs FILE --make
    python3 scripts/torch_walk_ab.py --src PATH/src --inputs FILE
        [--check] [--sweep]

``PATH`` is a checkout of any commit of the port (for example a parent
commit unpacked with ``git archive`` into a git-ignored directory); its
kernels build into its own ``build/`` (once: a later run loads them).
``--make`` builds the walks' states with that tree and saves them to
``FILE`` (``torch.save``, CPU tensors), so every tree walks the same
states:

* the paper serving state (Aksenov et al., arXiv:2008.01009 §6, Fig.
  12; ``chip_smoke.py`` phases 3 and 7): 10^5 keys prefilled into
  ``make(131074, 24)``, 25 plane-search epochs of 4096 Zipf(1) contains,
  and the first epoch's 4096 keys: the phase-7 shape;
* phase 10's populated states of both engines (Figs. 3-5: 10^5 keys of
  the 90-10 and 99-1 ``xy_workload``s, seed 9, max level 20, capacity
  2n + 4), as the race starts them at B = 256, and the workload's first
  16, 64 and 256 keys.

A timing run (no ``--make``) loads them into its tree's state types and
times W by CUDA-graph replay of ``state_walk.launcher`` (device time a
launch, no status read) and a ``find_batch`` call by CUDA events, at
every shape; and S by events: the populate of the 99-1 workload's 10^5
keys in ascending order (as phase 10 populates), in descending order and
shuffled (``default_rng(3)``), heights from ``default_rng(0)``, and
phase 10's 4096-op mixed list on the ascending populate's state.
``--check`` holds each output against its plain version (W's loop on
the card, S's fold on the CPU) bit for bit; ``--sweep`` adds W's block
sizes (where the tree has them).  ``--make``
also counts, without the card, the level-0 steps that a lane walking
its level alone from its finger would take on the shuffled populate.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import fold_timing as ft
import search_timing as stm

N = 100_000
MAX_LEVEL = 20
S_LIST = 4096
BATCHES = (16, 64, 256)
WORKLOADS = ((0.90, 0.10, "90-10"), (0.99, 0.01, "99-1"))
BLOCKS = (32, 64, 128)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def make_inputs(torch, path: str) -> dict:
    """The walks' states, made with this tree on the card, saved as CPU
    tensors; returns the level-0 count of the lone-lane design."""
    from repro_torch.benchmarks import concurrent_scaling as cs
    from repro_torch.core import device_index as dix
    from repro_torch.core import splaylist as sx
    from repro_torch.core import workload as wl
    dev = torch.device("cuda")
    out = {}
    stream, pre = ft.paper_prefill(sx, wl)
    st = sx.make(capacity=ft.PAPER_CAPACITY, max_level=ft.PAPER_LEVELS,
                 device=dev)
    st, _, _ = sx.run_ops(st, *pre)
    plane = dix.from_state_device(st, n_levels=ft.PAPER_LEVELS,
                                  width=131072)
    E, B = ft.PAPER_E, ft.PAPER_B
    keys = stream.keys.reshape(E, B)
    served = sx.run_serving(st, plane, np.zeros((E, B), np.int32), keys,
                            stream.upd.reshape(E, B), aggregate=True,
                            plane_search=True)
    out["phase7"] = ("splay", dict(served[0]._asdict()),
                     torch.as_tensor(keys[0]))
    for x, y, tag in WORKLOADS:
        w = wl.xy_workload(N, x, y, 65536, seed=9)
        pop = np.sort(w.populate)
        q = torch.as_tensor(w.keys[:256], device=dev)
        sp = cs.populate_splay(pop, MAX_LEVEL, 2 * N + 4, dev)
        sp, _, _ = sx.run_contains_batch(
            sp, q, torch.zeros((256,), dtype=torch.bool, device=dev))
        sk = cs.populate_skip(pop, MAX_LEVEL, 2 * N + 4, dev)
        for eng, s in (("splay", sp), ("skip", sk)):
            out[f"{tag}/{eng}"] = (eng, dict(s._asdict()), q.cpu())
    torch.save({k: (e, {f: t.cpu() for f, t in d.items()}, q)
                for k, (e, d, q) in out.items()}, path)
    return lone_lane_steps(s_inputs()[1])


def lone_lane_steps(order) -> dict:
    """The level-0 steps that a lane walking level 0 alone from its
    finger (the last insert's node) would take for each insert of
    ``order`` above the last one: the keys present between the two."""
    rank = np.argsort(np.argsort(order))
    tree = [0] * (len(order) + 1)

    def add(i):
        i += 1
        while i < len(tree):
            tree[i] += 1
            i += i & -i

    def below(i):        # inserted ranks < i
        s = 0
        while i > 0:
            s += tree[i]
            i -= i & -i
        return s

    total, ups, longest = 0, 0, 0
    prev = None
    for r in rank:
        if prev is not None and r > prev:
            d = below(r) - below(prev + 1)
            total += d
            longest = max(longest, d)
            ups += 1
        add(r)
        prev = r
    return {"inserts_above_last": ups, "steps": total, "longest": longest}


def s_inputs():
    """S's populate keys (the 99-1 workload's), ascending and shuffled."""
    from repro_torch.core import workload as wl
    asc = np.sort(wl.xy_workload(N, 0.99, 0.01, 65536, seed=9)
                  .populate).astype(np.int32)
    return asc, np.random.default_rng(3).permutation(asc)


def mixed_list(skx, keys):
    """Phase 10's mixed list of ``S_LIST`` ops on the populated state."""
    mrng = np.random.default_rng(12)
    kinds = mrng.choice(3, S_LIST, p=[0.6, 0.2, 0.2]).astype(np.int32)
    ks = np.where(mrng.random(S_LIST) < 0.8, mrng.choice(keys, S_LIST),
                  mrng.integers(0, 2 * N, S_LIST)).astype(np.int32)
    h = skx.sample_heights(np.random.default_rng(13), S_LIST, MAX_LEVEL,
                           device="cpu")
    return kinds, ks, h.numpy()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the tree's src/")
    ap.add_argument("--inputs", required=True, help="the saved states")
    ap.add_argument("--make", action="store_true",
                    help="make and save the states with this tree")
    ap.add_argument("--check", action="store_true",
                    help="hold every output against its plain version")
    ap.add_argument("--sweep", action="store_true",
                    help="W's block sizes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import skiplist as skx
    from repro_torch.core import splaylist as sx
    from repro_torch.kernels import build, skip_fold
    from repro_torch.kernels import state_walk as sw
    missing = [n for n in build.SOURCES if not build.lib_path(n).exists()]
    if missing:
        build.build(missing)
    dev = torch.device("cuda")
    if args.make:
        t = time.perf_counter()
        lone = make_inputs(torch, args.inputs)
        print(json.dumps({"made": args.inputs, "card": card_line(),
                          "s": time.perf_counter() - t,
                          "lone_lane_shuffled": lone}))
        return

    saved = torch.load(args.inputs)
    mods = {"splay": sx, "skip": skx}
    checked = []
    walk = {}
    params = inspect.signature(sw.launcher).parameters
    has_threads = "threads" in params
    for name, (eng, fields, keys) in saved.items():
        mod = mods[eng]
        st = getattr(mod, "SplayState" if eng == "splay" else "SkipState")(
            **{f: t.to(dev) for f, t in fields.items()})
        plain = sw.splay_walk_plain if eng == "splay" else sw.skip_walk_plain
        for B in ((len(keys),) if name == "phase7" else BATCHES):
            q = keys[:B].to(dev)
            got = mod.find_batch(st, q)
            r = {"ms": stm.graph_ms(torch, sw.launcher(st, q)),
                 "call_ms": stm.eager_ms(torch,
                                         lambda: mod.find_batch(st, q), 20),
                 "longest": int(got[1].max()), "q": B}
            if args.sweep and has_threads:
                r["block_ms"] = {T: stm.graph_ms(torch, sw.launcher(
                    st, q, threads=T)) for T in BLOCKS}
            if args.check:
                want = plain(st, q)
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                checked.append((f"W {name} B={B}", ok))
            walk[f"{name}/B{B}"] = r

    asc, shuf = s_inputs()
    hts = skx.sample_heights(np.random.default_rng(0), N, MAX_LEVEL,
                             device="cpu")
    ins = np.ones(N, np.int32)
    def s_run(st, kinds, keys, heights, reps):
        args_ = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in (kinds, keys, heights)]
        n = len(kinds)
        times, out = [], None
        for _ in range(reps):
            work = skx.clone(st)
            res = torch.zeros(n, dtype=torch.bool, device=dev)
            plen = torch.zeros(n, dtype=torch.int32, device=dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            stop = skip_fold.fold_ops(work, *args_, res, plen)
            e1.record()
            torch.cuda.synchronize()
            assert stop == n, f"S stopped at op {stop}"
            times.append(e0.elapsed_time(e1))
            out = (work, res, plen)
        return times, out

    def s_check(what, st, kinds, keys, heights, got):
        cpu = skx.SkipState(*(t.cpu() for t in st))
        n = len(kinds)
        res = torch.zeros(n, dtype=torch.bool)
        plen = torch.zeros(n, dtype=torch.int32)
        skx.fold_plain(cpu, *(torch.as_tensor(a, dtype=torch.int32)
                              for a in (kinds, keys, heights)), res, plen)
        ok = (all(torch.equal(a.cpu(), b) for a, b in zip(got[0], cpu))
              and torch.equal(got[1].cpu(), res)
              and torch.equal(got[2].cpu(), plen))
        checked.append((f"S {what}", ok))

    empty = skx.make(2 * N + 4, MAX_LEVEL, device=dev)
    fold = {}
    h_np = hts.numpy()
    for what, order, hh, reps in (("ascending", asc, h_np, 2),
                                  ("descending", asc[::-1].copy(), h_np, 1),
                                  ("shuffled", shuf, h_np, 1)):
        times, got = s_run(empty, ins, order, hh, reps)
        fold[what] = {"ms": times, "ops": N}
        if args.check:
            s_check(what, empty, ins, order, hh, got)
        if what == "ascending":
            populated = got[0]
    m_kinds, m_keys, m_h = mixed_list(skx, asc)
    times, got = s_run(populated, m_kinds, m_keys, m_h, 2)
    fold["mixed"] = {"ms": times, "ops": S_LIST,
                     "find_steps": int(got[2].sum()),
                     "inserts": int((m_kinds == 1).sum())}
    if args.check:
        s_check("mixed", populated, m_kinds, m_keys, m_h, got)
    line = {"src": args.src, "card": card_line(), "walk": walk,
            "fold": fold}
    if has_threads:
        line["block"] = sw.BLOCK
    if args.check:
        line["checked"] = checked
        line["all_equal"] = all(ok for _, ok in checked)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
