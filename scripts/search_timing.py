"""Kernels B1 and B2 (the rank-windowed descents): their inputs, their
clocks and the descent statistics, shared by ``chip_smoke.py`` (phase
6) and ``scripts/torch_search_ab.py``.

Every function takes the modules of the tree under test as arguments
(``ssk`` = ``repro_torch.kernels.splay_search``), so the same inputs
and clocks serve any commit of the port.  The inputs come from fixed
seeds (``scripts/fold_timing.py``):

* the paper plane (Aksenov et al., arXiv:2008.01009 §6, Fig. 12):
  10^5 keys prefilled into ``make(131074, 24)``, ``from_state_device``
  at L = 24, W = 131072, and the first serving epoch's 4096 Zipf(1)
  contains — B1's shape (W / gcd(W, 256) = 512 tiles > 64);
* the W = 16384 plane of ``chip_smoke.py`` phase 5: 10^4 keys, L = 24,
  and the first batch of 2048 — B2's shape.

Three clocks: ``graph_ms`` (device time per call from CUDA-graph
replays: the wrapper's host cost stays out), ``traced_ms`` (device time
per launch of the descent kernel alone, from a ``torch.profiler``
trace) and ``eager_ms`` (CUDA events around a loop of eager wrapper
calls: what a caller waits for).
"""

from __future__ import annotations

import inspect

import numpy as np

import fold_timing as ft

W16_N, W16_E, W16_B, W16_WIDTH = 10_000, 8, 2048, 16384
# kernel names of the descents, in every tree of the port
KERNEL_NAMES = ("tiered_kernel", "pipelined_kernel", "descent_kernel")


def paper_plane(torch, sx, wl, dix, device):
    """The paper plane after the 10^5-insert prefill and the first
    epoch's queries."""
    stream, pre = ft.paper_prefill(sx, wl)
    st = sx.make(capacity=ft.PAPER_CAPACITY, max_level=ft.PAPER_LEVELS,
                 device=device)
    st, _, _ = sx.run_ops(st, *pre)
    plane = dix.from_state_device(st, n_levels=ft.PAPER_LEVELS,
                                  width=131072)
    return plane, torch.as_tensor(stream.keys[:ft.PAPER_B], device=device)


def w16384_plane(torch, sx, wl, dix, device):
    """``chip_smoke.py`` phase 5's plane after its prefill (10^4 keys,
    L = 24, W = 16384) and its first batch of 2048 queries."""
    s5 = wl.zipf_workload(n=W16_N, ops=W16_E * W16_B, s=1.0, p=0.01,
                          seed=5)
    st = sx.make(capacity=W16_WIDTH + 2, max_level=24, device=device)
    st, _, _ = sx.run_ops(
        st, np.full(W16_N, sx.OP_INSERT, np.int32),
        np.random.default_rng(6).permutation(s5.populate),
        np.ones(W16_N, bool))
    plane = dix.from_state_device(st, n_levels=24, width=W16_WIDTH)
    return plane, torch.as_tensor(s5.keys[:W16_B], device=device)


def b1_call(ssk, plane, q, **private):
    """One B1 call over the plane's arrays; ``private`` launch arguments
    (``_block``) where the tree's wrapper takes them."""
    params = inspect.signature(ssk._splay_search_arrays).parameters
    kw = {k: v for k, v in private.items() if k in params}
    return lambda: ssk._splay_search_arrays(
        plane.keys, q, 256, plane.rank_map, plane.widths, **kw)


def b2_call(ssk, plane, q, query_block: int = 256, **private):
    """One B2 call over the plane's arrays; ``private`` launch
    arguments where the tree's wrapper takes them."""
    params = inspect.signature(ssk._splay_search_pipelined_arrays).parameters
    kw = {k: v for k, v in private.items() if k in params}
    return lambda: ssk._splay_search_pipelined_arrays(
        plane.keys, q, query_block, plane.rank_map, plane.widths,
        plane.bot_rank, **kw)


def eager_ms(torch, fn, reps: int = 50, warmup: int = 2) -> float:
    """ms per call of ``fn`` by CUDA events around ``reps`` eager calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``rounds`` times between two events.  The host's cost
    of a call (tens of microseconds for a Python wrapper) stays out of
    it; :func:`eager_ms` measures the longer of the two."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * rounds)


def traced_ms(torch, fn, reps: int = 20):
    """Device ms per launch of the descent kernel over ``reps`` eager
    calls of ``fn`` under ``torch.profiler`` (the median of the traced
    launches), and how many launches the trace holds."""
    _, ks = ft.kernel_ms(torch, lambda: [fn() for _ in range(reps)],
                         match=KERNEL_NAMES)
    return (float(np.median(ks)) if ks else float("nan")), len(ks)


def descent_stats(torch, plane, q, exits: bool, last: int = 3,
                  fan: int = 4):
    """What the lanes of a batch walk, with torch ops on the plane's
    device.  Rows walked until a lane resolves (a hit, ``level_found +
    1``, or a width-1 bottom-row projection), per query and per warp of
    32 queries.  The plane entries the lanes' windows hold, distinct per
    row, and the compares they need (a compare per candidate plus the
    hit's), over the rows the kernel walks: every row for B1, the rows
    up to resolution for B2 (``exits``); the bound counts these.  And
    the longest chain of dependent global loads of one lane: the descent
    engine's (one trip per row it reads, once its window holds at most
    ``last`` candidates, one more per ``fan``-ary narrowing) and the
    parent's binary descent (its probes, then one trip for the hit
    check and the rank map, on every live row)."""
    keys, rm, br = plane.keys, plane.rank_map, plane.bot_rank
    n_levels, width = keys.shape
    w = plane.widths.tolist()
    dev = keys.device
    nq = q.shape[0]
    i32 = torch.int32
    lo = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    hi = torch.full((nq,), w[0], dtype=torch.int64, device=dev)
    q = q.long()
    resolved = torch.zeros((nq,), dtype=torch.bool, device=dev)
    rows = torch.full((nq,), n_levels, dtype=i32, device=dev)
    chain_new = torch.zeros((nq,), dtype=i32, device=dev)
    chain_old = torch.zeros((nq,), dtype=i32, device=dev)
    windows = []
    entries = compares = 0
    for r in range(n_levels):
        row = keys[r].long()
        walk = ~resolved if exits else torch.ones_like(resolved)
        if bool(walk.any()):
            seen = torch.zeros((width,), dtype=torch.bool, device=dev)
            for k in range(int((hi - lo)[walk].max()) + 1):
                j = lo + k
                ok = walk & (j >= 0) & (j <= hi) & (j < width)
                seen[j[ok]] = True
            entries += int(seen.sum())
            compares += int(((hi - lo - 1).clamp(min=0) + 1)[walk].sum())
            windows.append(float((hi - lo - 1)[walk].clamp(min=0)
                                 .float().mean()))
        # the parent: binary probes while hi - lo > 1, then a trip for
        # row[p] and the rank map on a live row
        blo, bhi = lo.clone(), hi.clone()
        probes = torch.zeros_like(chain_old)
        while bool((bhi - blo > 1).any()):
            act = bhi - blo > 1
            mid = torch.div(blo + bhi, 2, rounding_mode="floor")
            le = row[mid.clamp(0, width - 1)] <= q
            blo = torch.where(act & le, mid, blo)
            bhi = torch.where(act & ~le, mid, bhi)
            probes += act.to(i32)
        if w[r] > 0:
            chain_old += probes + 1
        # the descent engine: fan-ary narrowing, then the last trip
        trips = torch.zeros_like(chain_new)
        nlo, nhi = lo.clone(), hi.clone()
        while bool((nhi - nlo - 1 > last).any()):
            act = nhi - nlo - 1 > last
            span = nhi - nlo
            c = torch.zeros_like(nlo)
            for k in range(1, fan):
                j = nlo + k * span // fan
                c += (row[j.clamp(0, width - 1)] <= q).long()
            nlo, nhi = (torch.where(act, nlo + c * span // fan, nlo),
                        torch.where(act, nlo + (c + 1) * span // fan, nhi))
            trips += act.to(i32)
        p = nlo.clone()
        for k in range(1, last + 1):
            j = nlo + k
            p += ((j < nhi) & (row[j.clamp(0, width - 1)] <= q)).long()
        trips += ((nhi > nlo + 1) | (nlo >= 0) | (w[r] > 0)).to(i32)
        chain_new += torch.where(walk, trips, 0)
        pc = p.clamp(0, width - 1)
        edge = (p + 1 >= width) | (w[r] == 0)
        hit = (p >= 0) & (row[pc] == q)
        bl = torch.where(p >= 0, br[r][pc].long(), -1)
        bh = torch.where(edge, w[-1], br[r][(p + 1).clamp(0, width - 1)]
                         .long())
        now = ~resolved & (hit | (bh - bl == 1))
        rows = torch.where(now, r + 1, rows)
        resolved |= now
        if r < n_levels - 1:
            lo = torch.where(p >= 0, rm[r][pc].long(), -1)
            hi = torch.where(edge, w[r + 1],
                             rm[r][(p + 1).clamp(0, width - 1)].long())
    pad = (-nq) % 32
    warp_max = torch.nn.functional.pad(rows, (0, pad)).view(-1, 32).max(1)
    return {
        "rows_mean": float(rows.float().mean()),
        "warp_max_mean": float(warp_max.values.float().mean()),
        "warps_to_bottom": float((warp_max.values == n_levels).float()
                                 .mean()),
        "rows_hist": {int(k): int(v) for k, v in zip(
            *torch.unique(rows, return_counts=True))},
        "window_mean": [round(x, 3) for x in windows],
        "entries": entries, "compares": compares,
        "chain_loads": int(chain_new.max()),
        "parent_chain_loads": int(chain_old.max()),
    }


def chain_us(loads: int, chase_ns: float) -> float:
    """The chain figure: dependent L2 loads x the one-thread chase's ns
    per dependent load in L2, in microseconds."""
    return loads * chase_ns / 1e3

