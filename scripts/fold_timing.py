"""Kernel F's inputs and timings, shared by ``chip_smoke.py`` (phase 8)
and ``scripts/torch_fold_ab.py``.

Every function takes the modules of the tree under test as arguments
(``sx`` = ``repro_torch.core.splaylist``, ``wl`` =
``repro_torch.core.workload``, ``fold`` = ``repro_torch.kernels.fold``),
so the same inputs and the same clocks serve any commit of the port.
The inputs come from fixed seeds:

* the paper's Fig. 12 stream (Aksenov et al., arXiv:2008.01009 §6:
  10^5 keys, Zipf s = 1, rebalancing coin p = 0.01, 25 epochs of 4096
  contains) and its prefill, 10^5 inserts in a seeded order;
* the vocab tier's stream flushes (4 epochs x 256 decode lanes, 5%
  dead) and one more stream epoch's op list.

F is timed two ways.  By CUDA events around a loop of wrapper calls:
what a caller waits for, host synchronisation included where the
wrapper reads a result back.  And per launch from a ``torch.profiler``
trace: the device time of each ``fold_kernel`` launch alone.
"""

from __future__ import annotations

import numpy as np

PAPER_N, PAPER_E, PAPER_B = 100_000, 25, 4096
PAPER_CAPACITY, PAPER_LEVELS = 131074, 24
TIER_EPOCHS, TIER_LANES, TIER_FLUSHES = 4, 256, 32


def paper_prefill(sx, wl):
    """The paper stream and its prefill op list ``(kinds, keys, upd)``
    for ``run_ops`` on ``make(PAPER_CAPACITY, PAPER_LEVELS)``."""
    stream = wl.zipf_workload(n=PAPER_N, ops=PAPER_E * PAPER_B, s=1.0,
                              p=0.01, seed=0)
    order = np.random.default_rng(1).permutation(stream.populate)
    return stream, (np.full(PAPER_N, sx.OP_INSERT, np.int32), order,
                    np.ones(PAPER_N, bool))


def tier_flushes(wl, rng, vocab: int):
    """The vocab tier's ``TIER_FLUSHES`` token blocks of ``[TIER_EPOCHS,
    TIER_LANES]`` Zipf(1) ids, 5% dead lanes (-1), drawn from ``rng``."""
    out = []
    for _ in range(TIER_FLUSHES):
        toks = wl.zipf_token_ids(rng, vocab, (TIER_EPOCHS, TIER_LANES))
        toks[rng.random((TIER_EPOCHS, TIER_LANES)) < 0.05] = -1
        out.append(toks)
    return out


def tier_epoch_ops(torch, sx, wl, vocab: int, device):
    """One stream epoch's op list as ``observe_serving`` makes it (a live
    token inserts, a dead lane reads, 1% update coin): ``(kinds, keys,
    upd)`` tensors on ``device``."""
    rng = np.random.default_rng(11)
    tok = wl.zipf_token_ids(rng, vocab, (TIER_LANES,))
    tok[rng.random(TIER_LANES) < 0.05] = -1
    live = tok >= 0
    kinds = np.where(live, sx.OP_INSERT, sx.OP_CONTAINS).astype(np.int32)
    upd = live & (rng.random(TIER_LANES) < 0.01)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (kinds, tok, upd))


def kernel_ms(torch, fn, match=("fold_kernel",)):
    """Run ``fn`` once under ``torch.profiler``; returns its result and
    the device ms of each traced kernel whose name holds one of the
    strings ``match``, in
    launch order (an empty list when the trace holds none).  A session
    that follows others in the process can miss its first device
    activity, so a one-element fill runs first and takes that place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones((1,), device="cuda")
        out = fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and any(m in e.name for m in match))
    return out, [(b - a) / 1e3 for a, b in ev]


def mean_or_nan(xs) -> float:
    return float(np.mean(xs)) if len(xs) else float("nan")


def fold_paths(torch, sx, fold, st, entries, vst, vops, reps: int = 10):
    """Kernel F on three inputs, each on fresh clones of its state after
    two warm-up folds: the paper epoch's aggregated fold list
    ``entries`` (mode 1), the same list cut to its ``w > 0`` entries,
    and one vocab-tier epoch's op list ``vops`` (kinds, keys, upd; mode
    0) on the tier's stream state ``vst``.  Returns ``{name: {"call_ms":
    ms per wrapper call over ``reps`` calls between two events,
    "kernel_ms": mean device ms per launch over the launches that a
    trace of ``reps`` launches holds, "launches": how many it holds (a
    trace may miss one), "state": the state after one fold}}`` and the
    walk steps of each input: the plain version's path lengths (find
    steps of the weighted keys) in mode 1, ``plen`` in mode 0."""
    keep = entries[1] > 0
    subset = tuple(x[keep] for x in entries)
    n = vops[0].shape[0]
    res = torch.zeros((n,), dtype=torch.int32, device=vops[0].device)
    plen = torch.zeros_like(res)

    def timed(src, fn):
        clones = [sx.clone(src) for _ in range(2 * reps + 2)]
        for c in clones[:2]:
            fn(c)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for c in clones[2:reps + 2]:
            fn(c)
        t1.record()
        torch.cuda.synchronize()
        _, ks = kernel_ms(torch, lambda: [fn(c) for c in clones[reps + 2:]])
        return {"call_ms": t0.elapsed_time(t1) / reps,
                "kernel_ms": mean_or_nan(ks), "launches": len(ks),
                "state": clones[-1]}

    out = {"epoch_full": timed(st, lambda c: fold.fold_weighted(
               c, *entries)),
           "epoch_subset": timed(st, lambda c: fold.fold_weighted(
               c, *subset)),
           "vocab_epoch": timed(vst, lambda c: fold.fold_ops(
               c, *vops, res, plen))}
    steps = {"epoch": int(sx.find_batch(st, subset[0])[1].sum()),
             "vocab_epoch": int(plen.sum())}
    return out, steps
