"""The yardstick: the work a kernel must do, the card's peaks, and the
reduction of a profiler trace to the numbers the metric readers read.

Work is reckoned from a batch's inputs and the reference's state and
plane, never from the program's outputs, so a kernel's roofline share
reads the same work whatever implements it.  The rules follow the
port's kernel table (``PERF.md``): the least time of a kernel is its
bytes over the memory rate or its int32 operations over the int32 rate,
the larger, with each input byte read once and each output byte written
once.

* descent (B1, ``descent_kernel``): per query its key, verdict, rank and
  row (13 B), the row widths, and the distinct plane entries the lanes'
  windows hold in the two arrays it reads (keys, rank map), 4 B each;
  one compare per window candidate;
* state walk (W, ``walk_kernel``): per query its key, slot and steps
  (12 B), and each distinct state entry the walks read once (``nxt``,
  ``key`` and ``nzero`` entries, ``zl``), 4 B each;
* update fold (F, ``fold_kernel``): its list (a weighted entry's key,
  weight and marked weight, 12 B; an op's kind, key, coin, answer and
  path length, 17 B) and the state bytes it changes, read and written.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

# device kernels by layer, matched as substrings of the traced names
KERNEL_LAYERS = {"search": "descent_kernel", "walk": "walk_kernel",
                 "fold": "fold_kernel"}
PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def layer_of(kernel_name: str) -> str:
    for layer, sub in KERNEL_LAYERS.items():
        if sub in kernel_name:
            return layer
    return "torch"


def peaks(device_name: str):
    """The card's published peaks (``hbm_bytes_per_s``,
    ``int32_ops_per_s``), or None for a card the table lacks."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_name)


def least_s(work: dict, peak: dict) -> float:
    """Least seconds of ``work`` (``bytes``, ``ops``) on the card."""
    return max(work["bytes"] / peak["hbm_bytes_per_s"],
               work["ops"] / peak["int32_ops_per_s"])


# ---------------------------------------------------------------------------
# work of each kernel
# ---------------------------------------------------------------------------

def _covered(a: np.ndarray, b: np.ndarray, width: int) -> int:
    """Positions of ``[0, width)`` inside at least one ``[a_i, b_i]``."""
    keep = a <= b
    d = np.zeros(width + 1, np.int64)
    np.add.at(d, a[keep], 1)
    np.add.at(d, b[keep] + 1, -1)
    return int(np.count_nonzero(np.cumsum(d[:width])))


def descent_work(plane: dict, queries) -> dict:
    """B1's work for ``queries`` on ``plane`` (the reference's, as
    :func:`reference.plane` gives it): every lane walks every row; in a
    row its window ``[lo, hi]`` starts from the row above's rank-map
    entries of the predecessor and its successor."""
    keys, rm = plane["keys"], plane["rank_map"]
    w = plane["widths"].tolist()
    n_levels, width = keys.shape
    q = np.asarray(queries, np.int64)
    nq = q.shape[0]
    lo = np.full(nq, -1, np.int64)
    hi = np.full(nq, w[0], np.int64)
    entries = compares = 0
    for r in range(n_levels):
        entries += _covered(np.maximum(lo, 0), np.minimum(hi, width - 1),
                            width)
        compares += int((np.maximum(hi - lo - 1, 0) + 1).sum())
        p = np.searchsorted(keys[r][:w[r]], q, side="right") - 1
        edge = (p + 1 >= width) | (w[r] == 0)
        lo = np.where(p >= 0, rm[r][np.maximum(p, 0)], -1)
        hi = np.where(edge, w[min(r + 1, n_levels - 1)],
                      rm[r][np.minimum(p + 1, width - 1)])
    return {"bytes": 13 * nq + 4 * n_levels + 4 * 2 * entries,
            "ops": compares}


def walk_work(ref, queries) -> dict:
    """W's work for ``queries`` on the reference's state: each walk as W
    steps it (the link at ``max(h, nzero[pred])``, the key of the node it
    reaches, a descent when that key is past the query), its distinct
    reads counted once over the batch."""
    q = np.asarray(queries, np.int64)
    nxt_seen, key_seen, nz_seen = set(), {id(ref.head)}, set()
    zl = ref.zero_level
    for k in np.unique(q).tolist():
        pred, h, found = ref.head, ref.ML1, False
        while h >= zl and not found:
            z = pred.zero_level
            lvl = z if z > h else h
            curr = pred.nxt[lvl]
            nxt_seen.add((lvl, id(pred)))
            key_seen.add(id(curr))
            nz_seen.add(id(pred))
            if curr.key <= k:
                pred = curr
            else:
                found = pred.key == k
                h -= 1
    return {"bytes": 12 * q.shape[0]
            + 4 * (len(nxt_seen) + len(key_seen) + len(nz_seen) + 1),
            "ops": 0}


def fold_work(n_entries: int, entry_bytes: int, changed: int) -> dict:
    """F's work: ``n_entries`` list entries of ``entry_bytes`` each, and
    ``changed`` state bytes read and written."""
    return {"bytes": entry_bytes * n_entries + 2 * changed, "ops": 0}


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def union_s(spans) -> float:
    """Seconds covered by the union of ``(start, end)`` spans (µs)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    return busy / 1e6


def idle_gaps(spans, t0: float, t1: float):
    """The idle intervals of ``[t0, t1]`` (µs) between device spans."""
    out, at = [], t0
    for a, b in sorted(spans):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def innermost(cpu, starts, t: float):
    """Name of the innermost host event (the latest started) that
    covers time ``t``; ``cpu`` sorted by start, ``starts`` its starts."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    while i >= 0:
        name, a, b = cpu[i]
        if b >= t:
            return name
        i -= 1
    return "host (no event)"


class TraceSummary:
    """What the metric readers take from one profiler session: device
    activities ``(name, start_us, end_us)``, host events likewise, the
    traced window's bounds (µs) and the batches it holds."""

    def __init__(self, device, host, t0: float, t1: float, batches: int):
        self.device, self.host = device, sorted(host, key=lambda e: e[1])
        self.t0, self.t1, self.batches = t0, t1, batches

    @classmethod
    def from_profile(cls, prof, batches: int, t0: float = None,
                     t1: float = None):
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.events():
            span = (e.name, float(e.time_range.start),
                    float(e.time_range.end))
            if e.device_type != DeviceType.CUDA:
                host.append(span)
            elif not (getattr(e, "is_user_annotation", False)
                      or e.name.startswith("bench.")):
                # the harness's spans also appear on the device's
                # timeline; they are no device activity
                dev.append(span)
        marks = [(a, b) for n, a, b in host if n == "bench.window"]
        if marks:
            t0, t1 = marks[0]
        return cls(dev, host, t0, t1, batches)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.device])

    def kernel_s(self, layer: str) -> float:
        """Device seconds of the layer's activities (``torch``: every
        activity not of a hand-written kernel)."""
        return sum(b - a for n, a, b in self.device
                   if layer_of(n) == layer) / 1e6

    def syncs_in(self, span_name: str) -> int:
        """Host waits on the card (``SYNC_CALLS``) inside the spans named
        ``span_name``."""
        spans = [(a, b) for n, a, b in self.host if n == span_name]
        out = 0
        for n, a, b in self.host:
            if n in SYNC_CALLS and any(s <= a and b <= e for s, e in spans):
                out += 1
        return out

    def breakdown(self, top: int = 10, gaps_named: int = 500) -> dict:
        """The device activities that took most time, by name, and the
        idle time by what the host was doing (the innermost host event
        at the middle of each of the ``gaps_named`` longest gaps)."""
        by = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps([(a, b) for _, a, b in self.device], self.t0,
                         self.t1)
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = np.asarray([a for _, a, _ in self.host])
        named = {}
        for a, b in gaps[:gaps_named]:
            n = innermost(self.host, starts, (a + b) / 2)
            named[n] = named.get(n, 0.0) + (b - a) / 1e6
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in idle]}


# ---------------------------------------------------------------------------
# what the per-layer metric readers share
# ---------------------------------------------------------------------------

def dev_ms(ctx: dict, layer: str):
    """Device ms a batch of the layer's kernels over the traced slice, or
    None where the trace holds none."""
    s = ctx["summary"]
    if s is None or not s.batches:
        return None
    t = s.kernel_s(layer)
    return 1e3 * t / s.batches if t > 0 else None


def roofline_pct(ctx: dict, layer: str):
    """The layer kernel's share of its roofline: its least time a batch
    (from the counted batches' work) over its traced time a batch, in
    percent; None without a trace, a count or the card's peaks."""
    ms = dev_ms(ctx, layer)
    work = ctx["work"].get(layer)
    if ms is None or work is None or ctx["peak"] is None:
        return None
    return 100.0 * 1e3 * least_s(work, ctx["peak"]) / ms
