"""What the readers of the program's own spans and counters share.

The program (``repro_torch.core.trace``) opens ``splay.*`` profiler
ranges and counts host waits, rebuilds and F's walk steps, but only
while its tracing is on.  The harness loads a cell's readers before the
run's set-up, and only in a traced run: loading a reader that imports
this module calls :func:`arm`, which switches the program's tracing on
and zeroes its counters.  The counts a reader takes are those the
program made while the profiler recorded (``counts(profiled=True)``):
the traced slice's.  A program without the module (an older tree)
leaves every such reader with nothing to read: it returns None.

Device time by span: each device activity of the traced slice belongs to
the innermost ``splay.*`` range open when the host enqueued it.  The
trace reduction keeps no correlation ids, so the session's activities
and the host's enqueueing runtime calls are paired in order (one stream
runs its work in the order it was enqueued), counted from the session's
end (a session can miss its first activities), and never by comparing
the host's clock with the device's.  Where the kinds of a pair differ (a
kernel against a copy: an activity or a call the trace lost inside the
slice), the lost one is skipped; an activity with no call is left out.
A kernel lost among kernels shifts the pairs back to the last change of
kind: those few are attributed approximately.
"""

from __future__ import annotations

import bisect

import numpy as np

from splaybench.yardstick import innermost, union_s

PREFIX = "splay."
# the runtime calls that put work on the device's stream
ENQUEUE = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset", "cuLaunchKernel")
NO_SPAN = "host (no event)"
LOOK = 8                 # pairs compared where a lost event is sought


def arm():
    """Switch the program's tracing on and zero its counters; returns its
    ``trace`` module, or None when the program has none."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    trace.enable(True)
    trace.reset_counts()
    return trace


def slice_counts(trace, ctx):
    """The program's counts over the traced slice, or None without a
    trace or a program that counts."""
    s = ctx["summary"]
    if trace is None or s is None or not s.batches:
        return None
    return trace.counts(profiled=True)


def _spans(summary):
    return [e for e in summary.host if e[0].startswith(PREFIX)]


def _kind(name: str) -> str:
    """What a runtime call or a device activity moves: a copy, a fill, or
    a kernel's work."""
    for kind, prefixes in (("copy", ("Memcpy", "cudaMemcpy")),
                           ("fill", ("Memset", "cudaMemset"))):
        if name.startswith(prefixes):
            return kind
    return "kernel"


def _enqueue_times(calls, acts):
    """The enqueue time of each activity (None: none found): ``calls``
    and ``acts``, both ``(name, start)`` in order, paired from the end.
    Where a pair's kinds differ, one of the two was lost: the one skipped
    is the one that lets more of the next ``LOOK`` pairs agree."""
    kc = [_kind(n) for n, _ in calls]
    ka = [_kind(n) for n, _ in acts]

    def agree(i, j):
        return sum(kc[i - k] == ka[j - k] for k in range(min(LOOK, i + 1,
                                                             j + 1)))

    times = [None] * len(acts)
    i, j = len(calls) - 1, len(acts) - 1
    while i >= 0 and j >= 0:
        if kc[i] == ka[j]:
            times[j] = calls[i][1]
            i, j = i - 1, j - 1
        elif agree(i, j - 1) >= agree(i - 1, j):
            j -= 1                          # an activity with no call
        else:
            i -= 1                          # a call with no activity
    return times


def _paired(summary):
    """``(enqueue time, start, end)`` of each device activity of the
    session whose enqueue was found."""
    calls = sorted(((n, a) for n, a, _ in summary.host
                    if n.startswith(ENQUEUE)), key=lambda e: e[1])
    acts = sorted(summary.device, key=lambda e: e[1])
    times = _enqueue_times(calls, [(n, a) for n, a, _ in acts])
    return [(t, a, b) for t, (_, a, b) in zip(times, acts) if t is not None]


def device_by_span(summary):
    """Device seconds of the slice by the innermost ``splay.*`` span open
    at each activity's enqueue (``NO_SPAN`` outside every span), or None
    where the program opened no span."""
    spans = _spans(summary)
    if not spans or not summary.device:
        return None
    starts = np.asarray([a for _, a, _ in spans])
    out = {}
    for t, a, b in _paired(summary):
        if summary.t0 <= t <= summary.t1:
            name = innermost(spans, starts, t)
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def span_dev_ms(ctx, name: str):
    """Device ms a batch attributed to the span ``name``, or None."""
    s = ctx["summary"]
    if s is None or not s.batches:
        return None
    by = device_by_span(s)
    if by is None or name not in by:
        return None
    return 1e3 * by[name] / s.batches


def idle_inside_s(summary, name: str):
    """Seconds the device sat idle inside the calls ``name``: for each,
    between the start of the first activity it enqueued and the end of
    the last, on the device's clock alone (the host's may lie
    milliseconds apart from it); None where there is none."""
    spans = sorted((a, b) for n, a, b in summary.host if n == name)
    if not spans or not summary.device:
        return None
    starts = [a for a, _ in spans]
    reach = {}
    for t, a, b in _paired(summary):
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= spans[k][1]:
            lo, hi = reach.get(k, (a, b))
            reach[k] = (min(lo, a), max(hi, b))
    busy = sorted((a, b) for _, a, b in summary.device)
    idle = 0.0
    for lo, hi in reach.values():
        inside = [(max(a, lo), min(b, hi)) for a, b in busy
                  if b > lo and a < hi]
        idle += (hi - lo) / 1e6 - union_s(inside)
    return idle
