"""Spans and counters of the serving loop.

Spans (:func:`span`) are ``torch.profiler`` ranges named ``splay.*``.
They exist only while tracing is on (:func:`enable`) and a profiler
session records: the session then shows each layer's range, on the
device trace's clock, with every kernel and copy linked to the range
that launched it.  Otherwise a span is one shared no-op context (a range
that no session records would cost its enter and exit for nothing), and
with tracing off the program records nothing.

Counters (:func:`count`) are process-wide integers, kept on the host and
always on: the serving loop's host waits on the device by site
(``waits.<site>``), its rebuilds, refresh fallbacks, overflow arms and
epochs, and the kernels' launch counters (``launches.<kernel>``, the
``LAUNCHES`` dicts registered by :func:`register`).  Device counters are
opt-in: while tracing is on, a kernel that keeps one (F's
``fold.walks``/``fold.steps``) is handed an int64 tensor by
:func:`device_counter` and adds its totals there once a launch; off, it
is handed None and counts nothing.  Reading them (:func:`counts`) waits
on the device, so only a caller that asks pays for it.

Each count made while tracing is on and a profiler session records is
also kept apart (``counts(profiled=True)``): the counts that line up
with that session's trace.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()

_on = False
_counts: Dict[str, int] = {}          # everything counted on the host
_profiled: Dict[str, int] = {}        # ... while a profiler session records
_groups: Dict[str, dict] = {}         # registered dicts, by name prefix
# (group, device) -> (field names, [total counter, profiled counter])
_device: Dict[tuple, tuple] = {}


def enable(on: bool) -> None:
    """Switch spans and device counters on or off (off by default)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _profiling() -> bool:
    return _on and bool(getattr(_profiler, "_is_profiler_enabled", False))


def span(name: str, args=None):
    """A profiler range ``name`` (``args``, if given, as its string)
    while tracing is on and a profiler session records; otherwise a
    shared no-op context."""
    if not _profiling():
        return _NULL
    return _profiler.record_function(name,
                                     None if args is None else str(args))


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the host counter ``name``; returns its new total."""
    total = _counts[name] = _counts.get(name, 0) + n
    if _profiling():
        _profiled[name] = _profiled.get(name, 0) + n
    return total


def register(group: str, counters: dict) -> dict:
    """Report the integer dict ``counters`` (updated in place by its
    owner) in :func:`counts` as ``<group>.<key>``; returns it."""
    _groups.setdefault(group, {})[id(counters)] = counters
    return counters


def device_counter(group: str, fields: Sequence[str], device):
    """While tracing is on, the int64 ``[len(fields)]`` tensor on
    ``device`` a kernel adds its counts ``<group>.<field>`` to (the one
    kept apart while a profiler session records); None while off."""
    if not _on:
        return None
    key = (group, str(torch.device(device)))
    entry = _device.get(key)
    if entry is None:
        # both made at once, so that a session that starts later
        # allocates nothing inside it
        entry = _device[key] = (tuple(fields), [
            torch.zeros((len(fields),), dtype=torch.int64, device=device)
            for _ in range(2)])
    return entry[1][_profiling()]


def counts(profiled: bool = False) -> Dict[str, int]:
    """Every counter by name: the host counters, the registered dicts
    and the device counters (read back: a wait on each device that has
    one).  ``profiled=True``: only what was counted while tracing was on
    and a profiler session recorded (launch counters excluded)."""
    out = dict(_profiled if profiled else _counts)
    if not profiled:
        for group, dicts in _groups.items():
            for d in dicts.values():
                for k, v in d.items():
                    out[f"{group}.{k}"] = out.get(f"{group}.{k}", 0) + v
    for (group, _), (fields, pair) in _device.items():
        vals = [pair[1]] if profiled else pair
        for t in vals:
            for f, v in zip(fields, t.tolist()):
                out[f"{group}.{f}"] = out.get(f"{group}.{f}", 0) + v
    return out


def reset_counts() -> None:
    """Zero every counter, the registered dicts included."""
    _counts.clear()
    _profiled.clear()
    for dicts in _groups.values():
        for d in dicts.values():
            for k in d:
                d[k] = 0
    for _, pair in _device.values():
        for t in pair:
            t.zero_()
