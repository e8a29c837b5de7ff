"""Kernel W: the batched state walk of both engines' ``find_batch``
(``csrc/state_walk.cu``).

:func:`splay_walk` (a ``SplayState``) and :func:`skip_walk` (a
``SkipState``) return ``(slot, steps)`` int32 ``[n]`` for a batch of
int32 keys on the state's device, exactly as the reference's vmapped
``find`` does: ``slot`` is the key's slot where it is physically present
(delete-marked or not) and -1 elsewhere, ``steps`` counts the walk's
advances and descents.  The splay walk reads a node's links at
``max(h, nzero[pred])`` (lazy expansion) and stops at the list's bottom
``zl``; the skip walk reads ``nxt[h][pred]`` down to level 0.

On CUDA tensors each call is one launch of the kernel (one thread a
query, :data:`BLOCK` threads a block) on torch's current stream,
followed by one read of its status word: the call's only wait on the
card.  On CPU tensors it runs the plain version (:func:`splay_walk_plain`,
:func:`skip_walk_plain`): the masked torch loop stepping every lane of
the batch together, which also runs on CUDA tensors when called by
name.  There is no fallback between the two: the tensors' device
decides.

Keys ``>= POS_INF_32`` never end their walk (the walk runs past the
tail sentinel), so both wrappers refuse them with ``ValueError``: the
kernel marks such a lane in its status word and does not walk it, and
on CPU tensors :func:`check_keys` runs before the plain loop.  A lane
that reaches ``C + L + 1`` steps (``C`` the capacity, ``L`` the
engine's ``max_level``) raises ``RuntimeError``: a walk passes each
slot at most once and descends at most ``L`` times, so only a
corrupted state gets there.  The walk is read-only: a refused batch
leaves the state as it was.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import trace
from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU runs do not count)
LAUNCHES = trace.register("launches", {"splay_walk": 0, "skip_walk": 0})

HEAD = 0
POS_INF_32 = 2 ** 31 - 1
BLOCK = 64               # threads a block, the fastest measured (PERF.md §6)

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = {"splay_walk": [_P] * 4 + [_I] * 3 + [_P] * 4 + [_I, _P],
             "skip_walk": [_P] * 2 + [_I] * 3 + [_P] * 4 + [_I, _P]}
_FIELDS = {"splay_walk": ("key", "nxt", "nzero", "zl"),
           "skip_walk": ("key", "nxt")}
# the status word's bit flags, the refusal first
REFUSED_KEY = 4
_STATUS = {1: "a lane reached the step bound C + L + 1",
           2: "a slot index outside [-C, C) or a level outside [0, L]"}
REFUSAL = ("state-walk keys must lie below POS_INF_32 (a walk for the "
           "tail sentinel's key never returns)")


def check_keys(keys: torch.Tensor) -> None:
    """Refuse walk keys ``>= POS_INF_32`` on the host (one read of the
    device): the plain loop, and the folds that write state, run it
    before they start."""
    if keys.numel():
        trace.count("waits.walk.keys")
        if bool((keys >= POS_INF_32).any()):
            raise ValueError(REFUSAL)


def status_error(name: str, word: int):
    """The exception for a launch's status word, or None when it is 0:
    ``ValueError`` for a refused key, before any other cause, else
    ``RuntimeError`` naming every cause set."""
    if word & REFUSED_KEY:
        return ValueError(REFUSAL)
    if word:
        why = "; ".join(m for b, m in _STATUS.items() if word & b) or word
        return RuntimeError(f"{name}: {why} (a corrupted state)")
    return None


def step_bound(capacity: int, max_level: int) -> int:
    """The most steps a walk on an intact state can take, plus one."""
    return capacity + max_level + 1


def _walk_plain(key, nxt, nzero, zl, max_level: int, ks, reads=None):
    """The masked loop: every lane steps together until none walks.
    ``nzero`` None is the skip-list (no lazy levels, bottom 0).  A list
    ``reads`` gets, for each step, the walking lanes' ``(level, pred,
    curr)``: the entries ``nxt[level, pred]``, ``key[curr]`` (and on the
    splay-list ``nzero[pred]``) that step reads."""
    n = ks.shape[0]
    dev = key.device
    bound = step_bound(key.shape[0], max_level)
    ks = ks.to(torch.int32)
    pred = torch.full((n,), HEAD, dtype=torch.int64, device=dev)
    h = torch.full((n,), max_level - 1, dtype=torch.int64, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    active = (h >= zl) & ~found
    taken = 0
    while bool(active.any()):
        if taken == bound:
            raise RuntimeError(f"state walk: a lane reached the step bound "
                               f"{bound} (a corrupted state)")
        lvl = h if nzero is None else torch.maximum(
            h, nzero[pred].to(torch.int64))
        curr = nxt[lvl, pred].to(torch.int64)
        if reads is not None:
            reads.append((lvl[active], pred[active], curr[active]))
        adv = key[curr] <= ks
        found = torch.where(active & ~adv, key[pred] == ks, found)
        pred = torch.where(active & adv, curr, pred)
        h = torch.where(active & ~adv, h - 1, h)
        steps = steps + active.to(torch.int32)
        active = (h >= zl) & ~found
        taken += 1
    # found can also become true exactly at loop exit (descended past
    # the bottom)
    found = found | (key[pred] == ks)
    slot = torch.where(found & (pred != HEAD), pred, -1)
    return slot.to(torch.int32), steps


def splay_walk_plain(st, ks, reads=None):
    """The splay-list walk as torch ops, on tensors of either device."""
    return _walk_plain(st.key, st.nxt, st.nzero, st.zl.to(torch.int64),
                       st.max_level, ks, reads)


def skip_walk_plain(st, ks, reads=None):
    """The skip-list walk as torch ops, on tensors of either device."""
    return _walk_plain(st.key, st.nxt, None, 0, st.max_level, ks, reads)


def _check(name: str, st, ks) -> None:
    dev = st.device
    for f in _FIELDS[name]:
        t = getattr(st, f)
        if not (t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()):
            raise ValueError(f"state field {f} must be a contiguous int32 "
                             "CUDA tensor")
        if t.device != dev:
            raise ValueError(f"state field {f} is on {t.device}, the state "
                             f"on {dev}")
    if not (ks.device == dev and ks.dtype == torch.int32
            and ks.dim() == 1 and ks.is_contiguous()):
        raise ValueError("walk keys must be a contiguous int32 vector on "
                         "the state's device")


def _bind(name: str, st, threads: int = BLOCK):
    """The loaded entry point and the launch's state arguments."""
    lib = build.load("state_walk")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    ptrs = [build.ptr(getattr(st, f)) for f in _FIELDS[name]]

    def call(ks, slot, steps, status) -> None:
        p = build.ptr
        code = fn(*ptrs, st.capacity, st.max_level, ks.shape[0], p(ks),
                  p(slot), p(steps), p(status), threads,
                  build.stream_of(st.key))
        build.check(lib, code, f"{name} launch")
    return call


def _launch(name: str, st, ks):
    _check(name, st, ks)
    n = ks.shape[0]
    dev = st.device
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    steps = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return slot, steps
    status = torch.zeros((1,), dtype=torch.int32, device=dev)
    _bind(name, st)(ks, slot, steps, status)
    LAUNCHES[name] += 1
    trace.count("waits.walk.status")
    err = status_error(name, int(status.item()))
    if err is not None:
        raise err
    return slot, steps


def launcher(st, ks, threads: int = BLOCK):
    """A function of no arguments that launches W once on the CUDA
    state ``st`` (either engine's) and keys ``ks`` (non-empty) into
    fixed outputs, ``threads`` a block, with no count and no status
    read: for timing by CUDA events or a graph replay, which cannot
    hold the status read (the word only gathers bits across replays).
    Its launches are not a path's and do not count."""
    name = "splay_walk" if hasattr(st, "nzero") else "skip_walk"
    _check(name, st, ks)
    if ks.shape[0] == 0:
        raise ValueError("launcher needs at least one key")
    call = _bind(name, st, threads)
    outs = (torch.empty_like(ks), torch.empty_like(ks),
            torch.zeros((1,), dtype=torch.int32, device=st.device))
    return lambda: call(ks, *outs)


def _on_cpu(st, ks) -> bool:
    if st.device.type != "cpu":
        return False
    if ks.device.type != "cpu":
        raise ValueError(f"walk keys on {ks.device}, state on the CPU")
    return True


def splay_walk(st, ks):
    """``(slot, steps)`` of the splay-list walk for each key of ``ks``."""
    if _on_cpu(st, ks):
        check_keys(ks)
        return splay_walk_plain(st, ks)
    return _launch("splay_walk", st, ks)


def skip_walk(st, ks):
    """``(slot, steps)`` of the skip-list walk for each key of ``ks``."""
    if _on_cpu(st, ks):
        check_keys(ks)
        return skip_walk_plain(st, ks)
    return _launch("skip_walk", st, ks)
