"""Kernel F: the serialized update fold (``csrc/splay_fold.cu``).

Two entry points, each mutating the state it is given in place (the
callers in ``core/splaylist.py`` hand it a private copy):

* :func:`fold_ops` — the ``run_ops`` op list: contains / insert /
  delete / predecessor / prefix count in order, writing each op's
  answer and path length; it stops after the op that makes a rebuild
  due and returns that op's index (``n`` when it ran to the end), so
  the caller rebuilds and resumes;
* :func:`fold_weighted` — the ``run_contains_batch`` fold over
  ``(key, w, wm)`` triples: a rebalance of weight ``w`` per entry with
  ``w > 0``, then ``dhits += wm``.

While tracing is on (``core/trace.py``) both count their walks (a
weighted entry visited, an op run) and steps (successor reads) into
``fold.walks``/``fold.steps``: the kernel in registers, added once a
launch to the counter tensor it is handed (null while off); the plain
version as it goes.

On CUDA tensors each call is one launch of the kernel: one warp, whose
lane 0 walks the state (the weighted fold's warp ballots its list 128
entries at a time, so the walk visits only the ``w > 0`` entries; at an
ordered op of the list the whole warp reduces over the live slots).  On CPU
tensors it runs the plain version, the step-by-step fold of
``core/splaylist.py`` (``_find``/``_update``/``_link_bottom`` and the
op bodies).  There is no fallback between the two: the tensors' device
decides.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import trace
from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU runs do not count)
LAUNCHES = trace.register("launches", {"splay_fold": 0})

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 12 + [_I] * 5 + [_P] * 9 + [_P]
# the walk counters F keeps while tracing is on: entries or ops walked,
# and steps (successor reads: F's Walk::next, the plain fold's
# _eff_next)
COUNTED = ("walks", "steps")


def _count_plain(walks: int, steps0: int) -> None:
    from repro_torch.core import splaylist as sx
    if trace.enabled():
        trace.count("fold.walks", walks)
        trace.count("fold.steps", sx.plain_steps() - steps0)


def fold_ops_plain(st, kinds, keys, upd, res, plen, start: int) -> int:
    from repro_torch.core import splaylist as sx
    kinds_l = kinds.tolist()
    keys_l = keys.tolist()
    upd_l = upd.tolist()
    n = len(kinds_l)
    steps0 = sx.plain_steps()
    for i in range(start, n):
        kind = kinds_l[i]
        r, steps = sx.OP_STEPS[kind](st, keys_l[i], upd_l[i])
        res[i] = r
        plen[i] = steps
        if kind in sx.REBUILD_CHECKED and sx._rebuild_due(st):
            _count_plain(i + 1 - start, steps0)
            return i
    _count_plain(n - start, steps0)
    return n


def fold_weighted_plain(st, keys, w, wm) -> None:
    from repro_torch.core import splaylist as sx
    steps0, walks = sx.plain_steps(), 0
    for k, wk, wmk in zip(keys.tolist(), w.tolist(), wm.tolist()):
        if wk > 0:
            sx._update(st, k, wk)
            st.dhits.add_(wmk)
            walks += 1
    _count_plain(walks, steps0)


def _launch(st, mode, start, n, kinds, keys, upd, w, wm, res, plen) -> int:
    """One launch.  Mode 0 reads the stop back (the caller rebuilds and
    relaunches there); mode 1 never stops early, so it returns ``n``
    without waiting for the card."""
    dev = st.device
    for name, t in zip(st._fields, st):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"state field {name} must be a contiguous "
                             "CUDA tensor")
    if st.m.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"count dtype {st.m.dtype} is not int32/int64")
    for t in (kinds, keys, upd, w, wm, res, plen):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("op tensors must be contiguous and on the "
                             "state's device")
    lib = build.load("splay_fold")
    fn = (lib.splay_fold_i32 if st.m.dtype == torch.int32
          else lib.splay_fold_i64)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = torch.empty((2,), dtype=torch.int32, device=dev)
    walked = trace.device_counter("fold", COUNTED, dev)
    p = build.ptr
    code = fn(*(p(t) for t in st), st.capacity, st.max_level, mode, start,
              n, p(kinds), p(keys), p(upd), p(w), p(wm), p(res), p(plen),
              p(status), p(walked), build.stream_of(st.key))
    build.check(lib, code, "splay_fold launch")
    LAUNCHES["splay_fold"] += 1
    if mode == 1:
        return n
    trace.count("waits.fold.status")
    stop, err = status.tolist()
    if err:
        raise RuntimeError(f"splay-list capacity {st.capacity} exhausted "
                           f"at op {stop}")
    return stop


def fold_ops(st, kinds, keys, upd, res, plen, start: int = 0) -> int:
    """Run ops ``start..`` of the list; returns the index of the op
    after which a rebuild is due, or ``n``."""
    with trace.span("splay.fold"):
        if st.device.type == "cpu":
            return fold_ops_plain(st, kinds, keys, upd, res, plen, start)
        return _launch(st, 0, start, kinds.shape[0], kinds, keys, upd,
                       None, None, res, plen)


def fold_weighted(st, keys, w, wm) -> None:
    """The weighted rebalance fold over ``(keys, w, wm)``; entries with
    ``w <= 0`` do nothing."""
    with trace.span("splay.fold"):
        if st.device.type == "cpu":
            fold_weighted_plain(st, keys, w, wm)
            return
        keys = keys.contiguous()
        w = w.to(st.m.dtype).contiguous()
        wm = wm.to(st.m.dtype).contiguous()
        _launch(st, 1, 0, keys.shape[0], None, keys, None, w, wm, None,
                None)
