"""Kernel S: the skip-list's serialized op fold (``csrc/skip_fold.cu``).

:func:`fold_ops` runs the ``skiplist.run_ops`` op list (contains,
insert of a pre-sampled height, delete, in order) on the state it is
given, in place (the caller hands it a private copy), writing each op's
answer and path length; it returns the index of an insert that found
the capacity exhausted, or ``n`` when it ran to the end.

On CUDA tensors each call is one launch of the kernel: one warp walks
the state in device memory, a lane a level for an insert's
predecessors, which start from the last insert's (its fingers).  On CPU
tensors it runs the plain version, the step-by-step fold of
``core/skiplist.py`` (``fold_plain``), which finds them the same way.
There is no fallback between the two: the tensors' device decides.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import trace
from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU runs do not count)
LAUNCHES = trace.register("launches", {"skip_fold": 0})

MAX_LEVELS = 64          # two levels a lane of the kernel's one warp

_I = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P] * 6 + [_P]


def _launch(st, kinds, keys, heights, res, plen) -> int:
    dev = st.device
    for name, t in zip(st._fields, st):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"state field {name} must be a contiguous "
                             "CUDA tensor")
    if st.max_level > MAX_LEVELS:
        raise ValueError(f"max_level {st.max_level} exceeds the kernel's "
                         f"{MAX_LEVELS}")
    for t in (kinds, keys, heights, res, plen):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("op tensors must be contiguous and on the "
                             "state's device")
    n = kinds.shape[0]
    if n == 0:
        return 0
    lib = build.load("skip_fold")
    lib.skip_fold.argtypes = _ARGTYPES
    lib.skip_fold.restype = ctypes.c_int
    status = torch.empty((1,), dtype=torch.int32, device=dev)
    p = build.ptr
    code = lib.skip_fold(*(p(t) for t in st), st.capacity, st.max_level, n,
                         p(kinds), p(keys), p(heights), p(res), p(plen),
                         p(status), build.stream_of(st.key))
    build.check(lib, code, "skip_fold launch")
    LAUNCHES["skip_fold"] += 1
    return int(status.item())


def fold_ops(st, kinds, keys, heights, res, plen) -> int:
    """Run the op list on ``st`` in place; returns the index of the
    insert that found the capacity exhausted, or ``n``."""
    if st.device.type == "cpu":
        from repro_torch.core import skiplist as skx
        return skx.fold_plain(st, kinds, keys, heights, res, plen)
    return _launch(st, kinds, keys, heights, res, plen)
