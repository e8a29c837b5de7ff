"""Splay-tiered embedding gather: the twin of ``repro.kernels.hot_gather``.

The splay heights stratify the vocabulary by access frequency (height
>= h*  <=>  freq >= m/2^(k-h*)), which gives a calibrated hot set.  An
embedding lookup reads hot rows from a small hot buffer and the rest
from the full table:

* :func:`hot_gather`, the two-tier gather in one launch: each id's hot
  rank is read in the kernel, and its row comes from the hot buffer
  (read under an L2 evict-last priority; the TPU holds it in VMEM) or
  from the table;
* :func:`gather_hot` (B3) over the hot buffer alone;
* :func:`gather_rows` (B4) over the full table alone (the cache builds
  its hot buffer with it).

All three are one dtype-blind CUDA row-copy engine
(``csrc/hot_gather.cu``) under three modes.  Their plain PyTorch
versions are the oracles ``ref.gather_rows_ref`` and
``ref.hot_gather_ref``.  CUDA tensors launch the kernel, CPU tensors run
the plain version.  Ids may be int32 or int64 (the kernel reads either;
an int64 id keeps its low 32 bits, as ``.to(torch.int32)``), and
resolve as the reference's gathers resolve them: a negative id wraps
once, anything still out of range clamps.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import trace
from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_rows_ref, hot_gather_ref

# launches of the CUDA kernel per entry point (plain CPU runs do not count)
LAUNCHES = trace.register("launches", {"gather_hot": 0, "gather_rows": 0,
                                        "hot_gather": 0})
# the copy path each entry point's last launch took (see copy_path)
LAST_PATH = {"gather_hot": None, "gather_rows": None, "hot_gather": None}

_MODES = {"gather_rows": 0, "gather_hot": 1, "hot_gather": 2}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _kernel():
    """The C entry of ``csrc/hot_gather.cu``, loaded and bound once."""
    fn = build.load("hot_gather").gather
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def copy_path(row_bytes: int, *tensors) -> str:
    """The copy a launch over rows of ``row_bytes`` bytes between
    ``tensors`` takes: ``"bulk"`` (TMA bulk copies) when the row length
    and every base address are multiples of 16 bytes, else
    ``"vector<w>"``, a warp per row in the widest of 8-, 4-, 2- or
    1-byte words that divides them all."""
    a = row_bytes
    for t in tensors:
        a |= t.data_ptr()
    if a % 16 == 0:
        return "bulk"
    w = 8
    while a % w:
        w //= 2
    return f"vector{w}"


def _rows(src, what):
    if src.dim() != 2:
        raise ValueError(f"{what} must be [n, d], got {tuple(src.shape)}")
    return src.contiguous()


def _ids(ids, like, what="ids"):
    """``ids`` as the kernel reads them: 1-D, contiguous, int32 or int64
    (on the CPU int32, whose plain version resolves the low 32 bits)."""
    if ids.dim() != 1:
        raise ValueError(f"{what} must be [q], got {tuple(ids.shape)}")
    if ids.device != like.device:
        raise ValueError(f"{what} on {ids.device}, rows on {like.device}")
    if ids.dtype.is_floating_point or ids.dtype.is_complex or \
            ids.dtype == torch.bool:
        raise ValueError(f"{what} must be integers, got {ids.dtype}")
    if like.device.type == "cpu" or ids.dtype not in (torch.int32,
                                                      torch.int64):
        ids = ids.to(torch.int32)
    return ids.contiguous()


def _launch(entry, ids, d, dtype, table=None, hot=None, hot_rank=None):
    src = table if table is not None else hot
    q = ids.shape[0]
    out = torch.empty((q, d), dtype=dtype, device=src.device)
    row_bytes = d * out.element_size()
    if q == 0 or row_bytes == 0:
        return out
    srcs = [t for t in (table, hot) if t is not None]
    path = copy_path(row_bytes, *srcs, out)
    code = _kernel()(
        _MODES[entry], None if table is None else table.data_ptr(),
        0 if table is None else table.shape[0],
        None if hot is None else hot.data_ptr(),
        0 if hot is None else hot.shape[0],
        None if hot_rank is None else hot_rank.data_ptr(),
        0 if hot_rank is None else hot_rank.shape[0], ids.data_ptr(),
        int(ids.dtype == torch.int64), q, row_bytes,
        16 if path == "bulk" else int(path[len("vector"):]),
        out.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream)
    build.check(build.load("hot_gather"), code, f"{entry} launch")
    LAUNCHES[entry] += 1
    LAST_PATH[entry] = path
    return out


def _gather(entry, src, ids):
    src = _rows(src, "gather source")
    ids = _ids(ids, src)
    if src.shape[0] == 0 and ids.shape[0]:
        raise ValueError("gather from an empty source")
    if src.device.type == "cpu":
        return gather_rows_ref(src, ids)
    if entry == "gather_rows":
        return _launch(entry, ids, src.shape[1], src.dtype, table=src)
    return _launch(entry, ids, src.shape[1], src.dtype, hot=src)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """B4: ``out[i] = table[ids[i]]``, ``table`` ``[n, d]`` of any dtype,
    ``ids`` ``[q]`` -> ``[q, d]``."""
    return _gather("gather_rows", table, ids)


def gather_hot(hot_buf: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """B3: ``out[i] = hot_buf[ranks[i]]``, ``hot_buf`` ``[h, d]`` of any
    dtype, ``ranks`` ``[q]`` -> ``[q, d]``."""
    return _gather("gather_hot", hot_buf, ranks)


def hot_gather(table: torch.Tensor, hot_buf: torch.Tensor,
               hot_rank: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Two-tier gather in one launch: ``r = hot_rank[ids[i]]``, then
    ``out[i] = hot_buf[r]`` where ``r >= 0``, else ``table[ids[i]]``.
    ``table`` ``[n, d]`` and ``hot_buf`` ``[h, d]`` of one dtype,
    ``hot_rank`` ``[nr]`` integers (``nr`` need not be ``n``), ``ids``
    ``[q]`` -> ``[q, d]``.  Each index resolves against its own array."""
    table = _rows(table, "table")
    hot_buf = _rows(hot_buf, "hot buffer")
    if hot_buf.dtype != table.dtype or hot_buf.shape[1] != table.shape[1] \
            or hot_buf.device != table.device:
        raise ValueError(f"hot buffer {tuple(hot_buf.shape)} "
                         f"{hot_buf.dtype} on {hot_buf.device} does not "
                         f"match table {tuple(table.shape)} {table.dtype} "
                         f"on {table.device}")
    ids = _ids(ids, table)
    hot_rank = _ids(hot_rank, table, "hot_rank").to(torch.int32)
    if ids.shape[0] and min(table.shape[0], hot_buf.shape[0],
                            hot_rank.shape[0]) == 0:
        raise ValueError("two-tier gather with an empty table, hot buffer "
                         "or hot_rank")
    if table.device.type == "cpu":
        return hot_gather_ref(table, hot_buf, hot_rank, ids)
    return _launch("hot_gather", ids, table.shape[1], table.dtype,
                   table=table, hot=hot_buf, hot_rank=hot_rank)
