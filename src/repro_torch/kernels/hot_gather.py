"""Splay-tiered embedding gather: the twin of ``repro.kernels.hot_gather``.

The splay heights stratify the vocabulary by access frequency (height
>= h*  <=>  freq >= m/2^(k-h*)), which gives a calibrated hot set.  An
embedding lookup becomes two row gathers with different residency:

* :func:`gather_hot` (B3) over the hot buffer, small enough to stay in
  the card's L2 (the TPU kernel holds it in VMEM);
* :func:`gather_rows` (B4) over the full table, one row streamed from
  device memory per id.

``ops.hot_gather`` composes them.  Both are one dtype-blind CUDA kernel
(``csrc/hot_gather.cu``) under two entry points; their plain PyTorch
version is the oracle ``ref.gather_rows_ref`` (resolve each id, copy
its row).  CUDA tensors launch the kernel, CPU tensors run the plain
version.  Ids resolve as the reference's gathers resolve them: a
negative id wraps once, anything still out of range clamps.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_rows_ref

# launches of the CUDA kernels (plain CPU runs do not count)
LAUNCHES = {"gather_hot": 0, "gather_rows": 0}


def _operands(src, ids):
    if src.dim() != 2:
        raise ValueError(f"gather source must be [n, d], got "
                         f"{tuple(src.shape)}")
    if ids.dim() != 1:
        raise ValueError(f"ids must be [q], got {tuple(ids.shape)}")
    if ids.device != src.device:
        raise ValueError(f"ids on {ids.device}, rows on {src.device}")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise ValueError(f"ids must be integers, got {ids.dtype}")
    if src.shape[0] == 0 and ids.shape[0]:
        raise ValueError("gather from an empty source")
    return src.contiguous(), ids.to(torch.int32).contiguous()


def _gather(entry: str, src: torch.Tensor, ids: torch.Tensor):
    src, ids = _operands(src, ids)
    if src.device.type == "cpu":
        return gather_rows_ref(src, ids)
    n, d = src.shape
    q = ids.shape[0]
    out = torch.empty((q, d), dtype=src.dtype, device=src.device)
    if q == 0 or d == 0:
        return out
    lib = build.load("hot_gather")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(build.ptr(src), build.ptr(ids), n, q, d * src.element_size(),
              build.ptr(out), build.stream_of(src))
    build.check(lib, code, f"{entry} launch")
    LAUNCHES[entry] += 1
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """B4: ``out[i] = table[ids[i]]``, ``table`` ``[n, d]`` of any dtype,
    ``ids`` ``[q]`` -> ``[q, d]``."""
    return _gather("gather_rows", table, ids)


def gather_hot(hot_buf: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """B3: ``out[i] = hot_buf[ranks[i]]``, ``hot_buf`` ``[h, d]`` of any
    dtype, ``ranks`` ``[q]`` -> ``[q, d]``."""
    return _gather("gather_hot", hot_buf, ranks)
