"""Error-feedback gradient compression: the twin of
``repro.parallel.compression``.

Two modes, both with error feedback (the compression residual is
carried to the next step):

  * int8: per-tensor symmetric quantization (4x fewer all-reduce
    bytes); ``torch.round`` rounds half to even, as ``jnp.round`` does;
  * topk: keep the top 1% magnitudes per tensor (lowered densely).

On a ``sharding.LaidOutTree`` of gradients each leaf is this rank's
block and the error feedback is laid out alike; the int8 scale is the
whole tensor's (the blocks' maxima, ``pmax`` over the axes the leaf is
split over) and so is the top-k threshold (the k-th largest magnitude
of the whole tensor, k from its global size, the blocks' magnitudes
gathered over those axes).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.parallel import collectives as cl
from repro_torch.parallel import sharding as shd


def _int8_codes(g: torch.Tensor, mesh=None, axes: Sequence[str] = ()):
    """(int8 codes, float32 scale) of one leaf (of its block split over
    ``axes`` of ``mesh``: the scale from the whole tensor's max)."""
    top = g.abs().max()
    for a in axes:
        top = cl.pmax(top, mesh, a)
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress_leaf_int8(g, mesh=None, axes: Sequence[str] = ()):
    q, scale = _int8_codes(g, mesh, axes)
    return q.float() * scale


def _compress_leaf_topk(g, mesh=None, axes: Sequence[str] = (),
                        frac: float = 0.01):
    mag = g.abs().reshape(-1)
    for a in axes:            # the whole tensor's magnitudes, any order
        mag = cl.all_gather(mag, mesh, a).reshape(-1)
    k = max(int(mag.shape[0] * frac), 1)
    # only the k-th largest magnitude matters, so ties do not
    thresh = torch.topk(mag, k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


@torch.no_grad()
def compress_decompress(grads, error_fb: Optional[dict], mode: str = "int8"):
    """Returns (decompressed grads, new error feedback), both in the
    layout of ``grads``."""
    if mode not in ("int8", "topk"):
        raise ValueError(mode)
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    squeeze = _compress_leaf_int8 if mode == "int8" else _compress_leaf_topk
    mesh = shd.tree_mesh(grads)
    flat = leaves(grads)
    splits = ([tuple(a for a in shd.spec_axes(s) if mesh.shape[a] > 1)
               for s in shd.spec_leaves(grads.specs)]
              if mesh is not None else [()] * len(flat))
    approx, resid = [], []
    for g, e, axes in zip(flat, leaves(error_fb), splits):
        corrected = g.float() + e
        a = squeeze(corrected, mesh, axes)
        approx.append(a)
        resid.append(corrected - a)
    return unflatten(grads, approx), unflatten(grads, resid)
