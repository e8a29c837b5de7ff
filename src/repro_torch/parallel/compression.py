"""Error-feedback gradient compression: the twin of
``repro.parallel.compression``.

Two modes, both with error feedback (the compression residual is
carried to the next step):

  * int8: per-tensor symmetric quantization (4x fewer all-reduce
    bytes); ``torch.round`` rounds half to even, as ``jnp.round`` does;
  * topk: keep the top 1% magnitudes per tensor (lowered densely).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.tree import tree_map


def _int8_codes(g: torch.Tensor):
    """(int8 codes, float32 scale) of one leaf."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress_leaf_int8(g):
    q, scale = _int8_codes(g)
    return q.float() * scale


def _compress_leaf_topk(g, frac: float = 0.01):
    flat = g.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    # only the k-th largest magnitude matters, so ties do not
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


@torch.no_grad()
def compress_decompress(grads, error_fb: Optional[dict], mode: str = "int8"):
    """Returns (decompressed grads, new error feedback)."""
    if mode not in ("int8", "topk"):
        raise ValueError(mode)
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    squeeze = _compress_leaf_int8 if mode == "int8" else _compress_leaf_topk

    def one(g, e):
        corrected = g.float() + e
        approx = squeeze(corrected)
        return approx, corrected - approx

    out = tree_map(one, grads, error_fb)
    return (tree_map(lambda g, o: o[0], grads, out),
            tree_map(lambda g, o: o[1], grads, out))
