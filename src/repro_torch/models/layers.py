"""Shared layers and the parameter builder (the twin of
``repro.models.layers``, meshless).

``ParamBuilder`` declares every parameter exactly once, with its shape
and init, and draws it from an explicit ``torch.Generator`` on an
explicit device.  Its draws cannot match ``jax.random``'s, so the
parity tests start both packages from the JAX parameters, converted
array by array (``core.convert.params_from_numpy``).  The logical-axis
annotations of the reference are mesh-only and arrive with the
models' mesh placement (ROADMAP queue A, A12b).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

INITS = ("normal", "zeros", "ones", "ssm_a")


class ParamBuilder:
    def __init__(self, generator: torch.Generator, device,
                 param_dtype=torch.float32):
        self.gen = generator
        self.device = torch.device(device)
        self.param_dtype = param_dtype

    def add(self, tree: Dict, name: str, shape: Sequence[int],
            init: str = "normal", scale: Optional[float] = None):
        """``normal``: N(0, 1) times ``scale``, or 1/sqrt(fan_in) with
        fan_in the leading dimension; ``ones``; ``zeros``; ``ssm_a``:
        -exp(U(0, 1.5)), the negative SSM decay."""
        shape = tuple(int(s) for s in shape)
        kw = dict(dtype=self.param_dtype, device=self.device)
        if init == "zeros":
            t = torch.zeros(shape, **kw)
        elif init == "ones":
            t = torch.ones(shape, **kw)
        elif init == "ssm_a":
            t = torch.rand(shape, generator=self.gen, **kw).mul_(1.5)
            t = t.exp_().neg_()
        elif init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            t = torch.randn(shape, generator=self.gen, **kw).mul_(s)
        else:
            raise ValueError(f"unknown init {init!r} (choose from {INITS})")
        tree[name] = t
        return t


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float):
    """float32 statistics; the output in ``x``'s dtype, scaled by
    ``gamma`` cast to it."""
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return y.to(dt) * gamma.to(dt)


def rope(q, positions, theta: float):
    """Rotary embedding over the last dim of ``q`` ``[b, s, h, d]``;
    ``positions`` ``[b or 1, s]``."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs   # [.., s, half]
    # cos and sin rounded from float64, as jnp's (torch's float32 ones
    # are off by an ulp more often)
    cos = torch.cos(ang.double()).float()[:, :, None, :]
    sin = torch.sin(ang.double()).float()[:, :, None, :]
    q1, q2 = q[..., :half], q[..., half:]
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return out.to(q.dtype)


def swiglu(x, w_gate, w_up, w_down, compute_dtype):
    h = x @ w_gate.to(compute_dtype)
    u = x @ w_up.to(compute_dtype)
    return (F.silu(h) * u) @ w_down.to(compute_dtype)
