"""Shared layers and the parameter builder (the twin of
``repro.models.layers``).

``ParamBuilder`` declares every parameter exactly once, with its shape,
its logical sharding axes and its init, and draws it from an explicit
``torch.Generator`` on an explicit device (on ``"meta"``: shapes only,
no memory and no draw, the twin of the reference's ``abstract=True``).
Its draws cannot match ``jax.random``'s, so the parity tests start both
packages from the JAX parameters, converted array by array
(``core.convert.params_from_numpy``).  :func:`split_axes` separates the
axes from the parameters and :func:`axes_to_specs` resolves them on a
mesh (``parallel.sharding``).  On a laid-out tree the layers compute
from this rank's blocks (:func:`swiglu`: column-parallel gate and up,
row-parallel down, whose partial sums meet in one sum:
:func:`row_parallel`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as cl
from repro_torch.parallel import sharding as shd

INITS = ("normal", "zeros", "ones", "ssm_a")


class ParamBuilder:
    def __init__(self, generator: Optional[torch.Generator], device,
                 param_dtype=torch.float32):
        self.gen = generator
        self.device = torch.device(device)
        self.param_dtype = param_dtype

    def add(self, tree: Dict, name: str, shape: Sequence[int],
            axes: Sequence[Optional[str]], init: str = "normal",
            scale: Optional[float] = None):
        """Declare ``tree[name]``: its logical ``axes`` (one name a
        dimension, recorded in ``tree["__axes__"]``) and its init.
        ``normal``: N(0, 1) times ``scale``, or 1/sqrt(fan_in) with
        fan_in the leading dimension; ``ones``; ``zeros``; ``ssm_a``:
        -exp(U(0, 1.5)), the negative SSM decay.  On the meta device
        only the shape is made."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} has {len(shape)} "
                             f"dimensions, axes {tuple(axes)} name "
                             f"{len(axes)}")
        if init not in INITS:
            raise ValueError(f"unknown init {init!r} (choose from {INITS})")
        kw = dict(dtype=self.param_dtype, device=self.device)
        if self.device.type == "meta":
            t = torch.empty(shape, **kw)
        elif init == "zeros":
            t = torch.zeros(shape, **kw)
        elif init == "ones":
            t = torch.ones(shape, **kw)
        elif init == "ssm_a":
            t = torch.rand(shape, generator=self.gen, **kw).mul_(1.5)
            t = t.exp_().neg_()
        else:
            fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            t = torch.randn(shape, generator=self.gen, **kw).mul_(s)
        tree[name] = t
        tree.setdefault("__axes__", {})[name] = tuple(axes)
        return t


def split_axes(tree):
    """Separate a builder's tree into ``(params, axes)``: the parameter
    tree, and the same tree of logical-axis tuples."""
    if isinstance(tree, dict):
        params, axes = {}, {}
        for k, v in tree.items():
            if k == "__axes__":
                continue
            if isinstance(v, dict):
                params[k], axes[k] = split_axes(v)
            else:
                params[k] = v
                axes[k] = tree.get("__axes__", {}).get(k)
        return params, axes
    return tree, None


def axes_to_specs(params, axes, mesh, rules):
    """The spec tree matching ``params``, resolved against ``(mesh,
    rules)`` (``sharding.resolve_spec``; a leaf without axes is
    replicated)."""
    if isinstance(params, dict):
        return {k: axes_to_specs(params[k], axes[k], mesh, rules)
                for k in params}
    if axes is None:
        return ()
    return shd.resolve_spec(params.shape, axes, mesh, rules)


class Blocks(dict):
    """One layer's weights of a laid-out tree: this rank's blocks, with
    their specs (``specs``, the stacked specs without the layer axis,
    which is never split).  The blocks compute on the active mesh."""

    def __init__(self, blocks: dict, specs: dict):
        super().__init__(blocks)
        self.specs = specs


def split_over(spec, dim: int) -> Tuple[str, ...]:
    """The mesh axes dimension ``dim`` of ``spec`` is split over."""
    return shd.entry_axes(spec[dim]) if dim < len(spec) else ()


def compute_axes(w, spec, names, dim: int) -> Tuple[str, ...]:
    """The mesh axes dimension ``dim`` of the block ``w`` (stored by
    ``spec``) stays split over once :func:`~repro_torch.parallel.
    sharding.gather_param` has gathered its ``fsdp`` dimension:
    ``names`` are its logical axes with ``fsdp`` left out (``None``)."""
    mesh = shd.active_mesh()
    shape = shd.global_shape(w.shape, spec, mesh)
    return split_over(shd.resolve_spec(shape, names), dim)


def gather_last(x, axes, mesh=None):
    """The columns of ``x`` split over ``axes`` (of the active mesh when
    ``mesh`` is omitted) gathered whole: one all-gather an axis."""
    return shd.gather_dim(x, axes, -1, mesh)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float, axes: Tuple[str, ...] = (),
             width: int = 0):
    """float32 statistics; the output in ``x``'s dtype, scaled by
    ``gamma`` cast to it.  With ``axes``, ``x`` is this rank's block of
    columns of a row ``width`` wide, split over those axes of the
    active mesh (and ``gamma`` the same block): the sum of squares is
    summed over them, in float32, before the mean."""
    dt = x.dtype
    x32 = x.float()
    if axes:
        ss = psum_axes((x32 * x32).sum(dim=-1, keepdim=True), axes)
        ms = ss / width
    else:
        ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
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


def swiglu(x, w_gate, w_up, w_down, compute_dtype, specs=None, seq=None):
    """The gated MLP.  With ``specs`` (the three weights' specs: this
    rank's blocks of a laid-out tree) the ``fsdp`` dimensions are
    gathered first (``gather_param``, in ``compute_dtype``, as the
    reference casts before its gather), ``w_gate``/``w_up`` are
    column-parallel over ``mlp`` and ``w_down`` row-parallel, and the
    row blocks' partial sums meet in one sum over the mesh, where the
    reference constrains the output to ``("batch", "cp_seq",
    "embed")``.  With ``seq`` (``x`` the whole sequence) the output is
    this rank's block ``seq`` of it (:func:`row_parallel`)."""
    if specs is not None:
        sg, su, sd = specs
        rows = compute_axes(w_down, sd, ("mlp", None), 0)
        w_gate = shd.gather_param(w_gate.to(compute_dtype), "fsdp", "mlp",
                                  spec=sg)
        w_up = shd.gather_param(w_up.to(compute_dtype), "fsdp", "mlp",
                                spec=su)
        w_down = shd.gather_param(w_down.to(compute_dtype), "mlp", "fsdp",
                                  spec=sd)
    h = x @ w_gate.to(compute_dtype)
    u = x @ w_up.to(compute_dtype)
    return row_parallel(F.silu(h) * u, w_down, compute_dtype,
                        rows if specs is not None else (), seq)


def row_parallel(x, w, compute_dtype, axes=(), seq=None):
    """``x @ w`` where ``w`` is this rank's block of rows (and ``x`` its
    columns) split over the mesh ``axes``: the partial products summed
    over them.  A 16-bit product is taken in float32 and rounded once,
    after the sum, as the whole product rounds once after its float32
    accumulation; without ``axes``, ``x @ w`` in ``compute_dtype``.

    With ``seq`` (a ``sharding.SeqBlock`` of dimension 1, ``x`` the
    whole sequence) the result is this rank's block of the sequence:
    where ``axes`` are ``seq``'s, the sum is a reduce-scatter
    (Megatron-SP's block exit, in place of the reference's
    ``psum``); where they share no axis the block is taken before the
    product; otherwise the sum is taken whole and then cut."""
    if seq is not None and seq.axes and not set(seq.axes) & set(axes):
        x, seq = shd.seq_take(x, seq), None
    if not axes:
        return x @ w.to(compute_dtype)
    half = compute_dtype in (torch.bfloat16, torch.float16)
    y = x.float() @ w.float() if half else x @ w.to(compute_dtype)
    return reduce_to_seq(y, axes, seq).to(compute_dtype)


def reduce_to_seq(y, axes, seq=None):
    """The partial sums ``y`` ``[B, S, ...]`` summed over the mesh
    ``axes``, as this rank's block ``seq`` of the sequence (whole
    without it): a reduce-scatter where ``axes`` are ``seq``'s; the
    block first, then the sum, where they share no axis; else the sum,
    then the block."""
    s_axes = tuple(seq.axes) if seq is not None else ()
    if s_axes and tuple(axes) == s_axes:
        return scatter_axes(y, axes, dim=1)
    if s_axes and not set(s_axes) & set(axes):
        return psum_axes(shd.seq_take(y, seq), axes)
    y = psum_axes(y, axes)
    return shd.seq_take(y, seq) if s_axes else y


def scatter_axes(x, axes, dim: int, mesh=None):
    """The sum of the partial ``x`` over the mesh ``axes``, this rank's
    block of it along ``dim`` (blocks numbered as ``sharding`` numbers
    them: the last axis fastest), in float32 for a 16-bit ``x``,
    rounded once."""
    mesh = mesh if mesh is not None else shd.active_mesh()
    dt = x.dtype
    x = x.float() if dt in (torch.bfloat16, torch.float16) else x
    for a in axes:
        x = cl.reduce_scatter(x, mesh, axis=a, dim=dim)
    return x.to(dt)


def psum_axes(x, axes, mesh=None):
    """The sum of the partial ``x`` over the mesh ``axes`` (of the
    active mesh when ``mesh`` is omitted), in float32 for a 16-bit
    ``x``, rounded once."""
    mesh = mesh if mesh is not None else shd.active_mesh()
    for a in axes:
        x = cl.psum(x, mesh, axis=a)
    return x
