"""Mixture-of-Experts with sort-based dispatch (the twin of
``repro.models.moe``, meshless).

Tokens are sorted by expert id within each group (a batch row),
scattered into a capacity-bounded ``[E, C, d]`` buffer, run through a
batched expert matmul, and combined back by a gather and a weighted
add.  Top-k routing with normalized gates, token dropping at capacity,
and arctic's dense-residual parallel MLP.

Where torch differs from jnp, the reference's semantics are kept: the
top-k takes the lower expert id first on tied gates (a stable
descending sort, as ``jax.lax.top_k`` orders them), the expert sort is
stable, and the overflow entries that the reference scatters out of
range (``mode="drop"``) go to one spare row that the buffer drops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(s: int, cfg) -> int:
    cap = int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return max(cap, cfg.top_k)


def dispatch(eg, n_experts: int, cap: int):
    """The groups' dispatch plans.  ``eg`` ``[..., s, k]`` expert ids,
    one group per leading index -> ``(order, stok, slot, keep)``, each
    ``[..., s * k]``, over each group's entries sorted by expert
    (stably): the sort permutation, each entry's token, its row in the
    group's ``[E * cap]`` buffer and whether it fits under the capacity
    (``slot == E * cap`` where it does not)."""
    s, k = eg.shape[-2:]
    dev = eg.device
    flat_e = eg.reshape(*eg.shape[:-2], s * k)
    flat_t = torch.arange(s, device=dev).repeat_interleave(k).expand_as(
        flat_e)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    stok = torch.gather(flat_t, -1, order)
    experts = torch.arange(n_experts, device=dev, dtype=se.dtype)
    start = torch.searchsorted(
        se, experts.expand(*se.shape[:-1], n_experts).contiguous())
    rank = torch.arange(s * k, device=dev) - torch.gather(start, -1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(se, n_experts * cap))
    return order, stok, slot, keep


def moe_block(x, p, cfg, compute_dtype):
    """x: [B, S, d].  p: the layer's router/w_gate/w_up/w_down
    (expert-stacked) and, for arctic, res_gate/res_up/res_down.
    Returns [B, S, d].  Each batch row is a group with its own capacity,
    as in the reference's ``vmap``; the groups' buffers go through each
    expert's weights in one batched product."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(s, cfg)
    cdt = compute_dtype
    dev = x.device

    logits = x @ p["router"].to(cdt)
    gates = torch.softmax(logits.float(), dim=-1)
    top_g, top_e = top_k(gates, k)                           # [b, s, k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    top_g = top_g.to(cdt)

    order, stok, slot, keep = dispatch(top_e, e, cap)       # [b, s*k]
    sg = torch.gather(top_g.reshape(b, s * k), 1, order)
    group = torch.arange(b, device=dev)[:, None]
    # dispatch: the kept entries' tokens to their rows of the groups'
    # [b * e * cap] buffer; dropped ones to one spare row past its end
    rows = torch.where(keep, group * (e * cap) + slot,
                       torch.full_like(slot, b * e * cap))
    buf = torch.zeros((b * e * cap + 1, d), dtype=cdt, device=dev)
    buf.index_copy_(0, rows.reshape(-1),
                    x[group, stok].reshape(b * s * k, d))
    buf = buf[:-1].reshape(b, e, cap, d).transpose(0, 1).reshape(
        e, b * cap, d)
    w_gate, w_up, w_down = (p[n].to(cdt) for n in ("w_gate", "w_up",
                                                   "w_down"))
    h = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    y = torch.bmm(F.silu(h) * u, w_down)                    # [e, b*cap, d]
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    # combine: gather back, weighted
    contrib = torch.where(
        keep[..., None], y[group, torch.clamp(slot, max=e * cap - 1)],
        torch.zeros((), dtype=cdt, device=dev))
    out = torch.zeros((b * s, d), dtype=cdt, device=dev)
    out.index_add_(0, (group * s + stok).reshape(-1),
                   (contrib * sg[..., None]).reshape(b * s * k, d))
    y = out.reshape(b, s, d)

    if cfg.dense_residual_ff:
        h = x @ p["res_gate"].to(cdt)
        u = x @ p["res_up"].to(cdt)
        y = y + (F.silu(h) * u) @ p["res_down"].to(cdt)
    return y
