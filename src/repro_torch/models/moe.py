"""Mixture-of-Experts with sort-based dispatch (the twin of
``repro.models.moe``).

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
On a laid-out tree the experts are split over the ``expert`` axes
(:func:`moe_block`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ly
from repro_torch.parallel import sharding as shd


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


class Plan(NamedTuple):
    """The routing of one MoE layer: each token's ``top_e`` experts
    ``[b, s, k]``, the capacity ``cap`` of an expert in a group, and the
    groups' dispatch plans (:func:`dispatch`) with each entry's gate
    ``gate`` ``[b, s * k]`` in the sorted order."""
    top_e: torch.Tensor
    cap: int
    stok: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor


def route(x, p, cfg, compute_dtype) -> Plan:
    """The routing of ``x`` ``[B, S, d]`` by the layer's ``router``:
    top-k of the softmax gates (normalized), and the dispatch plan of
    each batch row.  On a laid-out tree every rank computes the whole
    plan from the replicated router."""
    b, s, _ = x.shape
    k = cfg.top_k
    router = p["router"]
    specs = getattr(p, "specs", None)
    if specs is not None and specs["router"]:
        router = shd.relayout(router, specs["router"], ())
    logits = x @ router.to(compute_dtype)
    gates = torch.softmax(logits.float(), dim=-1)
    top_g, top_e = top_k(gates, k)                           # [b, s, k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    top_g = top_g.to(compute_dtype)
    cap = capacity(s, cfg)
    order, stok, slot, keep = dispatch(top_e, cfg.n_experts, cap)
    gate = torch.gather(top_g.reshape(b, s * k), 1, order)
    return Plan(top_e, cap, stok, slot, keep, gate)


def _experts(p, cdt):
    """This rank's expert weights ``(w_gate, w_up, w_down)``, their
    ``fsdp`` dimension gathered (in ``cdt``), and the mesh axes their expert
    dimension and their ``ff`` dimension stay split over (``()``
    meshless)."""
    names = ("w_gate", "w_up", "w_down")
    specs = getattr(p, "specs", None)
    if specs is None:
        return tuple(p[n] for n in names), (), ()
    sd = specs["w_down"]
    e_axes = ly.compute_axes(p["w_down"], sd, ("expert", "mlp", None), 0)
    f_axes = ly.compute_axes(p["w_down"], sd, ("expert", "mlp", None), 1)
    w = (shd.gather_param(p["w_gate"].to(cdt), "expert", "fsdp", "mlp",
                          spec=specs["w_gate"]),
         shd.gather_param(p["w_up"].to(cdt), "expert", "fsdp", "mlp",
                          spec=specs["w_up"]),
         shd.gather_param(p["w_down"].to(cdt), "expert", "mlp", "fsdp",
                          spec=sd))
    return w, e_axes, f_axes


def moe_block(x, p, cfg, compute_dtype, seq=None):
    """x: [B, S, d].  p: the layer's router/w_gate/w_up/w_down
    (expert-stacked) and, for arctic, res_gate/res_up/res_down.
    Returns [B, S, d].  Each batch row is a group with its own capacity,
    as in the reference's ``vmap``; the groups' buffers go through each
    expert's weights in one batched product.

    On one layer's blocks of a laid-out tree (``layers.Blocks``) every
    rank computes the whole plan (:func:`route`), fills only its
    experts' rows of the ``[E, cap, d]`` buffers, runs its experts (over
    its ``ff`` block where the expert axis did not divide and ``mlp``
    took the axis), and combines its kept entries; one sum over the
    expert and ``ff`` axes ends the block.  The capacity and the drops
    are the global function's, since the plan is.  With ``seq`` (a
    ``sharding.SeqBlock``; ``x`` the whole sequence, as the routing
    needs) the output is this rank's block of the sequence: the sum
    over the expert axes a reduce-scatter where they are ``seq``'s
    (``layers.reduce_to_seq``)."""
    b, s, d = x.shape
    cdt = compute_dtype
    dev = x.device
    plan = route(x, p, cfg, cdt)
    cap, stok, slot, keep = plan.cap, plan.stok, plan.slot, plan.keep
    (w_gate, w_up, w_down), e_axes, f_axes = _experts(p, cdt)
    e = w_gate.shape[0]                       # this rank's experts
    lo = (shd.block_index(e_axes, shd.active_mesh()) * e * cap
          if e_axes else 0)
    local = slot - lo
    mine = keep & (local >= 0) & (local < e * cap)
    group = torch.arange(b, device=dev)[:, None]
    # dispatch: the kept entries' tokens to their rows of the groups'
    # [b * e * cap] buffer; the others to one spare row past its end
    rows = torch.where(mine, group * (e * cap) + local,
                       torch.full_like(slot, b * e * cap))
    buf = torch.zeros((b * e * cap + 1, d), dtype=cdt, device=dev)
    buf.index_copy_(0, rows.reshape(-1),
                    x[group, stok].reshape(b * s * cfg.top_k, d))
    buf = buf[:-1].reshape(b, e, cap, d).transpose(0, 1).reshape(
        e, b * cap, d)
    h = torch.bmm(buf, w_gate.to(cdt))
    u = torch.bmm(buf, w_up.to(cdt))
    # the partial sums (over the ff block, or over the experts in the
    # combine) stay in float32 until the sum over the ranks, which
    # rounds once, as the meshless sums do
    split = e_axes + f_axes
    acc = torch.float32 if split else cdt
    if f_axes:
        y = torch.bmm((F.silu(h) * u).to(acc), w_down.to(acc))
    else:
        y = torch.bmm(F.silu(h) * u, w_down.to(cdt))         # [e, b*cap, d]
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    # combine: gather back, weighted
    contrib = torch.where(
        mine[..., None], y[group, torch.clamp(local, 0, e * cap - 1)],
        torch.zeros((), dtype=y.dtype, device=dev))
    out = torch.zeros((b * s, d), dtype=acc, device=dev)
    out.index_add_(0, (group * s + stok).reshape(-1),
                   (contrib * plan.gate[..., None]).reshape(
                       b * s * cfg.top_k, d).to(acc))
    y = out.reshape(b, s, d)
    if split or seq is not None:
        y = ly.reduce_to_seq(y, split, seq).to(cdt)

    if cfg.dense_residual_ff:
        specs = getattr(p, "specs", None)
        y = y + ly.swiglu(x, p["res_gate"], p["res_up"], p["res_down"], cdt,
                          None if specs is None else tuple(
                              specs[n] for n in ("res_gate", "res_up",
                                                 "res_down")), seq)
    return y
