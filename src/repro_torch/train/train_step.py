"""Training step: loss, gradients, optimizer, microbatching and the
compression hook (the twin of ``repro.train.train_step``), meshless or
on a mesh.

``make_train_step(cfg)`` returns the eager step that
``launch/train.py`` runs.  Gradients come from ``torch.autograd.grad``
over the parameter leaves; microbatches are a Python loop that
accumulates float32 gradients in order, as the reference's scan does.
The dry-run's inputs of a cell are :func:`input_specs` (meta tensors:
shapes only) and their logical axes :func:`batch_axes`.

**On a mesh** (a ``sharding.LaidOutTree``; the step the reference's
dry-run lowers with parameter, AdamW-state and batch shardings) every
rank of the mesh calls the step with its rows of the batch (its block
over the ``batch`` axes, every position) and gets its blocks of the
new parameters and moments.  The collectives are differentiable, each
backward the transpose of its forward (``parallel.collectives``):

* :func:`loss_fn` runs on this rank's block of the logits: the row max
  by ``pmax`` over the vocab axes (held constant), the rank's
  ``sumexp`` and gold logit (0 for a label outside its vocab block)
  summed over them, and the nll sum and the mask count summed over the
  other axes of the mesh (a sum over an axis whose ranks hold the same
  rows scales both alike), so every rank holds the global loss;
* each rank seeds its loss's cotangent with ``1/N`` (``N`` ranks):
  its backward pass gives each block its share of the gradient, and
  :func:`sum_partials` sums each leaf's shares over the mesh axes its
  spec does not split (the data-parallel all-reduce; the fsdp
  gathers' transposes have already reduce-scattered over ``data``),
  so a replicated leaf's gradient is the same on every rank;
* microbatch i is the global rows ``[i B / M, (i + 1) B / M)``
  whatever the layout, as in the reference: the rows are gathered over
  the batch axes once at the step's start and each rank takes its
  block of each microbatch;
* AdamW (``train.optimizer``) and the compression
  (``parallel.compression``) work on the blocks, their norms, scales
  and thresholds those of the whole tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import layers as ly
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import collectives as cl
from repro_torch.parallel import compression as comp
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Next-token cross-entropy over ``forward``'s logits, with the
    reference's numerics: the row max held constant (its
    ``stop_gradient``), ``exp`` and the log-sum in float32, the gold
    logit taken exactly (the reference's one-hot product with float32
    accumulation) and the last position, whose label is -1, masked.
    The labels are shifted on the whole sequence, then cut to the
    logits' block of positions.  On a laid-out tree this rank's block
    of the logits, every rank's result the global loss (module
    docstring)."""
    logits = zoo.forward(params, cfg, batch["tokens"],
                         frontend=batch.get("frontend"))      # [b,s,v]
    lab = batch["labels"]
    labels = torch.cat([lab[:, 1:], torch.full_like(lab[:, :1], -1)],
                       dim=1)                                  # shift left
    mesh = shd.tree_mesh(params)
    v_axes = zoo.vocab_axes(params, cfg)
    if mesh is not None:
        labels = shd.seq_take(labels, zoo.logits_layout(
            (lab.shape[0], lab.shape[1], cfg.vocab_padded), mesh,
            params.rules))
    lmax = logits.max(dim=-1).values.detach()
    for a in v_axes:
        lmax = cl.pmax(lmax, mesh, a)
    shifted = logits - lmax[..., None]
    sumexp = ly.psum_axes(torch.exp(shifted.float()).sum(dim=-1), v_axes,
                          mesh)
    logz = torch.log(sumexp) + lmax.float()
    if v_axes:
        n = logits.shape[-1]
        local = labels.long() - shd.block_index(v_axes, mesh) * n
        mine = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        gold = torch.where(mine, gold[..., 0].float(), 0.0)
        gold = ly.psum_axes(gold, v_axes, mesh)
    else:
        # a label of -1 would index out of range: read row 0, masked below
        idx = labels.clamp(min=0).long()[..., None]
        gold = torch.gather(logits, -1, idx)[..., 0].float()
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    if mesh is None:
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    tot = torch.stack([nll.sum(), mask.sum()])
    tot = ly.psum_axes(tot, [a for a, n in mesh.shape.items()
                             if n > 1 and a not in v_axes], mesh)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def _partial_grads(params, cfg, batch):
    """(loss, grads) of every leaf, zeros for a leaf the loss does not
    reach (as JAX gives).  On a laid-out tree the loss's cotangent is
    seeded with ``1/N`` and the gradients are this rank's shares
    (:func:`sum_partials` sums them)."""
    mesh = shd.tree_mesh(params)
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, cfg, batch)
        flat = leaves(live)
        seed = (None if mesh is None else
                torch.full_like(loss, 1 / math.prod(mesh.shape.values())))
        gs = torch.autograd.grad(loss, flat, grad_outputs=seed,
                                 allow_unused=True)
    return loss.detach(), unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)])


@torch.no_grad()
def sum_partials(grads):
    """Each leaf's shares summed over the mesh axes (of more than one
    rank) its spec does not split (``sharding.psum_grouped``): the
    gradient of the rank's block.  A global tree's gradients are
    returned as they are."""
    mesh = shd.tree_mesh(grads)
    if mesh is None:
        return grads
    out = shd.psum_grouped(leaves(grads), [
        tuple(a for a, n in mesh.shape.items()
              if n > 1 and a not in shd.spec_axes(spec))
        for spec in shd.spec_leaves(grads.specs)], mesh)
    return unflatten(grads, out)


def _grads_of(params, cfg, batch):
    """(loss, grads): the gradient of every leaf (of this rank's block
    on a laid-out tree)."""
    loss, grads = _partial_grads(params, cfg, batch)
    return loss, sum_partials(grads)


def _row_axes(params):
    """The mesh axes a rank's rows of the batch are a block over: the
    ``batch`` rule's axes of more than one rank, less those the
    ``seq`` rule takes (a sequence shares an axis with the batch only
    where the batch is not split over it, ``model_zoo``)."""
    mesh, rules = params.mesh, params.rules
    seq = set(rules.get("seq") or ())
    return tuple(a for a in (rules.get("batch") or ())
                 if mesh.shape.get(a, 1) > 1 and a not in seq)


def _microbatches(params, batch, microbatch: int) -> list:
    """The ``microbatch`` parts of the global batch in the reference's
    composition (part i the global rows ``[i B / M, (i + 1) B / M)``);
    on a laid-out tree this rank's block of each part, from the rows
    gathered over the batch axes once."""
    mesh = shd.tree_mesh(params)
    axes = _row_axes(params) if mesh is not None else ()
    if axes:
        batch = {k: shd.gather_dim(v, axes, 0, mesh)
                 for k, v in batch.items()}
    b = batch["tokens"].shape[0]
    if b % microbatch:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{microbatch} microbatches")
    size = b // microbatch
    parts = []
    for i in range(microbatch):
        part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        if axes:
            rows = shd.block_slices((size,), (axes,), mesh)[0]
            part = {k: v[rows] for k, v in part.items()}
        parts.append(part)
    return parts


def _value_and_grad(params, cfg, batch, microbatch: int = 1):
    """(loss, grads) of the step: over ``microbatch`` parts of the batch
    (:func:`_microbatches`), the mean of the parts' losses and of their
    float32 gradients accumulated in order, as the reference's scan."""
    if microbatch == 1:
        return _grads_of(params, cfg, batch)
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for mb in _microbatches(params, batch, microbatch):
        l_i, g_i = _partial_grads(params, cfg, mb)
        loss = loss + l_i
        grads = tree_map(torch.add, grads, g_i)
    return (loss / microbatch,
            tree_map(lambda g: g / microbatch, sum_partials(grads)))


def make_train_step(cfg: ModelConfig, microbatch: int = 1,
                    compress: Optional[str] = None, lr: float = 3e-4):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); with ``compress`` it takes and returns the error feedback
    too.  microbatch > 1 splits the global batch and accumulates grads.
    compress: None | 'int8' | 'topk', error-feedback compression of the
    accumulated grads before the optimizer.  ``metrics`` holds ``loss``
    and ``grad_norm`` (of the grads after compression).  On a laid-out
    tree every rank of its mesh calls the step with its rows of the
    batch, the state :func:`optimizer.init` laid out from the tree and
    its blocks of the error feedback (module docstring)."""

    def step(params, opt_state, batch, error_fb=None):
        loss, grads = _value_and_grad(params, cfg, batch, microbatch)
        if compress is not None:
            grads, error_fb = comp.compress_decompress(
                grads, error_fb, mode=compress)

        new_params, new_opt = opt.update(grads, opt_state, params, lr=lr)
        with torch.no_grad():
            metrics = {"loss": loss, "grad_norm": opt.global_norm(grads)}
        if compress is not None:
            return new_params, new_opt, metrics, error_fb
        return new_params, new_opt, metrics

    return step


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str = "train"):
    """Stand-ins for every model input of a cell, on the meta device (no
    memory): the ids (and the labels for ``train``) ``[B, S]`` int32,
    and whisper's frames or paligemma's patches ``[B, n, d]`` bf16."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    batch = {"tokens": meta((global_batch, seq_len), torch.int32)}
    if kind == "train":
        batch["labels"] = meta((global_batch, seq_len), torch.int32)
    if cfg.family == "encdec":
        batch["frontend"] = meta((global_batch, cfg.enc_positions,
                                  cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        batch["frontend"] = meta((global_batch, cfg.img_tokens,
                                  cfg.d_model), torch.bfloat16)
    return batch


def batch_axes(cfg: ModelConfig, kind: str = "train"):
    """The logical axes of :func:`input_specs`' tensors."""
    ax = {"tokens": ("batch", "seq")}
    if kind == "train":
        ax["labels"] = ("batch", "seq")
    if cfg.family in ("encdec", "vlm"):
        ax["frontend"] = ("batch", "frames", None)
    return ax
