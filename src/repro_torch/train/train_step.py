"""Training step: loss, gradients, optimizer, microbatching and the
compression hook (the twin of ``repro.train.train_step``, meshless).

``make_train_step(cfg)`` returns the eager step that
``launch/train.py`` runs.  Gradients come from ``torch.autograd.grad``
over the parameter leaves; microbatches are a Python loop that
accumulates float32 gradients in order, as the reference's scan does.
The dry-run's inputs of a cell are :func:`input_specs` (meta tensors:
shapes only) and their logical axes :func:`batch_axes`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import compression as comp
from repro_torch.train import optimizer as opt


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Next-token cross-entropy over ``forward``'s logits, with the
    reference's numerics: the row max held constant (its
    ``stop_gradient``), ``exp`` and the log-sum in float32, the gold
    logit taken exactly (the reference's one-hot product with float32
    accumulation) and the last position, whose label is -1, masked."""
    logits = zoo.forward(params, cfg, batch["tokens"],
                         frontend=batch.get("frontend"))      # [b,s,v]
    lab = batch["labels"]
    labels = torch.cat([lab[:, 1:], torch.full_like(lab[:, :1], -1)],
                       dim=1)                                  # shift left
    lmax = logits.max(dim=-1).values.detach()
    shifted = logits - lmax[..., None]
    sumexp = torch.exp(shifted.float()).sum(dim=-1)
    logz = torch.log(sumexp) + lmax.float()
    # a label of -1 would index out of range: read row 0, masked below
    idx = labels.clamp(min=0).long()[..., None]
    gold = torch.gather(logits, -1, idx)[..., 0].float()
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _grads_of(params, cfg, batch):
    """(loss, grads): float32 gradients of every leaf (zeros for a leaf
    the loss does not reach, as JAX gives)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, cfg, batch)
        flat = leaves(live)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)])


def make_train_step(cfg: ModelConfig, microbatch: int = 1,
                    compress: Optional[str] = None, lr: float = 3e-4):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); with ``compress`` it takes and returns the error feedback
    too.  microbatch > 1 splits the global batch and accumulates grads.
    compress: None | 'int8' | 'topk', error-feedback compression of the
    accumulated grads before the optimizer.  ``metrics`` holds ``loss``
    and ``grad_norm`` (of the grads after compression)."""

    def step(params, opt_state, batch, error_fb=None):
        if microbatch > 1:
            def part(x, i):
                b = x.shape[0]
                return x.reshape(microbatch, b // microbatch,
                                 *x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatch):
                mb = {k: part(v, i) for k, v in batch.items()}
                l_i, g_i = _grads_of(params, cfg, mb)
                loss = loss + l_i
                grads = tree_map(torch.add, grads, g_i)
            loss = loss / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        else:
            loss, grads = _grads_of(params, cfg, batch)

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
