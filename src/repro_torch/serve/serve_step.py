"""Serving steps: prefill and single-token decode with stacked caches
(the twin of ``repro.serve.serve_step``).  Greedy throughout: ties go to
the lower token id, as ``jnp.argmax`` breaks them, on a laid-out tree
too (:func:`greedy`), and with the last position on one rank of a
sequence split (:func:`last_logits`).  ``decode_input_specs`` gives the
dry-run's inputs of a decode cell on the meta device."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import collectives as cl
from repro_torch.parallel import sharding as shd


def greedy(logits, params, cfg: ModelConfig) -> torch.Tensor:
    """The greedy ids ``[...]`` (int64) of ``logits`` ``[..., V]``.  On
    a vocab-split head (a laid-out tree) ``logits`` is this rank's block
    ``[..., V/S]``: each rank takes its block's largest value and its
    lowest index, one all-gather of the (value, global id) pairs gives
    every rank all of them, and the largest value wins, the lower global
    id on a tie (the lower block, then the lower index in it), so every
    rank holds the same ids.  Every rank of the mesh must call this."""
    axes = zoo.vocab_axes(params, cfg)
    if not axes:
        return torch.argmax(logits, dim=-1)
    mesh = params.mesh
    v, i = logits.max(dim=-1)
    i = i + shd.block_index(axes, mesh) * logits.shape[-1]
    pair = torch.stack([v.float(), i.float()], -1)   # ids < 2**24: exact
    for a in reversed(axes):
        blocks = cl.all_gather(pair, mesh, axis=a)        # [S, ..., 2]
        best = blocks[..., 0].amax(0)
        first = (blocks[..., 0] == best).int().argmax(0)  # lowest block
        pair = torch.gather(blocks, 0, first[None, ..., None].expand(
            1, *first.shape, 2))[0]
    return pair[..., 1].long()


def last_logits(logits, params, cfg: ModelConfig, seq_len: int):
    """The last position's logits ``[B, 1, V]`` (this rank's vocab
    block on a laid-out tree) on every rank, from ``forward``'s logits
    of a ``seq_len``-long sequence: where ``seq`` splits the logits'
    positions over ranks (``zoo.logits_layout``), the rank whose block
    holds the last position gives it and the others zeros, and one sum
    over those axes gives every rank the row (exact: one term is
    nonzero).  Every rank of the mesh must call this."""
    mesh = shd.tree_mesh(params)
    if mesh is None:
        return logits[:, -1:]
    blk = zoo.logits_layout((logits.shape[0], seq_len, cfg.vocab_padded),
                            mesh, params.rules)
    if not blk.axes:
        return logits[:, -1:]
    last = seq_len - 1 - blk.start
    row = (logits[:, last:last + 1] if 0 <= last < blk.size
           else torch.zeros_like(logits[:, :1]))
    for a in blk.axes:
        row = cl.psum(row, mesh, axis=a)
    return row


def make_prefill(cfg: ModelConfig):
    def prefill(params, batch):
        tokens = batch["tokens"]
        logits = zoo.forward(params, cfg, tokens,
                             frontend=batch.get("frontend"))
        return greedy(last_logits(logits, params, cfg, tokens.shape[1]),
                      params, cfg)
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, cache, cache_len):
        logits, cache = zoo.decode_step(params, cfg, tokens, cache,
                                        cache_len)
        next_tok = greedy(logits[:, -1], params, cfg)[:, None]
        return next_tok.to(torch.int32), cache
    return decode_step


def decode_input_specs(cfg: ModelConfig, seq_len: int, global_batch: int):
    """The inputs of one decode step with a ``seq_len`` KV/SSM cache, on
    the meta device (shapes only): the ids ``[B, 1]``, the cache and
    ``cache_len`` (an int)."""
    tokens = torch.empty((global_batch, 1), dtype=torch.int32,
                         device="meta")
    cache = zoo.init_cache(cfg, global_batch, seq_len, device="meta")
    return tokens, cache, 0


def prefill_loop(decode_fn, params, tokens, cache, cache_len0: int = 0):
    """Token-by-token prefill through the decode cell: feed ``tokens``
    (``[B, L]`` numpy, already left-padded) one position at a time,
    returning ``(last, cache, cache_len)`` where ``last`` is the
    ``[B, 1]`` greedy continuation after the final prompt position and
    ``cache_len`` the filled length (an int).  Shared by
    ``serve.engine.Engine`` and the left-pad parity tests, so both walk
    the same cell sequence.  The ids are checked here, on the host, so
    that no step on the device has to read its ids back."""
    dev = params["embed"].device
    n = zoo.vocab_rows(params)
    if tokens.size and (tokens.min() < 0 or tokens.max() >= n):
        raise ValueError(f"token id out of range [0, {n})")
    cache_len = int(cache_len0)
    last = None
    for t in range(tokens.shape[1]):
        step = torch.as_tensor(tokens[:, t:t + 1], device=dev)
        last, cache = decode_fn(params, step, cache, cache_len)
        cache_len += 1
    return last, cache, cache_len
