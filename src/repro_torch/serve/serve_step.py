"""Serving steps: prefill and single-token decode with stacked caches
(the twin of ``repro.serve.serve_step``).  Greedy throughout: ties go to
the lower token id, as ``jnp.argmax`` breaks them."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo


def make_prefill(cfg: ModelConfig):
    def prefill(params, batch):
        logits = zoo.forward(params, cfg, batch["tokens"],
                             frontend=batch.get("frontend"))
        return torch.argmax(logits[:, -1:], dim=-1)
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, cache, cache_len):
        logits, cache = zoo.decode_step(params, cfg, tokens, cache,
                                        cache_len)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return next_tok.to(torch.int32), cache
    return decode_step


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
    n = params["embed"].shape[0]
    if tokens.size and (tokens.min() < 0 or tokens.max() >= n):
        raise ValueError(f"token id out of range [0, {n})")
    cache_len = int(cache_len0)
    last = None
    for t in range(tokens.shape[1]):
        step = torch.as_tensor(tokens[:, t:t + 1], device=dev)
        last, cache = decode_fn(params, step, cache, cache_len)
        cache_len += 1
    return last, cache, cache_len
