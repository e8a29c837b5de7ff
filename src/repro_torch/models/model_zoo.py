"""Unified model zoo: every architecture of the registry as one
parameterized stack (dense / GQA / MoE / SSM / hybrid / enc-dec / VLM),
the twin of ``repro.models.model_zoo`` (meshless).

The parameters are the reference's tree: per-layer weights stacked on a
leading layer axis, the same names and shapes.  The layers run as a
Python loop over slices of that stack (the reference's ``scan_layers``
changes no value and does not branch here).  With ``cfg.remat`` other
than ``"none"`` and grad mode on, each decoder block (with zamba2's
shared block) and each encoder block runs under
``torch.utils.checkpoint``, so the backward pass recomputes its
activations, as the reference's ``jax.checkpoint`` does; it changes no
value.  The modality
frontends of whisper and paligemma are stubs: the caller passes
precomputed frame or patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.splaylist import _device
from repro_torch.models import attention as attn
from repro_torch.models import layers as ly
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _attn_params(pb, tree, cfg, prefix=""):
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    nl = cfg.n_layers
    pb.add(tree, prefix + "wq", (nl, d, nh * hd))
    pb.add(tree, prefix + "wk", (nl, d, nkv * hd))
    pb.add(tree, prefix + "wv", (nl, d, nkv * hd))
    pb.add(tree, prefix + "wo", (nl, nh * hd, d))
    if cfg.qkv_bias:
        pb.add(tree, prefix + "bq", (nl, nh * hd), init="zeros")
        pb.add(tree, prefix + "bk", (nl, nkv * hd), init="zeros")
        pb.add(tree, prefix + "bv", (nl, nkv * hd), init="zeros")
    pb.add(tree, prefix + "ln_attn", (nl, d), init="ones")


def _mlp_params(pb, tree, cfg):
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    pb.add(tree, "w_gate", (nl, d, ff))
    pb.add(tree, "w_up", (nl, d, ff))
    pb.add(tree, "w_down", (nl, ff, d))
    pb.add(tree, "ln_mlp", (nl, d), init="ones")


def _moe_params(pb, tree, cfg):
    d, ff, e, nl = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    pb.add(tree, "router", (nl, d, e), scale=0.02)
    pb.add(tree, "w_gate", (nl, e, d, ff))
    pb.add(tree, "w_up", (nl, e, d, ff))
    pb.add(tree, "w_down", (nl, e, ff, d))
    if cfg.dense_residual_ff:
        rf = cfg.dense_residual_ff
        pb.add(tree, "res_gate", (nl, d, rf))
        pb.add(tree, "res_up", (nl, d, rf))
        pb.add(tree, "res_down", (nl, rf, d))
    pb.add(tree, "ln_mlp", (nl, d), init="ones")


def _ssm_params(pb, tree, cfg):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, nl = cfg.ssm_heads, cfg.n_layers
    pb.add(tree, "in_proj", (nl, d, 2 * di + 2 * n + h))
    pb.add(tree, "conv_w", (nl, cfg.conv_width, di + 2 * n))
    pb.add(tree, "conv_b", (nl, di + 2 * n), init="zeros")
    pb.add(tree, "dt_bias", (nl, h), init="zeros")
    pb.add(tree, "A", (nl, h), init="ssm_a")
    pb.add(tree, "D", (nl, h), init="ones")
    pb.add(tree, "norm", (nl, di), init="ones")
    pb.add(tree, "out_proj", (nl, di, d))
    pb.add(tree, "ln", (nl, d), init="ones")


def _shared_attn_params(pb, tree, cfg):
    """zamba2's single shared attention+MLP block (weights shared across
    all its applications)."""
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    ff = cfg.d_ff
    pb.add(tree, "wq", (d, nh * hd))
    pb.add(tree, "wk", (d, nkv * hd))
    pb.add(tree, "wv", (d, nkv * hd))
    pb.add(tree, "wo", (nh * hd, d))
    pb.add(tree, "ln_attn", (d,), init="ones")
    pb.add(tree, "w_gate", (d, ff))
    pb.add(tree, "w_up", (d, ff))
    pb.add(tree, "w_down", (ff, d))
    pb.add(tree, "ln_mlp", (d,), init="ones")


def _enc_params(pb, tree, cfg):
    """Whisper encoder stack (bidirectional) + the decoder's
    cross-attention projections."""
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    ne, nl = cfg.n_enc_layers, cfg.n_layers
    pb.add(tree, "enc_wq", (ne, d, nh * hd))
    pb.add(tree, "enc_wk", (ne, d, nkv * hd))
    pb.add(tree, "enc_wv", (ne, d, nkv * hd))
    pb.add(tree, "enc_wo", (ne, nh * hd, d))
    pb.add(tree, "enc_ln_attn", (ne, d), init="ones")
    pb.add(tree, "enc_w_gate", (ne, d, cfg.d_ff))
    pb.add(tree, "enc_w_up", (ne, d, cfg.d_ff))
    pb.add(tree, "enc_w_down", (ne, cfg.d_ff, d))
    pb.add(tree, "enc_ln_mlp", (ne, d), init="ones")
    pb.add(tree, "enc_pos", (cfg.enc_positions, d), scale=0.02)
    pb.add(tree, "x_wq", (nl, d, nh * hd))
    pb.add(tree, "x_wk", (nl, d, nkv * hd))
    pb.add(tree, "x_wv", (nl, d, nkv * hd))
    pb.add(tree, "x_wo", (nl, nh * hd, d))
    pb.add(tree, "x_ln", (nl, d), init="ones")


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda"
                 ) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` (the reference's names and shapes;
    ``shared_attn`` a nested dict for zamba2), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, in
    ``cfg.param_dtype``."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pb = ly.ParamBuilder(gen, dev, _DTYPES[cfg.param_dtype])
    tree: Dict[str, Any] = {}
    pb.add(tree, "embed", (cfg.vocab_padded, cfg.d_model), scale=0.02)
    pb.add(tree, "ln_f", (cfg.d_model,), init="ones")
    if not cfg.tie_embeddings:
        pb.add(tree, "unembed", (cfg.d_model, cfg.vocab_padded),
               scale=0.02)
    fam = cfg.family
    if fam in ("dense", "vlm", "encdec"):
        _attn_params(pb, tree, cfg)
        _mlp_params(pb, tree, cfg)
        if fam == "encdec":
            _enc_params(pb, tree, cfg)
    elif fam == "moe":
        _attn_params(pb, tree, cfg)
        _moe_params(pb, tree, cfg)
    elif fam == "ssm":
        _ssm_params(pb, tree, cfg)
    elif fam == "hybrid":
        _ssm_params(pb, tree, cfg)
        tree["shared_attn"] = {}
        _shared_attn_params(pb, tree["shared_attn"], cfg)
    else:
        raise ValueError(fam)
    return tree


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------

def cache_write(cache, x, start: int):
    """Write ``x`` into ``cache`` in place where
    ``jax.lax.dynamic_update_slice_in_dim(cache, x, start, axis=1)``
    puts it: the start is clamped to ``[0, cache.shape[1] - x.shape[1]]``
    so the update always fits (a write past the end overwrites the last
    rows).  Returns ``cache``."""
    s = x.shape[1]
    start = min(max(int(start), 0), cache.shape[1] - s)
    cache[:, start:start + s] = x
    return cache


def _attn_block(x, p, cfg, mask_mode, prefix_len, cdt,
                kv_override=None, q_offset=None, cache=None,
                cache_len=None):
    """Pre-norm attention block over one layer's (unstacked) params.
    Returns (out, new_kv): on the decode path ``cache``, written in
    place at ``cache_len``, else this call's (k, v)."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = ly.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    src = h if kv_override is None else kv_override
    q = h @ p["wq"].to(cdt)
    k = src @ p["wk"].to(cdt)
    v = src @ p["wv"].to(cdt)
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, src.shape[1], nkv, hd)
    v = v.reshape(b, src.shape[1], nkv, hd)
    if mask_mode != "full" or kv_override is None:
        pos_q = torch.arange(s, device=x.device)
        if q_offset is not None:
            pos_q = q_offset + pos_q
        q = ly.rope(q, pos_q[None, :], cfg.rope_theta)
        if cache is None or kv_override is None:
            pos_k = (torch.arange(k.shape[1], device=x.device)
                     if cache is None else pos_q)
            k = ly.rope(k, pos_k[None, :], cfg.rope_theta)
    if cache is not None:
        if len(cache) == 4:          # int8 cache with per-token scales
            k_cache, v_cache, k_sc, v_sc = cache
            kq, ks = attn.quantize_kv(k)
            vq, vs = attn.quantize_kv(v)
            new_cache = (cache_write(k_cache, kq, cache_len),
                         cache_write(v_cache, vq, cache_len),
                         cache_write(k_sc, ks, cache_len),
                         cache_write(v_sc, vs, cache_len))
            o = attn.decode_attention_q8(q, *new_cache, cache_len + s)
        else:
            k_cache, v_cache = cache
            new_cache = (cache_write(k_cache, k, cache_len),
                         cache_write(v_cache, v, cache_len))
            o = attn.decode_attention(q, *new_cache, cache_len + s)
    else:
        o = attn.attention(q, k, v, mask_mode, prefix_len)
        new_cache = (k, v)
    return o.reshape(b, s, nh * hd) @ p["wo"].to(cdt), new_cache


def _mlp_block(x, p, cfg, cdt):
    h = ly.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return ly.swiglu(h, p["w_gate"], p["w_up"], p["w_down"], cdt)


def _moe_block(x, p, cfg, cdt):
    h = ly.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return moe_mod.moe_block(h, p, cfg, cdt)


def _layer_keys(params, cfg):
    """Names of the per-layer stacked decoder params."""
    fam = cfg.family
    keys = []
    if fam in ("dense", "vlm", "encdec", "moe"):
        keys += ["wq", "wk", "wv", "wo", "ln_attn", "ln_mlp"]
        if cfg.qkv_bias:
            keys += ["bq", "bk", "bv"]
        if fam == "moe":
            keys += ["router", "w_gate", "w_up", "w_down"]
            if cfg.dense_residual_ff:
                keys += ["res_gate", "res_up", "res_down"]
        else:
            keys += ["w_gate", "w_up", "w_down"]
        if fam == "encdec":
            keys += ["x_wq", "x_wk", "x_wv", "x_wo", "x_ln"]
    elif fam in ("ssm", "hybrid"):
        keys += ["in_proj", "conv_w", "conv_b", "dt_bias", "A", "D",
                 "norm", "out_proj", "ln"]
    return [k for k in keys if k in params]


def _layer(params, keys, i):
    return {k: params[k][i] for k in keys}


def _cross(lp):
    return {"wq": lp["x_wq"], "wk": lp["x_wk"], "wv": lp["x_wv"],
            "wo": lp["x_wo"], "ln_attn": lp["x_ln"]}


def _decoder_block(x, lp, cfg, cdt, mask_mode="causal", prefix_len=0,
                   enc_out=None):
    """One decoder layer (the training/prefill path)."""
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        h = ly.rms_norm(x, lp["ln"], cfg.norm_eps)
        return x + ssm_mod.mamba2_block(h, lp, cfg, cdt)
    a, _ = _attn_block(x, lp, cfg, mask_mode, prefix_len, cdt)
    x = x + a
    if fam == "encdec" and enc_out is not None:
        xa, _ = _attn_block(x, _cross(lp), cfg, "full", 0, cdt,
                            kv_override=enc_out)
        x = x + xa
    if fam == "moe":
        return x + _moe_block(x, lp, cfg, cdt)
    return x + _mlp_block(x, lp, cfg, cdt)


def _shared_due(cfg, idx: int) -> bool:
    return (cfg.family == "hybrid" and bool(cfg.attn_every)
            and (idx + 1) % cfg.attn_every == 0)


def _no_tap(name, x):
    return x


def _remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat``
    asks for it and a backward pass can follow."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _shared_block(x, shared, cfg, cdt, mask_mode, prefix_len):
    """zamba2's shared attention + MLP block."""
    a, _ = _attn_block(x, shared, cfg, mask_mode, prefix_len, cdt)
    x = x + a
    return x + _mlp_block(x, shared, cfg, cdt)


def _unstack(params, keys):
    """Per-layer views of the stacked weights, split once: the backward
    pass then stacks each weight's layer gradients in one write, where
    indexing the stack per layer would accumulate a zero-filled copy of
    the whole stack for every layer."""
    views = {k: params[k].unbind(0) for k in keys}
    return [{k: v[i] for k, v in views.items()}
            for i in range(len(next(iter(views.values()))))]


def _run_layers(x, params, cfg, cdt, mask_mode="causal", prefix_len=0,
                enc_out=None, tap=_no_tap):
    layers = _unstack(params, _layer_keys(params, cfg))
    shared = params.get("shared_attn")
    for i in range(cfg.n_layers):
        x = tap(f"layer{i}", _remat(
            cfg, _decoder_block, x, layers[i], cfg, cdt,
            mask_mode, prefix_len, enc_out))
        if _shared_due(cfg, i):
            x = tap(f"shared{i}", _remat(cfg, _shared_block, x, shared,
                                         cfg, cdt, mask_mode, prefix_len))
    return x


# ---------------------------------------------------------------------------
# public forward passes
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens, cdt):
    """Rows of the embedding table.  jnp indexing clamps an id past the
    table; here an id outside ``[0, vocab_padded)`` is an error.  Ids on
    the host are checked at once (``ValueError``); ids on the card by an
    asynchronous device assert, which reads nothing back and fails the
    next synchronising call."""
    n = params["embed"].shape[0]
    ok = ((tokens >= 0) & (tokens < n)).all()
    if tokens.device.type == "cpu":
        if not bool(ok):
            raise ValueError(f"token id out of range [0, {n})")
    else:
        torch._assert_async(ok, f"token id out of range [0, {n})")
    return params["embed"][tokens].to(cdt)


def logits_out(params, cfg, x, cdt):
    x = ly.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cdt).T
    return x @ params["unembed"].to(cdt)


def _encode(params, cfg, frames, cdt, tap=_no_tap):
    """Whisper encoder over stub frame embeddings [B, T_enc, d]."""
    x = frames.to(cdt) + params["enc_pos"].to(cdt)[None]
    names = ("wq", "wk", "wv", "wo", "ln_attn", "w_gate", "w_up",
             "w_down", "ln_mlp")
    layers = _unstack({k: params["enc_" + k] for k in names}, names)
    for i in range(cfg.n_enc_layers):
        x = tap(f"enc{i}", _remat(cfg, _enc_block, x, layers[i], cfg, cdt))
    return x


def _enc_block(x, lp, cfg, cdt):
    a, _ = _attn_block(x, lp, cfg, "full", 0, cdt)
    x = x + a
    return x + _mlp_block(x, lp, cfg, cdt)


def forward(params, cfg: ModelConfig, tokens, frontend=None, tap=None):
    """Training/prefill forward -> logits [B, S, vocab_padded].
    ``frontend``: the stub modality input, whisper frame embeddings or
    paligemma patch embeddings.  ``tap(name, x)``, when given, sees the
    hidden state after each stage (``embed``, ``enc{i}``, ``layer{i}``,
    ``shared{i}``) and returns the one the pass continues from: a parity
    check compares each stage and carries one input into both sides."""
    tap = tap or _no_tap
    cdt = _dt(cfg)
    x = embed_tokens(params, cfg, tokens, cdt)
    mask_mode, prefix_len, enc_out = "causal", 0, None
    if cfg.family == "vlm" and frontend is not None:
        x = torch.cat([frontend.to(cdt), x], dim=1)
        mask_mode, prefix_len = "prefix", cfg.img_tokens
    x = tap("embed", x)
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, frontend, cdt, tap)
    x = _run_layers(x, params, cfg, cdt, mask_mode, prefix_len, enc_out,
                    tap)
    if cfg.family == "vlm" and frontend is not None:
        x = x[:, cfg.img_tokens:]
    return logits_out(params, cfg, x, cdt)


# ---------------------------------------------------------------------------
# decode (serving) path
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Stacked decode cache, zeros.  Attention archs: K/V per layer
    (int8 with float32 per-token scales when ``kv_cache_dtype`` is
    ``int8``, for dense, vlm and moe); SSM/hybrid: SSM state + conv
    buffer (+ the shared block's K/V for hybrid)."""
    dev = _device(device)
    cdt = _dt(cfg)
    nkv, hd = cfg.n_kv, cfg.head_dim

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Dict[str, Any] = {}
    q8 = (cfg.kv_cache_dtype == "int8"
          and cfg.family in ("dense", "vlm", "moe"))
    kv_dt = torch.int8 if q8 else cdt
    if cfg.family in ("dense", "vlm", "encdec", "moe"):
        shape = (cfg.n_layers, batch, max_seq, nkv, hd)
        cache["k"] = mk(shape, kv_dt)
        cache["v"] = mk(shape, kv_dt)
        if q8:
            cache["k_sc"] = mk(shape[:-1], torch.float32)
            cache["v_sc"] = mk(shape[:-1], torch.float32)
        if cfg.family == "encdec":
            xshape = (cfg.n_layers, batch, cfg.enc_positions, nkv, hd)
            cache["xk"] = mk(xshape, cdt)
            cache["xv"] = mk(xshape, cdt)
    if cfg.family in ("ssm", "hybrid"):
        di, n = cfg.d_inner, cfg.ssm_state
        cache["ssm"] = mk((cfg.n_layers, batch, cfg.ssm_heads, n,
                           cfg.ssm_head_dim), torch.float32)
        cache["conv"] = mk((cfg.n_layers, batch, cfg.conv_width - 1,
                            di + 2 * n), cdt)
        if cfg.family == "hybrid" and cfg.attn_every:
            n_attn = cfg.n_layers // cfg.attn_every
            cache["k"] = mk((n_attn, batch, max_seq, nkv, hd), cdt)
            cache["v"] = mk((n_attn, batch, max_seq, nkv, hd), cdt)
    return cache


def decode_step(params, cfg: ModelConfig, tokens, cache,
                cache_len: int):
    """One decode step: tokens [B, 1] + cache -> (logits [B, 1, V],
    new cache).  ``cache_len``: the filled length before this step.
    The cache passed in is left as it was: each stacked tensor the step
    writes is copied once, and the layers write into the copy."""
    cdt = _dt(cfg)
    b = tokens.shape[0]
    x = embed_tokens(params, cfg, tokens, cdt)
    keys = _layer_keys(params, cfg)
    fam = cfg.family
    written = [k for k in ("k", "v", "k_sc", "v_sc", "ssm", "conv")
               if k in cache]
    cache = {k: (v.clone() if k in written else v)
             for k, v in cache.items()}

    if fam in ("dense", "vlm", "encdec", "moe"):
        names = (("k", "v", "k_sc", "v_sc") if "k_sc" in cache
                 else ("k", "v"))
        for i in range(cfg.n_layers):
            lp = _layer(params, keys, i)
            a, _ = _attn_block(
                x, lp, cfg, "causal", 0, cdt, q_offset=cache_len,
                cache=tuple(cache[n][i] for n in names),
                cache_len=cache_len)
            x = x + a
            if fam == "encdec":
                hq = ly.rms_norm(x, lp["x_ln"], cfg.norm_eps) @ \
                    lp["x_wq"].to(cdt)
                xa = attn.decode_attention(
                    hq.reshape(b, 1, cfg.n_heads, cfg.head_dim),
                    cache["xk"][i], cache["xv"][i], cfg.enc_positions)
                x = x + xa.reshape(b, 1, -1) @ lp["x_wo"].to(cdt)
            x = x + (_moe_block(x, lp, cfg, cdt) if fam == "moe"
                     else _mlp_block(x, lp, cfg, cdt))
    else:  # ssm / hybrid
        shared = params.get("shared_attn")
        j = 0
        for i in range(cfg.n_layers):
            lp = _layer(params, keys, i)
            hn = ly.rms_norm(x, lp["ln"], cfg.norm_eps)
            y, st = ssm_mod.mamba2_decode(
                hn, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                lp, cfg, cdt)
            cache["ssm"][i] = st["ssm"]
            cache["conv"][i] = st["conv"]
            x = x + y
            if _shared_due(cfg, i):
                a, _ = _attn_block(
                    x, shared, cfg, "causal", 0, cdt, q_offset=cache_len,
                    cache=(cache["k"][j], cache["v"][j]),
                    cache_len=cache_len)
                j += 1
                x = x + a
                x = x + _mlp_block(x, shared, cfg, cdt)

    return logits_out(params, cfg, x, cdt), cache
