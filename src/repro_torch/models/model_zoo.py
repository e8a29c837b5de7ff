"""Unified model zoo: every architecture of the registry as one
parameterized stack (dense / GQA / MoE / SSM / hybrid / enc-dec / VLM),
the twin of ``repro.models.model_zoo``.

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

On a mesh the parameters are laid out by their logical axes
(``build_params(..., with_axes=True)``, ``layers.axes_to_specs``,
``sharding.lay_out``) and the cache by :func:`cache_axes`.  Every
family computes on such a tree with explicit collectives, the function
of the global tree (the reference's constraints are layouts, never
values): the embedding over a vocab-split table, whole heads of
attention (:class:`_Heads`; zamba2's shared block, whisper's encoder
and cross-attention and paligemma's prefix included), the column- and
row-parallel MLP, the experts over the ``expert`` axes
(``moe.moe_block``), the Mamba2 heads over ``ssm_heads``
(``ssm._Split``), weights gathered over ``fsdp``, and this rank's rows
of the batch (its block over the ``batch`` axes) and block of the
logits.  Rules that split the sequence (``seq``, ``kvseq``,
``cp_seq``, ``cp_q`` over more than one rank) are refused: they are
ROADMAP queue A item 3.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.splaylist import _device
from repro_torch.models import attention as attn
from repro_torch.models import layers as ly
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.parallel import sharding as shd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def _attn_params(pb, tree, cfg, prefix=""):
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    nl = cfg.n_layers
    L = ("layers",)
    pb.add(tree, prefix + "wq", (nl, d, nh * hd), L + ("fsdp", "heads"))
    pb.add(tree, prefix + "wk", (nl, d, nkv * hd), L + ("fsdp", "kv"))
    pb.add(tree, prefix + "wv", (nl, d, nkv * hd), L + ("fsdp", "kv"))
    pb.add(tree, prefix + "wo", (nl, nh * hd, d), L + ("heads", "fsdp"))
    if cfg.qkv_bias:
        pb.add(tree, prefix + "bq", (nl, nh * hd), L + ("heads",),
               init="zeros")
        pb.add(tree, prefix + "bk", (nl, nkv * hd), L + ("kv",),
               init="zeros")
        pb.add(tree, prefix + "bv", (nl, nkv * hd), L + ("kv",),
               init="zeros")
    pb.add(tree, prefix + "ln_attn", (nl, d), L + (None,), init="ones")


def _mlp_params(pb, tree, cfg):
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    L = ("layers",)
    pb.add(tree, "w_gate", (nl, d, ff), L + ("fsdp", "mlp"))
    pb.add(tree, "w_up", (nl, d, ff), L + ("fsdp", "mlp"))
    pb.add(tree, "w_down", (nl, ff, d), L + ("mlp", "fsdp"))
    pb.add(tree, "ln_mlp", (nl, d), L + (None,), init="ones")


def _moe_params(pb, tree, cfg):
    d, ff, e, nl = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    L = ("layers",)
    pb.add(tree, "router", (nl, d, e), L + ("embed", None), scale=0.02)
    pb.add(tree, "w_gate", (nl, e, d, ff), L + ("expert", "fsdp", "mlp"))
    pb.add(tree, "w_up", (nl, e, d, ff), L + ("expert", "fsdp", "mlp"))
    pb.add(tree, "w_down", (nl, e, ff, d), L + ("expert", "mlp", "fsdp"))
    if cfg.dense_residual_ff:
        rf = cfg.dense_residual_ff
        pb.add(tree, "res_gate", (nl, d, rf), L + ("fsdp", "mlp"))
        pb.add(tree, "res_up", (nl, d, rf), L + ("fsdp", "mlp"))
        pb.add(tree, "res_down", (nl, rf, d), L + ("mlp", "fsdp"))
    pb.add(tree, "ln_mlp", (nl, d), L + (None,), init="ones")


def _ssm_params(pb, tree, cfg):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, nl = cfg.ssm_heads, cfg.n_layers
    L = ("layers",)
    pb.add(tree, "in_proj", (nl, d, 2 * di + 2 * n + h),
           L + ("fsdp", "ssm_proj"))
    pb.add(tree, "conv_w", (nl, cfg.conv_width, di + 2 * n),
           L + ("conv", None))
    pb.add(tree, "conv_b", (nl, di + 2 * n), L + (None,), init="zeros")
    pb.add(tree, "dt_bias", (nl, h), L + ("ssm_heads",), init="zeros")
    pb.add(tree, "A", (nl, h), L + ("ssm_heads",), init="ssm_a")
    pb.add(tree, "D", (nl, h), L + ("ssm_heads",), init="ones")
    pb.add(tree, "norm", (nl, di), L + (None,), init="ones")
    pb.add(tree, "out_proj", (nl, di, d), L + ("ssm_proj", "fsdp"))
    pb.add(tree, "ln", (nl, d), L + (None,), init="ones")


def _shared_attn_params(pb, tree, cfg):
    """zamba2's single shared attention+MLP block (weights shared across
    all its applications)."""
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    ff = cfg.d_ff
    pb.add(tree, "wq", (d, nh * hd), ("fsdp", "heads"))
    pb.add(tree, "wk", (d, nkv * hd), ("fsdp", "kv"))
    pb.add(tree, "wv", (d, nkv * hd), ("fsdp", "kv"))
    pb.add(tree, "wo", (nh * hd, d), ("heads", "fsdp"))
    pb.add(tree, "ln_attn", (d,), (None,), init="ones")
    pb.add(tree, "w_gate", (d, ff), ("fsdp", "mlp"))
    pb.add(tree, "w_up", (d, ff), ("fsdp", "mlp"))
    pb.add(tree, "w_down", (ff, d), ("mlp", "fsdp"))
    pb.add(tree, "ln_mlp", (d,), (None,), init="ones")


def _enc_params(pb, tree, cfg):
    """Whisper encoder stack (bidirectional) + the decoder's
    cross-attention projections."""
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    ne, nl = cfg.n_enc_layers, cfg.n_layers
    L = ("layers",)
    pb.add(tree, "enc_wq", (ne, d, nh * hd), L + ("fsdp", "heads"))
    pb.add(tree, "enc_wk", (ne, d, nkv * hd), L + ("fsdp", "kv"))
    pb.add(tree, "enc_wv", (ne, d, nkv * hd), L + ("fsdp", "kv"))
    pb.add(tree, "enc_wo", (ne, nh * hd, d), L + ("heads", "fsdp"))
    pb.add(tree, "enc_ln_attn", (ne, d), L + (None,), init="ones")
    pb.add(tree, "enc_w_gate", (ne, d, cfg.d_ff), L + ("fsdp", "mlp"))
    pb.add(tree, "enc_w_up", (ne, d, cfg.d_ff), L + ("fsdp", "mlp"))
    pb.add(tree, "enc_w_down", (ne, cfg.d_ff, d), L + ("mlp", "fsdp"))
    pb.add(tree, "enc_ln_mlp", (ne, d), L + (None,), init="ones")
    pb.add(tree, "enc_pos", (cfg.enc_positions, d), ("frames", None),
           scale=0.02)
    pb.add(tree, "x_wq", (nl, d, nh * hd), L + ("fsdp", "heads"))
    pb.add(tree, "x_wk", (nl, d, nkv * hd), L + ("fsdp", "kv"))
    pb.add(tree, "x_wv", (nl, d, nkv * hd), L + ("fsdp", "kv"))
    pb.add(tree, "x_wo", (nl, nh * hd, d), L + ("heads", "fsdp"))
    pb.add(tree, "x_ln", (nl, d), L + (None,), init="ones")


def build_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                 with_axes: bool = False):
    """The parameter tree of ``cfg`` (the reference's names and shapes;
    ``shared_attn`` a nested dict for zamba2), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, in
    ``cfg.param_dtype``; on ``"meta"`` the shapes alone (no memory).
    ``with_axes=True`` returns ``(params, axes)`` as the reference's
    ``build_params`` does, ``axes`` the logical-axis tree for
    ``layers.axes_to_specs``."""
    dev = torch.device(device) if str(device) == "meta" else _device(
        device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    pb = ly.ParamBuilder(gen, dev, _DTYPES[cfg.param_dtype])
    tree: Dict[str, Any] = {}
    pb.add(tree, "embed", (cfg.vocab_padded, cfg.d_model),
           ("vocab", "embed"), scale=0.02)
    pb.add(tree, "ln_f", (cfg.d_model,), (None,), init="ones")
    if not cfg.tie_embeddings:
        pb.add(tree, "unembed", (cfg.d_model, cfg.vocab_padded),
               ("embed", "vocab"), scale=0.02)
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
    params, axes = ly.split_axes(tree)
    return (params, axes) if with_axes else params


def param_axes(cfg: ModelConfig):
    """``(shapes, axes)``: the parameter tree of ``cfg`` on the meta
    device (shapes and dtypes, no memory) and its logical-axis tree."""
    return build_params(cfg, device="meta", with_axes=True)


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of the decode cache's tensors (for its layout)."""
    ax: Dict[str, Any] = {}
    if cfg.family in ("dense", "vlm", "encdec", "moe") or (
            cfg.family == "hybrid" and cfg.attn_every):
        ax["k"] = ("layers", "batch", "kvseq", "kv", None)
        ax["v"] = ("layers", "batch", "kvseq", "kv", None)
        if cfg.kv_cache_dtype == "int8" and cfg.family in (
                "dense", "vlm", "moe"):
            ax["k_sc"] = ("layers", "batch", "kvseq", "kv")
            ax["v_sc"] = ("layers", "batch", "kvseq", "kv")
    if cfg.family == "encdec":
        ax["xk"] = ("layers", "batch", "frames", "kv", None)
        ax["xv"] = ("layers", "batch", "frames", "kv", None)
    if cfg.family in ("ssm", "hybrid"):
        ax["ssm"] = ("layers", "batch", "ssm_heads", "state", None)
        ax["conv"] = ("layers", "batch", "conv", None)
    return ax


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
    place at ``cache_len``, else this call's (k, v).  On one layer's
    blocks of a laid-out tree (``layers.Blocks``) it computes whole
    heads on the active mesh (:func:`_sharded_heads`)."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = ly.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    src = h if kv_override is None else kv_override
    specs = getattr(p, "specs", None)
    w = {n: p[n] for n in ("wq", "wk", "wv", "wo")}
    if specs is not None:
        w, heads = _sharded_heads(p, cfg, cdt)
    q = h @ w["wq"].to(cdt)
    k = src @ w["wk"].to(cdt)
    v = src @ w["wv"].to(cdt)
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if specs is not None:
        q, k, v, nh, nkv = heads(q, k, v)
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
        if cache[0].shape[2] != nkv:
            raise ValueError(f"the cache holds {cache[0].shape[2]} kv "
                             f"heads, the layer computes {nkv}: lay the "
                             f"cache out as the params (init_cache(..., "
                             f"mesh=))")
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
    o = o.reshape(b, s, nh * hd)
    if specs is not None:
        return heads.out(o), new_cache
    return o @ w["wo"].to(cdt), new_cache


class _Heads:
    """How one layer's attention runs on a laid-out tree: which heads
    this rank computes and how its projections and its output meet the
    other ranks'.  ``local``: its ``wq``/``wk``/``wv`` columns are whole
    heads and its q heads' kv heads are its own (the kv head count
    divides over the axis), so it attends alone to its block of the
    cache; otherwise each split projection is all-gathered over its
    axes before the head reshape and every rank attends to all heads
    (with the cache replicated).  ``wo``'s rows follow the q heads'
    split and one sum over the mesh ends the block."""

    def __init__(self, cfg, cdt, q_axes, kv_axes, o_axes, wo):
        mesh = shd.active_mesh()
        self.mesh, self.cdt, self.wo = mesh, cdt, wo
        n_kv = shd.axes_size(mesh, kv_axes) if kv_axes else 1
        self.local = bool(kv_axes) and cfg.n_kv % n_kv == 0 \
            and q_axes == kv_axes
        self.q_axes, self.kv_axes, self.o_axes = q_axes, kv_axes, o_axes
        n = n_kv if self.local else 1
        self.nh, self.nkv = cfg.n_heads // n, cfg.n_kv // n

    def __call__(self, q, k, v):
        if not self.local:
            q = ly.gather_last(q, self.q_axes, self.mesh)
            k = ly.gather_last(k, self.kv_axes, self.mesh)
            v = ly.gather_last(v, self.kv_axes, self.mesh)
        return q, k, v, self.nh, self.nkv

    def out(self, o):
        """The block's output from this rank's attention ``o``: this
        rank's columns of ``o`` (all of them when local) times its rows
        of ``wo``, summed over ``wo``'s row axes."""
        if self.o_axes and not self.local:
            k = shd.axes_size(self.mesh, self.o_axes)
            size = o.shape[-1] // k
            o = o.narrow(-1, shd.block_index(self.o_axes, self.mesh) * size,
                         size)
        return ly.row_parallel(o, self.wo, self.cdt, self.o_axes)


def _sharded_heads(p, cfg, cdt):
    """One layer's projections of a laid-out tree with their ``fsdp``
    dimension gathered, and its :class:`_Heads`."""
    sp = p.specs
    w = {"wq": shd.gather_param(p["wq"], "fsdp", "heads", spec=sp["wq"]),
         "wk": shd.gather_param(p["wk"], "fsdp", "kv", spec=sp["wk"]),
         "wv": shd.gather_param(p["wv"], "fsdp", "kv", spec=sp["wv"]),
         "wo": shd.gather_param(p["wo"], "heads", "fsdp", spec=sp["wo"])}
    mesh = shd.active_mesh()

    def axes(name, names, dim):
        shape = shd.global_shape(p[name].shape, sp[name], mesh)
        return ly.split_over(shd.resolve_spec(shape, names), dim)
    heads = _Heads(cfg, cdt, axes("wq", (None, "heads"), 1),
                   axes("wk", (None, "kv"), 1),
                   axes("wo", ("heads", None), 0), w["wo"])
    return w, heads


def _mlp_block(x, p, cfg, cdt):
    h = ly.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    specs = getattr(p, "specs", None)
    if specs is not None:
        specs = tuple(specs[n] for n in ("w_gate", "w_up", "w_down"))
    return ly.swiglu(h, p["w_gate"], p["w_up"], p["w_down"], cdt, specs)


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
    lp = {k: params[k][i] for k in keys}
    if isinstance(params, shd.LaidOutTree):
        return ly.Blocks(lp, {k: tuple(params.specs[k][1:]) for k in keys})
    return lp


_CROSS = {"wq": "x_wq", "wk": "x_wk", "wv": "x_wv", "wo": "x_wo",
          "ln_attn": "x_ln"}


def _cross(lp):
    """The cross-attention's weights under the names ``_attn_block``
    reads (their specs kept on a laid-out layer)."""
    cp = {k: lp[v] for k, v in _CROSS.items()}
    specs = getattr(lp, "specs", None)
    return cp if specs is None else ly.Blocks(
        cp, {k: specs[v] for k, v in _CROSS.items()})


def _cross_decode(x, lp, cfg, cdt, xk, xv):
    """The decode step's cross-attention to the encoder's cached
    ``xk``/``xv`` (no rope), through the sharded heads on a laid-out
    layer."""
    b = x.shape[0]
    cp = _cross(lp)
    hq = ly.rms_norm(x, cp["ln_attn"], cfg.norm_eps)
    nh = cfg.n_heads
    if getattr(cp, "specs", None) is None:
        q = hq @ cp["wq"].to(cdt)
    else:
        w, heads = _sharded_heads(cp, cfg, cdt)
        q = hq @ w["wq"].to(cdt)
        if not heads.local:
            q = ly.gather_last(q, heads.q_axes)
        nh = heads.nh
        if xk.shape[2] != heads.nkv:
            raise ValueError(f"the cross cache holds {xk.shape[2]} kv "
                             f"heads, the layer computes {heads.nkv}: lay "
                             f"the cache out as the params (init_cache(..., "
                             f"mesh=))")
    o = attn.decode_attention(q.reshape(b, 1, nh, cfg.head_dim), xk, xv,
                              cfg.enc_positions).reshape(b, 1, -1)
    if getattr(cp, "specs", None) is None:
        return o @ cp["wo"].to(cdt)
    return heads.out(o)


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


def _shared_params(params):
    """zamba2's shared block: its weights, with their specs on a
    laid-out tree (the block has no layer axis)."""
    shared = params.get("shared_attn")
    if shared is None or not isinstance(params, shd.LaidOutTree):
        return shared
    return ly.Blocks(shared, params.specs["shared_attn"])


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
    layers = [{k: v[i] for k, v in views.items()}
              for i in range(len(next(iter(views.values()))))]
    if isinstance(params, shd.LaidOutTree):
        specs = {k: tuple(params.specs[k][1:]) for k in keys}
        return [ly.Blocks(lp, specs) for lp in layers]
    return layers


def _run_layers(x, params, cfg, cdt, mask_mode="causal", prefix_len=0,
                enc_out=None, tap=_no_tap):
    layers = _unstack(params, _layer_keys(params, cfg))
    shared = _shared_params(params)
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

# the logical axes of the sequence- and context-parallel layouts, which
# only the dry-run turns on (ROADMAP queue A item 3)
SEQ_AXES = ("seq", "kvseq", "cp_seq", "cp_q")


def refuse_seq_layouts(mesh, rules) -> None:
    """Raise ``NotImplementedError`` for ``rules`` that split the
    sequence over more than one rank of ``mesh`` (``seq``, ``kvseq``,
    ``cp_seq`` or ``cp_q`` resolving to mesh axes of more than one rank):
    the port computes with the sequence whole on every rank."""
    for name in SEQ_AXES:
        axes = tuple(a for a in (rules.get(name) or ()) if a in mesh.shape)
        if axes and shd.axes_size(mesh, axes) > 1:
            raise NotImplementedError(
                f"rules that split {name!r} over {axes} ({mesh.shape}) lay "
                f"the sequence out over ranks: that is ROADMAP queue A "
                f"item 3 (the dry-run tooling), not implemented here")


def _laid_out(params, cfg) -> bool:
    """Whether ``params`` is a laid-out tree; raises for one whose rules
    split the sequence (:func:`refuse_seq_layouts`; no fallback gathers
    it to one rank)."""
    mesh = shd.tree_mesh(params)
    if mesh is None:
        return False
    refuse_seq_layouts(mesh, params.rules)
    return True


def vocab_axes(params, cfg):
    """The mesh axes the head table's vocab dimension is split over
    (the logits' last dimension follows it); ``()`` meshless."""
    if not isinstance(params, shd.LaidOutTree):
        return ()
    if cfg.tie_embeddings:
        return ly.split_over(params.specs["embed"], 0)
    return ly.split_over(params.specs["unembed"], 1)


def vocab_rows(params) -> int:
    """The global row count of the embedding table, laid out or not."""
    n = params["embed"].shape[0]
    if isinstance(params, shd.LaidOutTree):
        axes = ly.split_over(params.specs["embed"], 0)
        n *= shd.axes_size(params.mesh, axes) if axes else 1
    return n


def embed_tokens(params, cfg, tokens, cdt):
    """Rows of the embedding table.  jnp indexing clamps an id past the
    table; here an id outside ``[0, vocab_padded)`` is an error.  Ids on
    the host are checked at once (``ValueError``); ids on the card by an
    asynchronous device assert, which reads nothing back and fails the
    next synchronising call.  On a vocab-split table each rank takes
    the ids in its rows and zeros for the others, and one sum over the
    mesh gives every rank the rows (exact: one term is nonzero)."""
    n = vocab_rows(params)
    ok = ((tokens >= 0) & (tokens < n)).all()
    if tokens.device.type == "cpu":
        if not bool(ok):
            raise ValueError(f"token id out of range [0, {n})")
    else:
        torch._assert_async(ok, f"token id out of range [0, {n})")
    axes = (ly.split_over(params.specs["embed"], 0)
            if isinstance(params, shd.LaidOutTree) else ())
    if not axes:
        return params["embed"][tokens].to(cdt)
    table = params["embed"]
    rows = table.shape[0]
    local = tokens - shd.block_index(axes, params.mesh) * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=table.dtype,
                                device=table.device))
    return ly.psum_axes(x.to(cdt), axes, params.mesh)


def logits_out(params, cfg, x, cdt):
    """Logits ``[..., vocab_padded]``; on a vocab-split head table this
    rank's block ``[..., vocab_padded / S]`` of them."""
    x = ly.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cdt).T
    return x @ params["unembed"].to(cdt)


def _encode(params, cfg, frames, cdt, tap=_no_tap):
    """Whisper encoder over stub frame embeddings [B, T_enc, d]."""
    x = frames.to(cdt) + params["enc_pos"].to(cdt)[None]
    names = ("wq", "wk", "wv", "wo", "ln_attn", "w_gate", "w_up",
             "w_down", "ln_mlp")
    enc = {k: params["enc_" + k] for k in names}
    if isinstance(params, shd.LaidOutTree):
        enc = shd.LaidOutTree(enc, {k: params.specs["enc_" + k]
                                    for k in names}, params.mesh,
                              params.rules)
    layers = _unstack(enc, names)
    for i in range(cfg.n_enc_layers):
        x = tap(f"enc{i}", _remat(cfg, _enc_block, x, layers[i], cfg, cdt))
    return x


def _enc_block(x, lp, cfg, cdt):
    a, _ = _attn_block(x, lp, cfg, "full", 0, cdt)
    x = x + a
    return x + _mlp_block(x, lp, cfg, cdt)


def _on_tree(params, cfg):
    """The context a pass over ``params`` runs in: its mesh and rules
    active for a laid-out tree (``sharding.use_mesh``), nothing for a
    global one."""
    if _laid_out(params, cfg):
        return shd.use_mesh(params.mesh, params.rules)
    return contextlib.nullcontext()


def forward(params, cfg: ModelConfig, tokens, frontend=None, tap=None):
    """Training/prefill forward -> logits [B, S, vocab_padded].
    ``frontend``: the stub modality input, whisper frame embeddings or
    paligemma patch embeddings.  ``tap(name, x)``, when given, sees the
    hidden state after each stage (``embed``, ``enc{i}``, ``layer{i}``,
    ``shared{i}``) and returns the one the pass continues from: a parity
    check compares each stage and carries one input into both sides.
    On a laid-out tree (``sharding.lay_out``) every rank of its mesh
    must call this, with its rows of the batch (and of ``frontend``):
    the block of ``[B, ...]`` that ``("batch", ...)`` resolves to, all
    of it where the batch is not split.  Each gets its rows' block of
    the logits (``[B_rank, S, vocab_padded / S]`` on a vocab-split
    head)."""
    with _on_tree(params, cfg):
        return _forward(params, cfg, tokens, frontend, tap)


def _forward(params, cfg, tokens, frontend, tap):
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

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               mesh=None, rules=None):
    """Stacked decode cache, zeros.  Attention archs: K/V per layer
    (int8 with float32 per-token scales when ``kv_cache_dtype`` is
    ``int8``, for dense, vlm and moe); SSM/hybrid: SSM state + conv
    buffer (+ the shared block's K/V for hybrid).  With ``mesh``, this
    rank's block of each tensor in the layout :func:`cache_axes`
    resolves to under ``rules`` (``default_rules()`` when omitted): the
    cache of a tree laid out on that mesh (``batch`` is then the global
    batch).  Rules that split the sequence raise
    (:func:`refuse_seq_layouts`)."""
    dev = _device(device)
    cdt = _dt(cfg)
    nkv, hd = cfg.n_kv, cfg.head_dim
    axes = cache_axes(cfg)
    rules = rules if rules is not None else shd.default_rules()
    if mesh is not None:
        refuse_seq_layouts(mesh, rules)

    def mk(shape, dtype, name):
        if mesh is not None:
            shape = shd.local_shape(
                shape, shd.resolve_spec(shape, axes[name], mesh, rules), mesh)
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Dict[str, Any] = {}
    q8 = (cfg.kv_cache_dtype == "int8"
          and cfg.family in ("dense", "vlm", "moe"))
    kv_dt = torch.int8 if q8 else cdt
    if cfg.family in ("dense", "vlm", "encdec", "moe"):
        shape = (cfg.n_layers, batch, max_seq, nkv, hd)
        cache["k"] = mk(shape, kv_dt, "k")
        cache["v"] = mk(shape, kv_dt, "v")
        if q8:
            cache["k_sc"] = mk(shape[:-1], torch.float32, "k_sc")
            cache["v_sc"] = mk(shape[:-1], torch.float32, "v_sc")
        if cfg.family == "encdec":
            xshape = (cfg.n_layers, batch, cfg.enc_positions, nkv, hd)
            cache["xk"] = mk(xshape, cdt, "xk")
            cache["xv"] = mk(xshape, cdt, "xv")
    if cfg.family in ("ssm", "hybrid"):
        di, n = cfg.d_inner, cfg.ssm_state
        cache["ssm"] = mk((cfg.n_layers, batch, cfg.ssm_heads, n,
                           cfg.ssm_head_dim), torch.float32, "ssm")
        cache["conv"] = mk((cfg.n_layers, batch, cfg.conv_width - 1,
                            di + 2 * n), cdt, "conv")
        if cfg.family == "hybrid" and cfg.attn_every:
            n_attn = cfg.n_layers // cfg.attn_every
            cache["k"] = mk((n_attn, batch, max_seq, nkv, hd), cdt, "k")
            cache["v"] = mk((n_attn, batch, max_seq, nkv, hd), cdt, "v")
    return cache


def decode_step(params, cfg: ModelConfig, tokens, cache,
                cache_len: int):
    """One decode step: tokens [B, 1] + cache -> (logits [B, 1, V],
    new cache).  ``cache_len``: the filled length before this step.
    The cache passed in is left as it was: each stacked tensor the step
    writes is copied once, and the layers write into the copy.  On a
    laid-out tree every rank of its mesh must call this with its rows of
    ``tokens`` and the cache ``init_cache(..., mesh=)`` lays out; each
    gets its rows' block of the logits, as :func:`forward`."""
    with _on_tree(params, cfg):
        return _decode_step(params, cfg, tokens, cache, cache_len)


def _decode_step(params, cfg, tokens, cache, cache_len):
    cdt = _dt(cfg)
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
                x = x + _cross_decode(x, lp, cfg, cdt, cache["xk"][i],
                                      cache["xv"][i])
            x = x + (_moe_block(x, lp, cfg, cdt) if fam == "moe"
                     else _mlp_block(x, lp, cfg, cdt))
    else:  # ssm / hybrid
        shared = _shared_params(params)
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
