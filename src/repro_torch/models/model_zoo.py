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
``sharding.lay_out``) and the cache by :func:`cache_axes`
(``init_cache(..., mesh=)`` returns it as a ``sharding.LaidOutTree``
that carries its specs).  Every family computes on such a tree with
explicit collectives, the function of the global tree (the
reference's constraints are layouts, never values): the embedding over
a vocab-split table, whole heads of attention (:class:`_Heads`;
zamba2's shared block, whisper's encoder and cross-attention and
paligemma's prefix included), the column- and row-parallel MLP, the
experts over the ``expert`` axes (``moe.moe_block``), the Mamba2 heads
over ``ssm_heads`` (``ssm._Split``), weights gathered over ``fsdp``,
and this rank's rows of the batch (its block over the ``batch`` axes)
and block of the logits.

The sequence layouts.  The residual stream between blocks is this
rank's block of positions where ``("batch", "cp_seq", "embed")``
(Megatron-SP), else ``("batch", "seq", "embed")``, resolves on its
shape to mesh axes (:func:`stream_layout`).  Each block norms its
positions, all-gathers the sequence whole at its entry and ends with a
reduce-scatter of its float32 partial sums over those axes
(``layers.row_parallel``; a sum and a cut where the sums run over
other axes).  Under ``cp_q`` a rank attends with its block of q
positions (global positions for the mask and rope) against the whole
k/v, the projections gathered whole, and ``wo``'s rows gathered so
that its output rows are its block.  Under ``kvseq`` a rank holds its
block of the cache's positions, writes position ``cache_len`` where
its block holds it (:func:`cache_write`) and attends with
flash-decoding (``attention.decode_attention``).  The MoE routing and
the Mamba2 scan see the whole sequence.  A sequence name shares a mesh
axis with ``batch`` only where the batch does not split over it (the
dry-run's ``seq_sharded`` rules: a global batch smaller than
``data``), so a rank's rows resolve the layout as the global batch
does.
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

def cache_write(cache, x, start: int, kv=None):
    """Write ``x`` into ``cache`` in place where
    ``jax.lax.dynamic_update_slice_in_dim(cache, x, start, axis=1)``
    puts it: the start is clamped to ``[0, length - x.shape[1]]`` so the
    update always fits (a write past the end overwrites the last rows).
    With ``kv`` (a ``sharding.SeqBlock``) ``cache`` is this rank's block
    of positions of a cache ``kv.length`` long, and the rows of ``x``
    that fall in it are written.  Returns ``cache``."""
    s = x.shape[1]
    length = kv.length if kv is not None else cache.shape[1]
    lo = kv.start if kv is not None else 0
    start = min(max(int(start), 0), length - s)
    a, b = max(start, lo), min(start + s, lo + cache.shape[1])
    if a < b:
        cache[:, a - lo:b - lo] = (x if b - a == s
                                   else x[:, a - start:b - start])
    return cache


def _attn_block(x, p, cfg, mask_mode, prefix_len, cdt,
                kv_override=None, q_offset=None, cache=None,
                cache_len=None, stream=None, kv=None):
    """Pre-norm attention block over one layer's (unstacked) params.
    Returns (out, new_kv): on the decode path ``cache``, written in
    place at ``cache_len``, else this call's (k, v).  On one layer's
    blocks of a laid-out tree (``layers.Blocks``) it computes whole
    heads on the active mesh (:func:`_sharded_heads`).  ``stream``:
    ``x``'s block of the residual stream (the output's too);
    ``kv_override`` is whole; ``kv``: the cache's block of positions."""
    b = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = _entry(ly.rms_norm(x, p["ln_attn"], cfg.norm_eps), stream)
    s = h.shape[1]
    src = h if kv_override is None else kv_override
    specs = getattr(p, "specs", None)
    w = {n: p[n] for n in ("wq", "wk", "wv", "wo")}
    qblk = shd.seq_block((b, s, nh, hd), ("batch", "cp_q", "heads", None))
    if specs is not None:
        w, heads = _sharded_heads(p, cfg, cdt, qblk.axes + (
            kv.axes if kv is not None else ()))
    q = h @ w["wq"].to(cdt)
    k = src @ w["wk"].to(cdt)
    v = src @ w["wv"].to(cdt)
    if cfg.qkv_bias and "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if specs is not None:
        q, k, v, nh, nkv = heads(q, k, v)
    q = shd.seq_take(q, qblk).reshape(b, qblk.size, nh, hd)
    k = k.reshape(b, src.shape[1], nkv, hd)
    v = v.reshape(b, src.shape[1], nkv, hd)
    if mask_mode != "full" or kv_override is None:
        pos = torch.arange(s, device=x.device)
        if q_offset is not None:
            pos = q_offset + pos
        q = ly.rope(q, shd.seq_take(pos, qblk, 0)[None, :], cfg.rope_theta)
        if cache is None or kv_override is None:
            pos_k = (torch.arange(k.shape[1], device=x.device)
                     if cache is None else pos)
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
            new_cache = (cache_write(k_cache, kq, cache_len, kv),
                         cache_write(v_cache, vq, cache_len, kv),
                         cache_write(k_sc, ks, cache_len, kv),
                         cache_write(v_sc, vs, cache_len, kv))
            o = attn.decode_attention_q8(q, *new_cache, cache_len + s, kv)
        else:
            k_cache, v_cache = cache
            new_cache = (cache_write(k_cache, k, cache_len, kv),
                         cache_write(v_cache, v, cache_len, kv))
            o = attn.decode_attention(q, *new_cache, cache_len + s, kv)
    else:
        o = attn.attention(q, k, v, mask_mode, prefix_len,
                           q_offset=qblk.start, q_len=s)
        new_cache = (k, v)
    o = o.reshape(b, qblk.size, nh * hd)
    if specs is None:
        return o @ w["wo"].to(cdt), new_cache
    if qblk.axes:     # cp_q: this rank's q rows, from the whole wo
        out = (heads.out(o) if heads.local else
               o @ heads.wo_rows().to(cdt))
        return shd.seq_move(out, qblk, stream or shd.whole_seq(s)), \
            new_cache
    return heads.out(o, stream), new_cache


def _entry(h, stream):
    """A block's normed input whole: the sequence all-gathered from this
    rank's block ``stream`` (Megatron-SP's block entry)."""
    return h if stream is None else shd.seq_gather(h, stream)


class _Heads:
    """How one layer's attention runs on a laid-out tree: which heads
    this rank computes and how its projections and its output meet the
    other ranks'.  ``local``: its ``wq``/``wk``/``wv`` columns are whole
    heads and its q heads' kv heads are its own (the kv head count
    divides over the axis), so it attends alone to its block of the
    cache; otherwise each split projection is all-gathered over its
    axes before the head reshape and every rank attends to all heads
    (with the cache replicated).  Heads are never ``local`` over an axis
    a sequence layout of q or of the cache takes (``seq_axes``).
    ``wo``'s rows follow the q heads' split and one sum over the mesh
    ends the block."""

    def __init__(self, cfg, cdt, q_axes, kv_axes, o_axes, wo, seq_axes=()):
        mesh = shd.active_mesh()
        self.mesh, self.cdt, self.wo = mesh, cdt, wo
        free = not (set(q_axes) | set(kv_axes)) & set(seq_axes)
        n_kv = shd.axes_size(mesh, kv_axes) if kv_axes else 1
        self.local = bool(kv_axes) and cfg.n_kv % n_kv == 0 \
            and q_axes == kv_axes and free
        self.q_axes, self.kv_axes, self.o_axes = q_axes, kv_axes, o_axes
        n = n_kv if self.local else 1
        self.nh, self.nkv = cfg.n_heads // n, cfg.n_kv // n

    def __call__(self, q, k, v):
        if not self.local:
            q = ly.gather_last(q, self.q_axes, self.mesh)
            k = ly.gather_last(k, self.kv_axes, self.mesh)
            v = ly.gather_last(v, self.kv_axes, self.mesh)
        return q, k, v, self.nh, self.nkv

    def out(self, o, stream=None):
        """The block's output from this rank's attention ``o``: this
        rank's columns of ``o`` (all of them when local) times its rows
        of ``wo``, summed over ``wo``'s row axes (to this rank's block
        ``stream`` of the sequence)."""
        if self.o_axes and not self.local:
            k = shd.axes_size(self.mesh, self.o_axes)
            size = o.shape[-1] // k
            o = o.narrow(-1, shd.block_index(self.o_axes, self.mesh) * size,
                         size)
        return ly.row_parallel(o, self.wo, self.cdt, self.o_axes, stream)

    def wo_rows(self):
        """``wo`` with its rows gathered whole (``cp_q``: a rank's
        output rows are then its q block's, with no sum)."""
        return shd.gather_dim(self.wo, self.o_axes, 0, self.mesh)


def _sharded_heads(p, cfg, cdt, seq_axes=()):
    """One layer's projections of a laid-out tree in ``cdt`` with their
    ``fsdp`` dimension gathered, and its :class:`_Heads` (``seq_axes``:
    the mesh axes a sequence layout of q or of the cache takes)."""
    sp = p.specs
    names = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv"),
             "wv": ("fsdp", "kv"), "wo": ("heads", "fsdp")}
    w = {n: shd.gather_param(p[n].to(cdt), *ax, spec=sp[n])
         for n, ax in names.items()}
    mesh = shd.active_mesh()

    def axes(name, names, dim):
        shape = shd.global_shape(p[name].shape, sp[name], mesh)
        return ly.split_over(shd.resolve_spec(shape, names), dim)
    heads = _Heads(cfg, cdt, axes("wq", (None, "heads"), 1),
                   axes("wk", (None, "kv"), 1),
                   axes("wo", ("heads", None), 0), w["wo"], seq_axes)
    return w, heads


def _mlp_block(x, p, cfg, cdt, stream=None):
    h = _entry(ly.rms_norm(x, p["ln_mlp"], cfg.norm_eps), stream)
    specs = getattr(p, "specs", None)
    if specs is not None:
        specs = tuple(specs[n] for n in ("w_gate", "w_up", "w_down"))
    return ly.swiglu(h, p["w_gate"], p["w_up"], p["w_down"], cdt, specs,
                     stream)


def _moe_block(x, p, cfg, cdt, stream=None):
    h = _entry(ly.rms_norm(x, p["ln_mlp"], cfg.norm_eps), stream)
    return moe_mod.moe_block(h, p, cfg, cdt, stream)


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
                   enc_out=None, stream=None):
    """One decoder layer (the training/prefill path); ``x`` this rank's
    block ``stream`` of the residual stream."""
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        h = _entry(ly.rms_norm(x, lp["ln"], cfg.norm_eps), stream)
        return x + ssm_mod.mamba2_block(h, lp, cfg, cdt, stream)
    a, _ = _attn_block(x, lp, cfg, mask_mode, prefix_len, cdt,
                       stream=stream)
    x = x + a
    if fam == "encdec" and enc_out is not None:
        xa, _ = _attn_block(x, _cross(lp), cfg, "full", 0, cdt,
                            kv_override=enc_out, stream=stream)
        x = x + xa
    if fam == "moe":
        return x + _moe_block(x, lp, cfg, cdt, stream)
    return x + _mlp_block(x, lp, cfg, cdt, stream)


def _shared_due(cfg, idx: int) -> bool:
    return (cfg.family == "hybrid" and bool(cfg.attn_every)
            and (idx + 1) % cfg.attn_every == 0)


def _no_tap(name, x):
    return x


def _remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat``
    asks for it and a backward pass can follow.  The recomputation
    runs in the backward pass, outside this call's (mesh, rules) and
    on the autograd engine's thread for a card: it re-enters them, so
    on a laid-out tree it issues the forward's collectives again, in
    the same order on every rank."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        mesh, rules = shd.active_mesh(), shd.active_rules()

        def run(*a):
            with shd.use_mesh(mesh, rules):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(run, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _shared_params(params):
    """zamba2's shared block: its weights, with their specs on a
    laid-out tree (the block has no layer axis)."""
    shared = params.get("shared_attn")
    if shared is None or not isinstance(params, shd.LaidOutTree):
        return shared
    return ly.Blocks(shared, params.specs["shared_attn"])


def _shared_block(x, shared, cfg, cdt, mask_mode, prefix_len,
                  stream=None):
    """zamba2's shared attention + MLP block."""
    a, _ = _attn_block(x, shared, cfg, mask_mode, prefix_len, cdt,
                       stream=stream)
    x = x + a
    return x + _mlp_block(x, shared, cfg, cdt, stream)


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
                enc_out=None, tap=_no_tap, stream=None):
    layers = _unstack(params, _layer_keys(params, cfg))
    shared = _shared_params(params)
    for i in range(cfg.n_layers):
        x = tap(f"layer{i}", _remat(
            cfg, _decoder_block, x, layers[i], cfg, cdt,
            mask_mode, prefix_len, enc_out, stream))
        if _shared_due(cfg, i):
            x = tap(f"shared{i}", _remat(cfg, _shared_block, x, shared,
                                         cfg, cdt, mask_mode, prefix_len,
                                         stream))
    return x


# ---------------------------------------------------------------------------
# public forward passes
# ---------------------------------------------------------------------------

def stream_layout(shape, mesh=None, rules=None):
    """This rank's block of the residual stream ``[B, S, d]`` (a
    ``sharding.SeqBlock`` of dimension 1) under ``(mesh, rules)`` (the
    active pair when omitted): ``("batch", "cp_seq", "embed")`` where
    it splits the sequence, else ``("batch", "seq", "embed")``."""
    blk = shd.seq_block(shape, ("batch", "cp_seq", "embed"), 1, mesh,
                        rules)
    if blk.axes:
        return blk
    return shd.seq_block(shape, ("batch", "seq", "embed"), 1, mesh, rules)


def logits_layout(shape, mesh=None, rules=None):
    """The logits' block of positions: ``("batch", "seq", "vocab")``
    on their shape ``[B, S, V]``."""
    return shd.seq_block(shape, ("batch", "seq", "vocab"), 1, mesh, rules)


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


def embed_tokens(params, cfg, tokens, cdt, seq=None):
    """Rows of the embedding table.  jnp indexing clamps an id past the
    table; here an id outside ``[0, vocab_padded)`` is an error.  Ids on
    the host are checked at once (``ValueError``); ids on the card by an
    asynchronous device assert, which reads nothing back and fails the
    next synchronising call.  On a vocab-split table each rank takes
    the ids in its rows and zeros for the others, and one sum over the
    mesh gives every rank the rows (exact: one term is nonzero).  With
    ``seq`` (a ``sharding.SeqBlock`` of the ids' positions) the rows of
    this rank's block: where the vocab's axes are the block's, the sum
    is a reduce-scatter (``layers.reduce_to_seq``)."""
    n = vocab_rows(params)
    ok = ((tokens >= 0) & (tokens < n)).all()
    if tokens.is_meta:
        pass
    elif tokens.device.type == "cpu":
        if not bool(ok):
            raise ValueError(f"token id out of range [0, {n})")
    else:
        torch._assert_async(ok, f"token id out of range [0, {n})")
    axes = (ly.split_over(params.specs["embed"], 0)
            if isinstance(params, shd.LaidOutTree) else ())
    if not axes:
        if seq is not None:
            tokens = shd.seq_take(tokens, seq)
        return params["embed"][tokens].to(cdt)
    table = params["embed"]
    rows = table.shape[0]
    if seq is not None and not set(seq.axes) & set(axes):
        tokens, seq = shd.seq_take(tokens, seq), None
    local = tokens - shd.block_index(axes, params.mesh) * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=table.dtype,
                                device=table.device))
    return ly.reduce_to_seq(x.to(cdt), axes, seq)


def logits_out(params, cfg, x, cdt):
    """Logits ``[..., vocab_padded]``; on a vocab-split head table this
    rank's block ``[..., vocab_padded / S]`` of them."""
    x = ly.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cdt).T
    return x @ params["unembed"].to(cdt)


def _encode(params, cfg, frames, cdt, tap=_no_tap):
    """Whisper encoder over stub frame embeddings [B, T_enc, d]; its
    output whole (gathered from the encoder's stream once)."""
    stream = stream_layout(frames.shape)
    x = shd.seq_take(frames.to(cdt) + params["enc_pos"].to(cdt)[None],
                     stream)
    names = ("wq", "wk", "wv", "wo", "ln_attn", "w_gate", "w_up",
             "w_down", "ln_mlp")
    enc = {k: params["enc_" + k] for k in names}
    if isinstance(params, shd.LaidOutTree):
        enc = shd.LaidOutTree(enc, {k: params.specs["enc_" + k]
                                    for k in names}, params.mesh,
                              params.rules)
    layers = _unstack(enc, names)
    for i in range(cfg.n_enc_layers):
        x = tap(f"enc{i}", _remat(cfg, _enc_block, x, layers[i], cfg, cdt,
                                  stream))
    return shd.seq_gather(x, stream)


def _enc_block(x, lp, cfg, cdt, stream=None):
    a, _ = _attn_block(x, lp, cfg, "full", 0, cdt, stream=stream)
    x = x + a
    return x + _mlp_block(x, lp, cfg, cdt, stream)


def _on_tree(params, cfg):
    """The context a pass over ``params`` runs in: its mesh and rules
    active for a laid-out tree (``sharding.use_mesh``), nothing for a
    global one."""
    if isinstance(params, shd.LaidOutTree):
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
    of it where the batch is not split, and every position.  Each gets
    its rows' block of the logits (``[B_rank, S, vocab_padded / S]`` on
    a vocab-split head; the positions of :func:`logits_layout` where
    ``seq`` splits them).  Under a sequence layout ``tap`` sees and
    returns this rank's block of the stream (:func:`stream_layout`)."""
    with _on_tree(params, cfg):
        return _forward(params, cfg, tokens, frontend, tap)


def _forward(params, cfg, tokens, frontend, tap):
    tap = tap or _no_tap
    cdt = _dt(cfg)
    b, s = tokens.shape
    mask_mode, prefix_len, enc_out = "causal", 0, None
    front = cfg.family == "vlm" and frontend is not None
    n_front = cfg.img_tokens if front else 0
    stream = stream_layout((b, n_front + s, cfg.d_model))
    if front:
        x = torch.cat([frontend.to(cdt),
                       embed_tokens(params, cfg, tokens, cdt)], dim=1)
        x = shd.seq_take(x, stream)
        mask_mode, prefix_len = "prefix", cfg.img_tokens
    else:
        x = embed_tokens(params, cfg, tokens, cdt, stream)
    x = tap("embed", x)
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, frontend, cdt, tap)
    x = _run_layers(x, params, cfg, cdt, mask_mode, prefix_len, enc_out,
                    tap, stream)
    out = logits_layout((b, s, cfg.vocab_padded))
    if front or out.axes != stream.axes:
        x = shd.seq_gather(x, stream)[:, n_front:]
        x = shd.seq_take(x, out)
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
    batch), returned as a ``sharding.LaidOutTree`` that carries each
    tensor's spec (``kvseq`` splits the positions of ``k``/``v`` and of
    the int8 scales alike).  On ``"meta"``: shapes only."""
    dev = (torch.device(device) if str(device) == "meta"
           else _device(device))
    cdt = _dt(cfg)
    nkv, hd = cfg.n_kv, cfg.head_dim
    axes = cache_axes(cfg)
    rules = rules if rules is not None else shd.default_rules()
    specs: Dict[str, Any] = {}

    def mk(shape, dtype, name):
        if mesh is not None:
            specs[name] = shd.resolve_spec(shape, axes[name], mesh, rules)
            shape = shd.local_shape(shape, specs[name], mesh)
        if dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
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
    if mesh is None:
        return cache
    return shd.LaidOutTree(cache, specs, mesh, rules)


def _cache_seq(cache, params):
    """The block of positions (dimension 2 of the stacked ``k``) this
    rank's cache holds: from the specs a laid-out cache carries; a
    plain dict of blocks must hold every position (its layout is not
    known), which the tree's rules must then leave whole."""
    if "k" not in cache or not isinstance(params, shd.LaidOutTree):
        return None
    mesh, k = params.mesh, cache["k"]
    if isinstance(cache, shd.LaidOutTree):
        axes = ly.split_over(cache.specs["k"], 2)
        if not axes:
            return None
        size = k.shape[2]
        return shd.SeqBlock(axes, size * shd.axes_size(mesh, axes),
                            shd.block_index(axes, mesh) * size, size)
    names = ("layers", "batch", "kvseq", "kv", None)
    if ly.split_over(shd.resolve_spec(k.shape, names, mesh, params.rules),
                     2):
        raise ValueError("the tree's rules split the cache's positions "
                         "(kvseq): pass the cache init_cache(..., mesh=) "
                         "lays out, which carries its layout")
    return None


def decode_step(params, cfg: ModelConfig, tokens, cache,
                cache_len: int):
    """One decode step: tokens [B, 1] + cache -> (logits [B, 1, V],
    new cache).  ``cache_len``: the filled length before this step.
    The cache passed in is left as it was: each stacked tensor the step
    writes is copied once, and the layers write into the copy.  On a
    laid-out tree every rank of its mesh must call this with its rows of
    ``tokens`` and the cache ``init_cache(..., mesh=)`` lays out (under
    ``kvseq``, its block of positions); each gets its rows' block of the
    logits, as :func:`forward`, and the cache in the layout it was
    given."""
    with _on_tree(params, cfg):
        return _decode_step(params, cfg, tokens, cache, cache_len)


def _decode_step(params, cfg, tokens, cache, cache_len):
    cdt = _dt(cfg)
    x = embed_tokens(params, cfg, tokens, cdt)
    keys = _layer_keys(params, cfg)
    fam = cfg.family
    kv = _cache_seq(cache, params)
    written = [k for k in ("k", "v", "k_sc", "v_sc", "ssm", "conv")
               if k in cache]
    copy = {k: (v.clone() if k in written else v) for k, v in cache.items()}
    if isinstance(cache, shd.LaidOutTree):
        copy = shd.LaidOutTree(copy, cache.specs, cache.mesh, cache.rules)
    cache = copy

    if fam in ("dense", "vlm", "encdec", "moe"):
        names = (("k", "v", "k_sc", "v_sc") if "k_sc" in cache
                 else ("k", "v"))
        for i in range(cfg.n_layers):
            lp = _layer(params, keys, i)
            a, _ = _attn_block(
                x, lp, cfg, "causal", 0, cdt, q_offset=cache_len,
                cache=tuple(cache[n][i] for n in names),
                cache_len=cache_len, kv=kv)
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
                    cache_len=cache_len, kv=kv)
                j += 1
                x = x + a
                x = x + _mlp_block(x, shared, cfg, cdt)

    return logits_out(params, cfg, x, cdt), cache
