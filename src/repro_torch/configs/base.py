"""Model configuration: the port's copy of ``ModelConfig`` (one record
for any architecture of the pool: dense / GQA / MoE / SSM / hybrid /
enc-dec / VLM) and of ``smoke_variant``, the reduced same-family config
the CPU tests use.  Field names, defaults and derived sizes
(``vocab_padded``, ``head_dim``, ``n_params``) are the JAX package's.
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv: int                   # GQA kv heads (n_heads for MHA, 1 for MQA)
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE layer every k-th layer (1 = all)
    dense_residual_ff: int = 0  # arctic: parallel dense MLP next to MoE
    capacity_factor: float = 1.25

    # -- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # -- hybrid (zamba2): shared attention block every k SSM blocks ---------
    attn_every: int = 0         # 0 = no interleaved attention

    # -- enc-dec (whisper backbone; conv frontend is a stub per assignment) --
    n_enc_layers: int = 0
    enc_positions: int = 0      # encoder frames (whisper: 1500)

    # -- VLM (paligemma; SigLIP frontend is a stub per assignment) ----------
    img_tokens: int = 0

    # -- adaptive embedding tier (the splay-list feature; DESIGN.md §3) -----
    splay_vocab_tier: bool = False
    hot_vocab: int = 4096       # hot-buffer rows when tiering is on

    # -- numerics / training -------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (per-token scales)
    remat: str = "block"        # none | block | full
    scan_layers: bool = True
    force_full_attn: bool = False   # probe path: no blockwise kv scan

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:   # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Parameter count (embedding included once if tied)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_padded
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv
        per_attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        if self.qkv_bias:
            per_attn += (nh + 2 * nkv) * hd
        per_mlp = 3 * d * ff                      # gated SwiGLU
        per_moe = 0
        if self.n_experts:
            per_moe = self.n_experts * 3 * d * ff + d * self.n_experts
            if self.dense_residual_ff:
                per_moe += 3 * d * self.dense_residual_ff
        per_ssm = 0
        if self.ssm_state:
            di, ns = self.d_inner, self.ssm_state
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            per_ssm = d * (2 * di + 2 * ns + self.ssm_heads) + di * d
            per_ssm += self.conv_width * (di + 2 * ns)
            per_ssm += 2 * self.ssm_heads
        total = 0
        if self.family in ("dense", "vlm", "encdec"):
            total += self.n_layers * (per_attn + per_mlp)
        elif self.family == "moe":
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            total += n_moe * (per_attn + per_moe) + n_dense * (per_attn + per_mlp)
        elif self.family == "ssm":
            total += self.n_layers * per_ssm
        elif self.family == "hybrid":
            n_attn = (self.n_layers // self.attn_every
                      if self.attn_every else 0)
            total += self.n_layers * per_ssm
            total += (per_attn + per_mlp)          # ONE shared attn block
        if self.family == "encdec":
            total += self.n_enc_layers * (per_attn + per_mlp)
            total += self.n_layers * per_attn      # cross-attention
        total += v * d                              # embedding
        if not self.tie_embeddings:
            total += v * d
        total += 2 * self.n_layers * d              # norms (approx)
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        per_expert = 3 * d * ff
        inactive = (self.n_layers // self.moe_every) * (
            self.n_experts - self.top_k) * per_expert
        return self.n_params() - inactive


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, small
    width/experts/vocab, same structural features."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else 4),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv else 0,
        d_head=32 if cfg.n_heads else 0,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        dense_residual_ff=128 if cfg.dense_residual_ff else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_every=2 if cfg.attn_every else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_positions=32 if cfg.enc_positions else 0,
        img_tokens=8 if cfg.img_tokens else 0,
        hot_vocab=64,
        dtype="float32", param_dtype="float32")
