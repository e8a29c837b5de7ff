"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].  The shared transformer block (zamba2's
signature weight-sharing trick) is applied every 6 Mamba2 blocks."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_head_dim=64, attn_every=6,
    splay_vocab_tier=True)
