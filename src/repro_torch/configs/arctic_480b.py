"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, n_experts=128, top_k=2, dense_residual_ff=4864,
    splay_vocab_tier=True)
