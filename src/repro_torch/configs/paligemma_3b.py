"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma [arXiv:2407.07726; hf].  The SigLIP vision
tower is a STUB per the assignment: input_specs provides precomputed
patch embeddings [B, 256, d_model]; prefix-LM masking over the image
tokens."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384,
    vocab=257216, d_head=256, img_tokens=256, splay_vocab_tier=True)
