"""whisper-large-v3 [audio enc-dec]: 32L d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866 [arXiv:2212.04356; unverified].  The conv/mel
frontend is a STUB per the assignment: input_specs provides precomputed
frame embeddings [B, 1500, d_model]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51866, n_enc_layers=32, enc_positions=1500,
    splay_vocab_tier=True)
