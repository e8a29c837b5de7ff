"""Architecture registry: --arch <id> -> ModelConfig (the port's copy of
the JAX package's registry).

Exact configs from the assignment (sources inline in each record);
smoke variants are reduced same-family configs for CPU tests.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, smoke_variant
from repro_torch.configs import (
    qwen2_0_5b, qwen1_5_110b, minitron_8b, stablelm_3b, zamba2_7b,
    whisper_large_v3, paligemma_3b, arctic_480b, phi35_moe, mamba2_1_3b)

ARCHS = {
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "qwen1.5-110b": qwen1_5_110b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "stablelm-3b": stablelm_3b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
}


def get(arch: str) -> ModelConfig:
    return ARCHS[arch]


def get_smoke(arch: str) -> ModelConfig:
    return smoke_variant(ARCHS[arch])


def sub_quadratic(cfg: ModelConfig) -> bool:
    """long_500k applicability: SSM/hybrid archs only (DESIGN.md §6)."""
    return cfg.family in ("ssm", "hybrid")
