"""Config registry: ``get_config(arch_id, shape)`` over the architectures
this package runs (the reference's registry, cut to them), with the
reference's long-context variants and its assigned shape table."""
from __future__ import annotations

from repro_torch.configs import (hymba_1_5b, mamba2_780m, mistral_nemo_12b,
                                 musicgen_medium, paligemma_3b,
                                 phi3_mini_3_8b, qwen1_5_0_5b, qwen3_1_7b,
                                 resnet20_cifar)
from repro_torch.configs.base import (SHAPES, IDKDConfig,  # noqa: F401
                                      MLAConfig, ModelConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, TrainConfig)

# in the reference's order, without Arctic and DeepSeek-V3 (ROADMAP.md
# item 10c)
ARCHS = {
    "mamba2-780m": mamba2_780m.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "resnet20-cifar": resnet20_cifar.CONFIG,
}

# Variants substituted for specific input shapes, as the reference's.
LONG_CONTEXT_VARIANTS = {
    "mistral-nemo-12b": mistral_nemo_12b.LONG_CONFIG,
}

ASSIGNED_ARCHS = [k for k in ARCHS if k != "resnet20-cifar"]


def get_config(arch_id: str, shape: str | None = None) -> ModelConfig:
    """Resolve an ``--arch`` id (optionally specialized for a shape)."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    if shape == "long_500k" and arch_id in LONG_CONTEXT_VARIANTS:
        return LONG_CONTEXT_VARIANTS[arch_id]
    return ARCHS[arch_id]


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rule: long_500k needs sub-quadratic attention/decode state."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
