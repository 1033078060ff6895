"""Config registry: ``get_config(arch_id)`` over the architectures this
package runs (the reference's registry, cut to them), with the
reference's long-context variants."""
from __future__ import annotations

from repro_torch.configs import (hymba_1_5b, mamba2_780m, mistral_nemo_12b,
                                 musicgen_medium, paligemma_3b,
                                 phi3_mini_3_8b, qwen1_5_0_5b, qwen3_1_7b,
                                 resnet20_cifar)
from repro_torch.configs.base import (IDKDConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, SSMConfig,
                                      TrainConfig)

ARCHS = {
    "mamba2-780m": mamba2_780m.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
    "paligemma-3b": paligemma_3b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "resnet20-cifar": resnet20_cifar.CONFIG,
}

# Variants substituted for specific input shapes, as the reference's.
LONG_CONTEXT_VARIANTS = {
    "mistral-nemo-12b": mistral_nemo_12b.LONG_CONFIG,
}


def get_config(arch_id: str) -> ModelConfig:
    """Resolve an ``--arch`` id."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
