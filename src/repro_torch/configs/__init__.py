"""Config registry: ``get_config(arch_id)`` over the architectures this
package runs (the reference's registry, cut to them)."""
from __future__ import annotations

from repro_torch.configs import hymba_1_5b, mamba2_780m, resnet20_cifar
from repro_torch.configs.base import (IDKDConfig, MLAConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, SSMConfig,
                                      TrainConfig)

ARCHS = {
    "mamba2-780m": mamba2_780m.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "resnet20-cifar": resnet20_cifar.CONFIG,
}


def get_config(arch_id: str) -> ModelConfig:
    """Resolve an ``--arch`` id."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
