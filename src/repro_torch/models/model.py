"""``build_model(cfg)`` — one entry point over the ported families."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.resnet import ResNetModel
from repro_torch.models.transformer import DecoderModel


def build_model(cfg: ModelConfig):
    if cfg.arch_type == "cnn":
        return ResNetModel(cfg)
    return DecoderModel(cfg)
