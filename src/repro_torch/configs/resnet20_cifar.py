"""resnet20-evonorm — the paper's own model.

Source: IDKD paper §4.1 — ResNet20 (He et al., 2016) with BatchNorm
replaced by EvoNorm (Liu et al., 2020a). 3 stages × 3 basic blocks,
width 16.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet20-evonorm",
    arch_type="cnn",
    source="IDKD paper §4.1 (ResNet20 + EvoNorm-B0)",
    cnn_stages=(3, 3, 3),
    cnn_width=16,
    image_size=32,
    image_channels=3,
    num_classes=10,
    dtype="float32",
    scan_layers=False,
    remat=False,
)

# Small variant for fast experiments (same family, fewer blocks).
SMALL_CONFIG = CONFIG.replace(name="resnet8-evonorm", cnn_stages=(1, 1, 1))
