from repro_torch.configs.base import (IDKDConfig, ModelConfig,  # noqa: F401
                                     TrainConfig)
