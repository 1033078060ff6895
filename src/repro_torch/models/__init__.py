from repro_torch.models.model import build_model  # noqa: F401
from repro_torch.models.resnet import ResNetModel  # noqa: F401
