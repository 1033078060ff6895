from repro_torch.models.resnet import ResNetModel, build_model  # noqa: F401
