"""Hand-written Hopper kernels, one package per kernel of the reference:
the wrapper, its launch counter and its plain PyTorch version side by
side. CUDA sources live in ``repro_torch/csrc`` (see ``build``)."""
