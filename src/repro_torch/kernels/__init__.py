"""Hand-written Hopper kernels, one package per kernel of the reference:
the wrapper, its launch counter and its plain PyTorch version side by
side. CUDA sources live in ``repro_torch/csrc`` (see ``build``)."""


def forbid_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a call to an inference-only kernel:
    ``head_select`` and ``msp_select`` have no backward in either package,
    and their outputs (confidences, top-k) must not silently cut the
    graph of a caller that wants gradients."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is inference-only (no backward): call it under "
            "torch.no_grad() or on tensors that do not require grad")
