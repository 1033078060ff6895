"""msp_select: one pass over logit rows -> detector confidence + top-k.

Replaces the Pallas TPU kernel ``msp_select_pallas`` (body
``_msp_kernel``) of ``src/repro/kernels/msp_select/kernel.py``. From
logits (N, C) it returns ``conf`` (N,) f32 — MSP ``max softmax`` or
energy ``logsumexp`` at T=1 — and the top-k of ``softmax(logits / T)``
renormalized over the top-k, ``vals`` (N, k) f32 and ``idx`` (N, k)
int32, ties to the lowest index.

The CUDA kernel (``csrc/msp_select.cu``, whose header note gives the
design and what bounds it on the H100) streams each row once.
:func:`msp_select` runs it on CUDA tensors and :func:`msp_select_plain`
— the same function in plain PyTorch — on CPU tensors only; a CUDA call
that the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distill import top_k
from repro_torch.kernels import build, forbid_grad

DETECTORS = ("msp", "energy")
KMAX = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def msp_select_plain(logits, *, temperature: float, k: int,
                     detector: str = "msp"):
    """The plain PyTorch version: two softmaxes over the f32 row."""
    lf = logits.float()
    if detector == "energy":
        conf = torch.logsumexp(lf, dim=-1)
    else:
        conf = torch.softmax(lf, dim=-1).max(dim=-1).values
    vals, idx = top_k(torch.softmax(lf / temperature, dim=-1), k)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return conf, vals, idx.to(torch.int32)


def _fn():
    fn = build.load("msp_select").msp_select_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, i, ctypes.c_float, i, p, p, p, p]
        fn.restype = i
    return fn


def msp_select(logits, *, temperature: float = 10.0, k: int = 8,
               detector: str = "msp"):
    if detector not in DETECTORS:
        raise ValueError(f"unknown detector {detector!r}")
    forbid_grad("msp_select", logits)
    if logits.device.type == "cpu":
        return msp_select_plain(logits, temperature=temperature, k=k,
                                detector=detector)
    if logits.device.type != "cuda":
        raise ValueError(f"msp_select: unsupported device {logits.device}")
    if logits.dim() != 2:
        raise ValueError(f"msp_select kernel takes (N, C) logits, got "
                         f"{tuple(logits.shape)}")
    N, C = logits.shape
    if logits.dtype not in _DTYPES:
        raise TypeError(f"msp_select kernel takes float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    if not 1 <= k <= min(KMAX, C):
        raise ValueError(f"msp_select kernel takes 1 <= k <= min(16, C), "
                         f"got k={k}, C={C}")
    if not logits.is_contiguous():
        raise ValueError("msp_select: logits must be contiguous")
    dev = logits.device
    conf = torch.empty((N,), device=dev)
    vals = torch.empty((N, k), device=dev)
    idx = torch.empty((N, k), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        rc = _fn()(_DTYPES[logits.dtype], logits.data_ptr(), N, C, k,
                   float(temperature), int(detector == "energy"),
                   conf.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"msp_select kernel launch failed: CUDA error "
                           f"{rc}")
    msp_select.launches += 1
    return conf, vals, idx


msp_select.launches = 0
