"""head_select: fused classifier head + OoD detector + top-k soft label.

Replaces the Pallas TPU kernel ``head_select_pallas`` (body
``_head_kernel``) of ``src/repro/kernels/head_select/kernel.py``. From
pre-head activations ``hidden`` (L, N, D), per-node heads ``w`` (L, D, C)
and ``bias`` (L, C) it returns, per node and row:

* ``conf`` (L, N) f32 — detector confidence at T=1: MSP ``max softmax``
  or energy ``logsumexp``;
* ``vals`` (L, N, k) f32 — the top-k of ``softmax(logits / T)``,
  renormalized over the top-k;
* ``idx`` (L, N, k) int32 — their class indices, ties to the lowest.

The CUDA kernel (``csrc/head_select.cu``, whose header note gives the
design and what bounds it on the H100) never writes the (N, C) logits to
memory; one launch covers all L nodes. :func:`head_select` runs the
kernel on CUDA tensors
and :func:`head_select_plain` — the same function in plain PyTorch — on
CPU tensors only; a CUDA call that the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distill import top_k
from repro_torch.kernels import build

DETECTORS = ("msp", "energy")
KMAX = 16            # largest k the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def head_select_plain(hidden, w, bias=None, *, temperature: float, k: int,
                      detector: str = "msp"):
    """The plain PyTorch version: materializes the logits in f32."""
    logits = torch.matmul(hidden.float(), w.float())
    if bias is not None:
        logits = logits + bias.float().unsqueeze(-2)
    if detector == "energy":
        conf = torch.logsumexp(logits, dim=-1)
    else:
        conf = torch.softmax(logits, dim=-1).max(dim=-1).values
    vals, idx = top_k(logits, k)
    return conf, torch.softmax(vals / temperature, dim=-1), idx.to(torch.int32)


def _fn():
    fn = build.load("head_select").head_select_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, i, i, i, i, i, ctypes.c_float, i,
                       p, p, p, p]
        fn.restype = i
    return fn


def head_select(hidden, w, bias=None, *, temperature: float = 10.0,
                k: int = 8, detector: str = "msp"):
    if detector not in DETECTORS:
        raise ValueError(f"unknown detector {detector!r}")
    if hidden.device.type == "cpu":
        return head_select_plain(hidden, w, bias, temperature=temperature,
                                 k=k, detector=detector)
    if hidden.device.type != "cuda":
        raise ValueError(f"head_select: unsupported device {hidden.device}")
    L, N, D = hidden.shape
    C = w.shape[-1]
    if w.shape != (L, D, C):
        raise ValueError(f"head_select: w {tuple(w.shape)} does not match "
                         f"hidden {tuple(hidden.shape)}")
    if hidden.dtype not in _DTYPES or w.dtype != hidden.dtype:
        raise TypeError(f"head_select kernel takes float32 or bfloat16 "
                        f"hidden and w of one dtype, got {hidden.dtype}, "
                        f"{w.dtype}")
    if not 1 <= k <= min(KMAX, C):
        raise ValueError(f"head_select kernel takes 1 <= k <= min(16, C), "
                         f"got k={k}, C={C}")
    if bias is not None:
        if bias.shape != (L, C):
            raise ValueError(f"head_select: bias {tuple(bias.shape)} is "
                             f"not ({L}, {C})")
        bias = bias.float().contiguous()
    for name, t in (("hidden", hidden), ("w", w), ("bias", bias)):
        if t is not None and (t.device != hidden.device
                              or not t.is_contiguous()):
            raise ValueError(f"head_select: {name} must be contiguous on "
                             f"{hidden.device}")
    dev = hidden.device
    conf = torch.empty((L, N), device=dev)
    vals = torch.empty((L, N, k), device=dev)
    idx = torch.empty((L, N, k), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        rc = _fn()(
            _DTYPES[hidden.dtype], hidden.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), L, N, D, C, k,
            float(temperature), int(detector == "energy"), conf.data_ptr(),
            vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"head_select kernel launch failed: CUDA error "
                           f"{rc}")
    head_select.launches += 1
    return conf, vals, idx


head_select.launches = 0
