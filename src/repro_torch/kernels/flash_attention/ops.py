"""flash_attention: causal grouped-query attention with a sliding window.

Replaces the Pallas TPU kernel ``flash_attention_pallas`` (body
``_flash_kernel``) of ``src/repro/kernels/flash_attention/kernel.py``,
and computes what the decoder's ``chunked_attention`` computes on its
path: q (B, S, H, D), k/v (B, S, KVH, D), head h reading kv head
h // (H // KVH); key kp is visible to row qp iff kp <= qp and, for
``window`` > 0, qp - window < kp. f32 math, q scaled by 1/sqrt(D) first,
output in q's dtype.

Two CUDA kernels compute it, neither forming the (S, S) scores; their
header notes give each design and what bounds it on the H100:
``csrc/flash_attention_tc.cu`` (``tc``: bf16 at head_dim 64 or 128, on
the tensor cores) and ``csrc/flash_attention.cu`` (``simt``: f32, and
bf16 at head_dim 32). :func:`_variant` picks one from dtype and head_dim
alone; :func:`flash_attention` runs it on CUDA tensors and counts the
launch in ``launches`` and ``launches_by_variant``, and
:func:`flash_attention_plain` — the reference's chunked online softmax in
plain PyTorch — runs on CPU tensors only; a CUDA call that no kernel
takes raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, window: int = 0, chunk: int = 512):
    """The plain PyTorch version: ``chunked_attention``'s online softmax
    over ``chunk``-long key blocks, masked with -1e30 as the reference
    masks."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / torch.sqrt(torch.tensor(float(D)))
    qf = q.reshape(B, S, KVH, G, D).float() * scale
    q_pos = torch.arange(S, device=q.device)
    n_chunks = -(-S // chunk)
    m = torch.full((B, S, KVH, G), NEG_INF, device=q.device)
    l = torch.zeros((B, S, KVH, G), device=q.device)
    acc = torch.zeros((B, S, KVH, G, v.shape[-1]), device=q.device)
    for c in range(n_chunks):
        kc = k[:, c * chunk:(c + 1) * chunk].float()
        vc = v[:, c * chunk:(c + 1) * chunk].float()
        k_pos = c * chunk + torch.arange(kc.shape[1], device=q.device)
        allow = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            allow = allow & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc)
        s = torch.where(allow[None, :, None, None, :], s,
                        torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, -1).to(q.dtype)


def _variant(dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): ``"tc"`` (tensor cores)
    for bf16 at head_dim 64 or 128, ``"simt"`` for f32 and for bf16 at
    head_dim 32; anything else raises."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {head_dim}")
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def _fn(variant: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant == "tc":
        fn = build.load("flash_attention_tc").flash_attention_tc_launch
        args = [p, p, p, p, i, i, i, i, i, i, p]
    else:
        fn = build.load("flash_attention").flash_attention_launch
        args = [i, p, p, p, p, i, i, i, i, i, i, p]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = i
    return fn


def _launch(variant: str, q, k, v, window: int):
    """Run one kernel on checked CUDA tensors and count the launch."""
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (B, S, H, k.shape[2], D, int(window), stream)
    with torch.cuda.device(q.device):
        if variant == "tc":
            rc = _fn("tc")(*ptrs, *shape)
        else:
            rc = _fn("simt")(_DTYPES[q.dtype], *ptrs, *shape)
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch "
                           f"failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


def flash_attention(q, k, v, *, window: int = 0, chunk: int = 512):
    """Causal GQA attention with a per-layer ``window`` (0 = full).
    ``chunk`` is the plain version's key block; the kernels tile keys by
    64 (``simt``) or 128 (``tc``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: the kernel "
                         f"takes self-attention with k, v (B, S, KVH, D)")
    if KVH < 1 or H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} kv heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    variant = _variant(q.dtype, D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")
        if variant == "tc" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary (TMA)")
    return _launch(variant, q, k, v, window)


flash_attention.launches = 0
flash_attention.launches_by_variant = {"tc": 0, "simt": 0}
