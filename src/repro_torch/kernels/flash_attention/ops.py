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

The backward pass. With grad enabled and an input that requires grad,
:func:`flash_attention` on CUDA tensors goes through
:class:`FlashAttentionFn`: its forward launches the same kernel with the
rows' log-sum-exp written to a (B, H, S) f32 buffer (under
``torch.no_grad`` the kernel is passed no buffer and writes nothing
more), and its backward is :func:`flash_attention_bwd`
(FlashAttention-2's formulas) on CUDA tensors and
:func:`flash_attention_bwd_plain` on CPU tensors. The backward has the
forward's two variants, picked by the same :func:`_variant`:
``csrc/flash_attention_bwd_tc.cu`` (``tc``: bf16 at head_dim 64 or 128,
P and dS rounded to bf16 as the tensor cores' operands, which
``flash_attention_bwd_plain(..., operands="bf16")`` reproduces) and
``csrc/flash_attention_bwd.cu`` (``simt``: f32 math). The JAX package
has no backward kernel (its training differentiates
``chunked_attention``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)
TC_BWD_TILE = 64       # the tc backward's key and query tile
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


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, window: int = 0,
                              chunk: int = 512, operands: str = "f32"):
    """The plain PyTorch version of the backward pass, the explicit
    FlashAttention-2 formulas: D = rowsum(dO∘O); P = exp(Q·Kᵀ·scale −
    lse) under the forward's causal / window mask; dV = Pᵀ·dO;
    dS = P∘(dO·Vᵀ − D); dQ = dS·K·scale; dK = dSᵀ·Q·scale; dK and dV
    summed over each KV head's group. ``lse`` (B, H, S) f32 is the
    forward's row log-sum-exp of the scaled scores. Query rows run in
    ``chunk``-long blocks; math in f32 (or float64 inputs' float64),
    gradients in q's dtype. ``operands="bf16"`` rounds P and dS to bf16
    before the products that take them (dV, dK, dQ), as the ``tc``
    kernel feeds them to the tensor cores; sums stay in the working
    dtype. ``"f32"`` rounds nothing."""
    if operands not in ("f32", "bf16"):
        raise ValueError(f"operands must be 'f32' or 'bf16', got "
                         f"{operands!r}")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / float(D) ** 0.5
    qf = q.to(wd).reshape(B, S, KVH, G, D)
    kf, vf = k.to(wd), v.to(wd)
    dof = do.to(wd).reshape(B, S, KVH, G, D)
    delta = (do.to(wd) * o.to(wd)).sum(-1).reshape(B, S, KVH, G)
    lsef = lse.to(wd).permute(0, 2, 1).reshape(B, S, KVH, G)
    pos = torch.arange(S, device=q.device)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in range(0, S, chunk):
        rows = pos[c0:c0 + chunk]
        allow = pos[None, :] <= rows[:, None]
        if window > 0:
            allow = allow & (rows[:, None] - pos[None, :] < window)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf[:, c0:c0 + chunk], kf)
        p = torch.exp(s * scale - lsef[:, c0:c0 + chunk, ..., None])
        p = torch.where(allow[None, :, None, None, :], p, 0.0)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof[:, c0:c0 + chunk], vf)
        ds = p * (dp - delta[:, c0:c0 + chunk, ..., None])
        if operands == "bf16":
            p = p.to(torch.bfloat16).to(wd)
            ds = ds.to(torch.bfloat16).to(wd)
        dv += torch.einsum("bqhgk,bqhgd->bkhd", p, dof[:, c0:c0 + chunk])
        dq[:, c0:c0 + chunk] = torch.einsum("bqhgk,bkhd->bqhgd", ds,
                                            kf) * scale
        dk += torch.einsum("bqhgk,bqhgd->bkhd", ds,
                           qf[:, c0:c0 + chunk]) * scale
    out = q.dtype
    return (dq.reshape(B, S, H, D).to(out), dk.to(out), dv.to(out))


def _fn(variant: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant == "tc":
        fn = build.load("flash_attention_tc").flash_attention_tc_launch
        args = [p, p, p, p, p, i, i, i, i, i, i, p]
    elif variant == "bwd_simt":
        fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
        args = [i] + [p] * 10 + [i] * 6 + [p]
    elif variant == "bwd_tc":
        fn = build.load("flash_attention_bwd_tc").flash_attention_bwd_tc_launch
        args = [p] * 13 + [i] * 6 + [p]
    else:
        fn = build.load("flash_attention").flash_attention_launch
        args = [i, p, p, p, p, p, i, i, i, i, i, i, p]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = i
    return fn


def _launch(variant: str, q, k, v, window: int, lse=None):
    """Run one forward kernel on checked CUDA tensors and count the
    launch; ``lse`` (B, H, S) f32, when given, receives the rows'
    log-sum-exp (training only)."""
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
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


def _check(q, k, v):
    """Raise on what the CUDA kernels do not take; returns the variant."""
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
    return variant


def _bwd_launch(variant: str, q, k, v, o, lse, do, window: int):
    """Run one backward call of the given variant on checked CUDA
    tensors and count it (each variant issues three kernels a call).
    ``tc`` sums dK and dV over the group's heads from f32 per-query-head
    partials and dQ in an f32 accumulator that the key tiles add into
    (so dQ's summation order varies between runs; dK and dV do not)."""
    B, S, H, D = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    shape = (B, S, H, k.shape[2], D, int(window), stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr())
    with torch.cuda.device(q.device):
        if variant == "tc":
            sp = -(-S // TC_BWD_TILE) * TC_BWD_TILE
            dev = q.device
            ld = torch.empty((B, H, sp, 2), device=dev)
            dq_acc = torch.empty((B, H, sp, D), device=dev)
            dk_part = torch.empty((B, S, H, D), device=dev)
            dv_part = torch.empty((B, S, H, D), device=dev)
            rc = _fn("bwd_tc")(*ptrs, ld.data_ptr(), dq_acc.data_ptr(),
                               dk_part.data_ptr(), dv_part.data_ptr(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               *shape)
        else:
            delta = torch.empty((B, H, S), device=q.device)
            rc = _fn("bwd_simt")(_DTYPES[q.dtype], *ptrs, delta.data_ptr(),
                                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 *shape)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward {variant} kernel "
                           f"launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_variant[variant] += 1
    return dq, dk, dv


def _bwd_check(q, k, v, o, lse, do):
    """Raise on what the backward kernels do not take; returns the
    variant, the forward's (:func:`_variant`)."""
    variant = _check(q, k, v)
    B, S, H, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {q.dtype} {tuple(q.shape)} tensor "
                             f"on {q.device}")
        if variant == "tc" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must start on a "
                             f"16-byte boundary (TMA)")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 {(B, H, S)} on {q.device}")
    return variant


def flash_attention_bwd(q, k, v, o, lse, do, *, window: int = 0,
                        chunk: int = 512):
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, its
    rows' log-sum-exp ``lse`` (B, H, S) f32 and dO: on CUDA tensors the
    kernels of the forward's variant (``csrc/flash_attention_bwd_tc.cu``
    for bf16 at head_dim 64/128, ``csrc/flash_attention_bwd.cu``
    otherwise; one launch counted per call), on CPU tensors
    :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, window=window,
                                         chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _bwd_launch(_bwd_check(q, k, v, o, lse, do), q, k, v, o, lse, do,
                       window)


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_variant = {"tc": 0, "simt": 0}


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on CUDA tensors with a kernel backward: the
    forward launches the forward kernel of :func:`_variant` with its
    rows' log-sum-exp written, the backward the same variant's backward
    kernels through :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), device=q.device)
        out = _launch(_variant(q.dtype, q.shape[-1]), q, k, v, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         window=ctx.window)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, window: int = 0, chunk: int = 512):
    """Causal GQA attention with a per-layer ``window`` (0 = full).
    ``chunk`` is the plain version's key block; the kernels tile keys by
    64 (``simt``) or 128 (``tc``). With grad enabled and an input that
    requires grad the call goes through :class:`FlashAttentionFn`; under
    ``torch.no_grad`` no log-sum-exp is written."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    variant = _check(q, k, v)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, int(window))
    return _launch(variant, q, k, v, window)


flash_attention.launches = 0
flash_attention.launches_by_variant = {"tc": 0, "simt": 0}
