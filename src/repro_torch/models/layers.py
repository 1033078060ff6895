"""Shared model building blocks: EvoNorm for the paper's ResNet, and the
decoder's initializers, norms, RoPE and MLP.

The decoder functions keep the reference's cast points
(``src/repro/models/layers.py``): norms and RoPE compute in f32 and cast
back to the input's dtype; matmuls run in the params' dtype. Parameters
are dicts of tensors keyed as in the reference's pytree.

The JAX package names the ResNet's norm ``evonorm_b0`` but computes
**EvoNorm-S0** (no batch statistics), which is what transfers to
decentralized non-IID training: ``y = x · sigmoid(v·x) / group_std(x) ·
gamma + beta`` with ``groups = max(1, C // 8)`` and the variance taken
over (H, W, channels-in-group) per sample. That is a population variance
(``correction=0``; ``torch.var`` defaults to the unbiased one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def evonorm_nodes(x, gamma, beta, v, eps: float = 1e-5):
    """EvoNorm-S0 on the model's internal layout.

    ``x`` is (B, L·C, H, W): L nodes' channels side by side, as the
    grouped convolutions produce them; ``gamma``/``beta``/``v`` are
    (L, C). Groups never straddle two nodes.
    """
    B, LC, H, W = x.shape
    L, C = gamma.shape
    groups = max(1, C // 8)
    xg = x.reshape(B, L, groups, C // groups, H, W)
    var = torch.var(xg, dim=(3, 4, 5), keepdim=True, correction=0)
    std = torch.sqrt(var + eps).expand_as(xg).reshape(B, LC, H, W)
    g = gamma.reshape(1, LC, 1, 1)
    b = beta.reshape(1, LC, 1, 1)
    vv = v.reshape(1, LC, 1, 1)
    num = x * torch.sigmoid(vv * x)
    return num / std * g + b


def evonorm_b0(x, params, eps: float = 1e-5):
    """EvoNorm-S0 in the reference's layout: ``x`` (B, H, W, C) NHWC,
    ``params`` {"gamma", "beta", "v"} of shape (C,)."""
    xc = x.permute(0, 3, 1, 2)
    y = evonorm_nodes(xc, params["gamma"][None], params["beta"][None],
                      params["v"][None], eps)
    return y.permute(0, 2, 3, 1)


def init_evonorm(c: int, dtype=torch.float32):
    return {"gamma": torch.ones((c,), dtype=dtype),
            "beta": torch.zeros((c,), dtype=dtype),
            "v": torch.ones((c,), dtype=dtype)}


# ------------------------------------------------------------ decoder init
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None):
    """Truncated-normal fan-in init: N(0, 1) cut at ±3, times 1/sqrt(d_in)
    (or ``scale``), drawn in f32 on ``gen``'s device, cast to ``dtype``."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * std).to(dtype)


def normal_init(gen: torch.Generator, shape, std: float, dtype):
    """N(0, std²) drawn in f32 on ``gen``'s device, cast to ``dtype``."""
    w = torch.empty(shape, device=gen.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return normal_init(gen, (vocab, d), 0.02, dtype)


# ------------------------------------------------------------------ norms
def init_norm(cfg: ModelConfig, d: int, dtype, device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(params, x, cfg: ModelConfig):
    eps = cfg.norm_eps
    xf = x.float() if cfg.norm_in_f32 else x
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps: float = 1e-6):
    """Per-head RMS norm of qk-norm (normalizes head_dim)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * inv_freq    # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, cfg: ModelConfig, d: int, d_ff: int,
             dtype):
    p = {"wi": dense_init(gen, d, d_ff, dtype)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, d_ff, dtype)
    p["wo"] = dense_init(gen, d_ff, d, dtype)
    return p


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif cfg.mlp_type == "geglu":
        h = _gelu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = _gelu(x @ params["wi"])
    return h @ params["wo"]
