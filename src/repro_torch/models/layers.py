"""EvoNorm for the paper's ResNet.

The JAX package names it ``evonorm_b0`` but computes **EvoNorm-S0** (no
batch statistics), which is what transfers to decentralized non-IID
training: ``y = x · sigmoid(v·x) / group_std(x) · gamma + beta`` with
``groups = max(1, C // 8)`` and the variance taken over (H, W,
channels-in-group) per sample. That is a population variance
(``correction=0``; ``torch.var`` defaults to the unbiased one).
"""
from __future__ import annotations

import torch


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
