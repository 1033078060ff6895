"""ResNet-CIFAR with EvoNorm-S0 — the paper's architecture (ResNet20).

Parameters are a flat dict of tensors keyed by the reference's pytree
paths (``"stem"``, ``"stem_norm/gamma"``, ``"s1b0/conv1"``, ...,
``"fc_w"``, ``"fc_b"``). Convolution kernels are stored OIHW
(out, in, kh, kw), cuDNN's layout; :mod:`repro_torch.models.convert`
carries the reference's HWIO kernels across.

The forward pass is **node-stacked**: every parameter has a leading node
axis L and images arrive as (L, B, H, W, C) NHWC, as in the reference's
vmapped forward. Internally the L nodes' channels sit side by side in one
(B, L·C, H, W) activation and every convolution is one grouped cuDNN
call with ``groups=L`` — what ``vmap`` over a convolution lowers to — so
one launch covers all nodes and their gradients stay independent.

SAME padding follows XLA's convention, low = total // 2: a 3×3 stride-2
conv on 32×32 pads (0, 1), not PyTorch's symmetric ``padding=1``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import evonorm_nodes

Params = Dict[str, torch.Tensor]
CONV_KEYS = ("stem", "conv1", "conv2", "proj")


def same_pads(size: int, k: int, stride: int):
    """XLA SAME padding (low, high) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_nodes(x, w, stride: int = 1):
    """Grouped SAME conv: x (B, L·Cin, H, W), w (L, Cout, Cin, kh, kw)."""
    L, co, ci, kh, kw = w.shape
    H, W = x.shape[-2:]
    ph, pw = same_pads(H, kh, stride), same_pads(W, kw, stride)
    wf = w.reshape(L * co, ci, kh, kw)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, wf, stride=stride, padding=(ph[0], pw[0]),
                        groups=L)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, wf, stride=stride, groups=L)


def _norm(x, params: Params, name: str):
    return evonorm_nodes(x, params[f"{name}/gamma"], params[f"{name}/beta"],
                         params[f"{name}/v"])


def stack_params(params: Params, n: int) -> Params:
    """Identical copies of one node's params on n nodes (paper init)."""
    return {k: v[None].expand((n,) + v.shape).clone()
            for k, v in params.items()}


class ResNetModel:
    """init / forward_features / head_params / forward, node-stacked."""

    input_key = "images"

    def __init__(self, cfg: ModelConfig):
        if cfg.arch_type != "cnn":
            raise ValueError(
                f"arch_type {cfg.arch_type!r}: ResNetModel is the cnn "
                "family; decoders are models.model.build_model's")
        self.cfg = cfg

    def blocks(self):
        """(name, stride, cin, cout) of every residual block, in order;
        a block has a 1×1 ``proj`` shortcut when stride or width change."""
        cfg = self.cfg
        out = []
        cin = cfg.cnn_width
        for si, nblocks in enumerate(cfg.cnn_stages):
            cout = cfg.cnn_width * (2 ** si)
            for bi in range(nblocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                out.append((f"s{si}b{bi}", stride, cin, cout))
                cin = cout
        return out

    def init(self, generator: torch.Generator) -> Params:
        """One node's params (no node axis), He-normal convs — drawn from
        ``generator`` on the CPU; the reference draws other numbers, so
        parity tests carry weights across with ``convert``."""
        cfg = self.cfg

        def conv(kh, kw, cin, cout):
            w = torch.randn((cout, cin, kh, kw), generator=generator)
            return w * (2.0 / (kh * kw * cin)) ** 0.5

        p: Params = {"stem": conv(3, 3, cfg.image_channels, cfg.cnn_width)}
        self._norm_init(p, "stem_norm", cfg.cnn_width)
        cin = cfg.cnn_width
        for name, stride, cin, cout in self.blocks():
            p[f"{name}/conv1"] = conv(3, 3, cin, cout)
            self._norm_init(p, f"{name}/norm1", cout)
            p[f"{name}/conv2"] = conv(3, 3, cout, cout)
            self._norm_init(p, f"{name}/norm2", cout)
            if stride != 1 or cin != cout:
                p[f"{name}/proj"] = conv(1, 1, cin, cout)
            cin = cout
        p["fc_w"] = (torch.randn((cin, cfg.num_classes), generator=generator)
                     / cin ** 0.5)
        p["fc_b"] = torch.zeros((cfg.num_classes,))
        return p

    @staticmethod
    def _norm_init(p: Params, name: str, c: int):
        p[f"{name}/gamma"] = torch.ones((c,))
        p[f"{name}/beta"] = torch.zeros((c,))
        p[f"{name}/v"] = torch.ones((c,))

    def forward_features(self, params: Params, batch):
        """batch['images'] (L, B, H, W, C) -> (feats (L, B, F), aux=0):
        the pooled pre-head activations (the streaming-labeling hook)."""
        imgs = batch["images"]
        L, B, H, W, C = imgs.shape
        x = imgs.permute(1, 0, 4, 2, 3).reshape(B, L * C, H, W)
        x = conv_nodes(x, params["stem"])
        x = _norm(x, params, "stem_norm")
        for name, stride, _, _ in self.blocks():
            h = conv_nodes(x, params[f"{name}/conv1"], stride)
            h = _norm(h, params, f"{name}/norm1")
            h = conv_nodes(h, params[f"{name}/conv2"])
            h = _norm(h, params, f"{name}/norm2")
            proj = params.get(f"{name}/proj")
            sc = x if proj is None else conv_nodes(x, proj, stride)
            x = F.relu(h + sc)
        feats = x.mean(dim=(2, 3)).reshape(B, L, -1).transpose(0, 1)
        return feats, torch.zeros((), device=imgs.device)

    def head_params(self, params: Params):
        """(weight (L, F, C), bias (L, C)) of the classifier head."""
        return params["fc_w"], params["fc_b"]

    def forward(self, params: Params, batch):
        """batch['images'] (L, B, H, W, C) -> (logits (L, B, C), aux=0)."""
        feats, aux = self.forward_features(params, batch)
        w, b = self.head_params(params)
        return torch.bmm(feats, w) + b[:, None, :], aux


def build_model(cfg: ModelConfig) -> ResNetModel:
    return ResNetModel(cfg)
