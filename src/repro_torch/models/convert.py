"""Carry ResNet weights between the reference's pytree and the port.

The reference keeps params as a nested dict of arrays with HWIO conv
kernels ``(kh, kw, cin, cout)``; the port keeps a flat dict keyed by the
same paths joined with ``/`` and OIHW kernels ``(cout, cin, kh, kw)``.
EvoNorm vectors and ``fc_w``/``fc_b`` carry across unchanged. A leading
node axis, when present, is kept. Takes and returns numpy arrays on the
reference side, so neither direction needs the other framework.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.resnet import CONV_KEYS
from repro_torch.runtime import resolve_device


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, path + "/")
        else:
            yield path, v


def _is_conv(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in CONV_KEYS


def from_jax_params(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested numpy tree (HWIO convs, optional leading node axis) ->
    the port's flat params (OIHW convs) on ``device``."""
    device = resolve_device(device)
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, np.float32)
        if _is_conv(path):
            if a.ndim == 4:                     # (kh, kw, ci, co)
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 5:                   # (n, kh, kw, ci, co)
                a = a.transpose(0, 4, 3, 1, 2)
            else:
                raise ValueError(f"conv leaf {path!r} has shape {a.shape}")
        out[path] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def to_jax_params(params: Dict[str, torch.Tensor]):
    """The port's flat params -> the reference's nested numpy tree."""
    tree: Dict = {}
    for path, t in params.items():
        a = t.detach().cpu().numpy()
        if _is_conv(path):
            if a.ndim == 4:                     # (co, ci, kh, kw)
                a = a.transpose(2, 3, 1, 0)
            else:                               # (n, co, ci, kh, kw)
                a = a.transpose(0, 3, 4, 2, 1)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
