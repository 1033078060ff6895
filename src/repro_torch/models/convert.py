"""Carry weights between the reference's pytree and the port.

The reference keeps params as a nested dict of arrays; the port keeps a
flat dict keyed by the same paths joined with ``/``. A leading node
axis, when present, is kept. Takes and returns numpy arrays on the
reference side, so neither direction needs the other framework. The
port's tensors never share memory with the arrays they came from:
QG-DSGDm-N trains params in place.

* ResNet (:func:`from_jax_params`, :func:`to_jax_params`): f32, HWIO
  conv kernels ``(kh, kw, cin, cout)`` become OIHW ``(cout, cin, kh,
  kw)``; EvoNorm vectors and ``fc_w``/``fc_b`` carry across unchanged.
* Decoder (:func:`from_jax_lm_params`, :func:`to_jax_lm_params`): every
  leaf keeps its shape and its dtype — Hymba's bf16 weights stay bf16
  and its f32 ``a_log``/``dt_bias``/``d_skip`` stay f32; nothing is
  transposed (``ssm/conv_w`` is a ``(W, C)`` table, not a conv kernel).
  bf16 crosses as f32 and is cast back, which is exact: numpy's
  bfloat16 (``ml_dtypes``) is not a type ``torch.from_numpy`` takes.
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
        out[path] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device, copy=True)
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


def from_jax_lm_params(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested numpy tree of a decoder (optional leading node axis) -> the
    port's flat params on ``device``, dtypes kept."""
    device = resolve_device(device)
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
        out[path] = t.to(device, copy=True)
    return out


def to_jax_lm_params(params: Dict[str, torch.Tensor]):
    """The port's flat decoder params -> the reference's nested numpy
    tree, dtypes kept (bf16 leaves as ``ml_dtypes.bfloat16``, the type
    JAX gives and takes; imported here, where the reference is at hand,
    so that the port itself never needs it)."""
    tree: Dict = {}
    for path, t in params.items():
        a = t.detach().cpu()
        if a.dtype == torch.bfloat16:
            import ml_dtypes
            a = a.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            a = a.numpy()
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree
