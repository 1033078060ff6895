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
  and its f32 ``a_log``/``dt_bias``/``d_skip`` stay f32, as do an MoE
  layer's f32 ``router_bias`` beside its (layer, E, d, dff) expert
  banks; nothing is transposed (``ssm/conv_w`` is a ``(W, C)`` table,
  not a conv kernel). Every segment (``layers_0``, ``layers_1``) and the
  MLA and ``mtp_*`` leaves cross as they are.
  bf16 crosses as f32 and is cast back, which is exact: numpy's
  bfloat16 (``ml_dtypes``) is not a type ``torch.from_numpy`` takes.
* Decode state (:func:`from_jax_decode_state`,
  :func:`to_jax_decode_state`): the list of per-segment dicts that
  ``DecoderModel.init_decode_state`` makes in either package, each cache
  (``KVCache``, ``MLACache``, ``SSMState``) a named tuple of arrays with a
  leading layer axis; dtypes kept, but for the positions and lengths,
  int32 in the reference and int64 in the port.
"""
from __future__ import annotations

import collections
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


def _decode_types():
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.ssm import SSMState
    return {t.__name__: t for t in (KVCache, MLACache, SSMState)}


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_decode_state(states, device="cuda"):
    """The reference's decode state (per segment {name: cache}, each cache
    a named tuple of arrays) -> the port's, on ``device``: the caches'
    own types (``attention.KVCache``, ``attention.MLACache``,
    ``ssm.SSMState``), matched by name."""
    device = resolve_device(device)
    types = _decode_types()
    return [{name: types[type(c).__name__](
        *(_to_torch(a, device) for a in c)) for name, c in seg.items()}
        for seg in states]


def to_jax_decode_state(states):
    """The port's decode state -> numpy, each cache a named tuple of the
    reference's name and fields (which JAX takes as a pytree node): bf16
    as ``ml_dtypes.bfloat16``, positions and lengths int32."""
    out = []
    for seg in states:
        d = {}
        for name, c in seg.items():
            fields = []
            for t in c:
                t = t.detach().cpu()
                if t.dtype == torch.bfloat16:
                    import ml_dtypes
                    a = t.float().numpy().astype(ml_dtypes.bfloat16)
                elif t.dtype == torch.long:
                    a = t.numpy().astype(np.int32)
                else:
                    a = t.numpy()
                fields.append(a)
            d[name] = collections.namedtuple(type(c).__name__,
                                             c._fields)(*fields)
        out.append(d)
    return out
