"""Stand-ins for every model input on the meta device: shapes and dtypes,
no allocation (``src/repro/launch/input_specs.py``, where they are
``jax.ShapeDtypeStruct`` s).

``train_specs``   → a node-stacked batch {tokens, labels, [frontend stubs]};
``prefill_specs`` → a request batch for one prefill;
``decode_specs``  → (tokens, decode state, extras) for one decode step
                    against a ``shape.seq_len``-token cache;
``params_specs``  → one model's params; ``stacked_params_specs`` → the
                    node-stacked params.

The shapes are the reference's. Token ids and labels are int64, the
dtype the port's samplers and embeddings take, where the reference's
are int32; the decode caches' positions and lengths are int64 too
(``DecoderModel.init_decode_state``); every other dtype is the
reference's. Params come from ``DecoderModel.init`` on the meta device:
the same leaves and shapes as on a card, and no number drawn. The
decode state is ``DecoderModel.init_decode_state`` on meta: per segment
the KV (or MLA) cache of the context's length — a ring of the window's
length when every layer is windowed — and the SSM state.

Modality frontends are stubs, as in the reference: the VLM's SigLIP
tower is its precomputed patch embeddings, MusicGen's EnCodec / T5 its
token streams and conditioning embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

META = torch.device("meta")
TOKEN_DTYPE = torch.int64


def _token_shape(cfg: ModelConfig, batch: int, seq: int) -> Tuple[int, ...]:
    if cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _frontend_specs(cfg: ModelConfig, lead: Tuple[int, ...]
                    ) -> Dict[str, Any]:
    """Stubbed modality-frontend inputs, batch dims prefixed by
    ``lead``."""
    out = {}
    dt = getattr(torch, cfg.dtype)
    if cfg.arch_type == "vlm":
        out["patch_embeddings"] = _empty(
            lead + (cfg.num_prefix_tokens, cfg.d_model), dt)
    if cfg.cross_attention:
        out["conditioning"] = _empty(lead + (cfg.cross_attn_len,
                                             cfg.d_model), dt)
    return out


def train_specs(cfg: ModelConfig, shape: ShapeConfig, num_nodes: int
                ) -> Dict[str, Any]:
    assert shape.mode == "train"
    per_node = shape.global_batch // num_nodes
    assert per_node * num_nodes == shape.global_batch, \
        f"global_batch {shape.global_batch} not divisible by {num_nodes} nodes"
    tok = (num_nodes,) + _token_shape(cfg, per_node, shape.seq_len)
    specs: Dict[str, Any] = {"tokens": _empty(tok, TOKEN_DTYPE),
                             "labels": _empty(tok, TOKEN_DTYPE)}
    specs.update(_frontend_specs(cfg, (num_nodes, per_node)))
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    tok = _token_shape(cfg, shape.global_batch, shape.seq_len)
    specs: Dict[str, Any] = {"tokens": _empty(tok, TOKEN_DTYPE)}
    specs.update(_frontend_specs(cfg, (shape.global_batch,)))
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model
                 ) -> Tuple[Any, Any, Tuple[Any, ...]]:
    """(tokens, decode state, extras) for one decode step with a
    ``shape.seq_len`` context; ``extras`` holds the conditioning a
    cross-attention model reads."""
    B = shape.global_batch
    tok = _empty(_token_shape(cfg, B, 1), TOKEN_DTYPE)
    state = model.init_decode_state(B, shape.seq_len, device=META)
    extras = ()
    if cfg.cross_attention:
        extras = (_empty((B, cfg.cross_attn_len, cfg.d_model),
                         getattr(torch, cfg.dtype)),)
    return tok, state, extras


def params_specs(model) -> Dict[str, torch.Tensor]:
    """One model's params on meta (``DecoderModel.init``)."""
    return model.init(0, META)


def stacked_params_specs(model, num_nodes: int) -> Dict[str, torch.Tensor]:
    return {k: v[None].expand((num_nodes,) + v.shape)
            for k, v in params_specs(model).items()}
