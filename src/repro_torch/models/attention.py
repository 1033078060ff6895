"""Decoder attention: GQA with RoPE, qk-norm, qkv-bias, a per-layer
sliding window and the prefix-LM mask (PaliGemma's), and cross-attention
to a conditioning sequence (MusicGen's) (``src/repro/models/attention.py``).

:func:`chunked_attention` is the reference's entry point; on the ported
path (causal self-attention from position 0, optionally windowed or with
a bidirectional prefix, and non-causal attention over a key set of any
length) it is the ``flash_attention`` kernel on the card — through
``FlashAttentionFn`` when gradients are wanted, whose backward is the
hand-written backward kernel — and the kernel's plain version — the
reference's chunked online softmax, differentiated by autograd — on the
CPU. MLA (ROADMAP.md item 10c), ``q_offset``, ``kv_valid_len`` and
KV-cache decode (item 10b) are not ported and raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_head_norm


def chunked_attention(q, k, v, *, q_offset=0, causal=True, window=0,
                      prefix_len: int = 0, kv_valid_len=None,
                      chunk: int = 512):
    """q (B, Sq, H, D), k/v (B, Sk, KVH, D) -> (B, Sq, H, D) in q's dtype:
    causal self-attention (Sk = Sq), bidirectional over the first
    ``prefix_len`` positions, or, with ``causal=False``, every key
    visible (cross-attention)."""
    if q_offset or kv_valid_len is not None:
        raise NotImplementedError(
            "chunked_attention: q_offset and kv_valid_len (decode) are not "
            "ported (ROADMAP.md item 10b)")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=int(window), causal=causal,
                           prefix_len=int(prefix_len), chunk=chunk)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    dev = gen.device
    p = {"wq": dense_init(gen, d, H * hd, dtype),
         "wk": dense_init(gen, d, KVH * hd, dtype),
         "wv": dense_init(gen, d, KVH * hd, dtype),
         "wo": dense_init(gen, H * hd, d, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_forward(params, x, cfg: ModelConfig, *, positions=None,
                      layer_window=None):
    """Prefill self-attention. ``layer_window``: this layer's window
    (0 = full); ``None`` takes the config's."""
    B, S, _ = x.shape
    window = cfg.sliding_window if layer_window is None else layer_window
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            prefix_len=cfg.prefix_lm_prefix,
                            chunk=min(cfg.attn_chunk, S))
    return out.reshape(B, S, -1) @ params["wo"]


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    return init_attention(gen, cfg, dtype)


def cross_attention_forward(params, x, memory, cfg: ModelConfig):
    """Non-causal attention of x (B, S, d) over ``memory`` (B, Sk, d):
    q from x, k and v from memory, no RoPE, as the reference's."""
    B, S, _ = x.shape
    Sk = memory.shape[1]
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (memory @ params["wk"]).reshape(B, Sk, cfg.num_kv_heads, hd)
    v = (memory @ params["wv"]).reshape(B, Sk, cfg.num_kv_heads, hd)
    out = chunked_attention(q, k, v, causal=False,
                            chunk=min(cfg.attn_chunk, Sk))
    return out.reshape(B, S, -1) @ params["wo"]
