"""Decoder attention: GQA with RoPE, qk-norm, qkv-bias, a per-layer
sliding window and the prefix-LM mask (PaliGemma's), cross-attention to
a conditioning sequence (MusicGen's), and DeepSeek-V3's multi-head
latent attention (MLA) in its expanded training / prefill form
(``src/repro/models/attention.py``).

:func:`chunked_attention` is the reference's entry point; on the ported
path (causal self-attention from position 0, optionally windowed or with
a bidirectional prefix, non-causal attention over a key set of any
length, and MLA's v head dim apart from q's) it is the
``flash_attention`` kernel on the card — through ``FlashAttentionFn``
when gradients are wanted, whose backward is the hand-written backward
kernel — and the kernel's plain version — the reference's chunked online
softmax, differentiated by autograd — on the CPU. ``q_offset``,
``kv_valid_len``, KV-cache decode and MLA's absorbed decode
(``mla_decode``, ``make_mla_cache``) are not ported (ROADMAP.md item
10b) and raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, dense_init, rms_head_norm,
                                       rms_norm_f32)


def chunked_attention(q, k, v, *, q_offset=0, causal=True, window=0,
                      prefix_len: int = 0, kv_valid_len=None,
                      chunk: int = 512):
    """q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, Dv) -> (B, Sq, H,
    Dv) in q's dtype (Dv = D but in MLA): causal self-attention (Sk =
    Sq), bidirectional over the first ``prefix_len`` positions, or, with
    ``causal=False``, every key visible (cross-attention)."""
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


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(gen, d, m.q_lora_rank, dtype)
        p["q_norm"] = torch.ones((m.q_lora_rank,), dtype=dtype, device=dev)
        p["wq_b"] = dense_init(gen, m.q_lora_rank, H * qd, dtype)
    else:
        p["wq"] = dense_init(gen, d, H * qd, dtype)
    p["wkv_a"] = dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype)
    p["kv_norm"] = torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev)
    # decoupled: W_UK (kv_lora -> H*nope), W_UV (kv_lora -> H*v)
    p["w_uk"] = dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype)
    p["w_uv"] = dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype)
    p["wo"] = dense_init(gen, H * m.v_head_dim, d, dtype)
    return p


def _mla_q(params, x, cfg: ModelConfig):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)); the low-rank q
    goes through its f32 RMS norm (``q_norm``)."""
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora_rank:
        cq = rms_norm_f32(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = cq @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, S, cfg.num_heads, -1)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def _mla_latent(params, x, cfg: ModelConfig):
    """(c_kv (B, S, kv_lora) after its f32 RMS norm, k_rope (B, S, rope))."""
    m = cfg.mla
    kv = x @ params["wkv_a"]
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    return rms_norm_f32(c_kv, params["kv_norm"], cfg.norm_eps), k_rope


def mla_forward(params, x, cfg: ModelConfig, *, positions=None):
    """Training / prefill MLA in the expanded form: k = [k_nope ; k_rope]
    with the one rope key broadcast over the heads, q = [q_nope ;
    q_rope], RoPE on the rope halves only, and causal attention with qk
    head dim nope + rope and v head dim ``v_head_dim`` — flash_attention's
    MLA mode on the card."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, cfg)
    c_kv, k_rope = _mla_latent(params, x, cfg)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(B, S, H, m.v_head_dim)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    k_rope = k_rope.expand(B, S, H, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    out = chunked_attention(q, k, v, causal=True,
                            chunk=min(cfg.attn_chunk, S))
    return out.reshape(B, S, -1) @ params["wo"]
