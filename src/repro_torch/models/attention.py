"""Decoder attention: GQA with RoPE, qk-norm, qkv-bias, a per-layer
sliding window and the prefix-LM mask (PaliGemma's), cross-attention to
a conditioning sequence (MusicGen's), KV-cache decode with a ring buffer
for windowed layers, and DeepSeek-V3's multi-head latent attention (MLA)
in its expanded training / prefill form and its absorbed decode form
(``src/repro/models/attention.py``).

:func:`chunked_attention` is the reference's entry point: causal
self-attention from position 0, optionally windowed or with a
bidirectional prefix, non-causal attention over a key set of any
length, MLA's v head dim apart from q's, and, with ``q_offset`` and
``kv_valid_len``, queries at an offset over a cache. On the card it is
the ``flash_attention`` kernel — through ``FlashAttentionFn`` when
gradients are wanted, whose backward is the hand-written backward
kernel (not in the offset mode, which nothing trains through) — and on
the CPU the kernel's plain version — the reference's chunked online
softmax, differentiated by autograd.

Decode (:func:`attention_decode`, :func:`mla_decode`) is the reference's
plain arithmetic: one token's scores against the whole cache, softmax
and P·V in f32. The reference runs it as plain ``jnp`` (no Pallas
kernel), so here it is plain torch. The caches are written in place
(``index_put_`` at each row's slot) and their ``length`` advanced in
place; the functions still return the cache, as the reference's return
the new one (ROADMAP.md §3, a deliberate difference). Two faults of the
reference are kept, as it has them (ROADMAP.md §3): a full-attention
cache of capacity ``context`` wraps at ``pos % cap`` past its end (a
silent sliding window), and ``mla_decode`` drops a write past its cache's
end (JAX's out-of-bounds scatter rule).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, dense_init, rms_head_norm,
                                       rms_norm_f32)


NEG_INF = -1e30


def chunked_attention(q, k, v, *, q_offset=0, causal=True, window=0,
                      prefix_len: int = 0, kv_valid_len=None,
                      chunk: int = 512):
    """q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, Dv) -> (B, Sq, H,
    Dv) in q's dtype (Dv = D but in MLA): causal self-attention (Sk =
    Sq), bidirectional over the first ``prefix_len`` positions, or, with
    ``causal=False``, every key visible (cross-attention). ``q_offset``:
    the position of q[0] (a cache's length), the causal mask and the
    window measured from there over any Sk; ``kv_valid_len`` (B,): the
    valid keys of each row's cache, the rest masked. Without grad only:
    their backward raises (ROADMAP.md item 10b.1)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=int(window), causal=causal,
                           prefix_len=int(prefix_len), chunk=chunk,
                           q_offset=int(q_offset), kv_valid_len=kv_valid_len)


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


class KVCache(NamedTuple):
    """Decode cache. Full attention: capacity = context length. Sliding
    window: capacity = window (ring buffer, positions tracked). In a
    decode state each field carries a leading layer axis."""
    k: torch.Tensor          # (B, cap, KVH, D)
    v: torch.Tensor          # (B, cap, KVH, D)
    pos: torch.Tensor        # (B, cap) absolute positions, -1 = empty
    length: torch.Tensor     # (B,) tokens seen so far


def make_kv_cache(cfg: ModelConfig, batch: int, context: int, dtype,
                  window_override: Optional[int] = None,
                  device="cuda") -> KVCache:
    """An empty cache of capacity ``min(context, window)`` when a window
    is given (the config's, or ``window_override``), else ``context``;
    ``pos`` and ``length`` int64 (the reference's are int32)."""
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window if window_override is None \
        else window_override
    cap = min(context, window) if window else context
    shape = (batch, cap, cfg.num_kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, cap), -1, dtype=torch.long, device=device),
        length=torch.zeros((batch,), dtype=torch.long, device=device))


def attention_decode(params, x, cfg: ModelConfig, cache: KVCache, *,
                     layer_window=None):
    """One token x (B, 1, d) against the cache -> (out (B, 1, d), cache):
    RoPE at each row's position ``length``, k and v written in place at
    slot ``length % cap`` (a ring buffer for a windowed cache; a full
    cache wraps there too, as the reference's), the scores masked by the
    stored positions and the window; scores, softmax and P·V in f32, the
    output cast to x's dtype."""
    B = x.shape[0]
    window = int(cfg.sliding_window if layer_window is None
                 else layer_window)
    pos = cache.length.clone()                             # (B,)
    q, k, v = _project_qkv(params, x, cfg)                 # S = 1
    # one RoPE call for q and k (the same positions; elementwise per head)
    q, k = apply_rope(torch.cat([q, k], dim=2), pos[:, None],
                      cfg.rope_theta).split([q.shape[2], k.shape[2]], dim=2)
    cap = cache.k.shape[1]
    slot = pos % cap
    bidx = torch.arange(B, device=x.device)
    cache.k.index_put_((bidx, slot), k[:, 0])
    cache.v.index_put_((bidx, slot), v[:, 0])
    cache.pos.index_put_((bidx, slot), pos)
    cache.length.add_(1)
    kp = cache.pos                                         # (B, cap)
    allow = (kp >= 0) & (kp <= pos[:, None])
    if window > 0:
        allow = allow & (pos[:, None] - kp < window)
    KVH, D = cfg.num_kv_heads, q.shape[-1]
    qf = q.reshape(B, 1, KVH, -1, D).float()               # (B,1,KVH,G,D)
    scale = 1.0 / torch.sqrt(torch.tensor(float(D)))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf * scale, cache.k.float())
    s = s.masked_fill(~allow[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, cache.v.float())
    o = o.reshape(B, 1, cfg.num_heads * v.shape[-1]).to(x.dtype)
    return o @ params["wo"], cache


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


class MLACache(NamedTuple):
    """MLA's decode cache: the compressed latents and the rope keys, the
    expanded k and v never stored."""
    c_kv: torch.Tensor       # (B, cap, kv_lora)
    k_rope: torch.Tensor     # (B, cap, rope_dim)
    length: torch.Tensor     # (B,)


def make_mla_cache(cfg: ModelConfig, batch: int, context: int, dtype,
                   device="cuda") -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, context, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, context, m.qk_rope_head_dim),
                           dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.long, device=device))


def mla_decode(params, x, cfg: ModelConfig, cache: MLACache):
    """Absorbed-form decode of one token x (B, 1, d) -> (out, cache):
    the latent query q_nope · W_UK, scores = latent + rope part, the
    output o_lat · W_UV, all in f32, so the cache holds only (kv_lora +
    rope_dim) a token. The latent and rope key are written in place at
    each row's position; a row at or past the cache's capacity writes
    nothing (the reference's scatter drops it), and attends to the cache
    as it is."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    pos = cache.length.clone()
    q_nope, q_rope = _mla_q(params, x, cfg)              # (B, 1, H, .)
    c_kv, k_rope = _mla_latent(params, x, cfg)           # (B, 1, .)
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], pos[:, None],
                        cfg.rope_theta)[:, :, 0]
    cap = cache.c_kv.shape[1]
    bidx = torch.arange(B, device=x.device)
    slot = torch.clamp(pos, max=cap - 1)
    keep = (pos < cap)[:, None]         # no host sync: a dropped row
    cache.c_kv.index_put_((bidx, slot), torch.where(      # rewrites its
        keep, c_kv[:, 0], cache.c_kv[bidx, slot]))        # slot's value
    cache.k_rope.index_put_((bidx, slot), torch.where(
        keep, k_rope[:, 0], cache.k_rope[bidx, slot]))
    cache.length.add_(1)
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope.float(), w_uk.float())
    ckv = cache.c_kv.float()
    s_lat = torch.einsum("bqhc,bkc->bhqk", q_lat, ckv)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                          cache.k_rope.float())
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(m.qk_nope_head_dim + m.qk_rope_head_dim)))
    s = (s_lat + s_rope) * scale
    allow = torch.arange(cap, device=x.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~allow[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkc->bqhc", p, ckv)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bqhc,chd->bqhd", o_lat, w_uv.float())
    o = o.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    return o @ params["wo"], cache
