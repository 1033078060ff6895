"""Mixture-of-experts layer with sort-based dispatch
(``src/repro/models/moe.py``): top-k softmax routing (Arctic), sigmoid
routing whose f32 ``router_bias`` only ranks the experts (DeepSeek-V3's
aux-loss-free balancing), shared experts, Arctic's dense-residual
branch, and the Switch-style load-balance aux loss.

Dispatch, as the reference's: the (token, slot) assignments are sorted
by expert id (a stable sort, so within an expert they keep token
order), each expert's segment starts where a left-sided
``searchsorted`` puts it, and an assignment whose place in its segment
reaches the capacity ``int(capacity_factor · (T // G) · k / E) + 1`` is
dropped to an overflow row that no expert reads. The per-expert GLU is
``torch.bmm`` over the (E, C, d) buffers: a plain product, which the
reference computes with XLA outside any Pallas kernel.

The reference scatter-adds the experts' outputs back onto their tokens
(``.at[token_of].add``). Here each assignment's output is gathered in
the unsorted (token, slot) order and summed over the k slots: the same
sum in another order, with no atomic additions, so the result (and,
under per-layer recompute, its rerun) is the same bits every time. The
buffers are filled with an index_put whose only repeated index is the
overflow row, and the tokens reach it by an expand, so the backward
pass adds no two values at one place by atomics either.

Parameters are the flat dict under a layer's ``moe/``: ``router`` (d,
E), ``router_bias`` (E,) f32, ``experts/wi``, ``experts/wg`` (E, d,
dff), ``experts/wo`` (E, dff, d), and ``shared/...``,
``dense_residual/...`` MLPs.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distill import top_k
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, sub

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype) -> Iterator[Tuple[str, tuple, tuple, torch.Tensor]]:
    """The layer's leaves as ``(key, shape, index, piece)``: each expert
    bank leaf is drawn one expert at a time (``index`` (e,) into its (E,
    ...) shape), so a full-width bank (256 x 7168 x 2048) is never drawn
    whole in f32; other leaves whole (``index`` ()). On the meta device,
    where nothing is drawn, a bank comes whole too."""
    m = cfg.moe
    d, E = cfg.d_model, m.num_experts
    dev = gen.device

    def whole(key, t):
        return key, tuple(t.shape), (), t
    yield whole("router", dense_init(gen, d, E, dtype, scale=0.02))
    yield whole("router_bias", torch.zeros((E,), device=dev))
    names = [("wi", d, m.moe_d_ff), ("wo", m.moe_d_ff, d)]
    if cfg.mlp_type in ("swiglu", "geglu"):
        names.append(("wg", d, m.moe_d_ff))
    for name, din, dout in names:
        if dev.type == "meta":
            yield whole(f"experts/{name}",
                        torch.empty((E, din, dout), dtype=dtype, device=dev))
            continue
        for e in range(E):
            yield (f"experts/{name}", (E, din, dout), (e,),
                   dense_init(gen, din, dout, dtype))
    if m.num_shared_experts:
        for k, v in init_mlp(gen, cfg, d, m.num_shared_experts * m.moe_d_ff,
                             dtype).items():
            yield whole(f"shared/{k}", v)
    if m.dense_residual_ff:
        for k, v in init_mlp(gen, cfg, d, m.dense_residual_ff,
                             dtype).items():
            yield whole(f"dense_residual/{k}", v)


def route(p: Params, x, cfg: ModelConfig):
    """Router: (expert ids (T, k), weights (T, k) in x's dtype, aux)."""
    m = cfg.moe
    logits = (x @ p["router"]).float()                       # (T, E)
    if m.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        _, ids = top_k(scores + p["router_bias"], m.num_experts_per_tok)
        w = torch.gather(scores, -1, ids)
    else:
        w, ids = top_k(torch.softmax(logits, dim=-1), m.num_experts_per_tok)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss (density * mean prob per expert)
    probs = torch.softmax(logits, dim=-1)
    density = torch.nn.functional.one_hot(
        ids[:, 0], m.num_experts).float().mean(0)
    aux = m.num_experts * (density * probs.mean(0)).sum()
    return ids, w.to(x.dtype), aux


def _expert_ffn(bank: Params, xb, cfg: ModelConfig):
    """xb (E, C, d) -> (E, C, d) through each expert's MLP."""
    act = {"swiglu": torch.nn.functional.silu,
           "geglu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
           }.get(cfg.mlp_type)
    if act is not None:
        h = act(torch.bmm(xb, bank["wg"])) * torch.bmm(xb, bank["wi"])
    else:
        h = torch.nn.functional.gelu(torch.bmm(xb, bank["wi"]),
                                     approximate="tanh")
    return torch.bmm(h, bank["wo"])


def dispatch_slots(ids, E: int, cap: int):
    """Each (token, slot) assignment's row in the (E · cap + 1)-row buffer,
    in the unsorted (T · k) order: expert e's c-th assignment (stable
    order) at e · cap + c, or the overflow row E · cap past the
    capacity."""
    flat = ids.reshape(-1)
    sorted_ids, order = torch.sort(flat, stable=True)
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(E, device=ids.device, dtype=flat.dtype))
    pos = torch.arange(flat.numel(), device=ids.device) - seg_start[sorted_ids]
    dest = torch.where(pos < cap, sorted_ids * cap + pos,
                       torch.full_like(pos, E * cap))
    out = torch.empty_like(dest)
    out[order] = dest
    return out


def _dispatch_group(xt, ids, w, bank: Params, cfg: ModelConfig, cap: int):
    """One token group: xt (T, d), ids / w (T, k) -> (T, d)."""
    T, d = xt.shape
    k = ids.shape[1]
    E = cfg.moe.num_experts
    dest = dispatch_slots(ids, E, cap)                       # (T · k,)
    keep = (dest < E * cap).to(xt.dtype)
    buf = xt.new_zeros((E * cap + 1, d))
    buf[dest] = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    yb = _expert_ffn(bank, buf[:-1].reshape(E, cap, d), cfg)
    yb = torch.cat([yb.reshape(E * cap, d), xt.new_zeros((1, d))])
    y = yb[dest] * (w.reshape(-1) * keep)[:, None]
    return y.reshape(T, k, d).sum(1)


def capacity(cfg: ModelConfig, T: int) -> Tuple[int, int]:
    """(groups G, per-group capacity), the reference's float arithmetic."""
    m = cfg.moe
    G = max(1, m.dispatch_groups)
    if T % G:
        G = 1
    return G, int(m.capacity_factor * (T // G) * m.num_experts_per_tok
                  / m.num_experts) + 1


def moe_forward(p: Params, x, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), aux). With ``dispatch_groups`` G > 1
    (and T divisible by G) each of G token groups sorts and fills its
    own capacity buffers, as the reference's vmapped groups do."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    ids, w, aux = route(p, xt, cfg)
    G, cap = capacity(cfg, T)
    bank = sub(p, "experts/")
    n = T // G
    out = torch.cat([_dispatch_group(xt[g * n:(g + 1) * n],
                                     ids[g * n:(g + 1) * n],
                                     w[g * n:(g + 1) * n], bank, cfg, cap)
                     for g in range(G)])
    if m.num_shared_experts:
        out = out + apply_mlp(sub(p, "shared/"), xt, cfg)
    if m.dense_residual_ff:
        out = out + apply_mlp(sub(p, "dense_residual/"), xt, cfg)
    return out.reshape(B, S, d), aux
