"""Decentralized optimizers against an abstract gossip mixer.

Params, grads and optimizer state are flat dicts of node-stacked tensors
(leading axis = node). Ported: ``dsgd``, ``dsgdm`` and ``qg-dsgdm-n``
(the paper's base optimizer); the other names of the reference's
registry raise until they are ported (ROADMAP.md queue 1 item 6).
Updates run under ``torch.no_grad`` and return new tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


def tree_zeros_like(x: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in x.items()}


@dataclass
class Algorithm:
    """init(params) -> state; step(params, grads, state, lr, mix) -> ..."""
    name: str
    init: Callable[[Params], Any]
    step: Callable[..., Any]
    needs_topology: bool = False


def make_dsgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Algorithm:
    """DSGD (Lian et al. 2017), with local heavy-ball momentum = DSGDm."""
    def init(params):
        return {"m": tree_zeros_like(params)} if momentum else {}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        if weight_decay:
            grads = {k: g + weight_decay * params[k].to(g.dtype)
                     for k, g in grads.items()}
        if momentum:
            upd = {k: (momentum * state["m"][k].float() + g.float()
                       ).to(g.dtype) for k, g in grads.items()}
            state = {"m": upd}
        else:
            upd = grads
        mixed = mix(params)
        new = {k: (-lr * upd[k].float() + mixed[k].float()).to(v.dtype)
               for k, v in mixed.items()}
        return new, state

    return Algorithm("dsgd" if not momentum else "dsgdm", init, step)


def make_qg_dsgdm_n(momentum: float = 0.9, weight_decay: float = 1e-4,
                    normalize: bool = True, eps: float = 1e-8) -> Algorithm:
    """Quasi-global momentum with normalized gradients (Lin et al. 2021).

    The momentum buffer tracks the global descent direction
    d = (x_t − x_{t+1}) / η, gossip displacement included. With
    ``normalize`` the local gradient (weight decay folded in) is scaled
    by one over its L2 norm over the whole node-stacked tree. Per leaf:
    half-step x − η(βm + ĝ), gossip mix, then the displacement EMA — the
    reference's fused per-leaf op sequence.
    """
    def init(params):
        return {"m": tree_zeros_like(params)}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        wd = weight_decay
        if normalize:
            total = 0.0
            for k in sorted(grads):            # the reference's leaf order
                gf = grads[k].float()
                if wd:
                    gf = gf + wd * params[k].float()
                total = total + torch.sum(gf ** 2)
            scale = 1.0 / (torch.sqrt(total) + eps)
        else:
            scale = 1.0
        inv_lr = 1.0 / lr
        mix_leaf = getattr(mix, "mix_leaf", None)
        new_p, new_m = {}, {}
        for k, p in params.items():
            g, m = grads[k], state["m"][k]
            gf = g.float()
            if wd:
                gf = gf + wd * p.float()
            gf = scale * gf
            upd = momentum * m.float() + gf
            half = (p.float() - lr * upd).to(p.dtype)
            new_p[k] = mix_leaf(half) if mix_leaf is not None else half
        if mix_leaf is None:
            new_p = mix(new_p)
        for k, p in params.items():
            m = state["m"][k]
            d = (p.float() - new_p[k].float()) * inv_lr
            new_m[k] = (momentum * m.float() + (1 - momentum) * d).to(m.dtype)
        return new_p, {"m": new_m}

    return Algorithm("qg-dsgdm-n", init, step)


def make_algorithm(name: str, *, topology=None, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> Algorithm:
    name = name.lower()
    if name == "dsgd":
        return make_dsgd(0.0, weight_decay)
    if name == "dsgdm":
        return make_dsgd(momentum, weight_decay)
    if name in ("qg-dsgdm-n", "qgm"):
        return make_qg_dsgdm_n(momentum, weight_decay)
    if name in ("centralized", "d2", "gradient-tracking", "gt", "relaysgd"):
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet; see ROADMAP.md queue 1 "
            "item 6")
    raise ValueError(f"unknown algorithm {name!r}")
