"""Decentralized optimizers against an abstract gossip mixer.

Params, grads and optimizer state are flat dicts of node-stacked tensors
(leading axis = node). Ported: ``dsgd``, ``dsgdm`` and ``qg-dsgdm-n``
(the paper's base optimizer); the other names of the reference's
registry raise until they are ported (ROADMAP.md queue 1 item 6).
Updates run under ``torch.no_grad``; ``dsgd``/``dsgdm`` return new
tensors, ``qg-dsgdm-n`` writes over the params and momentum passed in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


CHUNK = 1 << 26   # elements of a leaf whose f32 temporaries live at once


def tree_zeros_like(x: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in x.items()}


def leaf_slices(x: torch.Tensor):
    """Index tuples cutting a node-stacked leaf along its second axis
    (never the node axis, which the gossip mix reads) into pieces of at
    most :data:`CHUNK` elements: an update's f32 temporaries then hold
    one piece, not a whole stacked leaf (4 GB at Hymba-1.5B's largest)."""
    if x.dim() < 2 or x.numel() <= CHUNK:
        return [(slice(None),)]
    per = max(1, CHUNK // (x.numel() // x.shape[1]))
    return [(slice(None), slice(a, a + per))
            for a in range(0, x.shape[1], per)]


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
    reference's fused per-leaf op sequence — taken over
    :func:`leaf_slices`, so bf16 leaves keep f32 temporaries of one slice.
    The mixer's per-leaf protocol (``mix.mix_leaf``, which every
    ``core.mixing`` mixer has) does the gossip. Each slice is written
    over the old params and momentum — a slice reads only itself, gossip
    included — so no second copy of either is made and the returned
    dicts hold the tensors passed in.
    """
    def init(params):
        return {"m": tree_zeros_like(params)}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        wd = weight_decay
        if normalize:
            total = 0.0
            for k in sorted(grads):            # the reference's leaf order
                for sl in leaf_slices(grads[k]):
                    gf = grads[k][sl].float()
                    if wd:
                        gf = gf + wd * params[k][sl].float()
                    total = total + torch.sum(gf ** 2)
            scale = 1.0 / (torch.sqrt(total) + eps)
        else:
            scale = 1.0
        inv_lr = 1.0 / lr

        def half_step(p, g, m):
            gf = g.float()
            if wd:
                gf = gf + wd * p.float()
            upd = momentum * m.float() + scale * gf
            return (p.float() - lr * upd).to(p.dtype)

        def ema(m, p, y):
            d = (p.float() - y.float()) * inv_lr
            return (momentum * m.float() + (1 - momentum) * d).to(m.dtype)

        # per leaf and per slice: half-step, gossip mix, displacement EMA
        for k, p in params.items():
            g, m = grads[k], state["m"][k]
            for sl in leaf_slices(p):
                y = mix.mix_leaf(half_step(p[sl], g[sl], m[sl]))
                m[sl] = ema(m[sl], p[sl], y)
                p[sl] = y
        return params, state

    return Algorithm("qg-dsgdm-n", init, step)


def make_algorithm(name: str, *, topology=None, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> Algorithm:
    """The registry."""
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
