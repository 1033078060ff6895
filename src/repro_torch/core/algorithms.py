"""Decentralized optimizers against an abstract gossip mixer.

Params, grads and optimizer state are flat dicts of node-stacked tensors
(leading axis = node). Every name of the reference's registry is here:
``centralized`` (exact averaging, the paper's upper bound), ``dsgd``,
``dsgdm``, ``qg-dsgdm-n`` (the paper's base optimizer), ``d2``,
``gradient-tracking`` and ``relaysgd`` (on a tree). Updates run under
``torch.no_grad``. ``dsgd``/``dsgdm`` and ``relaysgd`` return new
tensors; ``centralized``, ``qg-dsgdm-n``, ``d2`` and
``gradient-tracking`` work leaf by leaf over :func:`leaf_slices`,
gossip through ``mix.mix_leaf`` on each slice, and write into the
buffers they are given (params and state), so that an update holds
f32 temporaries of one slice and no second copy of a node-stacked tree.

A stateful mixer (compressed, delayed or straggler gossip; its bound
form has ``whole_leaves``) takes whole leaves: a top-k over a slice is
another compressor, and the mixer pairs its calls with the params'
leaves. Under it the half-step still runs slice by slice, into a
leaf-sized buffer in the storage dtype, then one mix of the whole leaf,
then the slices' updates (:func:`_mixed_slices`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.topology import Topology

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


def _whole(mix) -> bool:
    return getattr(mix, "whole_leaves", False)


def _filled(p, fill):
    """A whole leaf's pre-mix value, which ``fill(sl)`` gives slice by
    slice, in a leaf-sized buffer of ``p``'s storage dtype: f32
    temporaries stay one slice wide until the mixer's. (Hymba-1.5B's
    largest leaf, layer-stacked, is 4 x 282 M elements: its buffer
    takes 2.3 GB in bf16, the top-k mixer ~4 GB of f32 transients a
    node row.)"""
    buf = torch.empty_like(p)
    for sl in leaf_slices(p):
        buf[sl] = fill(sl)
    return buf


def _mixed_slices(mix, p, fill=None):
    """(sl, y[sl]) over :func:`leaf_slices` of ``p``: y the gossip mix of
    the leaf's pre-mix value, which ``fill(sl)`` gives slice by slice
    (``p`` itself when None). A stateless mixer mixes each slice as it
    is asked for, so the caller may write slice sl before the next one
    is filled; a stateful one mixes the whole leaf once, formed by
    :func:`_filled` before the first slice is yielded."""
    get = fill if fill is not None else p.__getitem__
    if not _whole(mix):
        for sl in leaf_slices(p):
            yield sl, mix.mix_leaf(get(sl))
        return
    y = mix.mix_leaf(p if fill is None else _filled(p, fill))
    for sl in leaf_slices(p):
        yield sl, y[sl]


def _decayed(g, p, wd: float):
    """g + wd·p, added in the grad's dtype (the reference's
    ``_apply_weight_decay``)."""
    return g + wd * p.to(g.dtype) if wd else g


@dataclass
class Algorithm:
    """init(params) -> state; step(params, grads, state, lr, mix) -> ..."""
    name: str
    init: Callable[[Params], Any]
    step: Callable[..., Any]
    needs_topology: bool = False


def make_centralized(momentum: float = 0.9, weight_decay: float = 0.0,
                     nesterov: bool = True) -> Algorithm:
    """SGD on exactly averaged gradients (the paper's upper bound, on the
    complete graph's uniform mixing): per slice, gossip the grads, add
    the weight decay, heavy-ball momentum (Nesterov by default), step.
    Params and momentum are written in place."""
    def init(params):
        return {"m": tree_zeros_like(params)}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        for k, p in params.items():
            m = state["m"][k]
            for sl, gm in _mixed_slices(mix, grads[k]):
                gk = _decayed(gm, p[sl], weight_decay)
                mk = (momentum * m[sl].float() + gk.float()).to(gk.dtype)
                upd = ((momentum * mk.float() + gk.float()).to(gk.dtype)
                       if nesterov else mk)
                m[sl] = mk
                p[sl] = (p[sl].float() - lr * upd.float()).to(p.dtype)
        return params, state

    return Algorithm("centralized", init, step)


def make_dsgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Algorithm:
    """DSGD (Lian et al. 2017), with local heavy-ball momentum = DSGDm."""
    def init(params):
        return {"m": tree_zeros_like(params)} if momentum else {}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        grads = {k: _decayed(g, params[k], weight_decay)
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
            sq = {}
            for k in sorted(grads):            # the reference's leaf order
                leaf = 0.0
                for sl in leaf_slices(grads[k]):
                    gf = grads[k][sl].float()
                    if wd:
                        gf = gf + wd * params[k][sl].float()
                    leaf = leaf + torch.sum(gf ** 2)
                sq[k] = leaf
            # the norm spans every node; a sharded mixer holds one block
            # of them and completes the sum over the ranks (its
            # reduce_tree_sum, as the reference's mixer hook)
            reduce = getattr(mix, "reduce_tree_sum", None)
            total = reduce(sq) if reduce is not None else sum(sq.values())
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

        whole = _whole(mix)

        def fill(k):
            return lambda sl: half_step(params[k][sl], grads[k][sl],
                                        state["m"][k][sl])

        mix_leaves = getattr(mix, "mix_leaves", None)
        if mix_leaves is not None:
            # a sharded mixer: every slice's (or, stateful, every whole
            # leaf's) half-step, then one gossip collective for all of
            # them, then the EMA (the same values)
            items = [(k, sl) for k, p in params.items()
                     for sl in ([(slice(None),)] if whole
                                else leaf_slices(p))]
            halves = [_filled(params[k], fill(k)) if whole else fill(k)(sl)
                      for k, sl in items]
            ys = mix_leaves(halves)
            del halves
            for (k, sl), y in zip(items, ys):
                m, p = state["m"][k], params[k]
                m[sl] = ema(m[sl], p[sl], y)
                p[sl] = y
            return params, state
        # per leaf and per slice: half-step, gossip mix, displacement EMA
        for k, p in params.items():
            m = state["m"][k]
            for sl, y in _mixed_slices(mix, p, fill(k)):
                m[sl] = ema(m[sl], p[sl], y)
                p[sl] = y
        return params, state

    return Algorithm("qg-dsgdm-n", init, step)


def make_d2(weight_decay: float = 0.0) -> Algorithm:
    """D² (Tang et al. 2018): x⁺ = W(2x − x_prev − η(g − g_prev)), and
    x − ηg on the first step; removes DSGD's data-heterogeneity bias.

    The state holds x_prev, g_prev (weight decay added) and the step
    count ``t`` as a Python int. From the second step the new params are
    written over x_prev's buffer, slice by slice, each slice read before
    it is written, and the params passed in become the next x_prev: two
    node-stacked copies of the params, as the method needs, and none
    more. The first step, whose x_prev is the params themselves, writes
    into new tensors. g_prev is written over the old one's buffer, so
    the grads passed in are left as they are."""
    def init(params):
        return {"prev_x": params, "prev_g": tree_zeros_like(params), "t": 0}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        first = state["t"] == 0
        new = {}
        for k, x in params.items():
            g, px, pg = grads[k], state["prev_x"][k], state["prev_g"][k]
            out = torch.empty_like(x) if first else px

            def half(sl):
                gk = _decayed(g[sl], x[sl], weight_decay)
                xf, gf = x[sl].float(), gk.float()
                if first:
                    h = xf - lr * gf
                else:
                    h = 2.0 * xf - px[sl].float() - lr * (
                        gf - pg[sl].float())
                pg[sl] = gk
                return h.to(x.dtype)

            # px may be out: each slice's half-step (under a stateful
            # mixer the whole leaf's) is formed before the mix writes it
            for sl, y in _mixed_slices(mix, x, half):
                out[sl] = y
            new[k] = out
        return new, {"prev_x": params, "prev_g": state["prev_g"],
                     "t": state["t"] + 1}

    return Algorithm("d2", init, step)


def make_gradient_tracking(weight_decay: float = 0.0) -> Algorithm:
    """Gradient tracking: a tracker y of the global gradient,
    y⁺ = W(y + g − g_prev) (the local gradient on the first step), then
    x⁺ = W(x − ηy⁺) — two gossips a step. The tracker's sum runs in the
    leaf's dtype, as the reference's. Params, tracker and g_prev are
    written in place, slice by slice."""
    def init(params):
        return {"y": tree_zeros_like(params),
                "prev_g": tree_zeros_like(params), "t": 0}

    @torch.no_grad()
    def step(params, grads, state, lr, mix):
        if _whole(mix):
            from repro_torch.core.mixing import MIXED_MORE
            raise ValueError(MIXED_MORE)
        first = state["t"] == 0
        for k, x in params.items():
            g, y, pg = grads[k], state["y"][k], state["prev_g"][k]
            for sl in leaf_slices(x):
                gk = _decayed(g[sl], x[sl], weight_decay)
                ym = mix.mix_leaf(gk if first else y[sl] + gk - pg[sl])
                y[sl] = ym
                pg[sl] = gk
                x[sl] = mix.mix_leaf(
                    (x[sl].float() - lr * ym.float()).to(x.dtype))
        return params, {"y": state["y"], "prev_g": state["prev_g"],
                        "t": state["t"] + 1}

    return Algorithm("gradient-tracking", init, step)


def make_relaysgd(topology: Topology, momentum: float = 0.9,
                  weight_decay: float = 5e-4) -> Algorithm:
    """RelaySum/Model (Vogels et al. 2021): messages relayed along a
    spanning tree give every node the exact, delayed, average of all
    models. The state holds a message per directed edge, ``msg`` leaves
    (n_src, n_dst, ...) in f32 (zero off the edges), the (n, n) count of
    models each message sums, and the momentum. It gossips through its
    own messages: the mixer it is passed is ignored."""
    if not topology.is_tree():
        raise ValueError("RelaySGD requires a tree topology (e.g. chain)")
    n = topology.n
    adj_np = np.zeros((n, n), bool)
    for i in range(n):
        adj_np[i, topology.neighbors(i)] = True
    adj_on = {}

    def adjacency(device):
        if device not in adj_on:
            adj_on[device] = torch.as_tensor(adj_np, device=device)
        return adj_on[device]

    def init(params):
        dev = next(iter(params.values())).device
        return {"msg": {k: torch.zeros((n,) + v.shape, dtype=torch.float32,
                                       device=v.device)
                        for k, v in params.items()},
                "cnt": torch.zeros((n, n), dtype=torch.float32, device=dev),
                "m": tree_zeros_like(params)}

    def incoming(msg, adj_f):
        """inc[i] = Σ_k adj[k, i] · msg[k, i]."""
        return torch.einsum("ki...,ki->i...", msg, adj_f)

    @torch.no_grad()
    def step(params, grads, state, lr, mix=None):
        adj = adjacency(state["cnt"].device)
        adj_f = adj.float()
        cnt = state["cnt"]
        new_cnt = torch.where(adj, 1.0 + (cnt * adj_f).sum(0)[:, None]
                              - cnt.T, 0.0)
        total = 1.0 + (new_cnt * adj_f).sum(0)                    # (n,)
        new_params, new_msg, new_m = {}, {}, {}
        for k, p in params.items():
            gk = _decayed(grads[k], p, weight_decay)
            m = (momentum * state["m"][k].float() + gk.float()).to(gk.dtype)
            xh = (p.float() - lr * m.float()).to(p.dtype)
            msg = state["msg"][k]
            # msg'[i, j] = xhat_i + Σ_{k ∈ N(i) \ {j}} msg[k, i]
            relay = (xh.float()[:, None] + incoming(msg, adj_f)[:, None]
                     - msg.transpose(0, 1))
            mask = adj.reshape((n, n) + (1,) * (msg.dim() - 2))
            msg = torch.where(mask, relay, 0.0)
            shape = (n,) + (1,) * (p.dim() - 1)
            new_params[k] = ((xh.float() + incoming(msg, adj_f))
                             / total.reshape(shape)).to(p.dtype)
            new_msg[k], new_m[k] = msg, m
        return new_params, {"msg": new_msg, "cnt": new_cnt, "m": new_m}

    return Algorithm("relaysgd", init, step, needs_topology=True)


def make_algorithm(name: str, *, topology: Optional[Topology] = None,
                   momentum: float = 0.9, weight_decay: float = 1e-4
                   ) -> Algorithm:
    """The registry: the reference's names, defaults and errors."""
    name = name.lower()
    if name == "centralized":
        return make_centralized(momentum, weight_decay)
    if name == "dsgd":
        return make_dsgd(0.0, weight_decay)
    if name == "dsgdm":
        return make_dsgd(momentum, weight_decay)
    if name in ("qg-dsgdm-n", "qgm"):
        return make_qg_dsgdm_n(momentum, weight_decay)
    if name == "d2":
        return make_d2(weight_decay)
    if name in ("gradient-tracking", "gt"):
        return make_gradient_tracking(weight_decay)
    if name == "relaysgd":
        if topology is None:
            raise ValueError("relaysgd needs a topology")
        return make_relaysgd(topology, momentum, weight_decay)
    raise ValueError(f"unknown algorithm {name!r}")
