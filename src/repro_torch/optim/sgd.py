"""Plain (not decentralized) optimizers on flat dicts of tensors: SGD
with momentum and AdamW, as the JAX package's ``optim/sgd.py``. Each
update returns new tensors and a new state."""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class SGDState(NamedTuple):
    momentum: Params


def sgd_init(params: Params, momentum: float = 0.9) -> SGDState:
    return SGDState({k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def sgd_update(params: Params, grads: Params, state: SGDState, lr,
               momentum: float = 0.9, weight_decay: float = 0.0,
               nesterov: bool = False):
    """Heavy-ball (or Nesterov) momentum in the grads' dtype; the step is
    taken in f32 and cast back to each param's dtype."""
    if weight_decay:
        grads = {k: g + weight_decay * params[k].to(g.dtype)
                 for k, g in grads.items()}
    m = {k: momentum * state.momentum[k] + g for k, g in grads.items()}
    upd = ({k: momentum * m[k] + g for k, g in grads.items()} if nesterov
           else m)
    new = {k: (p.float() - lr * upd[k].float()).to(p.dtype)
           for k, p in params.items()}
    return new, SGDState(m)


class AdamWState(NamedTuple):
    mu: Params
    nu: Params
    t: int


def adamw_init(params: Params) -> AdamWState:
    z = {k: torch.zeros_like(v, dtype=torch.float32)
         for k, v in params.items()}
    return AdamWState(z, {k: torch.zeros_like(v) for k, v in z.items()}, 0)


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """AdamW with bias correction, moments in f32, decoupled weight
    decay; the step count is a Python int."""
    t = state.t + 1
    mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
          for k, g in grads.items()}
    nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
          for k, g in grads.items()}
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    new = {}
    for k, p in params.items():
        step = ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                + weight_decay * p.float())
        new[k] = (p.float() - lr * step).to(p.dtype)
    return new, AdamWState(mu, nu, t)
