"""Node-stacked params and the serving step of the consensus model
(``src/repro/launch/steps.py``). The decentralized LM train step and the
decode step are not ported (ROADMAP.md items 10a and 10b)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


def stack_params(params: Params, num_nodes: int) -> Params:
    """Replicate one model's params into node-stacked form (copies)."""
    return {k: v[None].expand((num_nodes,) + v.shape).clone()
            for k, v in params.items()}


def consensus_params(stacked: Params) -> Params:
    """Node average (the model the paper evaluates), in f32, cast back."""
    return {k: v.float().mean(dim=0).to(v.dtype) for k, v in stacked.items()}


def make_prefill_step(model) -> Callable:
    """params (node-stacked), batch -> logits (L, B, S, V)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill_step
