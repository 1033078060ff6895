"""Node-stacked params, the decentralized train step and the serving
steps of the consensus model, prefill and decode
(``src/repro/launch/steps.py``)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.driver import lm_adapter, make_step
from repro_torch.core.mixing import make_mixer
from repro_torch.core.topology import Topology

Params = Dict[str, torch.Tensor]


def stack_params(params: Params, num_nodes: int) -> Params:
    """Replicate one model's params into node-stacked form (copies)."""
    return {k: v[None].expand((num_nodes,) + v.shape).clone()
            for k, v in params.items()}


def consensus_params(stacked: Params) -> Params:
    """Node average (the model the paper evaluates), in f32, cast back."""
    return {k: v.float().mean(dim=0).to(v.dtype) for k, v in stacked.items()}


def make_train_step(model, tcfg: TrainConfig, num_nodes: int,
                    wire_dtype: str = "native", device="cuda") -> Callable:
    """The decentralized LM train step on ``tcfg.topology``:
    ``train_step(params, opt_state, batch, lr) -> (params, opt_state,
    {"loss": loss})`` on node-stacked params and (n, B, S) batches —
    (n, B, S, K) tokens and labels and an (n, B, Sk, d) ``conditioning``
    for MusicGen, (n, B, P, d) ``patch_embeddings`` for PaliGemma, which
    ride along to ``model.loss`` — with
    ``train_step.init_opt``. The algorithm is made without a topology,
    as the reference makes it (``relaysgd`` raises). QG-DSGDm-N,
    centralized SGD and gradient tracking update params and state in
    place (the returned dicts hold the tensors passed in); D² writes the
    new params over its previous ones."""
    algo = make_algorithm(tcfg.algorithm, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay)
    mixer = make_mixer(Topology.make(tcfg.topology, num_nodes),
                       wire_dtype=wire_dtype, device=device)
    inner = make_step(model, algo, mixer, lm_adapter)

    def train_step(params, opt_state, batch, lr):
        params, opt_state, loss = inner(params, opt_state, batch, lr)
        return params, opt_state, {"loss": loss}

    train_step.init_opt = inner.init_opt
    return train_step


def make_prefill_step(model) -> Callable:
    """params (node-stacked), batch -> logits (L, B, S, V); the batch's
    ``conditioning`` or ``patch_embeddings`` ride along to
    ``model.forward``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill_step


def make_decode_step(model) -> Callable:
    """``decode_step(params, tokens, state, *extras) -> (logits, state)``:
    one model's params (``consensus_params``' or ``model.init``'s), tokens
    (B, 1[, K]), the decode state (updated in place), and ``extras[0]``,
    when given, the ``memory`` a cross-attention model reads; no grad."""
    @torch.no_grad()
    def decode_step(params, tokens, state, *extras):
        memory = extras[0] if extras else None
        return model.decode_step(params, tokens, state, memory=memory)

    return decode_step
