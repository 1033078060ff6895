"""Gossip mixing on node-stacked params: x_i ← Σ_j W_ij x_j.

The port has the reference's ``dense`` backend — the (n, n) Metropolis
matrix applied along the leading node axis, one matmul per leaf — with
its per-leaf protocol (``mix.mix_leaf``, which QG-DSGDm-N fuses into its
update) and ``wire_dtype``, the churn mask (``active``: the masked
Metropolis matrix, identity rows on down nodes) and the resilience
layer's wire faults (``wire_fault``, wrapped by
``resil.make_validated_mixer``; a fault-free mixer comes back
unwrapped). The gather/roll backends, compressed, delayed and straggler
gossip (ROADMAP.md queue 1 item 12) and the shard-mode ppermute backends
(item 13) are still to port and raise here.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.runtime import resolve_device

Params = Dict[str, torch.Tensor]
Mixer = Callable[[Params], Params]


def make_dense_mixer(W: np.ndarray, wire_dtype: str = "native",
                     device="cuda") -> Mixer:
    Wt = torch.as_tensor(np.asarray(W), dtype=torch.float32,
                         device=resolve_device(device))
    n = Wt.shape[0]

    def mix_leaf(x):
        # accumulate in f32 either way; "native" keeps the operand in its
        # storage dtype (the bytes a real wire would carry)
        xf = x.float() if wire_dtype == "float32" else x
        y = Wt @ xf.reshape(n, -1).float()
        return y.reshape(x.shape).to(x.dtype)

    def mix(stacked: Params) -> Params:
        return {k: mix_leaf(v) for k, v in stacked.items()}

    mix.mix_leaf = mix_leaf
    return mix


def make_mixer(topology: Topology, backend: str = "dense",
               wire_dtype: str = "native", device="cuda", *, active=None,
               compression=None, gossip: str = "sync", stale=None,
               stateful=None, wire_fault=None, wire_guard=None) -> Mixer:
    """The uncompressed node-stacked mixer on the topology's Metropolis
    matrix, masked to the ``active`` nodes when some are down
    (``Topology.mixing_matrix(active)``: doubly stochastic on the active
    subgraph, identity on the down nodes). ``wire_fault`` (a
    ``resil.WireFault``) wraps it in ``resil.make_validated_mixer`` with
    ``wire_guard``'s (a ``resil.GuardSpec``) bound and validation
    switch. The mixer carries ``remake(active=..., stale=...)``, which
    rebuilds it for another availability mask."""
    if backend != "dense":
        raise NotImplementedError(
            f"mixer backend {backend!r} is not ported yet (only 'dense'); "
            "see ROADMAP.md queue 1 items 12 and 13")
    if compression is not None or gossip != "sync" or stateful or (
            stale is not None and np.any(np.asarray(stale, bool))):
        raise NotImplementedError(
            "compressed, delayed and straggler (stale) gossip are not "
            "ported yet; see ROADMAP.md queue 1 item 12")
    dev = resolve_device(device)
    if active is not None and np.all(np.asarray(active, bool)):
        active = None
    W = topology.mixing_matrix(active)
    mix = make_dense_mixer(W, wire_dtype, dev)
    if wire_fault is not None and not wire_fault.is_noop():
        from repro_torch.resil.faults import (DEFAULT_MAX_ABS,
                                              make_validated_mixer)
        mix = make_validated_mixer(
            mix, W, wire_fault,
            max_abs=(wire_guard.max_abs if wire_guard is not None
                     else DEFAULT_MAX_ABS),
            validate=(wire_guard.validate_wire if wire_guard is not None
                      else True), device=dev)
    mix.remake = lambda active=None, stale=None: make_mixer(
        topology, backend, wire_dtype, dev, active=active, stale=stale,
        wire_fault=wire_fault, wire_guard=wire_guard)
    return mix


def consensus_distance(stacked: Params) -> torch.Tensor:
    """L2 distance of node params from the node average (diagnostic)."""
    total = 0.0
    for k in sorted(stacked):
        xf = stacked[k].float()
        total = total + torch.sum((xf - xf.mean(dim=0, keepdim=True)) ** 2)
    return torch.sqrt(torch.as_tensor(total))
