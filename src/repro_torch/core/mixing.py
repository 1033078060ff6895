"""Gossip mixing on node-stacked params: x_i ← Σ_j W_ij x_j.

The port has the reference's ``dense`` backend — the (n, n) Metropolis
matrix applied along the leading node axis, one matmul per leaf — with
its per-leaf protocol (``mix.mix_leaf``, which QG-DSGDm-N fuses into its
update) and ``wire_dtype``. The gather/roll backends and the shard-mode
ppermute backends are still to port (ROADMAP.md queue 1 items 12 and
13) and raise here; compressed / delayed gossip and churn masks are
refused where a run is configured (the simulator and the scheduler).
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
               wire_dtype: str = "native", device="cuda") -> Mixer:
    """The uncompressed node-stacked mixer on the topology's Metropolis
    matrix."""
    if backend != "dense":
        raise NotImplementedError(
            f"mixer backend {backend!r} is not ported yet (only 'dense'); "
            "see ROADMAP.md queue 1 items 12 and 13")
    return make_dense_mixer(topology.mixing_matrix(), wire_dtype, device)


def consensus_distance(stacked: Params) -> torch.Tensor:
    """L2 distance of node params from the node average (diagnostic)."""
    total = 0.0
    for k in sorted(stacked):
        xf = stacked[k].float()
        total = total + torch.sum((xf - xf.mean(dim=0, keepdim=True)) ** 2)
    return torch.sqrt(torch.as_tensor(total))
