"""Gossip mixing on node-stacked params: x_i ← Σ_j W_ij x_j.

The port has the reference's ``dense`` backend — the (n, n) Metropolis
matrix applied along the leading node axis, one matmul per leaf — with
its per-leaf protocol (``mix.mix_leaf``, which QG-DSGDm-N fuses into its
update) and ``wire_dtype``, the churn mask (``active``: the masked
Metropolis matrix, identity rows on down nodes) and the resilience
layer's wire faults (``wire_fault``, wrapped by
``resil.make_validated_mixer``; a fault-free mixer comes back
unwrapped).

The sharded driver's backends (``backend="ppermute"``) run on one rank's
contiguous block of a ring's or complete graph's nodes
(:mod:`repro_torch.launch.dist`): :func:`make_ppermute_mixer` takes the
two boundary rows from the neighbouring ranks (:func:`block_ring_shift`)
and mixes 1/3 each (1/2 at two nodes), :func:`make_psum_mixer` averages
exactly over the node group. Both carry ``reduce_tree_sum``, which
completes QG-DSGDm-N's global grad norm over the ranks. The gather/roll
backends and compressed, delayed and straggler gossip (ROADMAP.md queue
1 item 12) are still to port and raise here.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.runtime import resolve_device

if TYPE_CHECKING:    # the shard mixers' collectives, imported where used
    from repro_torch.launch.dist import Group

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


def _is_ring(topology: Topology) -> bool:
    n = topology.n
    if n <= 2:
        return True
    return all(topology.neighbors(i) == sorted({(i - 1) % n, (i + 1) % n})
               for i in range(n))


def _is_full(topology: Topology) -> bool:
    n = topology.n
    return all(len(topology.neighbors(i)) == n - 1 for i in range(n))


def shard_supported_topology(topology: Topology) -> bool:
    """Graphs the sharded gossip backends implement: rings (boundary-row
    exchange) and complete graphs (exact averaging over the node group).
    Everything else runs node-stacked (the ``dense`` backend)."""
    return _is_ring(topology) or _is_full(topology)


def block_ring_shift(x, group: Group, shift: int, neighbors=None):
    """Global ring roll of a block of a ring's node axis: ``x`` is this
    rank's contiguous block (rows ``j·L .. j·L+L-1`` of the global node
    axis, rank j of ``group``); returns the local block of
    ``torch.roll(global_x, shift, 0)`` for ``shift = ±1``. Only the
    boundary rows cross ranks (``neighbors``, the block's pair from
    :func:`dist.ring_neighbors_many`, fetched when None); with one rank
    this is ``torch.roll``."""
    if shift not in (1, -1):
        raise ValueError(f"block_ring_shift supports shift ±1, got {shift}")
    from repro_torch.launch import dist
    before, after = (neighbors if neighbors is not None
                     else dist.ring_neighbors_many([x], group)[0])
    if shift == 1:      # row i receives row i-1
        return torch.cat([before, x[:-1]])
    return torch.cat([x[1:], after])


def _tree_sum_hook(mix, group: Group, reduce=None):
    """QG-DSGDm-N's global grad norm over the ranks: the local block's
    per-leaf sums, completed over the node group — or, on the 2-D mesh,
    by ``reduce`` (``launch.sharding.ShardReduce.tree_sum``), which also
    completes model-sharded leaves over the model group."""
    from repro_torch.launch import dist
    def reduce_tree_sum(sq):
        if reduce is not None:
            return reduce(sq)
        keys = sorted(sq)
        return dist.all_reduce(torch.stack([sq[k] for k in keys]).sum(),
                               group)
    mix.reduce_tree_sum = reduce_tree_sum
    return mix


def make_ppermute_mixer(group: Group, local_nodes: int = 1,
                        reduce=None) -> Mixer:
    """Metropolis ring gossip over a node axis of ``local_nodes ·
    group.size`` nodes cut into contiguous blocks, one per rank of
    ``group``: 1/3 each to self and the two ring neighbours (1/2 each at
    two nodes, the identity at one), which is the ring's Metropolis
    matrix, so the mix equals the dense mixer's to float tolerance.
    Only the boundary rows cross ranks. Mixes in f32 and stores in the
    leaf's dtype (the wire moves shards in their storage dtype).
    ``mix.mix_leaves`` mixes many leaves with one collective; the
    algorithms take it where the mixer has it."""
    if local_nodes < 1:
        raise ValueError(f"local_nodes must be >= 1, got {local_nodes}")
    from repro_torch.launch import dist
    n = local_nodes * group.size

    def combine(x, nb):
        if n <= 1:
            return x
        xf = x.float()
        fwd = block_ring_shift(x, group, 1, nb).float()
        if n == 2:
            y = 0.5 * xf + 0.5 * fwd
        else:
            y = (xf + fwd + block_ring_shift(x, group, -1, nb).float()) / 3.0
        return y.to(x.dtype)

    def mix_leaves(xs):
        return [combine(x, nb) for x, nb in
                zip(xs, dist.ring_neighbors_many(xs, group))]

    def mix_leaf(x):
        return mix_leaves([x])[0]

    def mix(local: Params) -> Params:
        return dict(zip(local, mix_leaves(list(local.values()))))

    mix.mix_leaf = mix_leaf
    mix.mix_leaves = mix_leaves
    return _tree_sum_hook(mix, group, reduce)


def make_psum_mixer(group: Group, num_nodes: int,
                    reduce=None) -> Mixer:
    """Exact averaging for the complete graph, whose Metropolis matrix
    is uniform 1/n: the local rows' sum, summed over the node group,
    over n."""
    from repro_torch.launch import dist
    def mix_leaves(xs):
        sums = [x.float().sum(dim=0) for x in xs]
        total = dist.all_reduce(torch.cat([t.reshape(-1) for t in sums]),
                                group)
        out = []
        for x, t in zip(xs, torch.split(total, [t.numel() for t in sums])):
            out.append((t.reshape(x.shape[1:]) / num_nodes)
                       .expand(x.shape).to(x.dtype))
        return out

    def mix_leaf(x):
        return mix_leaves([x])[0]

    def mix(local: Params) -> Params:
        return dict(zip(local, mix_leaves(list(local.values()))))

    mix.mix_leaf = mix_leaf
    mix.mix_leaves = mix_leaves
    return _tree_sum_hook(mix, group, reduce)


def make_shard_mixer(topology: Topology, group: Group, *,
                     local_nodes: int, reduce=None, compression=None,
                     gossip: str = "sync") -> Mixer:
    """The ``backend="ppermute"`` branch of the reference's
    ``make_mixer``: exact averaging on a complete graph that is not also
    a ring, the boundary-row ring mixer on a ring; every other graph,
    compression and delayed gossip raise. (A churn mask, a wire fault
    and an f32 wire are refused before a sharded run is built:
    ``sched.validate_shard_schedule`` and the entry points.)"""
    if compression is not None or gossip != "sync":
        raise NotImplementedError(
            "compressed and delayed gossip under the sharded driver are "
            "not ported yet; see ROADMAP.md queue 1 item 12")
    if topology.n != local_nodes * group.size:
        raise ValueError(f"topology has {topology.n} nodes, the node "
                         f"group holds {local_nodes} x {group.size}")
    if _is_full(topology) and not _is_ring(topology):
        return make_psum_mixer(group, topology.n, reduce)
    if not _is_ring(topology):
        raise ValueError(
            "the sharded mixers implement ring gossip (plus exact "
            f"averaging on complete graphs); topology {topology.name!r} "
            "must run node-stacked — use backend='dense'")
    return make_ppermute_mixer(group, local_nodes, reduce)


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
    if backend == "ppermute":
        raise ValueError(
            "the sharded backend runs on a rank's node block: build it "
            "with make_shard_mixer(topology, group, local_nodes=...)")
    if backend != "dense":
        raise NotImplementedError(
            f"mixer backend {backend!r} is not ported yet (only 'dense' "
            "and the sharded 'ppermute'); see ROADMAP.md queue 1 item 12")
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
