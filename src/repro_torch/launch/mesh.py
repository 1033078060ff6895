"""The sharded driver's meshes over the ranks of a ``torch.distributed``
run (``src/repro/launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` es over devices; the port's
mesh is a grid of ranks (:mod:`repro_torch.launch.dist`, one process per
mesh device) with a process group per axis. Rank ``r`` sits at grid
position ``(r // model_parallel, r % model_parallel)``, as the
reference reshapes its device list. :class:`Mesh` carries, for this
rank, the ``node`` group (the ranks that hold the other node blocks of
the same model shard: the gossip and label-exchange axis) and the
``model`` group (the ranks that hold the other model shards of the same
node block: the axis of the all-gathers inside one replica).

The device pool is the world of the run. The reference leaves the
devices its divisor rule does not use idle; an SPMD rank has no such
state, so a world larger than the mesh raises and names the world to
spawn. ``make_production_mesh``, ``make_host_mesh`` and
``node_axes_for`` come with the dry run (ROADMAP.md item 10b.2).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.launch import dist


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (node, model) grid of ranks."""
    node: dist.Group
    model: dist.Group

    @property
    def shape(self) -> Dict[str, int]:
        return {"node": self.node.size, "model": self.model.size}


_MESHES: Dict[Tuple[int, int, int], Mesh] = {}


def _largest_divisor(num_nodes: int, limit: int) -> int:
    """Largest divisor of ``num_nodes`` that is ≤ ``limit`` (≥ 1)."""
    return max(d for d in range(1, max(min(limit, num_nodes), 1) + 1)
               if num_nodes % d == 0)


def _grid(node_size: int, model_size: int) -> Mesh:
    """The groups of a (node_size, model_size) grid over ranks 0 ..
    node_size·model_size − 1, built once per process (creating a group
    is collective: every rank builds every group, in one order)."""
    rank, world = dist.world()
    key = (node_size, model_size, world)
    if key not in _MESHES:
        used = node_size * model_size
        if world != used:
            raise ValueError(
                f"the mesh ({node_size} node x {model_size} model) uses "
                f"{used} rank(s) but the run has {world}; spawn {used} "
                "ranks (launch.dist.spawn) — an SPMD rank outside the mesh "
                "would have no nodes to hold")
        node_groups = [dist.new_group([i * model_size + m
                                       for i in range(node_size)])
                       for m in range(model_size)]
        model_groups = [dist.new_group([i * model_size + m
                                        for m in range(model_size)])
                        for i in range(node_size)]
        _MESHES[key] = Mesh(node_groups[rank % model_size],
                            model_groups[rank // model_size])
    return _MESHES[key]


def make_node_mesh(num_nodes: int) -> Mesh:
    """1-D mesh for the sharded driver (``driver_mode="shard"``): one
    ``"node"`` axis over the largest rank count that divides
    ``num_nodes``, so every rank holds a contiguous block of
    ``num_nodes // size`` nodes. One rank (no process group) is the
    one-device mesh: the block holds every node.

    When ``num_nodes`` has no divisor matching the world (a prime node
    count larger than it), the mesh uses fewer ranks than there are and
    a warning names the size, as in the reference; the extra ranks then
    make :func:`_grid` raise."""
    if num_nodes < 1:
        raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
    _, world = dist.world()
    size = _largest_divisor(num_nodes, world)
    if size < min(world, num_nodes):
        warnings.warn(
            f"make_node_mesh: num_nodes={num_nodes} has no divisor matching "
            f"the {world}-rank pool; using a {size}-rank node mesh "
            f"({num_nodes // size} node(s) per rank). Pick a node count "
            "that divides by the rank count to use every rank.",
            RuntimeWarning, stacklevel=2)
    return _grid(size, 1)


def make_federation_mesh(num_nodes: int, model_parallel: int = 1) -> Mesh:
    """2-D ``("node", "model")`` mesh for the sharded driver: the node
    axis places node blocks exactly like :func:`make_node_mesh`; the
    model axis shards each replica's parameters (FSDP-style, see
    ``launch.sharding.federation_specs``). ``model_parallel=1`` returns
    the 1-D node mesh.

    The grid factors as ``(node_size, model_parallel)``: ``node_size`` is
    the largest divisor of ``num_nodes`` that fits in ``world //
    model_parallel``. Gossip runs over ``"node"`` only; ``"model"``
    carries the all-gathers and sums inside one replica."""
    if model_parallel == 1:
        return make_node_mesh(num_nodes)
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    if num_nodes < 1:
        raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
    _, world = dist.world()
    if model_parallel > world:
        raise ValueError(
            f"model_parallel={model_parallel} exceeds the rank count "
            f"({world}) — shrink --model-parallel or spawn more ranks "
            "(launch.dist.spawn)")
    node_size = _largest_divisor(num_nodes, world // model_parallel)
    return _grid(node_size, model_parallel)
