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
spawn.

The dry run's meshes are :class:`AxisMesh` es: named axes and their
sizes. :func:`make_production_mesh` is abstract (no ranks, no devices:
the dry run runs on the meta device), (data 16, model 16) or (pod 2,
data 16, model 16) as in the reference; :func:`make_host_mesh` is a
(data, model) grid over the ranks of a run, with a process group per
axis. :func:`node_axes_for` and :func:`num_nodes` read either kind.

The roofline constants are the card's, not the reference's TPU v5e
figures: datasheet numbers of an "NVIDIA H100 80GB HBM3" SXM card at its
700 W limit, not measurements. A mesh axis wider than one 8-card NVLink
domain would run at the network's rate between domains, which the dry
run does not model: every collective is charged at the NVLink rate.
"""
from __future__ import annotations

import warnings
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.launch import dist

# NVIDIA H100 80GB HBM3 (SXM, 700 W) datasheet figures, per card, for
# the dry run's roofline terms
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BANDWIDTH = 3.35e12           # B/s, HBM3
LINK_BANDWIDTH = 450e9            # B/s a direction, NVLink 4


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (node, model) grid of ranks."""
    node: dist.Group
    model: dist.Group

    @property
    def shape(self) -> Dict[str, int]:
        return {"node": self.node.size, "model": self.model.size}


def _largest_divisor(num_nodes: int, limit: int) -> int:
    """Largest divisor of ``num_nodes`` that is ≤ ``limit`` (≥ 1)."""
    return max(d for d in range(1, max(min(limit, num_nodes), 1) + 1)
               if num_nodes % d == 0)


def _grid(node_size: int, model_size: int) -> Mesh:
    """The (node, model) grid over ranks 0 .. node_size·model_size − 1
    (:func:`make_grid`) as the sharded driver's :class:`Mesh`."""
    grid = make_grid(("node", "model"), (node_size, model_size))
    return Mesh(grid.group("node"), grid.group("model"))


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


# ------------------------------------------------------------ the dry run
@dataclass(frozen=True)
class AxisMesh:
    """A named grid: ``axis_names`` and ``axis_sizes`` (the reference's
    ``Mesh.axis_names`` and ``Mesh.shape``); over the ranks of a run,
    also this rank's process group along each axis (``groups``, None
    for an abstract mesh)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    groups: Optional[Tuple[dist.Group, ...]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def group(self, name: str) -> dist.Group:
        """This rank's group along axis ``name``."""
        if self.groups is None:
            raise ValueError("an abstract mesh has no ranks")
        return self.groups[self.axis_names.index(name)]

    def federation(self) -> Mesh:
        """A (data, model) grid over ranks as the sharded driver's
        federation mesh: the data axis is the node axis (replica
        scope)."""
        return Mesh(self.group("data"), self.group("model"))


def make_production_mesh(*, multi_pod: bool = False) -> AxisMesh:
    """The reference's production mesh, abstract: (data 16, model 16),
    256 devices, or (pod 2, data 16, model 16), 512."""
    if multi_pod:
        return AxisMesh(("pod", "data", "model"), (2, 16, 16))
    return AxisMesh(("data", "model"), (16, 16))


_GRIDS: Dict[Tuple, AxisMesh] = {}


def make_grid(names: Tuple[str, ...], sizes: Tuple[int, ...]) -> AxisMesh:
    """A grid of ``sizes`` over every rank of the run, in row-major order
    (rank r at the coordinates of r in the grid, the last axis fastest,
    as the reference reshapes its device list), with a process group per
    axis: the ranks that differ from this one in that coordinate only.
    Collective: every rank builds every group, in one order, once a
    process."""
    rank, world = dist.world()
    key = (tuple(names), tuple(sizes), world)
    if key not in _GRIDS:
        used = math.prod(sizes)
        if world != used:
            raise ValueError(
                f"the grid {dict(zip(names, sizes))} uses {used} rank(s) "
                f"but the run has {world}; spawn {used} ranks "
                "(launch.dist.spawn) — an SPMD rank outside the mesh "
                "would have no nodes to hold")
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        mine = []
        for a, (n, st) in enumerate(zip(sizes, strides)):
            for base in range(used):
                if (base // st) % n:          # one group per line of axis a
                    continue
                g = dist.new_group([base + i * st for i in range(n)])
                if rank in g.ranks:
                    mine.append(g)
        _GRIDS[key] = AxisMesh(tuple(names), tuple(sizes), tuple(mine))
    return _GRIDS[key]


def make_host_mesh(data: int = 1, model: int = 1) -> AxisMesh:
    """A (data, model) grid over the ranks of the run, sizes cut to the
    world as the reference cuts them to its devices; the world must be
    the grid's size (:func:`make_grid`)."""
    _, n = dist.world()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return make_grid(("data", "model"), (data, model))


def node_axes_for(mesh, scope: str) -> Tuple[str, ...]:
    """Which mesh axes form the decentralized gossip graph. scope
    "replica": every data-parallel index is a node; "pod": one node per
    pod, FSDP over "data" inside it (the architectures too large to
    hold per replica)."""
    names = mesh.axis_names
    if scope == "replica":
        return tuple(a for a in ("pod", "data") if a in names)
    if scope == "pod":
        return ("pod",) if "pod" in names else ()
    raise ValueError(scope)


def num_nodes(mesh, scope: str) -> int:
    n = 1
    for a in node_axes_for(mesh, scope):
        n *= mesh.shape[a]
    return n
