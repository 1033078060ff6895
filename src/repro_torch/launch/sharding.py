"""Sharding rules of the sharded driver (``src/repro/launch/sharding.py``).

Params are node-stacked flat dicts (leading dim = node axis, keys the
reference's paths joined with ``/``). On a mesh
(:mod:`repro_torch.launch.mesh`) each rank holds its contiguous block of
node rows; on the 2-D federation mesh it also holds one ``"model"``
shard of each weight leaf: the largest trailing dim divisible by the
model size (for embedding and LM-head leaves, the vocabulary), an MoE
expert bank on its expert dim, and nothing of the small leaves (norms,
biases), which every model peer keeps whole.

Where the reference gives a ``PartitionSpec`` per leaf, the port gives
a :class:`Spec`: whether the leaf has the node axis, and the dim it
shards over ``"model"`` (None when replicated over it). The rule is the
reference's, applied to the port's layouts: a ResNet conv kernel is
OIHW here and HWIO there, so when two of its dims tie the port shards
the other one of them; the gathered leaf and the trajectory are the
same either way.

Specs are computed once from the *global* shapes
(:func:`federation_specs`); a local block cannot tell which of two
equal dims was cut. :func:`comm_block` cuts a stateful gossip mixer's
comm state (estimates node-stacked at full width, the uncompressed
snapshot like the params, sums and generator states replicated). :func:`local_block` cuts a global tree down to this
rank's block and :func:`global_stack` gathers one back (evals, tests,
the round's payload); :func:`gather_model_tree` and
:func:`slice_model_tree` move between a rank's shards and full-width
leaves inside one replica.

The dry run's rules (``launch.dryrun``) are the reference's, whole: a
:class:`PSpec` per leaf (the port's ``PartitionSpec``: per dim None, an
axis name or a tuple of names) from :func:`leaf_spec` in both scopes
with its experts rule (``REPRO_SHARD_EXPERTS=both`` read as the
reference reads it), :func:`param_shardings`, :func:`batch_shardings`,
:func:`serve_param_shardings`, :func:`serve_batch_shardings` and
:func:`serve_state_shardings`, over an abstract
:class:`launch.mesh.AxisMesh`; :func:`shard_shape` is one device's
shard of a leaf. They take the port's trees (flat param dicts, whose
keys are the reference's paths joined with ``/``; a decode state's
caches, whose named-tuple fields and shapes are the reference's) and
return a tree of specs of the same structure. The sharded driver's
:class:`Spec` is the runtime view of the replica-scope rule on the 2-D
federation mesh: the node axis, and the one dim cut over "model".
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch import dist
from repro_torch.launch.mesh import Mesh


class Spec(NamedTuple):
    """How one leaf is laid out over the mesh."""
    node: bool                    # leading dim is the node axis
    model_dim: Optional[int]      # dim cut over "model", None if whole


REPLICATED = Spec(False, None)


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def node_leaf_spec(leaf, num_nodes: int) -> Spec:
    """The 1-D node mesh's spec of one leaf: its leading dim is the node
    axis when it has ``num_nodes`` rows; scalars, counters and payloads
    without a node dim replicate."""
    if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
            and leaf.shape[0] == num_nodes:
        return Spec(True, None)
    return REPLICATED


def _map(tree, fn, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``: dict keys,
    list positions and named-tuple field names joined with "/", as the
    reference's ``_path_str`` joins a pytree path."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        return _rebuild(tree, [_map(v, fn, f"{path}{i}/")
                               for i, v in zip(names, tree)])
    return fn(path[:-1], tree)


def _rebuild(tree, items):
    """A list, tuple or NamedTuple of the same type holding ``items``."""
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def node_stacked_specs(tree, num_nodes: int):
    """Per-leaf :class:`Spec` tree of a node-stacked tree on the 1-D
    node mesh."""
    return _map(tree, lambda _, leaf: node_leaf_spec(leaf, num_nodes))


def _param_skip_dims(path: str, ndim: int) -> int:
    """Leading dims of a node-stacked param leaf that are NOT shardable
    weight dims: dim 0 is the node axis; scanned-layer stacking
    (``layers_*`` subtrees, stacked codebooks) adds one more."""
    skip = 2 if ("layers_" in path or "embed_cb" in path
                 or ("head" in path and ndim > 3)) else 1
    return min(skip, max(ndim - 1, 1))


def leaf_model_dim(path: str, shape, model_size: int) -> Optional[int]:
    """The dim the reference's replica-scope ``leaf_spec`` puts on
    ``"model"`` for a node-stacked leaf of ``shape``: an expert bank's
    expert dim, else the largest divisible trailing weight dim; None for
    leaves with fewer than two trailing dims."""
    trailing = list(range(_param_skip_dims(path, len(shape)), len(shape)))
    if len(trailing) < 2:
        return None
    if "experts" in path and len(trailing) >= 3:
        e_dim = trailing[0]
        return e_dim if _divisible(shape[e_dim], model_size) else None
    cand = sorted(trailing, key=lambda i: -shape[i])
    return next((i for i in cand if _divisible(shape[i], model_size)),
                None)


def federation_specs(tree, num_nodes: int, mesh: Mesh):
    """Per-leaf :class:`Spec` tree for the federation mesh, from the
    *global* shapes: node-stacked leaves put dim 0 on the node axis and,
    when the mesh has a model axis wider than 1, cut
    :func:`leaf_model_dim` over it. On the 1-D node mesh this is
    :func:`node_stacked_specs`."""
    model_size = mesh.shape["model"]
    if model_size <= 1:
        return node_stacked_specs(tree, num_nodes)

    def one(path, leaf):
        spec = node_leaf_spec(leaf, num_nodes)
        if not spec.node:
            return spec
        return Spec(True, leaf_model_dim(path, tuple(leaf.shape),
                                         model_size))

    return _map(tree, one)


def like_params(tree, param_specs: Dict[str, Spec], num_local: int):
    """Specs of a tree that mirrors the params (optimizer state, grads):
    a leaf under a params key takes that key's spec; any other leaf with
    ``num_local`` rows is node-stacked and model-replicated."""
    def one(path, leaf):
        key = path
        while key:
            if key in param_specs:
                return param_specs[key]
            key = key.partition("/")[2]
        return node_leaf_spec(leaf, num_local)
    return _map(tree, one)


def _zip(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [_zip(v, s, fn) for v, s in zip(tree, specs)])
    return fn(tree, specs)


GATHER_BYTES = 1 << 28    # shards moved by one all_gather at most


def gather_model_tree(tree, specs, mesh: Mesh):
    """All-gather every model-sharded leaf back to full width along its
    cut dim over the mesh's model group; model-replicated leaves pass
    through. The shards move in few collectives, up to GATHER_BYTES of
    them each, so that a step pays few waits and a full-width model no
    second copy of itself in flight."""
    if mesh.model.size == 1:
        return tree
    cut = []

    def collect(x, spec):
        if isinstance(x, torch.Tensor) and spec.model_dim is not None:
            cut.append((x, spec.model_dim))
        return x
    _zip(tree, specs, collect)
    full, batch, nbytes = [], [], 0
    for i, (x, _) in enumerate(cut + [(None, None)]):
        size = 0 if x is None else x.numel() * x.element_size()
        if batch and (x is None or nbytes + size > GATHER_BYTES):
            parts = dist.all_gather_many([cut[j][0] for j in batch],
                                         mesh.model)
            full += [torch.cat(p, dim=cut[j][1])
                     for j, p in zip(batch, parts)]
            batch, nbytes = [], 0
        batch.append(i)
        nbytes += size
    it = iter(full)

    def put(x, spec):
        if isinstance(x, torch.Tensor) and spec.model_dim is not None:
            return next(it)
        return x
    return _zip(tree, specs, put)


def slice_model_tree(tree, specs, mesh: Mesh):
    """Full-width leaves cut down to this rank's model shard — the
    inverse of :func:`gather_model_tree`."""
    size, idx = mesh.model.size, mesh.model.index

    def one(x, spec):
        if not isinstance(x, torch.Tensor) or spec.model_dim is None:
            return x
        width = x.shape[spec.model_dim] // size
        return x.narrow(spec.model_dim, idx * width, width)
    return _zip(tree, specs, one)


def local_block(tree, specs, mesh: Mesh):
    """This rank's block of a global tree: its node rows (``node`` leaves)
    and its model shard (cut leaves), as new contiguous tensors.
    Replicated leaves pass through."""
    size, j = mesh.node.size, mesh.node.index

    def nodes(x, spec):
        if not isinstance(x, torch.Tensor) or not spec.node:
            return x
        L = x.shape[0] // size
        return x[j * L:(j + 1) * L]
    out = slice_model_tree(_zip(tree, specs, nodes), specs, mesh)
    return _map(out, lambda _, x: x.contiguous()
                if isinstance(x, torch.Tensor) else x)


def global_stack(tree, specs, mesh: Mesh):
    """The global tree from every rank's :func:`local_block` (collective
    over the whole mesh): model shards gathered, then node blocks."""
    full = gather_model_tree(tree, specs, mesh)

    def nodes(x, spec):
        if not isinstance(x, torch.Tensor) or not spec.node:
            return x
        return dist.all_gather_cat(x, mesh.node, 0)
    return _zip(full, specs, nodes)


def comm_block(comm, param_specs: Dict[str, Spec], mesh: Mesh):
    """This rank's block of a stateful mixer's comm state built on the
    global params (``init_comm`` needs no collective): the shared
    estimates and the neighbours' replicas (``hat``, ``hfwd``, ``hbwd``:
    (n, flat) rows, full width, replicated over the model group) keep
    the block's node rows, the uncompressed ``prev`` is cut like the
    params (node rows and model shard), and the complete graph's sum
    ``hsum`` and random-k's generator state (``key``) are replicated."""
    out = {}
    for name, sub in comm.items():
        if name == "prev":
            out[name] = local_block(sub, param_specs, mesh)
        elif name in ("hat", "hfwd", "hbwd"):
            out[name] = local_block(sub, {k: Spec(True, None) for k in sub},
                                    mesh)
        else:
            out[name] = sub
    return out


SHARD_COMM = ("hfwd", "hbwd", "hsum")    # the sharded mixer's own replicas


def comm_global(comm, param_specs: Dict[str, Spec], mesh: Mesh):
    """The whole federation's comm state in the node-stacked mixers'
    structure, from every rank's block (collective): ``prev`` gathered
    like the params, the estimates ``hat`` node by node, the generator
    state as it is; the sharded mixer's replicas of its neighbours'
    estimates and the complete graph's sum (:data:`SHARD_COMM`) are left
    out, since both are functions of ``hat`` (:func:`comm_from_global`).
    This is what a durable snapshot stores, whichever driver wrote it."""
    out = {}
    for name, sub in comm.items():
        if name == "prev":
            out[name] = global_stack(sub, param_specs, mesh)
        elif name == "hat":
            out[name] = gather_nodes(sub, mesh)
        elif name not in SHARD_COMM:
            out[name] = sub
    return out


def comm_from_global(comm, names, param_specs: Dict[str, Spec],
                     mesh: Mesh):
    """This rank's block (:func:`comm_block`) of a whole-federation comm
    state in the node-stacked structure (a snapshot's), with the sharded
    mixer's entries among ``names`` rebuilt from the estimates: ``hfwd``
    (row i holds x̂_{i−1}) the roll of ``hat`` by one, ``hbwd`` the roll
    back, ``hsum`` its sum over the nodes. The replicas are kept equal
    to the rolls bit for bit in a run, so a ring resumes exactly; the
    complete graph's running sum is recomputed, equal to f32 rounding."""
    full = dict(comm)
    hat = comm.get("hat", {})
    if "hfwd" in names:
        full["hfwd"] = {k: torch.roll(h, 1, 0) for k, h in hat.items()}
    if "hbwd" in names:
        full["hbwd"] = {k: torch.roll(h, -1, 0) for k, h in hat.items()}
    if "hsum" in names:
        full["hsum"] = {k: h.sum(dim=0, keepdim=True)
                        for k, h in hat.items()}
    return comm_block(full, param_specs, mesh)


def gather_nodes(tree, mesh: Mesh):
    """Node blocks of a tree whose every tensor leaf has the node axis
    first and no model cut (a round's payload, a carry) gathered to the
    global node stack over the node group."""
    return _map(tree, lambda _, x: dist.all_gather_cat(x, mesh.node, 0)
                if isinstance(x, torch.Tensor) else x)


class ShardReduce:
    """The replica-wide reductions of a sharded step (the reference's
    ``reduce_tree_sum`` split): a per-leaf partial sum of a model-sharded
    leaf completes over the model group too, while a model-replicated
    leaf, which every model peer holds whole, sums over the node group
    only (summed over "model" it would count ``model_size`` times)."""

    def __init__(self, mesh: Mesh, num_nodes: int,
                 model_dims: Optional[Dict[str, Optional[int]]] = None):
        self.mesh = mesh
        self.num_nodes = num_nodes
        self.model_dims = model_dims or {}

    def sharded(self, key: str) -> bool:
        return self.model_dims.get(key) is not None

    def tree_sum(self, sq: Dict[str, Any]):
        """Σ over leaves and over every node of the per-leaf sums ``sq``
        (QG-DSGDm-N's global grad norm)."""
        keys = sorted(sq)
        sh = [sq[k] for k in keys if self.sharded(k)]
        rep = [sq[k] for k in keys if not self.sharded(k)]
        dev = sq[keys[0]].device
        total = torch.zeros((), device=dev)
        if sh and self.mesh.model.size > 1:
            total = total + dist.all_reduce(
                dist.all_reduce(torch.stack(sh).sum(), self.mesh.node),
                self.mesh.model)
        elif sh:
            rep = sh + rep
        if rep:
            total = total + dist.all_reduce(torch.stack(rep).sum(),
                                            self.mesh.node)
        return total

    def rows(self, per_leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(L,) per-node totals of per-leaf (L,) row values, in sorted
        leaf order: model-sharded leaves' rows completed over the model
        group."""
        keys = sorted(per_leaf)
        rep = [per_leaf[k] for k in keys if not self.sharded(k)]
        sh = [per_leaf[k] for k in keys if self.sharded(k)]
        total = sum(rep) if rep else 0
        if sh:
            part = sum(sh)
            if self.mesh.model.size > 1:
                part = dist.all_reduce(part, self.mesh.model)
            total = total + part
        return total

    def node_means(self, tree: Dict[str, torch.Tensor]):
        """The (1, ...) mean over all ``num_nodes`` nodes of every leaf of
        this rank's block (the node group's sums), in the leaf's dtype,
        with one collective."""
        sums = {k: v.float().sum(dim=0, keepdim=True)
                for k, v in tree.items()}
        flat = dist.all_reduce(torch.cat([t.reshape(-1)
                                          for t in sums.values()]),
                               self.mesh.node)
        parts = torch.split(flat, [t.numel() for t in sums.values()])
        return {k: (p.reshape(sums[k].shape) / self.num_nodes)
                .to(tree[k].dtype) for k, p in zip(sums, parts)}


# ------------------------------------------------ the dry run's rules
class PSpec(tuple):
    """One leaf's layout over an :class:`launch.mesh.AxisMesh`: per dim
    None (whole), an axis name, or a tuple of names (cut over their
    product, the first outermost) — the reference's ``PartitionSpec``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"PSpec{tuple(self)!r}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: PSpec, mesh) -> Tuple[int, ...]:
    """One device's shard of a leaf of ``shape`` laid out by ``spec``
    (``NamedSharding.shard_shape``): each dim over the product of its
    axes' sizes, which must divide it."""
    sizes = mesh.shape
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        k = math.prod(sizes[a] for a in _axes(entry))
        if d % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({k})")
        out.append(d // k)
    return tuple(out)


def shard_bytes(leaf, spec: PSpec, mesh) -> int:
    """Bytes of one device's shard of ``leaf`` (a tensor, any device)."""
    return math.prod(shard_shape(tuple(leaf.shape), spec, mesh)) \
        * leaf.element_size()


def spec_axes(spec: PSpec) -> Tuple[str, ...]:
    """Every axis a spec cuts over."""
    return tuple(a for entry in spec for a in _axes(entry))


def leaf_spec(path: str, shape, mesh, node_axes, scope: str,
              skip_dims: int = 1) -> PSpec:
    """The reference's spec for one node-stacked param leaf: dim 0 over
    the node axes; an expert bank's expert dim over "model" (and in pod
    scope its d_model dim over "data"; with ``REPRO_SHARD_EXPERTS=both``
    in pod scope the expert dim over ("data", "model") when it divides);
    any other leaf of two or more weight dims "model" on its largest
    divisible weight dim and, in pod scope, "data" on the next
    divisible one. ``skip_dims``: the leading dims that are not weight
    dims (the node axis, and the layer axis of ``layers_*``)."""
    model_size = mesh.shape["model"]
    data_size = mesh.shape.get("data", 1)
    spec: list = [None] * len(shape)
    if node_axes:
        spec[0] = tuple(node_axes) if len(node_axes) > 1 else node_axes[0]
    trailing = list(range(skip_dims, len(shape)))
    if len(trailing) >= 2:
        if "experts" in path and len(trailing) >= 3:
            e_dim = trailing[0]
            both = (os.environ.get("REPRO_SHARD_EXPERTS") == "both"
                    and scope == "pod")   # "data" is the node axis else
            if both and _divisible(shape[e_dim], model_size * data_size):
                spec[e_dim] = ("data", "model")
            elif _divisible(shape[e_dim], model_size):
                spec[e_dim] = "model"
                if scope == "pod" and _divisible(shape[trailing[1]],
                                                 data_size):
                    spec[trailing[1]] = "data"
        else:
            cand = sorted(trailing, key=lambda i: -shape[i])
            m_dim = next((i for i in cand
                          if _divisible(shape[i], model_size)), None)
            if m_dim is not None:
                spec[m_dim] = "model"
            if scope == "pod":
                d_dim = next((i for i in cand if i != m_dim
                              and _divisible(shape[i], data_size)), None)
                if d_dim is not None:
                    spec[d_dim] = "data"
    return PSpec(*spec)


def param_shardings(params, mesh, scope: str):
    """A spec tree for node-stacked params (or an optimizer state that
    mirrors them): :func:`leaf_spec` with the node axes of ``scope``."""
    from repro_torch.launch.mesh import node_axes_for
    node_axes = node_axes_for(mesh, scope)
    return _map(params, lambda ps, leaf: leaf_spec(
        ps, tuple(leaf.shape), mesh, node_axes, scope,
        skip_dims=_param_skip_dims(ps, leaf.dim())))


def batch_shardings(batch, mesh, scope: str):
    """A node-stacked batch (N, B, ...): the node dim over the node axes;
    in pod scope the per-node batch over "data" when it divides."""
    from repro_torch.launch.mesh import node_axes_for
    node_axes = node_axes_for(mesh, scope)
    data = mesh.shape.get("data", 1)

    def one(_, leaf):
        spec: list = [None] * leaf.dim()
        if node_axes:
            spec[0] = tuple(node_axes) if len(node_axes) > 1 \
                else node_axes[0]
        if scope == "pod" and leaf.dim() > 1 and leaf.shape[1] % data == 0 \
                and data > 1:
            spec[1] = "data"
        return PSpec(*spec)
    return _map(batch, one)


def serve_param_shardings(params, mesh):
    """The served (consensus) model's params: no node axis; "model" on
    the largest divisible weight dim and "data" on the next (FSDP), the
    layer axis of ``layers_*`` left whole."""
    def one(ps, leaf):
        skip = min(1 if "layers_" in ps else 0, max(leaf.dim() - 1, 0))
        spec = leaf_spec(ps, (1,) + tuple(leaf.shape), mesh, (), "pod",
                         skip_dims=skip + 1)
        return PSpec(*tuple(spec)[1:])
    return _map(params, one)


def _batch_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    total = math.prod(mesh.shape[a] for a in axes) if axes else 1
    return (axes if len(axes) > 1 else axes[0]) if axes else None, total


def serve_batch_shardings(batch, mesh):
    """A request batch: the batch dim over ("pod", "data") when it
    divides."""
    entry, total = _batch_axes(mesh)

    def one(_, leaf):
        spec: list = [None] * leaf.dim()
        if leaf.dim() and leaf.shape[0] % total == 0 and total > 1:
            spec[0] = entry
        return PSpec(*spec)
    return _map(batch, one)


def serve_state_shardings(state, mesh):
    """A decode state's caches, each leaf (L, B, ...): B over the data
    axes when it divides, and the largest later dim that divides over
    "model". The port's caches have the reference's fields and shapes
    (``convert.to_jax_decode_state`` pairs them); their positions and
    lengths are int64 where the reference's are int32."""
    entry, total = _batch_axes(mesh)
    model_size = mesh.shape["model"]

    def one(_, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % total == 0 and total > 1:
            spec[1] = entry
        if len(shape) >= 3:
            cand = sorted(range(2, len(shape)), key=lambda i: -shape[i])
            m = next((i for i in cand if shape[i] % model_size == 0
                      and shape[i] >= model_size), None)
            if m is not None:
                spec[m] = "model"
        return PSpec(*spec)
    return _map(state, one)


def spec_leaves(tree, specs, path: str = ""):
    """(path, leaf, spec) of every tensor leaf of ``tree`` beside its
    spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from spec_leaves(v, specs[k], f"{path}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v, s in zip(tree._fields, tree, specs):
            yield from spec_leaves(v, s, f"{path}{f}/")
    elif isinstance(tree, (list, tuple)):
        for i, (v, s) in enumerate(zip(tree, specs)):
            yield from spec_leaves(v, s, f"{path}{i}/")
    elif isinstance(tree, torch.Tensor):
        yield path[:-1], tree, specs
