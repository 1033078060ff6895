"""Gossip mixing: x_i ← Σ_j W_ij x_j over node-stacked params, behind one
entry point (the reference's ``repro.core.mixing``).

:func:`make_mixer` builds the node-stacked backends:

* ``dense`` — the (n, n) Metropolis matrix applied along the leading
  node axis, one matmul per leaf: the numerical oracle;
* ``gather`` — each node gathers its padded neighbour slots
  (``Topology.neighbor_arrays``) and combines them with the gathered
  Metropolis weights, O(Σ deg) work;
* ``roll`` — the ring's fast path: rolls along the node axis, 1/3 each
  to self and the two neighbours (1/2 at two nodes, the identity at
  one);
* ``auto`` (the default) — ``roll`` on an unmasked ring, ``gather``
  everywhere else.

Each has the per-leaf protocol (``mix.mix_leaf``, which QG-DSGDm-N
fuses into its update), ``wire_dtype`` ("native" moves leaves in their
storage dtype, "float32" upcasts first; sums run in f32 either way), the
churn mask (``active``: the masked Metropolis matrix, identity rows on
down nodes), the resilience layer's wire faults (``wire_fault``, wrapped
by ``resil.make_validated_mixer``; a fault-free mixer comes back
unwrapped) and a ``remake(active=..., stale=...)`` handle.

**Compressed, delayed and straggler gossip** (``compression``,
``gossip="delayed"``, ``stale``) make the mixer *stateful*
(:func:`make_compressed_mixer`): every node keeps shared estimates x̂ of
the params, the wire moves top-k or random-k deltas of x − x̂ (CHOCO-SGD,
the gap x − x̂ being the implicit error feedback), delayed gossip mixes
the previous step's estimates and a stale straggler's outgoing payload
freezes. A stateful mixer is bound to its comm state per step
(``mix.init_state(params)``, ``mix.bind(comm)`` →
:class:`_BoundStatefulMixer`, ``finalize()``); ``core.driver.make_step``
carries the state. The bound mixer takes whole leaves (a top-k over a
slice is another compressor), so the algorithms hand it whole leaves;
it updates the comm state in place.

**Top-k ties.** ``torch.topk`` promises no order among equal values;
the reference's ``lax.top_k`` keeps the lower index. :func:`topk_indices`
selects by that rule: every value above the k-th largest, then the
lowest-index values equal to it. A random-k payload is the top-k of
uniforms drawn from a ``torch.Generator`` that the comm state carries
(its state tensor, so snapshots and rollback restore it); the
reference's streams differ, so parity tests replay its uniforms through
the ``uniform`` hook.

The sharded driver's backends (:func:`make_shard_mixer`) run on one
rank's contiguous block of a ring's or complete graph's nodes
(:mod:`repro_torch.launch.dist`): :func:`make_ppermute_mixer` takes the
two boundary rows from the neighbouring ranks (:func:`block_ring_shift`)
and mixes 1/3 each (1/2 at two nodes) — or, over the (pod, data) groups
of a grid, the reference's hierarchical ring-of-rings —,
:func:`make_psum_mixer` averages
exactly over the node group, and :func:`make_compressed_ppermute_mixer`
moves the compressed payloads' (value, index) boundary rows — one
exchange for every leaf of a step — into replicas of the neighbours'
estimates (an ``all_gather`` of the payloads into a replicated sum on the
complete graph). :func:`make_model_sharded_mixer` runs it on the 2-D
federation mesh. They carry ``reduce_tree_sum``, which completes
QG-DSGDm-N's global grad norm over the ranks.
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


def make_gather_mixer(topology: Topology, wire_dtype: str = "native",
                      active=None, device="cuda") -> Mixer:
    """Neighbour-gather gossip: row i combines x[nbr[i, d]] with the
    gathered Metropolis weights W[i, nbr[i, d]] (padding slots weigh 0),
    which is the dense mix on W's support. With ``active`` the weights
    come from the masked Metropolis matrix."""
    dev = resolve_device(device)
    nbr, valid = topology.neighbor_arrays(include_self=True)
    W = topology.mixing_matrix(active)
    w = W[np.arange(topology.n)[:, None], nbr] * valid      # (n, D)
    nbr_t = torch.as_tensor(nbr.astype(np.int64), device=dev)
    w_t = torch.as_tensor(w, dtype=torch.float32, device=dev)

    def mix_leaf(x):
        xw = x.float() if wire_dtype == "float32" else x
        g = xw[nbr_t].float()                               # (n, D, ...)
        y = torch.einsum("nd,nd...->n...", w_t, g)
        return y.to(x.dtype)

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
    Everything else runs node-stacked (``gather``/``dense``)."""
    return _is_ring(topology) or _is_full(topology)


def make_roll_mixer(num_nodes: int, wire_dtype: str = "native") -> Mixer:
    """Ring gossip by rolls along the node axis: 1/3 self + 1/3 each
    neighbour (1/2, 1/2 at two nodes; the identity at one)."""
    if num_nodes <= 1:
        identity = lambda t: t                              # noqa: E731
        identity.mix_leaf = lambda x: x
        return identity

    def mix_leaf(x):
        xw = x.float() if wire_dtype == "float32" else x
        fwd = torch.roll(xw, 1, 0).float()
        if num_nodes == 2:
            y = 0.5 * x.float() + 0.5 * fwd
        else:
            bwd = torch.roll(xw, -1, 0).float()
            y = (x.float() + fwd + bwd) / 3.0
        return y.to(x.dtype)

    def mix(tree: Params) -> Params:
        return {k: mix_leaf(v) for k, v in tree.items()}

    mix.mix_leaf = mix_leaf
    return mix


def make_mixer(topology: Topology, backend: str = "auto",
               wire_dtype: str = "native", device="cuda", *, active=None,
               compression=None, gossip: str = "sync", stale=None,
               stateful=None, consensus_lr: float = 1.0, wire_fault=None,
               wire_guard=None) -> Mixer:
    """One entry point for the node-stacked backends (module docstring).

    ``auto`` takes ``roll`` on an unmasked ring and ``gather`` elsewhere;
    ``roll`` refuses other graphs and masks. ``compression``, ``gossip``
    and ``stale`` select the stateful path (:func:`make_compressed_mixer`
    over the requested backend); ``stateful=True`` forces it for plain
    sync gossip too (the scheduler does, so that the comm state keeps
    its structure across a schedule whose later segments mark nodes
    stale). ``wire_fault`` / ``wire_guard``: the validated wrapper on
    stateless mixers, payload masking on compressed ones. Every mixer
    carries ``remake(active=..., stale=...)``, which rebuilds it for
    another availability or straggler mask. The sharded backend is built
    by :func:`make_shard_mixer`."""
    requested = backend
    if backend == "ppermute":
        raise ValueError(
            "the sharded backend runs on a rank's node block: build it "
            "with make_shard_mixer(topology, group, local_nodes=...)")
    fault_on = wire_fault is not None and not wire_fault.is_noop()
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"unknown gossip mode {gossip!r}; expected one "
                         f"of {GOSSIP_MODES}")
    comp = normalize_compression(compression)
    stale_any = stale is not None and bool(np.any(np.asarray(stale, bool)))
    want_state = (stateful if stateful is not None
                  else (comp is not None or gossip == "delayed"
                        or stale_any))
    masked = active is not None and not np.all(np.asarray(active, bool))
    if not masked:
        active = None
    dev = resolve_device(device)
    if want_state:
        mix = make_compressed_mixer(
            topology, backend, wire_dtype, dev, active=active,
            stale=(stale if stale_any else None), compression=comp,
            gossip=gossip, consensus_lr=consensus_lr,
            wire_fault=(wire_fault if fault_on else None),
            wire_guard=wire_guard)
        mix.remake = lambda active=None, stale=None: make_mixer(
            topology, requested, wire_dtype, dev, active=active,
            compression=comp, gossip=gossip, stale=stale, stateful=True,
            consensus_lr=consensus_lr, wire_fault=wire_fault,
            wire_guard=wire_guard)
        return mix
    if backend == "auto":
        backend = "roll" if _is_ring(topology) and not masked else "gather"
    if backend == "dense":
        mix = make_dense_mixer(topology.mixing_matrix(active), wire_dtype,
                               dev)
    elif backend == "gather":
        mix = make_gather_mixer(topology, wire_dtype, active, dev)
    elif backend == "roll":
        if masked:
            raise ValueError("roll mixer cannot mask churned nodes (a ring "
                             "with a hole is not a ring); use backend="
                             "'gather' or 'auto' for time-varying masks")
        if not _is_ring(topology):
            raise ValueError(
                f"roll mixer requires a ring topology, got {topology.name!r}")
        mix = make_roll_mixer(topology.n, wire_dtype)
    else:
        raise ValueError(f"unknown mixer backend {backend!r}; expected one "
                         "of ('auto', 'dense', 'gather', 'roll', 'ppermute')")
    if fault_on:
        from repro_torch.resil.faults import (DEFAULT_MAX_ABS,
                                              make_validated_mixer)
        mix = make_validated_mixer(
            mix, topology.mixing_matrix(active), wire_fault,
            max_abs=(wire_guard.max_abs if wire_guard is not None
                     else DEFAULT_MAX_ABS),
            validate=(wire_guard.validate_wire if wire_guard is not None
                      else True), device=dev)
    mix.remake = lambda active=None, stale=None: make_mixer(
        topology, requested, wire_dtype, dev, active=active, stale=stale,
        wire_fault=wire_fault, wire_guard=wire_guard)
    return mix


# ------------------------------------------------- the sharded backends
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


def make_ppermute_mixer(group, local_nodes: int = 1, reduce=None,
                        self_weight: float | None = None) -> Mixer:
    """Ring gossip over the node axes of a grid of ranks.

    With one axis (``group`` a :class:`Group`, or a sequence of one):
    the Metropolis ring over a node axis of ``local_nodes · group.size``
    nodes cut into contiguous blocks, one per rank of ``group``: 1/3
    each to self and the two ring neighbours (1/2 each at two nodes, the
    identity at one), which is the ring's Metropolis matrix, so the mix
    equals the dense mixer's to float tolerance. Only the boundary rows
    cross ranks.

    With two axes (``group`` a sequence of the (pod, data) groups of a
    grid, ``launch.mesh.make_grid``): the reference's hierarchical
    ring-of-rings, one node a rank. Every node mixes with itself, its two
    ring neighbours along each axis (one when the axis has 2 ranks; none
    along an axis of 1), each part weighing 1/(number of parts); a
    ``self_weight`` replaces its own weight and the row is renormalized
    to sum to 1. ``self_weight`` applies to the two-axis form only and
    ``local_nodes > 1`` to the one-axis form only, as in the reference.

    Mixes in f32 and stores in the leaf's dtype (the wire moves shards in
    their storage dtype). ``mix.mix_leaves`` mixes many leaves with one
    collective an axis; the algorithms take it where the mixer has
    it."""
    if local_nodes < 1:
        raise ValueError(f"local_nodes must be >= 1, got {local_nodes}")
    from repro_torch.launch import dist
    groups = list(group) if isinstance(group, (list, tuple)) else [group]
    if len(groups) > 1:
        return _hierarchical_mixer(groups, local_nodes, reduce, self_weight)
    group = groups[0]
    if self_weight is not None:
        raise ValueError("self_weight applies to the hierarchical "
                         "multi-axis mixer only")
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


def _hierarchical_mixer(groups, local_nodes: int, reduce,
                        self_weight) -> Mixer:
    """The two-axis form of :func:`make_ppermute_mixer`."""
    from repro_torch.launch import dist
    if local_nodes != 1:
        raise ValueError("local_nodes > 1 is single-axis only; the "
                         "hierarchical mixer holds one node per mesh index")

    def mix_leaves(xs):
        parts = [[x] for x in xs]
        for g in groups:
            if g.size < 2:
                continue
            # fwd: the row of the rank before along the axis; bwd: after
            for ps, (fwd, bwd) in zip(parts,
                                      dist.ring_neighbors_many(xs, g)):
                ps.append(fwd)
                if g.size > 2:      # at 2 ranks both are the one peer
                    ps.append(bwd)
        out = []
        for x, ps in zip(xs, parts):
            if len(ps) == 1:
                out.append(x)
                continue
            neigh_w = 1.0 / len(ps)
            w_self = self_weight if self_weight is not None else neigh_w
            acc = ps[0].float() * w_self
            for p in ps[1:]:
                acc = acc + p.float() * neigh_w
            total = w_self + neigh_w * (len(ps) - 1)
            out.append((acc / total).to(x.dtype))
        return out

    def mix_leaf(x):
        return mix_leaves([x])[0]

    def mix(local: Params) -> Params:
        return dict(zip(local, mix_leaves(list(local.values()))))

    def reduce_tree_sum(sq):
        if reduce is not None:
            return reduce(sq)
        total = torch.stack([sq[k] for k in sorted(sq)]).sum()
        for g in groups:
            total = dist.all_reduce(total, g)
        return total

    mix.mix_leaf = mix_leaf
    mix.mix_leaves = mix_leaves
    mix.reduce_tree_sum = reduce_tree_sum
    return mix


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
                     gossip: str = "sync",
                     consensus_lr: float = 1.0) -> Mixer:
    """The ``backend="ppermute"`` branch of the reference's
    ``make_mixer``: compressed or delayed gossip take the stateful
    :func:`make_compressed_ppermute_mixer`; otherwise exact averaging on
    a complete graph that is not also a ring, the boundary-row ring
    mixer on a ring. Every other graph raises. (A churn or straggler
    mask, a wire fault and an f32 wire are refused before a sharded run
    is built: ``sched.validate_shard_schedule`` and the entry points.)"""
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"unknown gossip mode {gossip!r}; expected one "
                         f"of {GOSSIP_MODES}")
    if topology.n != local_nodes * group.size:
        raise ValueError(f"topology has {topology.n} nodes, the node "
                         f"group holds {local_nodes} x {group.size}")
    full = _is_full(topology) and not _is_ring(topology)
    comp = normalize_compression(compression)
    if comp is not None or gossip == "delayed":
        if not full and not _is_ring(topology):
            raise ValueError(
                "compressed/delayed ppermute gossip runs on ring or "
                f"complete graphs only; topology {topology.name!r} "
                "must run node-stacked — use backend='gather' (or "
                "'dense')")
        return make_compressed_ppermute_mixer(
            group, local_nodes, num_nodes=topology.n, full_graph=full,
            compression=comp, gossip=gossip, consensus_lr=consensus_lr,
            reduce=reduce)
    if full:
        return make_psum_mixer(group, topology.n, reduce)
    if not _is_ring(topology):
        raise ValueError(
            "the sharded mixers implement ring gossip (plus exact "
            f"averaging on complete graphs); topology {topology.name!r} "
            "must run node-stacked — use backend='gather' (or 'dense')")
    return make_ppermute_mixer(group, local_nodes, reduce)


# ----------------------------------------- compressed / stateful gossip
COMPRESSION_KINDS = ("none", "topk", "randk")
GOSSIP_MODES = ("sync", "delayed")

CHUNK = 1 << 26   # elements of a leaf whose f32 temporaries live at once

MIXED_MORE = ("stateful gossip mixer mixed more leaves than the parameter "
              "tree has — the algorithm mixes more than once per step "
              "(e.g. gradient tracking); compressed/delayed gossip "
              "supports single-mix algorithms only")


def normalize_compression(spec):
    """A compression spec as ``None`` or ``(kind, frac)``: ``None`` /
    ``"none"``, a ``"topk:0.01"`` / ``"randk:0.1"`` string (bare
    ``"topk"`` means 1%) or a ``(kind, frac)`` pair; ``frac``, the kept
    share of each leaf's per-node elements, in (0, 1]."""
    if spec is None or spec == "none" or spec == ("none",):
        return None
    if isinstance(spec, str):
        kind, _, frac_s = spec.partition(":")
        frac = float(frac_s) if frac_s else 0.01
    else:
        kind, frac = spec
        if kind == "none":
            return None
        frac = float(frac)
    if kind not in ("topk", "randk"):
        raise ValueError(f"unknown compression kind {kind!r}; expected one "
                         f"of {COMPRESSION_KINDS}")
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"compression fraction must be in (0, 1], "
                         f"got {frac}")
    return (kind, frac)


def payload_k(size: int, frac: float) -> int:
    """Elements a (topk|randk, frac) payload keeps per node for one leaf
    of ``size`` per-node elements: at least 1, at most all (Python's
    ``round``, half to even, as the reference's)."""
    return max(1, min(int(size), int(round(frac * int(size)))))


def _leaf_shapes(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_shapes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_shapes(v)
    elif tree is not None:
        yield tuple(np.shape(tree))


def payload_elem_count(tree, compression, node_stacked: bool = True) -> int:
    """Per-node elements one gossip send carries under ``compression``
    (the ledger's count in place of the raw parameter count):
    ``node_stacked`` leaves have a leading node axis. None: the full
    per-node parameter count."""
    comp = normalize_compression(compression)

    def per_node(shape):
        return int(np.prod(shape[1:] if node_stacked else shape))

    sizes = [per_node(s) for s in _leaf_shapes(tree)]
    if comp is None:
        return sum(sizes)
    return sum(payload_k(s, comp[1]) for s in sizes)


def topk_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, k) int64 indices of each row's k largest values of ``a``
    (rows, flat), ascending: every value above the row's k-th largest,
    then the lowest-index values equal to it (``lax.top_k``'s set;
    ``torch.topk`` alone breaks ties in no promised order, and bf16
    params put |x − x̂| on a grid coarse enough to tie often). No host
    sync: the k-th value comes from ``torch.topk``'s values, the tied
    ones by a running count, and the set from a top-k of its 0/1 mask."""
    rows, flat = a.shape
    if k >= flat:
        return torch.arange(flat, device=a.device).expand(rows, flat) \
            .contiguous()
    kth = torch.topk(a, k, dim=1, sorted=False).values.amin(dim=1,
                                                            keepdim=True)
    above = a > kth
    tie = a == kth
    del a             # the caller's temporary: free it before the count
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie, dim=1, dtype=torch.int32)
                           <= need))
    idx = torch.topk(take.to(torch.uint8), k, dim=1, sorted=False).indices
    return torch.sort(idx, dim=1).values


def _select_payload(d, kind: str, k: int, r=None):
    """(vals, idx) payload of a (rows, flat) f32 delta: the top-k by
    magnitude, or a random k-subset (the top-k of the uniforms ``r``:
    unique indices; error feedback absorbs the selection bias)."""
    idx = topk_indices(d.abs() if kind == "topk" else r, k)
    return torch.gather(d, 1, idx), idx


def _add_payload(h, vals, idx, keep=None):
    """h[r, idx[r]] += vals[r] in place (a (rows, flat) f32 estimate;
    indices unique per row), for the rows ``keep`` marks (all when
    None): the reference's ``h + scatter(vals)``, at the selected
    coordinates only."""
    new = torch.gather(h, 1, idx) + vals
    if keep is not None:
        new = torch.where(keep, new, torch.gather(h, 1, idx))
    h.scatter_(1, idx, new)


class _BoundStatefulMixer:
    """What a stateful mixer's ``bind(comm)`` returns: the ordinary
    mixer protocol (``mix(tree)``, ``mix.mix_leaf``) over the comm
    state's leaves, taken by position (leaf i of the params, in their
    order, pairs with leaf i of each comm subtree), each updated in
    place. ``finalize()`` returns the comm state — and raises if the
    algorithm mixed more or fewer leaves than the params have (gradient
    tracking mixes twice, RelaySGD never mixes: per-leaf wire state
    takes neither). Leaves must come whole (``whole_leaves``)."""

    whole_leaves = True

    def __init__(self, leaf_fn, comm, state_names, gen=None):
        self._leaf_fn = leaf_fn
        self._comm = comm
        self._names = state_names
        self._keys = list(comm[state_names[0]])
        self._num = len(self._keys)
        self._gen = gen                # randk: the comm's generator
        self._i = 0

    def _take(self, count: int):
        i = self._i
        if i + count > self._num:
            raise ValueError(MIXED_MORE)
        self._i += count
        return list(range(i, i + count))

    def _state(self, i):
        return {nm: self._comm[nm][self._keys[i]] for nm in self._names}

    def mix_leaf(self, x):
        i = self._take(1)[0]
        return self._leaf_fn(x, self._state(i), i, self._gen)

    def __call__(self, tree: Params) -> Params:
        return {k: self.mix_leaf(v) for k, v in tree.items()}

    def finalize(self):
        if self._i != self._num:
            raise ValueError(
                f"stateful gossip mixer finalized after {self._i} of "
                f"{self._num} leaf mixes — the algorithm never mixed the "
                "full parameter tree (e.g. RelaySGD routes params per-edge "
                "and ignores the gossip mixer); compressed/delayed gossip "
                "requires a single whole-tree mix per step")
        if self._gen is not None:
            self._comm["key"] = self._gen.get_state()
        return self._comm


class _BoundShardMixer(_BoundStatefulMixer):
    """The sharded twin: ``mix_leaves`` mixes consecutive leaves with one
    exchange of their payloads (the algorithms take it where it is)."""

    def __init__(self, leaves_fn, comm, state_names, gen=None,
                 reduce_tree_sum=None):
        super().__init__(None, comm, state_names, gen)
        self._leaves_fn = leaves_fn
        self.reduce_tree_sum = reduce_tree_sum

    def mix_leaves(self, xs):
        idxs = self._take(len(xs))
        return self._leaves_fn(list(xs), [self._state(i) for i in idxs],
                               idxs, self._gen)

    def mix_leaf(self, x):
        return self.mix_leaves([x])[0]

    def __call__(self, tree: Params) -> Params:
        return dict(zip(tree, self.mix_leaves(list(tree.values()))))


def _init_estimates(stacked: Params) -> Params:
    """x̂₀ = x₀ as (n, flat) f32: every node starts from the same
    broadcast init, so the estimates need no wire traffic."""
    return {k: v.detach().reshape(v.shape[0], -1).to(torch.float32,
                                                     copy=True)
            for k, v in stacked.items()}


def _row_chunks(rows: int, flat: int):
    """Row slices of a (rows, flat) leaf holding at most CHUNK elements
    each (one row at least): the payload selection's f32 temporaries
    (the delta, its magnitude, the tie count, ``torch.topk``'s
    buffers) stay that wide (at Hymba-1.5B width one node's row of its
    largest leaf, 282 M elements)."""
    per = max(1, CHUNK // max(flat, 1))
    return [slice(a, a + per) for a in range(0, rows, per)]


def _col_chunks(rows: int, flat: int):
    """Column slices of a (rows, flat) leaf holding at most CHUNK
    elements each: the mix acts along the node axis only, so it runs on
    column blocks and its f32 temporaries stay that wide."""
    per = max(1, CHUNK // max(rows, 1))
    return [slice(a, a + per) for a in range(0, flat, per)]


def _generator_state(stacked: Params, seed: int) -> torch.Tensor:
    dev = next(iter(stacked.values())).device
    return torch.Generator(device=dev).manual_seed(seed).get_state()


def _bind_generator(comm, kind: str, uniform):
    """randk: a generator on the estimates' device, set to the comm's
    state (None when the ``uniform`` hook replaces its draws)."""
    if kind != "randk" or uniform is not None:
        return None
    dev = next(iter(comm["hat"].values())).device
    gen = torch.Generator(device=dev)
    gen.set_state(comm["key"])
    return gen


def _draw(uniform, gen, i: int, shape, device):
    """(n, flat) uniforms of leaf ``i``'s random-k selection: the
    replay hook's, or the comm generator's."""
    if uniform is not None:
        return torch.as_tensor(uniform(i, shape), dtype=torch.float32,
                               device=device)
    return torch.rand(shape, generator=gen, device=device)


def _stateful_mix(tree: Params) -> Params:
    raise TypeError(
        "stateful gossip mixer must be bound to its comm state: "
        "mix.bind(comm)(tree) — core.driver.make_step does this when "
        "step.comm is set; mix.init_state(params) builds the initial "
        "comm state")


def make_compressed_mixer(topology: Topology, backend: str = "auto",
                          wire_dtype: str = "native", device="cuda", *,
                          active=None, stale=None, compression=None,
                          gossip: str = "sync", seed: int = 0,
                          consensus_lr: float = 1.0, wire_fault=None,
                          wire_guard=None, uniform=None) -> Mixer:
    """Stateful node-stacked gossip on top of any node-stacked backend
    (the reference's ``make_compressed_mixer``; CHOCO-SGD)::

        p  = C(x − x̂)                   # (vals, idx) delta payload
        x̂' = x̂ + scatter(p)             # both ends apply the same delta
        y  = x + γ · (M(x̂*) − x̂*)       # x̂*: the estimates mixed

    with ``C`` the top-k / random-k selection, ``M`` the plain backend
    mix and γ = ``consensus_lr``: y_i = x_i + γ·Σ_j W_ij (x̂*_j − x̂*_i).
    Whatever a payload cut stays in the gap x − x̂' (the error feedback);
    ``frac=1, γ=1`` recovers the dense mix up to f32 rounding. x̂* is this
    step's estimate (sync) or the previous one (delayed); a stale
    straggler's row of x̂ stays at its last payload. Native wires round
    the payload values through the storage dtype. With
    ``compression=None`` the wire is the raw params and the state the
    previous snapshot ``prev``: y_i = W_ii·x_i + Σ_{j≠i} W_ij·x̂*_j,
    which the sync all-fresh path reduces to the plain mix exactly.

    Down nodes (``active``) keep identity rows; stale nodes stay active
    (they train and receive), only their payload freezes. ``wire_fault``
    drops or corrupts delta payloads; invalid ones (non-finite or past
    ``wire_guard.max_abs``) are masked out of the update at both ends,
    so the neighbours go on mixing the sender's last good x̂. The
    uncompressed stateful path takes no faults and compressed wires no
    ``validate_wire=False``, as in the reference.

    ``uniform(i, shape)``, when given, replaces the random-k draws of
    leaf i (a replay hook for parity tests); by default they come from
    a ``torch.Generator`` seeded with ``seed`` whose state rides the
    comm state's ``"key"``. The comm state is updated in place."""
    comp = normalize_compression(compression)
    kind, frac = comp if comp is not None else ("none", 1.0)
    fault_on = wire_fault is not None and not wire_fault.is_noop()
    if fault_on and kind == "none":
        raise ValueError(
            "wire fault injection on the uncompressed stateful gossip "
            "path (delayed/stale 'prev' snapshots) is unsupported — "
            "inject faults on sync stateless gossip or compressed "
            "(topk/randk) wires")
    if fault_on and wire_guard is not None and not wire_guard.validate_wire:
        raise ValueError(
            "GuardSpec.validate_wire=False (propagating unvalidated "
            "corruption) is unsupported on compressed wires; compressed "
            "payloads are always validated and degrade to the sender's "
            "last good estimate")
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"unknown gossip mode {gossip!r}; expected one "
                         f"of {GOSSIP_MODES}")
    dev = resolve_device(device)
    n = topology.n
    masked = active is not None and not np.all(np.asarray(active, bool))
    act = (np.asarray(active, bool) if masked else np.ones(n, bool))
    stale_arr = (np.asarray(stale, bool)
                 if stale is not None and np.any(stale) else None)
    if stale_arr is not None and stale_arr.shape != (n,):
        raise ValueError(f"stale mask shape {stale_arr.shape} != ({n},)")
    base = make_mixer(topology, backend, wire_dtype, dev,
                      active=(act if masked else None))
    W = topology.mixing_matrix(act if masked else None)
    d_self = torch.as_tensor(np.diag(W).copy(), dtype=torch.float32, device=dev)
    gamma = float(consensus_lr)
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"consensus_lr must be in (0, 1], got {gamma}")
    fresh_np = act & (~stale_arr if stale_arr is not None else True)
    if fault_on:
        from repro_torch.resil.faults import (DEFAULT_MAX_ABS,
                                              corrupt_values, payload_valid)
        drop_np = np.zeros(n, bool)
        drop_np[list(wire_fault.drop)] = True
        corrupt_np = np.zeros(n, bool)
        corrupt_np[list(wire_fault.corrupt)] = True
        fresh_np = fresh_np & ~drop_np
        fault_max_abs = (wire_guard.max_abs if wire_guard is not None
                         else DEFAULT_MAX_ABS)
        corrupt_col = torch.as_tensor(corrupt_np, device=dev)[:, None]
    all_fresh = bool(fresh_np.all()) and not fault_on
    fresh = torch.as_tensor(fresh_np, device=dev)[:, None]
    stale_t = (torch.as_tensor(stale_arr, device=dev)
               if stale_arr is not None else None)

    def _col(v, ndim):
        return v.reshape((n,) + (1,) * (ndim - 1))

    def leaf_fn(x, state, i, gen):
        if kind == "none":
            xf = x.float()
            prev = state["prev"]
            if gossip == "delayed":
                p_hat = prev
            elif stale_t is not None:
                p_hat = torch.where(_col(stale_t, x.dim()), prev, x)
            else:
                p_hat = x
            y = base.mix_leaf(p_hat).float() \
                + _col(d_self, x.dim()) * (xf - p_hat.float())
            prev.copy_(x if all_fresh
                       else torch.where(_col(fresh[:, 0], x.dim()), x, prev))
            return y.to(x.dtype)
        hat = state["hat"]                      # (n, flat) shared estimates
        if hat.shape != (n, x[0].numel()):
            raise ValueError(f"stateful gossip mixer: leaf {i} has shape "
                             f"{tuple(x.shape)}, its estimate "
                             f"{tuple(hat.shape)}: the algorithm must mix "
                             "whole leaves in the params' order")
        flat = hat.shape[1]
        xs = x.reshape(n, flat)                 # storage dtype
        k = payload_k(flat, frac)
        r = (_draw(uniform, gen, i, (n, flat), x.device)
             if kind == "randk" else None)
        vals = torch.empty((n, k), dtype=torch.float32, device=x.device)
        idx = torch.empty((n, k), dtype=torch.int64, device=x.device)
        for rs in _row_chunks(n, flat):
            d = xs[rs].to(torch.float32, copy=True)
            d -= hat[rs]
            vals[rs], idx[rs] = _select_payload(
                d, kind, k, None if r is None else r[rs])
            del d
        del r
        if wire_dtype != "float32":
            # native wire: payload values round-trip the storage dtype;
            # the rounding stays in the x − x̂ gap (implicit EF)
            vals = vals.to(x.dtype).float()
        keep = None if all_fresh else fresh
        if fault_on:
            if wire_fault.corrupt:
                vals = torch.where(corrupt_col,
                                   corrupt_values(vals, wire_fault.mode),
                                   vals)
            # invalid payloads are discarded at both ends: every node's
            # replica of the sender's x̂ stays at its last good value
            keep = keep & payload_valid(vals, fault_max_abs)[:, None]

        def consensus(use):
            y = torch.empty_like(xs)
            for cs in _col_chunks(n, flat):
                u = use[:, cs]
                y[:, cs] = (xs[:, cs].float() + gamma * (
                    base.mix_leaf(u).float() - u)).to(x.dtype)
            return y

        if gossip == "delayed":                 # the pre-update estimates
            y = consensus(hat)
            _add_payload(hat, vals, idx, keep)
        else:
            _add_payload(hat, vals, idx, keep)
            y = consensus(hat)
        return y.reshape(x.shape)

    state_names = ("prev",) if kind == "none" else ("hat",)

    def init_state(stacked: Params):
        """The comm state for step 0: ``prev`` the params themselves, or
        the shared estimates x̂₀ = x₀ (and, for random-k, the generator
        state)."""
        if kind == "none":
            return {"prev": {k: v.detach().clone()
                             for k, v in stacked.items()}}
        comm = {"hat": _init_estimates(stacked)}
        if kind == "randk":
            comm["key"] = _generator_state(stacked, seed)
        return comm

    def bind(comm):
        return _BoundStatefulMixer(leaf_fn, comm, state_names,
                                   _bind_generator(comm, kind, uniform))

    mix = lambda tree: _stateful_mix(tree)                  # noqa: E731
    mix.stateful = True
    mix.init_state = init_state
    mix.bind = bind
    # the metrics bus's EF residual ‖x − x̂‖ (for kind "none" the 'prev'
    # snapshot plays x̂: the delayed/stale gossip gap)
    mix.ef_ref = lambda comm: comm["prev" if kind == "none" else "hat"]
    return mix


def make_compressed_ppermute_mixer(group: Group, local_nodes: int = 1, *,
                                   num_nodes: int, full_graph: bool = False,
                                   compression=None, gossip: str = "sync",
                                   seed: int = 0, consensus_lr: float = 1.0,
                                   reduce=None) -> Mixer:
    """The sharded twin of :func:`make_compressed_mixer` on one node
    group (the reference's ``make_compressed_ppermute_mixer``).

    Each rank keeps its nodes' shared estimates x̂ and replicas of its
    ring neighbours' (``hfwd``: row i holds x̂_{i−1}; ``hbwd``: x̂_{i+1}),
    kept in lockstep by applying the payloads that cross the wire: each
    leaf's (vals, idx) boundary rows move to the neighbouring ranks —
    every leaf of a step in one exchange (values in the storage dtype,
    indices as int32) — and are added into the replicas. The mix is the
    ring's Metropolis weights over the replicas, y_i = x_i + γ·((x̂_i +
    x̂_fwd + x̂_bwd)/3 − x̂_i) (1/2 each at two nodes), the node-stacked
    form's math. A complete graph keeps the replicated sum S = Σ_j x̂_j
    (``hsum``), updated from one ``all_gather`` of the payloads: y_i =
    x_i + γ·(S/n − x̂_i). Delayed gossip mixes the pre-update estimates.
    Without compression the state is the previous params (``prev``),
    mixed as the plain backends mix. ``init_state`` takes the *global*
    node-stacked params (``launch.sharding.comm_block`` cuts this rank's
    block). Random-k draws every node's uniforms from the comm's
    generator and keeps the block's rows, so the draws are the
    node-stacked run's. Stragglers and churn masks have no sharded
    path."""
    from repro_torch.launch import dist
    comp = normalize_compression(compression)
    kind, frac = comp if comp is not None else ("none", 1.0)
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"unknown gossip mode {gossip!r}; expected one "
                         f"of {GOSSIP_MODES}")
    if local_nodes < 1:
        raise ValueError(f"local_nodes must be >= 1, got {local_nodes}")
    size = group.size
    n = num_nodes
    if n != local_nodes * size:
        raise ValueError(f"num_nodes ({n}) != local_nodes ({local_nodes}) "
                         f"· axis size ({size})")
    if n <= 1:
        raise ValueError("compressed/delayed gossip needs n >= 2 nodes "
                         "(a single node has no wire to compress)")
    gamma = float(consensus_lr)
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"consensus_lr must be in (0, 1], got {gamma}")
    lo = group.index * local_nodes

    def plain_leaves(xs, states):
        p_hats = [st["prev"] if gossip == "delayed" else x
                  for x, st in zip(xs, states)]
        ys = []
        if full_graph:
            sums = [p.float().sum(dim=0) for p in p_hats]
            total = dist.all_reduce(torch.cat([t.reshape(-1) for t in sums]),
                                    group)
            for x, p, t in zip(xs, p_hats, torch.split(
                    total, [t.numel() for t in sums])):
                ys.append((x.float() + t.reshape(x.shape[1:]) - p.float())
                          / n)
        else:
            for x, p, nb in zip(xs, p_hats,
                                dist.ring_neighbors_many(p_hats, group)):
                fwd = block_ring_shift(p, group, 1, nb).float()
                if n == 2:
                    ys.append(0.5 * x.float() + 0.5 * fwd)
                else:
                    bwd = block_ring_shift(p, group, -1, nb).float()
                    ys.append((x.float() + fwd + bwd) / 3.0)
        for x, st in zip(xs, states):
            st["prev"].copy_(x)
        return [y.to(x.dtype) for x, y in zip(xs, ys)]

    def leaves_fn(xs, states, idxs, gen):
        if kind == "none":
            return plain_leaves(xs, states)
        pays = []
        for x, st, i in zip(xs, states, idxs):
            hat = st["hat"]
            L, flat = hat.shape
            k = payload_k(flat, frac)
            r = (torch.rand((n, flat), generator=gen,
                            device=x.device)[lo:lo + L]
                 if kind == "randk" else None)
            vals, idx = _select_payload(x.float().reshape(L, flat) - hat,
                                        kind, k, r)
            # native wire: the values in the storage dtype, int32 indices
            pays.append((vals.to(x.dtype), idx.to(torch.int32)))
        wire = [t for pair in pays for t in pair]
        if full_graph:
            got = dist.all_gather_many(wire, group)
            recv = [(torch.cat(got[2 * j]), torch.cat(got[2 * j + 1]))
                    for j in range(len(pays))]
        else:
            nbs = dist.ring_neighbors_many(wire, group)
            recv = [(nbs[2 * j], nbs[2 * j + 1]) for j in range(len(pays))]
        ys = []
        for x, st, (vals, idx), rv in zip(xs, states, pays, recv):
            hat = st["hat"]
            L, flat = hat.shape
            xr = x.float().reshape(L, flat)
            vals, idx = vals.float(), idx.long()
            if full_graph:
                s = st["hsum"]               # (1, flat) replicated Σ_j x̂_j
                gv, gi = rv[0].float(), rv[1].long()
                add = torch.zeros((gv.shape[0], flat), dtype=torch.float32,
                                  device=x.device).scatter_(1, gi, gv) \
                    .sum(dim=0, keepdim=True)
                if gossip == "delayed":
                    y = xr + gamma * (s / n - hat)
                    _add_payload(hat, vals, idx)
                    s.add_(add)
                else:
                    _add_payload(hat, vals, idx)
                    s.add_(add)
                    y = xr + gamma * (s / n - hat)
            else:
                (vb, va), (ib, ia) = rv
                fv = block_ring_shift(vals, group, 1, (vb, va)).float()
                fi = block_ring_shift(idx, group, 1, (ib, ia)).long()
                hf = st["hfwd"]              # row i replicates x̂_{i-1}
                hb = st.get("hbwd")          # row i replicates x̂_{i+1}

                def mixed():
                    if n == 2:
                        return xr + gamma * (0.5 * (hat + hf) - hat)
                    return xr + gamma * ((hat + hf + hb) / 3.0 - hat)

                if gossip == "delayed":
                    y = mixed()
                _add_payload(hat, vals, idx)
                _add_payload(hf, fv, fi)
                if hb is not None:
                    _add_payload(
                        hb, block_ring_shift(vals, group, -1,
                                             (vb, va)).float(),
                        block_ring_shift(idx, group, -1, (ib, ia)).long())
                if gossip != "delayed":
                    y = mixed()
            ys.append(y.reshape(x.shape).to(x.dtype))
        return ys

    if kind == "none":
        state_names = ("prev",)
    elif full_graph:
        state_names = ("hat", "hsum")
    elif n == 2:
        state_names = ("hat", "hfwd")
    else:
        state_names = ("hat", "hfwd", "hbwd")

    def init_state(stacked: Params):
        """On the *global* node-stacked params, no collective: ``prev``,
        or x̂₀ = x₀ with the replicas (rolls of it) or the replicated sum,
        and random-k's generator state."""
        if kind == "none":
            return {"prev": {k: v.detach().clone()
                             for k, v in stacked.items()}}
        hat = _init_estimates(stacked)
        comm = {"hat": hat}
        if full_graph:
            comm["hsum"] = {k: h.sum(dim=0, keepdim=True)
                            for k, h in hat.items()}
        else:
            comm["hfwd"] = {k: torch.roll(h, 1, 0) for k, h in hat.items()}
            if n > 2:
                comm["hbwd"] = {k: torch.roll(h, -1, 0)
                                for k, h in hat.items()}
        if kind == "randk":
            comm["key"] = _generator_state(stacked, seed)
        return comm

    def bind(comm):
        return _BoundShardMixer(leaves_fn, comm, state_names,
                                _bind_generator(comm, kind, None),
                                mix.reduce_tree_sum)

    mix = lambda tree: _stateful_mix(tree)                  # noqa: E731
    _tree_sum_hook(mix, group, reduce)
    mix.stateful = True
    mix.init_state = init_state
    mix.bind = bind
    # the comm leaves are this rank's rows, like the param rows: the EF
    # residual needs no collective
    mix.ef_ref = lambda comm: comm["prev" if kind == "none" else "hat"]
    return mix


def make_model_sharded_mixer(inner, model_dims: Dict[str, object],
                             mesh) -> Mixer:
    """The 2-D federation mesh's adapter for the compressed sharded
    mixer: the payload selection must see each node's *full* delta row
    (a top-k of a model shard is another compressor), so the step's
    model-sharded leaves are all-gathered over the model group — one
    collective — the 1-D mixer runs on the full rows (its estimates are
    full-width, replicated over the model group) and each mixed leaf is
    cut back to this rank's shard. Model peers compute the same payloads
    from the same inputs, so the comm state stays replicated and the
    wire bytes per node are the 1-D run's. ``model_dims``: each param
    key's model-sharded dim, None for replicated leaves. No ``ef_ref``:
    the estimates are full-width while the params are sharded, so the
    metrics bus reports 0, as the reference's."""
    from repro_torch.launch import dist
    size, index = mesh.model.size, mesh.model.index

    def bind(comm):
        bound = inner.bind(comm)
        inner_fn = bound._leaves_fn
        keys = bound._keys

        def leaves_fn(xs, states, idxs, gen):
            dims = [model_dims.get(keys[i]) for i in idxs]
            cut = [j for j, d in enumerate(dims) if d is not None]
            full = list(xs)
            for j, parts in zip(cut, dist.all_gather_many(
                    [xs[j] for j in cut], mesh.model)):
                full[j] = torch.cat(parts, dim=dims[j])
            ys = inner_fn(full, states, idxs, gen)
            for j in cut:
                width = ys[j].shape[dims[j]] // size
                ys[j] = ys[j].narrow(dims[j], index * width,
                                     width).contiguous()
            return ys

        bound._leaves_fn = leaves_fn
        return bound

    mix = lambda tree: _stateful_mix(tree)                  # noqa: E731
    mix.stateful = True
    mix.init_state = inner.init_state
    mix.bind = bind
    mix.reduce_tree_sum = inner.reduce_tree_sum
    return mix


def consensus_distance(stacked: Params) -> torch.Tensor:
    """L2 distance of node params from the node average (diagnostic)."""
    total = 0.0
    for k in sorted(stacked):
        xf = stacked[k].float()
        total = total + torch.sum((xf - xf.mean(dim=0, keepdim=True)) ** 2)
    return torch.sqrt(torch.as_tensor(total))
