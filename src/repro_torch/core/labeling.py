"""The IDKD labeling engine — the paper's homogenization round
(Algorithm 1, lines 5–14) on node-stacked tensors:

  (line 5)  soft labels     softmax(f_i(D_P) / T)
  (line 6)  t_opt           ROC-calibrated detector threshold per node
  (line 7)  D_ID^i          {p : conf_p > t_opt}
  (l. 9-13) exchange        labels-only gossip with graph neighbours
  (line 14) average         per-sample mean over contributing nodes

:func:`label_round` takes pre-computed logit stacks and has the
reference's three backends: ``dense`` (full (n, P, C) labels, the
oracle), ``sparse`` (top-k payloads from plain ops) and ``fused`` (the
``msp_select`` kernel reads each logit row once for both the confidence
and the top-k payload). :func:`streaming_label_round` takes the model
instead and streams the public set through it in microbatches, running
the ``head_select`` kernel on the pre-head activations of **all nodes in
one launch per microbatch**: only (conf, top-k) per sample is kept, the
(n, P, C) logit stack never exists. Sparse payloads are exchanged
without densifying: the mean over contributors is the concatenation of
their (values · m_j / cnt, indices) along the k axis.

:func:`shard_label_round` and :func:`shard_streaming_label_round` are the
sharded driver's rounds (one rank's node block, :mod:`repro_torch.launch.
dist`): score, calibrate and select stay local, and only the top-k
payload crosses ranks — boundary rows on rings, an ``all_gather`` on
complete graphs. On the 2-D federation mesh the streaming round runs
the vocab-sharded head pass (:func:`_vocab_sharded_head_pass`): each
model rank scores one vocabulary slice with ``head_select``'s
``raw_stats`` mode and the slices' carries merge across the model group.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import IDKDConfig
from repro_torch.core import distill, ood
from repro_torch.core.topology import Topology
from repro_torch.kernels.head_select import (head_select,
                                             merge_head_stats_plain)
from repro_torch.kernels.msp_select import msp_select

BACKENDS = ("dense", "fused", "sparse")
DEFAULT_TOPK = 8
NEG_INF = -1e30     # the padded vocabulary columns' bias


class HomogenizedSet(NamedTuple):
    """Per-node distilled public subset, dense labels (node-stacked)."""
    labels: torch.Tensor      # (n, P, C) averaged soft labels
    weights: torch.Tensor     # (n, P) 1.0 where the sample is in D_ID∪neigh
    id_masks: torch.Tensor    # (n, P) the node's own D_ID mask
    thresholds: torch.Tensor  # (n,) calibrated t_opt per node


class SparseHomogenizedSet(NamedTuple):
    """Per-node distilled public subset with top-k sparse labels of width
    k_out = (max_degree + 1) · k; duplicate indices are legal (every
    consumer accumulates them)."""
    labels: distill.SparseLabels
    weights: torch.Tensor
    id_masks: torch.Tensor
    thresholds: torch.Tensor

    def densify(self, num_classes: int) -> torch.Tensor:
        """(n, P, C) labels — diagnostics and tests only."""
        return distill.densify_labels(self.labels, num_classes)


HomogenizedResult = Union[HomogenizedSet, SparseHomogenizedSet]



def _sequence_score(conf) -> torch.Tensor:
    """(n, P) sample confidences pass through; (n, P, S) token
    confidences reduce to a sequence's score, their mean over S."""
    return conf.mean(-1) if conf.dim() == 3 else conf


def detector_scores(logits, detector: str) -> torch.Tensor:
    """Per-sample detector confidence. (n, P, C) -> (n, P); LM logit
    stacks (n, P, S, V) reduce to sequence scores (``_sequence_score``).
    One node at a time, so the f32 softmax of an LM stack never exists
    for all nodes at once."""
    return _sequence_score(
        torch.stack([ood.confidence(x, detector) for x in logits]))


def calibrate(conf_val, conf_cal) -> torch.Tensor:
    """Per-node ROC thresholds (line 6): val = ID class, cal = OoD."""
    return ood.calibrate_threshold(conf_val, conf_cal)


def _neighbors(topology: Topology, device):
    nbr, valid = topology.neighbor_arrays()
    return (torch.as_tensor(nbr, dtype=torch.long, device=device),
            torch.as_tensor(valid, device=device))


# --------------------------------------------------------------- exchange
def exchange_dense(topology: Topology, id_mask, labels
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lines 9–14 on dense labels: per-sample mean over the contributing
    nodes (self + neighbours whose D_ID holds the sample), one padded
    neighbour slot at a time."""
    nbr, valid = _neighbors(topology, labels.device)
    lf = labels.float()
    m = id_mask.float()
    extra = (1,) * (lf.dim() - m.dim())                     # C, or S and V
    num = torch.zeros_like(lf)
    cnt = torch.zeros_like(m)
    for d in range(nbr.shape[1]):
        j = nbr[:, d]
        w = m[j] * valid[:, d, None]
        num = num + w.reshape(w.shape + extra) * lf[j]
        cnt = cnt + w
    avg = num / torch.clamp(cnt, min=1.0).reshape(cnt.shape + extra)
    return avg, (cnt > 0).float()


def exchange_sparse(topology: Topology, id_mask, sparse: distill.SparseLabels
                    ) -> Tuple[distill.SparseLabels, torch.Tensor]:
    """Lines 9–14 on top-k payloads without densifying: output width
    (max_degree + 1) · k, zero-valued padding slots. Payloads are (n, P,
    k) or, for token labels, (n, P, S, k)."""
    nbr, valid = _neighbors(topology, id_mask.device)
    m = id_mask.float()
    w = m[nbr] * valid[:, :, None]                          # (n, D, P)
    cnt = w.sum(dim=1)                                      # (n, P)
    share = w / torch.clamp(cnt, min=1.0)[:, None, :]
    vals = sparse.values[nbr]                               # (n, D, P[, S], k)
    idx = sparse.indices[nbr]
    extra = vals.dim() - share.dim()                        # k and the S axis
    vals = vals * share.reshape(share.shape + (1,) * extra)
    # merge the contributor axis into k: (n, P[, S], D·k)
    vals = vals.movedim(1, -2).flatten(-2)
    idx = idx.movedim(1, -2).flatten(-2)
    return (distill.SparseLabels(vals.float(), idx.to(torch.int32)),
            (cnt > 0).float())


# ------------------------------------------------------------ fused pass
def _fused_pass(logits, cfg: IDKDConfig, k: int
                ) -> Tuple[torch.Tensor, distill.SparseLabels]:
    """One read of the public logits through ``msp_select``: detector
    confidence + top-k payload."""
    lead, C = logits.shape[:-1], logits.shape[-1]
    conf, vals, idx = msp_select(logits.reshape(-1, C).contiguous(),
                                 temperature=cfg.temperature, k=k,
                                 detector=cfg.detector)
    return (_sequence_score(conf.reshape(lead)),
            distill.SparseLabels(vals.reshape(lead + (k,)),
                                 idx.reshape(lead + (k,))))


def _head_pass(model, params, x, cfg: IDKDConfig, k: int):
    """Every node's fused head-select pass on one microbatch: ``x`` is
    (L, mb, ...) and the head matrices of all L nodes go through one
    ``head_select`` launch. Token features (L, mb, S, D) go in as
    (L, mb·S, D) rows; the head goes in as ``head_params`` gives it
    (``head_select`` owns its layout). Returns conf (L, mb) — for tokens
    the mean over S of the token confidences — and vals/idx (L, mb[, S],
    k)."""
    feats, _ = model.forward_features(params, {model.input_key: x})
    w, b = model.head_params(params)
    lead = feats.shape[:-1]                                 # (L, mb[, S])
    conf, vals, idx = head_select(
        feats.reshape(lead[0], -1, feats.shape[-1]).contiguous(),
        w, None if b is None else b.contiguous(),
        temperature=cfg.temperature, k=k, detector=cfg.detector)
    return (_sequence_score(conf.reshape(lead)), vals.reshape(lead + (k,)),
            idx.reshape(lead + (k,)))


def _chunk_public(public_x, microbatch: int):
    """(P, ...) -> ((num_chunks, mb, ...), P, mb). The ragged tail is
    padded by repeating row 0 (real inputs, outputs sliced off)."""
    P = public_x.shape[0]
    mb = max(1, min(microbatch or 256, P))
    num_chunks = -(-P // mb)
    pad = num_chunks * mb - P
    pub = public_x
    if pad:
        pub = torch.cat([pub, pub[:1].expand((pad,) + pub.shape[1:])])
    return pub.reshape((num_chunks, mb) + pub.shape[1:]), P, mb


def _vocab_sharded_head_pass(model, params, x, cfg: IDKDConfig, k: int,
                             mesh):
    """:func:`_head_pass` on the 2-D federation mesh: this model rank runs
    ``head_select``'s ``raw_stats`` mode over its own vocabulary slice
    (``O(mb · C / model_size)`` scores, never the full row), and the
    slices' online-softmax stats (m, z) and top-k raw logits merge across
    the model group with the kernel's own streaming math
    (:func:`merge_head_stats_plain`). The finalizer runs only on the
    merged stats, so the result matches the unsharded pass: indices
    exactly, conf and vals to float tolerance.

    The slice is cut here, as the reference cuts it: C padded to
    ``model_size`` equal slices of ``w_sh`` columns, the padded columns
    zero weights with a ``NEG_INF`` bias, so they self-mask out of z and
    the top-k; ``k_loc = min(k, w_sh)``; the slice's indices are offset
    by ``j · w_sh`` before the merge. Only the last slices hold padding,
    so only they are copied to pad."""
    from repro_torch.launch import dist
    feats, _ = model.forward_features(params, {model.input_key: x})
    w, b = model.head_params(params)                      # (L, D, C)
    Ln, D, C = w.shape
    size, j = mesh.model.size, mesh.model.index
    w_sh = -(-C // size)
    c0, c1 = min(j * w_sh, C), min((j + 1) * w_sh, C)
    w_loc = w[..., c0:c1]
    b_loc = (torch.zeros((Ln, c1 - c0), device=w.device) if b is None
             else b[..., c0:c1].float())
    pad = w_sh - (c1 - c0)
    if pad:
        w_loc = torch.nn.functional.pad(w_loc, (0, pad))
        b_loc = torch.nn.functional.pad(b_loc, (0, pad), value=NEG_INF)
    k_loc = min(k, w_sh)
    lead = feats.shape[:-1]                                 # (L, mb[, S])
    m, z, tv, ti = head_select(
        feats.reshape(lead[0], -1, feats.shape[-1]).contiguous(),
        w_loc, b_loc.contiguous(), temperature=cfg.temperature, k=k_loc,
        detector=cfg.detector, raw_stats=True)
    ti = ti + j * w_sh                                     # global vocab idx
    conf, vals, idx = merge_head_stats_plain(
        *dist.all_gather_many([m, z, tv, ti], mesh.model),
        temperature=cfg.temperature, k=k, detector=cfg.detector)
    return (_sequence_score(conf.reshape(lead)), vals.reshape(lead + (k,)),
            idx.reshape(lead + (k,)).to(torch.int32))


def _stream_public(model, params, chunks, P: int, cfg: IDKDConfig, k: int,
                   head_pass=_head_pass):
    """Stream the chunked public set through every node's head pass;
    keep only (conf, vals, idx)."""
    L = next(iter(params.values())).shape[0]
    confs, vals, idxs = [], [], []
    for xc in chunks:
        c, v, i = head_pass(model, params,
                            xc[None].expand((L,) + xc.shape), cfg, k)
        confs.append(c)
        vals.append(v)
        idxs.append(i)
    return (torch.cat(confs, dim=1)[:, :P],
            distill.SparseLabels(torch.cat(vals, dim=1)[:, :P],
                                 torch.cat(idxs, dim=1)[:, :P]))


def _stream_val_conf(model, params, val_x, cfg: IDKDConfig,
                     head_pass=_head_pass):
    """Per-node confidence on each node's own val set (n, V, ...) through
    the same head pass; k=1, since only conf is consumed."""
    return head_pass(model, params, val_x, cfg, 1)[0]


def _select(conf_pub, scores, filter_ood: bool, active):
    """Thresholds and D_ID masks (lines 6–7), with the churn mask.
    ``scores()`` gives (ID val scores, OoD calibration scores); it runs
    only when the detector filters."""
    n = conf_pub.shape[0]
    if filter_ood:
        thresholds = calibrate(*scores())
        id_mask = conf_pub > thresholds[:, None]
    else:
        thresholds = torch.zeros((n,), device=conf_pub.device)
        id_mask = torch.ones(conf_pub.shape, dtype=torch.bool,
                             device=conf_pub.device)
    act = None
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.bool,
                              device=conf_pub.device)
        id_mask = id_mask & act[:, None]
    return thresholds, id_mask, act


# ------------------------------------------------------------ full round
@torch.no_grad()
def label_round(public_logits, val_logits, cal_logits, topology: Topology,
                cfg: IDKDConfig, *, backend: str = "dense",
                filter_ood: bool = True, active=None) -> HomogenizedResult:
    """One homogenization round on node-stacked logits.

    public_logits (n, P, C), val_logits (n, V, C), cal_logits (n, K, C)
    or None for D_C = D_P (the paper's default); LM stacks (n, P, S, V)
    score a sequence by the mean of its token confidences and label
    every token. ``filter_ood=False`` is
    the ``kd_mode="vanilla"`` baseline (every sample kept, thresholds
    0); ``active`` is the (n,) churn mask (a down node neither gives
    nor receives labels). Returns :class:`HomogenizedSet` (dense) or
    :class:`SparseHomogenizedSet` (fused / sparse).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown labeling backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    k = min(cfg.label_topk or DEFAULT_TOPK, public_logits.shape[-1])
    sparse = None
    if backend == "fused":
        conf_pub, sparse = _fused_pass(public_logits, cfg, k)
    else:
        conf_pub = detector_scores(public_logits, cfg.detector)

    def scores():
        conf_cal = (conf_pub
                    if cal_logits is None or cal_logits is public_logits
                    else detector_scores(cal_logits, cfg.detector))
        return detector_scores(val_logits, cfg.detector), conf_cal

    thresholds, id_mask, act = _select(conf_pub, scores, filter_ood, active)

    if backend == "dense":
        labels = distill.soft_labels(public_logits, cfg.temperature)
        avg, weights = exchange_dense(topology, id_mask, labels)
        if act is not None:
            weights = weights * act[:, None]
        return HomogenizedSet(avg, weights, id_mask, thresholds)

    if sparse is None:                                     # backend == sparse
        probs = distill.soft_labels(public_logits, cfg.temperature)
        sparse = distill.sparsify_labels(probs, k)
    merged, weights = exchange_sparse(topology, id_mask, sparse)
    if act is not None:
        weights = weights * act[:, None]
    return SparseHomogenizedSet(merged, weights, id_mask, thresholds)


# ---------------------------------------------------------- streaming round
@torch.no_grad()
def streaming_label_round(model, params, public_x, val_x,
                          topology: Topology, cfg: IDKDConfig, *,
                          filter_ood: bool = True, active=None
                          ) -> SparseHomogenizedSet:
    """One homogenization round that never materializes the public logit
    stack: ``public_x`` (P, ...) shared public inputs, ``val_x`` (n, V,
    ...) each node's own private inputs, node-stacked ``params``; D_C =
    D_P. Peak memory is one microbatch of activations for all n nodes
    plus the O(n · P · k) payload. Equals the fused backend of
    :func:`label_round` to float tolerance."""
    n = next(iter(params.values())).shape[0]
    if topology.n != n:
        raise ValueError(f"param stack has {n} nodes, topology "
                         f"{topology.name!r} has {topology.n}")
    C = model.head_params(params)[0].shape[-1]
    k = min(cfg.label_topk or DEFAULT_TOPK, C)
    chunks, P, _ = _chunk_public(public_x, cfg.stream_microbatch)
    conf_pub, sparse = _stream_public(model, params, chunks, P, cfg, k)
    thresholds, id_mask, act = _select(
        conf_pub,
        lambda: (_stream_val_conf(model, params, val_x, cfg), conf_pub),
        filter_ood, active)
    merged, weights = exchange_sparse(topology, id_mask, sparse)
    if act is not None:
        weights = weights * act[:, None]
    return SparseHomogenizedSet(merged, weights, id_mask, thresholds)


# ------------------------------------------------------------ sharded round
def _shard_layout(topology: Topology, local_nodes: int, mesh):
    """Shared shard-round validation: the node blocks cover the topology
    and the graph is a ring or complete. Returns (n, ring, full)."""
    from repro_torch.core import mixing

    n = local_nodes * mesh.node.size
    if topology.n != n:
        raise ValueError(f"the node blocks hold {local_nodes} x "
                         f"{mesh.node.size} = {n} nodes, topology "
                         f"{topology.name!r} has {topology.n}")
    ring = mixing._is_ring(topology)
    full = mixing._is_full(topology)
    if not (ring or full):
        raise ValueError(
            f"sharded label exchange supports ring/complete graphs; "
            f"topology {topology.name!r} must use the node-stacked "
            "labeling.label_round (backend='sparse')")
    return n, ring, full


def _local_rows(x, n: int, mesh):
    """This rank's node rows of a global (n, ...) stack; a tensor that
    is already a block passes through."""
    L = n // mesh.node.size
    if x.shape[0] == n and L != n:
        return x[mesh.node.index * L:(mesh.node.index + 1) * L]
    return x


def _merge_payloads(parts_v, parts_i, parts_m):
    """The mean over contributors distributes over the scatter: concat
    the contributors' payloads along k with m_j / cnt weights."""
    cnt = sum(parts_m)                                      # (L, P)
    share = [m / torch.clamp(cnt, min=1.0) for m in parts_m]
    extra = parts_v[0].dim() - cnt.dim()                    # k (and S)
    vals = torch.cat([v * s.reshape(s.shape + (1,) * extra)
                      for v, s in zip(parts_v, share)], dim=-1)
    idx = torch.cat(parts_i, dim=-1)
    return vals.float(), idx.to(torch.int32), (cnt > 0).float()


def _shard_exchange(sp: distill.SparseLabels, m, *, mesh, n: int,
                    ring: bool, full: bool):
    """The label exchange across the node group: only the top-k payload
    (values, indices, D_ID mask) moves — ring neighbours' boundary rows
    (``mixing.block_ring_shift``), or every rank's block on a complete
    graph (``all_gather``)."""
    from repro_torch.launch import dist
    if full and not (ring and n <= 3):
        vals_all = dist.all_gather_cat(sp.values, mesh.node)  # (n, P, k)
        idx_all = dist.all_gather_cat(sp.indices, mesh.node)
        m_all = dist.all_gather_cat(m, mesh.node)
        # every node merges the same contributor set: one merge,
        # broadcast over the local nodes
        vals, idx, w = _merge_payloads(list(vals_all), list(idx_all),
                                       list(m_all))
        L = m.shape[0]
        return (vals.expand((L,) + vals.shape), idx.expand((L,) + idx.shape),
                w.expand((L,) + w.shape))
    if n == 1:
        return _merge_payloads([sp.values], [sp.indices], [m])
    from repro_torch.core.mixing import block_ring_shift

    # the ring neighbours' boundary rows of all three, one collective
    ts = (sp.values, sp.indices, m)
    nbs = dist.ring_neighbors_many(list(ts), mesh.node)
    parts = [[t] + [block_ring_shift(t, mesh.node, s, nb)
                    for s in ((1, -1) if n > 2 else (1,))]
             for t, nb in zip(ts, nbs)]
    return _merge_payloads(*parts)


def _shard_select(conf_pub, scores, filter_ood: bool):
    if filter_ood:
        thresholds = calibrate(*scores())
        return thresholds, conf_pub > thresholds[:, None]
    return (torch.zeros((conf_pub.shape[0],), device=conf_pub.device),
            torch.ones(conf_pub.shape, dtype=torch.bool,
                       device=conf_pub.device))


@torch.no_grad()
def shard_label_round(public_logits, val_logits, topology: Topology,
                      cfg: IDKDConfig, *, mesh, filter_ood: bool = True
                      ) -> SparseHomogenizedSet:
    """One homogenization round on this rank's node block — the
    ``driver_mode="shard"`` twin of :func:`label_round` (the reference's
    ``shard_label_round``). ``public_logits`` (L, P, C) and
    ``val_logits`` (L, V, C) are the block's (a global (n, ...) stack is
    cut to the block).

    Score, calibrate and select are local. Only the exchange crosses the
    node group, and it moves nothing but top-k payloads. The merged
    payload equals the node-stacked sparse backend's up to a permutation
    along k (contributors self/prev/next instead of self/sorted
    neighbours): every consumer accumulates duplicate indices, and the
    per-node payload bytes match exactly. Always sparse; churn masks are
    unsupported; a topology other than a ring or a complete graph
    raises."""
    size = mesh.node.size
    n = topology.n
    if public_logits.shape[0] == n and size > 1:
        public_logits = _local_rows(public_logits, n, mesh)
        val_logits = _local_rows(val_logits, n, mesh)
    n, ring, full = _shard_layout(topology, public_logits.shape[0], mesh)
    k = min(cfg.label_topk or DEFAULT_TOPK, public_logits.shape[-1])
    conf_pub = detector_scores(public_logits, cfg.detector)
    thresholds, id_mask = _shard_select(
        conf_pub, lambda: (detector_scores(val_logits, cfg.detector),
                           conf_pub), filter_ood)
    sp = distill.sparsify_labels(
        distill.soft_labels(public_logits, cfg.temperature), k)
    vals, idx, w = _shard_exchange(sp, id_mask.float(), mesh=mesh, n=n,
                                   ring=ring, full=full)
    return SparseHomogenizedSet(distill.SparseLabels(vals, idx), w,
                                id_mask, thresholds)


@torch.no_grad()
def shard_streaming_label_round(model, params, public_x, val_x,
                                topology: Topology, cfg: IDKDConfig, *,
                                mesh, specs=None, filter_ood: bool = True
                                ) -> SparseHomogenizedSet:
    """:func:`streaming_label_round` on this rank's node block — the
    streaming twin of :func:`shard_label_round` (the reference's
    ``shard_streaming_label_round``). ``params`` is the block
    (``launch.sharding.local_block``); ``val_x`` the block's (L, V, ...)
    or the global (n, V, ...) stack; the public set is every rank's.

    Each rank streams the public microbatches through its own nodes —
    forward to pre-head activations, the fused head pass per chunk —
    and calibrates locally; only the top-k payload crosses the node
    group. On the 2-D federation mesh (``specs`` the params' specs) the
    rank all-gathers its nodes' model-sharded leaves to full width for
    ``forward_features`` and runs the vocab-sharded head pass; label wire
    bytes are unchanged by model parallelism."""
    from repro_torch.launch.sharding import gather_model_tree, like_params

    L = next(iter(params.values())).shape[0]
    n, ring, full = _shard_layout(topology, L, mesh)
    if mesh.model.size > 1:
        if specs is None:
            raise ValueError("a 2-D federation mesh needs the params' "
                             "specs (launch.sharding.federation_specs)")
        params = gather_model_tree(params, like_params(params, specs, L),
                                   mesh)

        def head_pass(model, p, x, cfg, k):
            return _vocab_sharded_head_pass(model, p, x, cfg, k, mesh)
    else:
        head_pass = _head_pass
    C = model.head_params(params)[0].shape[-1]
    k = min(cfg.label_topk or DEFAULT_TOPK, C)
    val_x = _local_rows(val_x, n, mesh)
    chunks, P, _ = _chunk_public(public_x, cfg.stream_microbatch)
    conf_pub, sp = _stream_public(model, params, chunks, P, cfg, k,
                                  head_pass)
    thresholds, id_mask = _shard_select(
        conf_pub, lambda: (_stream_val_conf(model, params, val_x, cfg,
                                            head_pass), conf_pub),
        filter_ood)
    del params
    vals, idx, w = _shard_exchange(sp, id_mask.float(), mesh=mesh, n=n,
                                   ring=ring, full=full)
    return SparseHomogenizedSet(distill.SparseLabels(vals, idx), w,
                                id_mask, thresholds)


def neighbor_topk_overlap(indices, topology: Topology):
    """Telemetry diagnostic: how much of each node's top-k label index
    set its graph neighbours share. ``indices`` (n, P[, S], k), a tensor
    or an array. For each undirected edge (i, j) the overlap is the
    fraction of node i's entries that also appear in node j's set for
    the same sample, averaged over samples. Returns ``(mean,
    per_edge)``, ``per_edge`` mapping ``"i-j"`` to the fraction; mean is
    0.0 on an edgeless graph. Host numpy, once a round."""
    idx = (indices.detach().cpu().numpy()
           if isinstance(indices, torch.Tensor) else np.asarray(indices))
    n = idx.shape[0]
    flat = idx.reshape(n, -1, idx.shape[-1])            # (n, M, k)
    per_edge = {}
    for i in range(n):
        for j in topology.neighbors(i):
            if j <= i:
                continue
            a, b = flat[i], flat[j]                      # (M, k) each
            hit = (a[:, :, None] == b[:, None, :]).any(-1)
            per_edge[f"{i}-{j}"] = float(hit.mean())
    mean = float(np.mean(list(per_edge.values()))) if per_edge else 0.0
    return mean, per_edge
