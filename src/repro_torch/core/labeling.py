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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import IDKDConfig
from repro_torch.core import distill, ood
from repro_torch.core.topology import Topology
from repro_torch.kernels.head_select import head_select
from repro_torch.kernels.msp_select import msp_select

BACKENDS = ("dense", "fused", "sparse")
DEFAULT_TOPK = 8


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


def _stream_public(model, params, chunks, P: int, cfg: IDKDConfig, k: int):
    """Stream the chunked public set through every node's head pass;
    keep only (conf, vals, idx)."""
    L = next(iter(params.values())).shape[0]
    confs, vals, idxs = [], [], []
    for xc in chunks:
        c, v, i = _head_pass(model, params,
                             xc[None].expand((L,) + xc.shape), cfg, k)
        confs.append(c)
        vals.append(v)
        idxs.append(i)
    return (torch.cat(confs, dim=1)[:, :P],
            distill.SparseLabels(torch.cat(vals, dim=1)[:, :P],
                                 torch.cat(idxs, dim=1)[:, :P]))


def _stream_val_conf(model, params, val_x, cfg: IDKDConfig):
    """Per-node confidence on each node's own val set (n, V, ...) through
    the same head pass; k=1, since only conf is consumed."""
    return _head_pass(model, params, val_x, cfg, 1)[0]


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
