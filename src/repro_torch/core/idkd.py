"""The paper's homogenization diagnostics (Figure 3a): per-node class
histograms before/after IDKD and the skew metric. The round itself
lives in :mod:`repro_torch.core.labeling`; :func:`homogenization_round`
is its paper-named entry point on the dense backend."""
from __future__ import annotations

import torch

from repro_torch.configs.base import IDKDConfig
from repro_torch.core import distill, labeling
from repro_torch.core.topology import Topology


def homogenization_round(public_logits, val_logits, cal_logits,
                         topology: Topology, cfg: IDKDConfig
                         ) -> labeling.HomogenizedSet:
    """One IDKD round on node-stacked logits (dense backend):
    public_logits (n, P, C) on D_P, val_logits (n, V, C) on each node's
    private D_V, cal_logits (n, K, C) on D_C, or None for D_C = D_P."""
    return labeling.label_round(public_logits, val_logits, cal_logits,
                                topology, cfg, backend="dense")


def class_histogram(hard_labels, soft_labels=None, weights=None,
                    num_classes: int = 10) -> torch.Tensor:
    """Normalized per-class counts of a node's private labels plus its
    (weighted) soft labels, dense (P, C) or a sparse payload — sparse
    counting is an O(P·k) scatter-add, never densified."""
    hard = torch.as_tensor(hard_labels).long()
    hist = torch.bincount(hard, minlength=num_classes).float()
    if soft_labels is not None:
        if isinstance(soft_labels, distill.SparseLabels):
            vals = soft_labels.values.float().to(hist.device)
            w = (torch.ones(vals.shape[0], device=hist.device)
                 if weights is None else weights.float().to(hist.device))
            contrib = vals * w[:, None]
            hist = hist + torch.zeros(num_classes, device=hist.device
                                      ).index_add_(
                0, soft_labels.indices.reshape(-1).long().to(hist.device),
                contrib.reshape(-1))
        else:
            soft = soft_labels.float().to(hist.device)
            w = (torch.ones(soft.shape[0], device=hist.device)
                 if weights is None else weights.float().to(hist.device))
            hist = hist + torch.einsum("p,pc->c", w, soft)
    return hist / torch.clamp(hist.sum(), min=1.0)


def skew_metric(histograms) -> float:
    """Mean per-node TV distance from uniform (0 = perfectly IID)."""
    h = torch.as_tensor(histograms, dtype=torch.float32)
    C = h.shape[-1]
    return float(torch.mean(0.5 * torch.sum(torch.abs(h - 1.0 / C), dim=-1)))
