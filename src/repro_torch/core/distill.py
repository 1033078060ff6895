"""Knowledge-distillation primitives (Hinton et al. 2015) for IDKD.

Temperature soft labels, the T²-scaled soft cross-entropy (the one
convention of both of the reference's drivers: consumers never rescale),
and the top-k sparse label codec that keeps the label exchange small.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def top_k(x, k: int):
    """Top-k along the last axis, ties to the lowest index (the order of
    ``lax.top_k``; ``torch.topk`` promises none): a stable descending
    sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def soft_labels(logits, temperature: float) -> torch.Tensor:
    """Teacher soft labels softmax(z / T) (paper Algorithm 1 line 5)."""
    return torch.softmax(logits.float() / temperature, dim=-1)


def kd_loss(student_logits, teacher_probs, temperature: float):
    """T²-scaled soft cross-entropy."""
    logp = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    ce = -torch.sum(teacher_probs * logp, dim=-1)
    return (temperature ** 2) * ce


def average_labels(label_stack, mask):
    """LabelAverage (Algorithm 1, line 14): label_stack (n, P, C) soft
    labels, mask (n, P) the samples each node kept. Returns the average
    over the nodes that labelled each sample (P, C) and whether any did
    (P,)."""
    m = mask.float()
    num = torch.einsum("np,npc->pc", m, label_stack.float())
    cnt = m.sum(dim=0)
    return num / torch.clamp(cnt, min=1.0)[:, None], cnt > 0


class SparseLabels(NamedTuple):
    """Top-k sparse soft labels (values + class indices)."""
    values: torch.Tensor   # (..., k) f32, renormalized
    indices: torch.Tensor  # (..., k) int32


def sparsify_labels(probs, k: int) -> SparseLabels:
    v, idx = top_k(probs, k)
    v = v / torch.clamp(v.sum(-1, keepdim=True), min=1e-9)
    return SparseLabels(v.float(), idx.to(torch.int32))


def densify_labels(sparse: SparseLabels, vocab: int) -> torch.Tensor:
    """Scatter-add the payload into dense (..., vocab) labels; duplicate
    indices accumulate."""
    vals = sparse.values.float()
    out = torch.zeros(vals.shape[:-1] + (vocab,), device=vals.device)
    return out.scatter_add_(-1, sparse.indices.long(), vals)


def sparse_kd_loss(student_logits, sparse: SparseLabels,
                   temperature: float) -> torch.Tensor:
    """KD loss against top-k labels without densifying:
    T² · −Σ_k v_k · log_softmax(z/T)[idx_k]."""
    logp = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    gathered = torch.gather(logp, -1, sparse.indices.long())
    ce = -torch.sum(sparse.values * gathered, dim=-1)
    return (temperature ** 2) * ce


def label_bytes(num_samples: int, num_classes: int, topk: int = 0) -> int:
    """Bytes of one node's label payload (Table 6 analysis)."""
    if topk:
        return num_samples * topk * (4 + 4)   # f32 value + i32 index
    return num_samples * num_classes * 4
