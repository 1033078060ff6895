"""Out-of-distribution detection for IDKD (paper §3, Figure 2c).

MSP (Hendrycks & Gimpel 2017) or energy (Liu et al. 2020b) confidence;
the per-node threshold t_opt is Youden's J = TPR − FPR on a ROC sweep,
private (ID) scores against calibration (OoD) scores. ``roc_curve`` and
``calibrate_threshold`` take a leading batch axis, so one call
calibrates every node.
"""
from __future__ import annotations

import torch


def msp_confidence(logits, temperature: float = 1.0) -> torch.Tensor:
    """Max softmax probability. logits: (..., C) -> (...)."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return probs.max(dim=-1).values


def energy_score(logits, temperature: float = 1.0) -> torch.Tensor:
    """−E(x) = T·logsumexp(z/T). Higher ⇒ more ID."""
    return temperature * torch.logsumexp(logits.float() / temperature, dim=-1)


def confidence(logits, detector: str = "msp", temperature: float = 1.0
               ) -> torch.Tensor:
    if detector == "energy":
        return energy_score(logits, temperature)
    if detector == "msp":
        return msp_confidence(logits, temperature)
    raise ValueError(f"unknown OoD detector {detector!r}")


def roc_curve(id_scores, ood_scores, num_thresholds: int = 256):
    """Threshold sweep over the trailing axis. Returns (thresholds, TPR,
    FPR), each (..., num_thresholds); score > t ⇒ ID."""
    lo = torch.minimum(id_scores.min(-1).values, ood_scores.min(-1).values)
    hi = torch.maximum(id_scores.max(-1).values, ood_scores.max(-1).values)
    start, stop = lo - 1e-6, hi + 1e-6
    # jnp.linspace's arithmetic: start + i·step, the last point = stop
    step = (stop - start) / (num_thresholds - 1)
    i = torch.arange(num_thresholds - 1, device=lo.device,
                     dtype=torch.float32)
    ts = torch.cat([start[..., None] + i * step[..., None], stop[..., None]],
                   dim=-1)
    tpr = (id_scores[..., None, :] > ts[..., :, None]).float().mean(-1)
    fpr = (ood_scores[..., None, :] > ts[..., :, None]).float().mean(-1)
    return ts, tpr, fpr


def calibrate_threshold(id_scores, ood_scores,
                        num_thresholds: int = 256) -> torch.Tensor:
    """t_opt = argmax_t TPR(t) − FPR(t) (Youden's J), per leading index."""
    ts, tpr, fpr = roc_curve(id_scores, ood_scores, num_thresholds)
    best = torch.argmax(tpr - fpr, dim=-1, keepdim=True)
    return torch.gather(ts, -1, best)[..., 0]
