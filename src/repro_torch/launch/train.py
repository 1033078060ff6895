"""The LM homogenization round of ``src/repro/launch/train.py``.

:func:`idkd_label_round` is the round the reference's LM federation runs
at every IDKD step: every node's detector confidences and top-k soft
labels on the public corpus, a ROC threshold per node calibrated on its
private sequences, and the sparse neighbour label exchange. Its
streaming branch runs ``forward_features`` per microbatch and the
``head_select`` kernel at vocabulary width; the one-shot branch forms the
(n, P, S, V) logits and runs ``msp_select`` (fused backend).
:func:`private_sequences` picks each node's calibration sequences as the
reference's federation does. The training loop (``run_training``) is not
ported (ROADMAP.md item 10a).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import IDKDConfig
from repro_torch.core import labeling
from repro_torch.core.topology import Topology


def private_sequences(tokens: np.ndarray, parts: Sequence[np.ndarray],
                      seq_len: int) -> np.ndarray:
    """(n, m, seq_len) private calibration sequences: the first m of each
    node's partition, m = max(1, min(16, smallest partition)), as the
    reference's ``_LMFederation.on_round`` takes them."""
    m = max(1, min(16, min(len(p) for p in parts)))
    return np.stack([tokens[p[:m], :seq_len] for p in parts])


def _tokens(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).long()


@torch.no_grad()
def idkd_label_round(model, params_stacked, public_tokens, private_tokens,
                     idkd_cfg: IDKDConfig, topology: Topology,
                     backend: str = "sparse", active=None, mesh=None):
    """One LM IDKD round. ``public_tokens`` (P, S), ``private_tokens``
    (n, V, S), node-stacked ``params_stacked``. Returns (sparse labels
    (n, P, S, k_out), weights (n, P), id_mask (n, P), thresholds (n,)).

    With ``idkd_cfg.stream_labels`` and the fused or sparse backend the
    round streams the public corpus in ``stream_microbatch`` sequences
    through ``labeling.streaming_label_round``; otherwise it forms the
    node logits and runs ``labeling.label_round``."""
    if mesh is not None:
        raise NotImplementedError("idkd_label_round: sharded rounds "
                                  "(mesh=) are ROADMAP.md queue 1 item 13")
    dev = next(iter(params_stacked.values())).device
    pub = _tokens(public_tokens, dev)
    priv = _tokens(private_tokens, dev)
    if idkd_cfg.stream_labels and backend in ("fused", "sparse"):
        out = labeling.streaming_label_round(
            model, params_stacked, pub, priv, topology, idkd_cfg,
            active=active)
        return out.labels, out.weights, out.id_masks, out.thresholds
    n = priv.shape[0]
    logits_pub, _ = model.forward(
        params_stacked, {"tokens": pub[None].expand((n,) + pub.shape)})
    logits_priv, _ = model.forward(params_stacked, {"tokens": priv})
    out = labeling.label_round(logits_pub, logits_priv, None, topology,
                               idkd_cfg, backend=backend, active=active)
    return out.labels, out.weights, out.id_masks, out.thresholds
