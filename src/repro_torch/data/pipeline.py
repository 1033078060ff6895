"""Batching pipeline for decentralized training.

``NodeSampler`` draws per-node minibatches from the Dirichlet partition;
``HomogenizedSampler`` draws from D_T^i ∪ D_ID (private hard-label samples
mixed with distilled soft-label public samples) after an IDKD round —
Algorithm 1 line 15.

Host numpy samplers, a copy of the reference's: the same seeds draw the
same indices. The port's simulator and LM runners draw on the device
(``core/driver.py``); these serve host-side consumers, and take label
payloads as numpy arrays or tensors (moved to the host).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class NodeSampler:
    """Per-node IID sampling *within* each node's (non-IID) partition."""

    def __init__(self, parts: List[np.ndarray], batch_size: int, seed: int):
        self.parts = parts
        self.batch_size = batch_size
        self.rngs = [np.random.default_rng(seed + 17 * i)
                     for i in range(len(parts))]

    def sample(self) -> np.ndarray:
        """(n_nodes, batch) global indices into the training arrays."""
        return np.stack([
            rng.choice(part, size=self.batch_size,
                       replace=len(part) < self.batch_size)
            for rng, part in zip(self.rngs, self.parts)])


class HomogenizedSampler:
    """Samples the union set: with prob proportional to sizes, a batch
    element comes from the private set (hard label) or the distilled
    public subset (soft label + weight).

    Optionally owns the post-round label payload (``public_labels``):
    either a dense ``(n, P, C)`` array or a sparse top-k
    ``(values (n, P, k), indices (n, P, k))`` pair — the sparse payload
    is gathered per batch and handed to the KD step without ever being
    densified to ``(n, P, C)``.
    """

    def __init__(self, parts: List[np.ndarray], public_weights: np.ndarray,
                 batch_size: int, seed: int, public_labels=None):
        # public_weights: (n_nodes, P) — 1 where sample in node's D_ID union
        self.parts = parts
        self.batch_size = batch_size
        self.rngs = [np.random.default_rng(seed + 31 * i)
                     for i in range(len(parts))]
        self.refresh(public_weights, public_labels)

    def refresh(self, public_weights: np.ndarray, public_labels=None) -> None:
        """Swap in a new homogenization round's D_ID selection and label
        payload. This is the repeated-round path for *host-side* numpy
        consumers of the pipeline (the jitted drivers refresh rounds by
        passing the round's state to the step
        as ``ctx`` instead); the per-node RNG streams keep
        advancing across a refresh, so draws are never replayed."""
        self.public_weights = _host(public_weights)
        self.public_idx = [np.flatnonzero(w > 0) for w in self.public_weights]
        if public_labels is not None:
            if isinstance(public_labels, (tuple, list)):
                # sparse payload: a (values, indices) named/plain tuple
                public_labels = (_host(public_labels[0]),
                                 _host(public_labels[1]))
            else:
                # dense (n, P, C) array or tensor
                public_labels = _host(public_labels)
        self.public_labels = public_labels

    @property
    def sparse(self) -> bool:
        return isinstance(self.public_labels, tuple)

    def gather_public(self, pub_idx: np.ndarray):
        """Per-batch public label payload for (n, B) public indices:
        dense (n, B, C), or (values (n, B, k), indices (n, B, k))."""
        if self.public_labels is None:
            raise ValueError("sampler was built without label payloads")
        nidx = np.arange(len(self.parts))[:, None]
        if self.sparse:
            vals, idx = self.public_labels
            return vals[nidx, pub_idx], idx[nidx, pub_idx]
        return self.public_labels[nidx, pub_idx]

    def gather_weights(self, pub_idx: np.ndarray) -> np.ndarray:
        """Per-batch public sample weights: (n, B)."""
        nidx = np.arange(len(self.parts))[:, None]
        return self.public_weights[nidx, pub_idx]

    def sample(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (private_idx (n, B), public_idx (n, B), is_public (n, B)).
        Unused slots hold index 0 with is_public mask selecting the source."""
        n = len(self.parts)
        B = self.batch_size
        priv = np.zeros((n, B), np.int64)
        pub = np.zeros((n, B), np.int64)
        is_pub = np.zeros((n, B), bool)
        for i, rng in enumerate(self.rngs):
            n_priv = len(self.parts[i])
            n_pub = len(self.public_idx[i])
            p_pub = n_pub / max(n_priv + n_pub, 1)
            mask = rng.random(B) < p_pub
            is_pub[i] = mask & (n_pub > 0)
            priv[i] = rng.choice(self.parts[i], size=B,
                                 replace=n_priv < B)
            if n_pub:
                pub[i] = rng.choice(self.public_idx[i], size=B,
                                    replace=n_pub < B)
        return priv, pub, is_pub
