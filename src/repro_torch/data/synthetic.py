"""Synthetic datasets standing in for CIFAR and its public sets.

A numpy copy of the JAX package's ``data/synthetic.py``: the same seed
gives bitwise-equal arrays on both sides, so the port and the reference
train on the same data.

* :func:`make_classification_data` — class-conditional images (per-class
  mean pattern over a shared feature dictionary, plus noise);
* :func:`make_public_data` — the unlabeled public set D_P: ``aligned``
  (half from the class generators, half OoD), ``shifted`` or ``noise``;
* :func:`make_lm_data` — a topic-conditional unigram token corpus.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ClassificationData:
    train_x: np.ndarray     # (N, H, W, C) float32
    train_y: np.ndarray     # (N,) int64
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    class_means: np.ndarray  # (num_classes, H, W, C) — the generators


def _class_means(rng, num_classes, image_size, channels, scale=1.0):
    """Per-class mean images as sparse combinations of a shared feature
    dictionary (shared features make non-IID training interfere, as
    CIFAR's low-level features do)."""
    K = 6
    D = rng.normal(size=(K, 4, 4, channels)).astype(np.float32)
    W = rng.normal(size=(num_classes, K)).astype(np.float32)
    W /= np.linalg.norm(W, axis=1, keepdims=True)
    base = np.einsum("ck,khwj->chwj", W, D)
    reps = image_size // 4
    up = np.repeat(np.repeat(base, reps, axis=1), reps, axis=2)
    return (up * scale).astype(np.float32)


def make_classification_data(num_classes: int = 10, image_size: int = 16,
                             channels: int = 3, n_train: int = 4096,
                             n_val: int = 512, n_test: int = 1024,
                             noise: float = 0.6, seed: int = 0
                             ) -> ClassificationData:
    rng = np.random.default_rng(seed)
    means = _class_means(rng, num_classes, image_size, channels)

    def sample(n):
        y = rng.integers(0, num_classes, size=n)
        x = means[y] + rng.normal(scale=noise,
                                  size=(n, image_size, image_size, channels)
                                  ).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int64)

    tx, ty = sample(n_train)
    vx, vy = sample(n_val)
    sx, sy = sample(n_test)
    return ClassificationData(tx, ty, vx, vy, sx, sy, means)


def make_public_data(data: ClassificationData, n_public: int = 2048,
                     kind: str = "aligned", aligned_frac: float = 0.5,
                     noise: float = 0.9, seed: int = 1) -> np.ndarray:
    """Unlabeled public set D_P. ``kind``: 'aligned' (aligned_frac from
    the class generators, the rest OoD), 'shifted' (perturbed
    generators) or 'noise' (uniform noise)."""
    rng = np.random.default_rng(seed)
    C, H, W, ch = data.class_means.shape
    if kind == "noise":
        return rng.uniform(-2, 2, size=(n_public, H, W, ch)).astype(np.float32)
    if kind == "shifted":
        shift = rng.normal(scale=0.8, size=data.class_means.shape
                           ).astype(np.float32)
        means = data.class_means + shift
        y = rng.integers(0, C, size=n_public)
        x = means[y] + rng.normal(scale=noise, size=(n_public, H, W, ch))
        return x.astype(np.float32)
    n_id = int(n_public * aligned_frac)
    y = rng.integers(0, C, size=n_id)
    x_id = data.class_means[y] + rng.normal(scale=noise, size=(n_id, H, W, ch))
    ood_means = _class_means(rng, C, H, ch)  # fresh generators => OoD
    y2 = rng.integers(0, C, size=n_public - n_id)
    x_ood = ood_means[y2] + rng.normal(scale=noise,
                                       size=(n_public - n_id, H, W, ch))
    x = np.concatenate([x_id, x_ood]).astype(np.float32)
    rng.shuffle(x)
    return x


def make_lm_data(vocab: int, seq_len: int, n_seqs: int, num_topics: int = 10,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Topic-conditional unigram LM corpus: (tokens (N, S) int32, topic
    (N,) int64). Each topic draws 80% of its tokens from its own vocab
    slice, so a Dirichlet partition by topic is non-IID in tokens."""
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, num_topics, size=n_seqs)
    slice_size = max(vocab // num_topics, 1)
    tokens = np.empty((n_seqs, seq_len), np.int32)
    for i, t in enumerate(topics):
        lo = (t * slice_size) % vocab
        in_slice = rng.random(seq_len) < 0.8
        tok = np.where(
            in_slice,
            lo + rng.integers(0, slice_size, size=seq_len),
            rng.integers(0, vocab, size=seq_len))
        tokens[i] = tok % vocab
    return tokens, topics.astype(np.int64)
