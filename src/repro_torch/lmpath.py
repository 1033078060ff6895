"""The LM slice's paths at full width, as ``chip_smoke.py`` drives them:
one homogenization round (``launch.train.idkd_label_round``) of
Hymba-1.5B nodes on a ring (:func:`setup`), and decentralized training
with IDKD (``launch.train.run_training``) of the same nodes
(:func:`train`).

* Model: Hymba-1.5B as configured (32 layers, d_model 1600, 25 heads /
  5 KV heads × 64, d_ff 5504, SSM 50 heads × 64 with state 16 and chunk
  256, vocabulary 32,001, bf16, 128 meta tokens, sliding window 1024
  with global layers 0, 16 and 31): about 1.64 B parameters per node.
* Nodes: 4 on a ring, node i initialised by the port's ``init`` from
  seed i, so the exchange merges payloads that differ. The nodes are
  untrained: the round's D_ID fraction says nothing of IDKD's quality.
* Data: ``make_lm_data`` at seq_len 2048 — 512 private sequences
  partitioned over the nodes at Dirichlet α = 0.1, 64 public sequences —
  as the reference's ``run_training`` makes it; each node calibrates on
  its first m = min(16, smallest partition) private sequences.
* Round: top-8 sparse labels, 8 public sequences per streaming
  microbatch, T = 10, MSP detector.
* Training (:data:`TRAIN`): the same model, nodes and data (every node
  initialised from the run's seed 4, as ``run_training`` starts them),
  QG-DSGDm-N with Metropolis gossip, 2 sequences per node and step, lr
  0.1 (the reference CLI's LM rate; the normalized update has norm lr
  over all 6.6 B parameters, and bf16 losses stay finite), 4 steps:
  2 plain, the round at step 2 (the round above), 2 sparse-KD steps on
  the neighbours' averaged top-8 labels with 4 public sequences per node
  and step. All 32 layers, each recomputed in its backward pass
  (``cfg.remat``).
* The dense family at full width, each a named ``TrainConfig`` that
  :func:`train` runs as it runs :data:`TRAIN` (nodes initialised from
  the run's seed, the round as :data:`TRAIN`'s at step 2, 2 plain and 2
  sparse-KD steps, every layer recomputed):

  - :data:`QWEN3_TRAIN`: Qwen3-1.7B (``qwen3-1.7b``, the reference
    CLI's default arch: 28 layers, d_model 2048, 16/8 heads × 128,
    qk-norm, tied head over 151,936 tokens, about 1.72 B parameters) on
    4 ring nodes, 1 private sequence per node and step and
    :data:`QWEN3_PUB_BATCH` = 2 public sequences per node in a KD step.
    Params, grads and momentum take 4 × 1.72 B × 6 B ≈ 41 GB; TRAIN's
    2 private and 4 public sequences would add ~50 GB of
    vocabulary-wide logits in a KD step, which one H100 cannot hold.
    Its ~63 GiB peak needs ``PYTORCH_CUDA_ALLOC_CONF=
    expandable_segments:True`` (as ``chip_smoke.py`` sets it): in
    fixed-size segments the KD step's blocks can fragment past the card.
  - :data:`PHI3_TRAIN`: Phi-3-mini (``phi3-mini-3.8b``: 32 layers,
    d_model 3072, 32/32 heads × 96, untied head over 32,064 tokens,
    about 3.82 B parameters) on 2 ring nodes at TRAIN's 2 private and
    4 public sequences: 2 × 3.82 B × 6 B ≈ 46 GB of state (4 nodes
    would need over 90 GB). Its attention runs the head_dim-96 kernels.

``setup`` and ``train`` take the same arguments at any size, so the CPU
tests drive this module with a reduced config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import IDKDConfig, ModelConfig, TrainConfig
from repro_torch.core.topology import Topology
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import make_lm_data
from repro_torch.launch.train import (idkd_label_round, private_sequences,
                                      run_training)
from repro_torch.models.transformer import DecoderModel
from repro_torch.runtime import resolve_device

CONFIG = get_config("hymba-1.5b")
NUM_NODES = 4
SEQ_LEN = 2048
N_PRIVATE = 512
N_PUBLIC = 64
ALPHA = 0.1
DATA_SEED = 4            # TrainConfig's default seed, as run_training uses
ROUND = IDKDConfig(label_topk=8, stream_microbatch=8, label_backend="sparse",
                   temperature=10.0, detector="msp")
TRAIN = TrainConfig(algorithm="qg-dsgdm-n", topology="ring",
                    num_nodes=NUM_NODES, alpha=ALPHA, lr=0.1, batch_size=2,
                    steps=4, seed=DATA_SEED,
                    idkd=dataclasses.replace(ROUND, start_step=2,
                                             num_rounds=1))
QWEN3_TRAIN = dataclasses.replace(TRAIN, batch_size=1)
QWEN3_PUB_BATCH = 2
PHI3_TRAIN = dataclasses.replace(TRAIN, num_nodes=2)


@dataclass
class LMRound:
    model: DecoderModel
    params: Dict[str, torch.Tensor]     # node-stacked
    public: np.ndarray                  # (P, S) tokens
    private: np.ndarray                 # (n, m, S) tokens
    topology: Topology
    icfg: IDKDConfig

    def run(self, icfg: IDKDConfig | None = None, public=None):
        """One round; ``icfg`` / ``public`` override the configured ones."""
        icfg = icfg or self.icfg
        return idkd_label_round(
            self.model, self.params,
            self.public if public is None else public, self.private, icfg,
            self.topology, backend=icfg.label_backend)


@torch.no_grad()
def node_params(model: DecoderModel, seeds: Sequence[int], device):
    """Node-stacked params, node i drawn from ``seeds[i]``; each node is
    copied into the stack as it is made, so the peak is one node over."""
    stacked = None
    for i, seed in enumerate(seeds):
        p = model.init(seed, device)
        if stacked is None:
            stacked = {k: torch.empty((len(seeds),) + v.shape, dtype=v.dtype,
                                      device=v.device) for k, v in p.items()}
        for k, v in p.items():
            stacked[k][i].copy_(v)
        del p
    return stacked


def setup(cfg: ModelConfig = CONFIG, *, num_nodes: int = NUM_NODES,
          seq_len: int = SEQ_LEN, n_private: int = N_PRIVATE,
          n_public: int = N_PUBLIC, icfg: IDKDConfig = ROUND,
          device="cuda") -> LMRound:
    device = resolve_device(device)
    model = DecoderModel(cfg)
    tokens, topics = make_lm_data(cfg.vocab_size, seq_len + 1, n_private,
                                  seed=DATA_SEED)
    parts = dirichlet_partition(topics, num_nodes, ALPHA,
                                np.random.default_rng(DATA_SEED))
    public, _ = make_lm_data(cfg.vocab_size, seq_len, n_public,
                             num_topics=10, seed=DATA_SEED + 99)
    return LMRound(model=model,
                   params=node_params(model, range(num_nodes), device),
                   public=public,
                   private=private_sequences(tokens, parts, seq_len),
                   topology=Topology.make("ring", num_nodes), icfg=icfg)


def train(cfg: ModelConfig = CONFIG, tcfg: TrainConfig = TRAIN, *,
          seq_len: int = SEQ_LEN, n_private: int = N_PRIVATE,
          n_public: int = N_PUBLIC, pub_batch=None, device="cuda",
          verbose: bool = False):
    """``run_training`` with IDKD on this configuration, the loss logged
    after every step (host runner); ``pub_batch`` as ``run_training``'s
    (None: the reference's)."""
    return run_training(cfg, tcfg, seq_len=seq_len, n_seqs=n_private,
                        n_public=n_public, log_every=1, use_idkd=True,
                        verbose=verbose, driver_mode="host", device=device,
                        pub_batch=pub_batch)
