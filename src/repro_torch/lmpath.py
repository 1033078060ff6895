"""The LM slice's paths at full width, as ``chip_smoke.py`` drives them:
one homogenization round (``launch.train.idkd_label_round``) of
Hymba-1.5B nodes on a ring (:func:`setup`), decentralized training
with IDKD (``launch.train.run_training``) of the same nodes
(:func:`train`), and the decentralized train step
(``launch.steps.make_train_step``, :func:`train_steps`) of
MusicGen-medium and PaliGemma-3B.

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

* :data:`MUSICGEN_TRAIN`: MusicGen-medium (``musicgen-medium``: 48
  layers, d_model 1536, 24/24 heads × 64, d_ff 6144, GELU, LayerNorm,
  4 codebooks × 2048 tokens with untied per-codebook heads, a
  cross-attention block per layer over 64 conditioning vectors; bf16;
  1.837 B parameters as the port's ``init`` makes them, 1.375 B by the
  reference's ``param_count()``, which counts no cross-attention and
  one table per extra codebook) on 4 ring nodes, QG-DSGDm-N at
  :data:`TRAIN`'s lr, 2 sequences per node of :data:`MUSICGEN_SEQ_LEN`
  = 1500 frames (MusicGen's 30-second training crops at EnCodec's 50 Hz,
  arXiv:2306.05284), every layer recomputed. The reference's
  ``run_training`` and round have no path for multi-codebook tokens, so
  :func:`train_steps` runs ``make_train_step`` on random batches in
  ``launch.input_specs.train_specs``' layout. Params, grads and
  momentum take 4 × 1.837 B × 6 B ≈ 44 GB (QG-DSGDm-N updates in place);
  the layer inputs that per-layer recompute saves 4 nodes × 48 layers ×
  2 × 1500 × 1536 × 2 B ≈ 1.8 GB; the f32 logits (2, 1500, 4, 2048)
  0.1 GB a node: a peak of ~45–50 GB.

* :data:`PALIGEMMA_TRAIN`: PaliGemma-3B (``paligemma-3b``: the Gemma-2B
  backbone, 18 layers, d_model 2048, 8 query heads on 1 KV head × 256,
  d_ff 16,384 GeGLU, tied embeddings over 257,216 tokens; bf16) on 4
  ring nodes, QG-DSGDm-N at :data:`TRAIN`'s lr, 2 sequences per node of
  256 N(0, 1) patch embeddings (the SigLIP tower stubbed, as the
  reference stubs it in ``launch.input_specs``) before
  :data:`PALIGEMMA_TEXT_LEN` = 256 text tokens, every layer recomputed;
  attention runs the prefix-LM mask over the 256 patches at head_dim
  256. The reference has no round or ``run_training`` for a VLM, so
  :func:`train_steps` runs ``make_train_step`` on :func:`train_batch`'s
  batches. Memory, reckoned before the first run on the card: the embed
  table 257,216 × 2048 = 0.527 B parameters and 18 layers × (9.44 M
  attention + 100.7 M GeGLU) = 1.98 B, about 2.51 B a node; params,
  grads and momentum 4 × 2.51 B × 6 B ≈ 60 GB; the f32 and bf16 logits
  and their gradients, (4, 2, 256, 257,216), ≈ 6 GB; the saved layer
  inputs 4 × 18 × 2 × 512 × 2048 × 2 B ≈ 0.3 GB: ≈ 62 GiB, under
  ``chip_smoke.py``'s 72 GiB gate. Cut: the text is 256 tokens where the
  reference's ``train_4k`` shape has 4096 (the vocabulary-wide logits of
  4 nodes × 2 × 4096 tokens would not fit beside the state), and depth
  (a few steps).

``setup``, ``train`` and ``train_steps`` take the same arguments at any
size, so the CPU tests drive this module with a reduced config.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import IDKDConfig, ModelConfig, TrainConfig
from repro_torch.core.topology import Topology
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import make_lm_data
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.launch.steps import make_train_step
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
MUSICGEN_TRAIN = dataclasses.replace(TRAIN, steps=3, idkd=None)
MUSICGEN_SEQ_LEN = 1500
PALIGEMMA_TRAIN = dataclasses.replace(TRAIN, steps=3, idkd=None)
PALIGEMMA_TEXT_LEN = 256


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


def train_batch(cfg: ModelConfig, num_nodes: int, batch_size: int,
                seq_len: int, gen: torch.Generator):
    """One node-stacked batch in ``train_specs``' layout, drawn on
    ``gen``'s device: token streams seq_len + 1 long, tokens = [:S] and
    labels = [1:] ((n, B, S, K) with K codebooks, else (n, B, S)); for
    a cross-attention model, conditioning (n, B, cross_attn_len, d),
    for a VLM patch_embeddings (n, B, num_prefix_tokens, d), from
    N(0, 1) in ``cfg.dtype``."""
    K = cfg.num_codebooks
    shape = (num_nodes, batch_size, seq_len + 1) + ((K,) if K > 1 else ())
    seq = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                        device=gen.device)
    batch = {"tokens": seq[:, :, :-1], "labels": seq[:, :, 1:]}
    if cfg.cross_attention:
        batch["conditioning"] = torch.randn(
            (num_nodes, batch_size, cfg.cross_attn_len, cfg.d_model),
            generator=gen, device=gen.device).to(getattr(torch, cfg.dtype))
    if cfg.arch_type == "vlm":
        batch["patch_embeddings"] = torch.randn(
            (num_nodes, batch_size, cfg.num_prefix_tokens, cfg.d_model),
            generator=gen, device=gen.device).to(getattr(torch, cfg.dtype))
    return batch


def _flash_counts():
    return {f.__name__: {m: dict(v) for m, v in f.launches_by_mode.items()}
            for f in (flash_attention, flash_attention_bwd)}


def train_steps(cfg: ModelConfig, tcfg: TrainConfig, *, seq_len: int,
                steps: int, device="cuda"):
    """``steps`` steps of ``launch.steps.make_train_step`` (``tcfg``'s
    algorithm, topology, nodes and lr; ``tcfg.batch_size`` sequences per
    node) from nodes all initialised from ``tcfg.seed``, on batches from
    :func:`train_batch` (a generator on the device seeded from
    ``tcfg.seed``). Returns the final params, each step's loss, wall
    seconds (ended by a synchronize on the card) and flash launches by
    kernel, mode and variant, a fingerprint of how many (leaf, node)
    pairs the run changed, and the peak device memory in GiB (None on
    the CPU)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    n = tcfg.num_nodes
    model = DecoderModel(cfg)
    params = node_params(model, [tcfg.seed] * n, device)

    def fingerprint():
        return {k: v.reshape(n, -1).sum(1, dtype=torch.float32)
                for k, v in params.items()}
    before = fingerprint()
    step = make_train_step(model, tcfg, n, device=device)
    opt = step.init_opt(params)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = []
    for _ in range(steps):
        batch = train_batch(cfg, n, tcfg.batch_size, seq_len, gen)
        counts = _flash_counts()
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch, tcfg.lr)
        loss = float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize(device)
        after = _flash_counts()
        out.append(dict(loss=loss, s=time.perf_counter() - t0, launches={
            name: {m: {v: after[name][m][v] - c for v, c in by.items()}
                   for m, by in modes.items()}
            for name, modes in counts.items()}))
        del batch
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda \
        else None
    moved = sum(int((a != before[k]).sum())
                for k, a in fingerprint().items())
    return dict(params=params, steps=out, moved=moved,
                pairs=n * len(params), peak_gib=peak)
