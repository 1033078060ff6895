"""Decentralized LM training with IDKD (``src/repro/launch/train.py``).

:func:`run_training` runs the reference's pipeline on token data:
node-stacked decoder params, per-node private shards (Dirichlet over
topics), ``tcfg.algorithm``'s steps (QG-DSGDm-N by default) with
gossip on ``tcfg.topology``, and IDKD homogenization rounds whose top-k
sparse labels on a public corpus feed the sparse-KD steps after them.
The algorithm is made without a topology, as the reference makes it, so
``relaysgd`` raises here. The step loop is ``core.driver``'s host
runner (one step per Python iteration) under both of the reference's
node-stacked names, ``"scan"`` (the default) and ``"host"``;
the outer loop is the federation scheduler, whose ledger counts the
gossip and label bytes.

:func:`idkd_label_round` is the round itself: every node's detector
confidences and top-k soft labels on the public corpus, a ROC threshold
per node calibrated on its private sequences, and the sparse neighbour
label exchange. Its streaming branch runs ``forward_features`` per
microbatch and the ``head_select`` kernel at vocabulary width; the
one-shot branch forms the (n, P, S, V) logits and runs ``msp_select``
(fused backend). :func:`private_sequences` picks each node's
calibration sequences as the reference's federation does.

Not ported (raise ``NotImplementedError``): the sharded driver and
``model_parallel`` (ROADMAP.md item 13), churn, rewire and
fault events, telemetry and resilience (item 11), compressed and
delayed gossip (item 12).

Usage (CPU, reduced config; ``--arch`` defaults to the reference's
``qwen3-1.7b``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 8 --nodes 4 --idkd --device cpu
"""
from __future__ import annotations

import argparse
import time
import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import sched
from repro_torch.configs import get_config
from repro_torch.configs.base import IDKDConfig, ModelConfig, TrainConfig
from repro_torch.core import distill, driver, labeling
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.mixing import make_mixer
from repro_torch.core.topology import Topology
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import make_lm_data
from repro_torch.launch.steps import consensus_params, stack_params
from repro_torch.models.model import build_model
from repro_torch.runtime import resolve_device


def make_gossip_mixer(tcfg: TrainConfig, wire_dtype: str = "native",
                      topology: Optional[Topology] = None, active=None,
                      stale=None, compression=None, gossip: str = "sync",
                      stateful=None, wire_fault=None, wire_guard=None,
                      device="cuda"):
    """The (topology, mixer) pair the launch path gossips params on: the
    dense Metropolis mixer on ``tcfg.topology`` (or ``topology``), the
    same graph the label exchange uses. Churn masks, stragglers,
    compressed or delayed gossip and wire faults are not ported."""
    if active is not None or stale is not None or stateful:
        raise NotImplementedError("churn masks and stragglers are not "
                                  "ported (ROADMAP.md queue 1 item 11)")
    if compression is not None or gossip != "sync":
        raise NotImplementedError("compressed and delayed gossip are not "
                                  "ported (ROADMAP.md queue 1 item 12)")
    if wire_fault is not None or wire_guard is not None:
        raise NotImplementedError("wire faults and guards are not ported "
                                  "(ROADMAP.md queue 1 item 11)")
    topo = topology or Topology.make(tcfg.topology, tcfg.num_nodes)
    return topo, make_mixer(topo, wire_dtype=wire_dtype, device=device)


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


def _refuse_codebooks(cfg: ModelConfig):
    """The reference has no LM data or round path for multi-codebook
    tokens or VLM patches: its ``run_training`` makes (n, S) token
    sequences and its round sends codebook models to a one-shot path
    that passes 2-D tokens and no conditioning, and calls
    ``forward_features`` with tokens alone, which a VLM's ``hidden``
    cannot run without ``patch_embeddings``."""
    if cfg.arch_type == "vlm":
        raise ValueError(
            f"{cfg.name}: a VLM; the reference has no LM data or round "
            "path for patch embeddings (src/repro/core/labeling.py:230, "
            "273 call forward_features with tokens alone, and "
            "make_lm_data makes no patches, so hidden's "
            "batch['patch_embeddings'] raises, "
            "src/repro/models/transformer.py:322-325); train it with "
            "launch.steps.make_train_step (lmpath.train_steps) and run "
            "launch.steps.make_prefill_step")
    if cfg.num_codebooks > 1:
        raise ValueError(
            f"{cfg.name}: {cfg.num_codebooks} codebooks; the reference has "
            "no LM data or round path for multi-codebook tokens "
            "(src/repro/launch/train.py:123-125 sends them to a one-shot "
            "round that cannot run them); train them with "
            "launch.steps.make_train_step (lmpath.train_steps)")


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
    _refuse_codebooks(model.cfg)
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


class _LMFederation(sched.CompiledFederationHooks):
    """Scheduler hooks of the LM launch path: plain and sparse-KD steps,
    the label round refreshing the KD sampler's ``ctx``, and the round's
    label bytes."""

    def __init__(self, *, model, algo, tcfg: TrainConfig,
                 idkd_cfg: IDKDConfig, cfg: ModelConfig, tokens, parts,
                 public_tokens, seq_len: int, wire_dtype: str,
                 verbose: bool, device, pub_batch: Optional[int] = None,
                 driver_mode: str = "scan"):
        super().__init__()
        self.model = model
        self.algo = algo
        self.tcfg = tcfg
        self.idkd_cfg = idkd_cfg
        self.cfg = cfg
        self.tokens = tokens
        self.parts = parts
        self.public_tokens = public_tokens
        self.seq_len = seq_len
        self.wire_dtype = wire_dtype
        self.verbose = verbose
        self.pub_batch = (min(4, len(public_tokens)) if pub_batch is None
                          else pub_batch)
        self.device = device
        self.lr_fn = lambda s: tcfg.lr
        self.driver_mode = driver_mode
        self.priv_parts = driver.pad_partitions(parts, device)
        self.plain_sampler = driver.make_lm_sampler(
            self.priv_parts, tokens, tcfg.batch_size)
        self.kd_sampler = None
        self.last_round_stats = None

    def _make_mixer(self, topology: Topology):
        return make_gossip_mixer(self.tcfg, self.wire_dtype,
                                 topology=topology, device=self.device)[1]

    def _adapter(self):
        return (driver.lm_adapter if self.phase == "plain"
                else driver.lm_sparse_kd_adapter(self.idkd_cfg))

    def _sampler(self):
        return (self.plain_sampler if self.phase == "plain"
                else self.kd_sampler)

    def on_round(self, params, round_index: int, step: int,
                 topology: Topology) -> np.ndarray:
        cfg = self.idkd_cfg
        priv = private_sequences(self.tokens, self.parts, self.seq_len)
        backend = cfg.label_backend
        if backend not in ("fused", "sparse"):
            # the LM KD step consumes sparse payloads; the dense oracle
            # backend is not an option at vocabulary scale
            warnings.warn(f"LM label round: backend {backend!r} requested, "
                          "using 'sparse'")
            backend = "sparse"
        sparse, w, id_mask, thr = idkd_label_round(
            self.model, params, self.public_tokens, priv, cfg, topology,
            backend=backend)
        self.ctx = driver.lm_kd_ctx(sparse.values, sparse.indices, w)
        if self.kd_sampler is None:
            self.kd_sampler = driver.make_lm_kd_sampler(
                self.priv_parts, self.tokens, self.tcfg.batch_size,
                self.public_tokens, sparse.values, sparse.indices, w,
                pub_batch=self.pub_batch)
        self.phase = "kd"
        mask = id_mask.cpu().numpy()
        counts = mask.sum(axis=1)
        id_fraction = float(mask.mean())
        if self.verbose:
            print(f"idkd.round step={step} round={round_index} "
                  f"id_fraction={id_fraction:.4f} thresholds="
                  f"{np.round(thr.cpu().double().numpy(), 3).tolist()}")
        self.last_round_stats = {
            "thresholds": thr.cpu().numpy(), "selected": counts,
            "id_fraction": id_fraction, "detector": cfg.detector}
        k_wire = min(cfg.label_topk or labeling.DEFAULT_TOPK,
                     self.cfg.vocab_size)
        return np.array([distill.label_bytes(int(c) * self.seq_len,
                                             self.cfg.vocab_size, k_wire)
                         for c in counts], np.float64)


def run_training(cfg: ModelConfig, tcfg: TrainConfig, *, seq_len: int = 64,
                 n_seqs: int = 512, n_public: int = 64, log_every: int = 10,
                 use_idkd: bool = False, verbose: bool = True,
                 wire_dtype: str = "native", driver_mode: str = "scan",
                 events: Sequence = (),
                 schedule: Optional[sched.Schedule] = None,
                 model_parallel: int = 1, telemetry=None, resil=None,
                 device="cuda", pub_batch: Optional[int] = None
                 ) -> Dict[str, Any]:
    """Decentralized LM training, as the reference's ``run_training``:
    data and partitions from ``tcfg.seed``, every node initialised from
    ``tcfg.seed`` (identical nodes, as the paper starts them), the
    schedule compiled from ``tcfg`` (``log_every`` boundaries and the
    IDKD rounds ``tcfg.idkd`` asks for when ``use_idkd``). Returns the
    consensus params, the loss at each log boundary, the model, the
    topology, the ledger, the schedule and the public sequences per node
    of a KD step. ``driver_mode`` "scan" (the default, as the
    reference's) and "host" both run the host runner. QG-DSGDm-N,
    centralized SGD, D² and gradient tracking update in place, so that a
    full-width federation holds one copy of params, grads and each state
    tree. ``pub_batch``, the public sequences per
    node in a KD step, is the reference's ``min(4, n_public)`` when None;
    a full-width run sets it lower where that many vocabulary-wide
    logits would not fit the card (``lmpath.QWEN3_PUB_BATCH``)."""
    _refuse_codebooks(cfg)
    if driver_mode == "shard" or model_parallel != 1:
        raise NotImplementedError(
            "the sharded driver and model_parallel are not ported "
            "(ROADMAP.md queue 1 item 13)")
    driver.resolve_runner_mode(driver_mode)
    if telemetry is not None or resil is not None:
        raise NotImplementedError("telemetry and resilience are not ported "
                                  "(ROADMAP.md queue 1 item 11)")
    if tcfg.compression_spec is not None or tcfg.gossip != "sync":
        raise NotImplementedError("compressed and delayed gossip are not "
                                  "ported (ROADMAP.md queue 1 item 12)")
    device = resolve_device(device)
    n = tcfg.num_nodes
    model = build_model(cfg)
    topo = Topology.make(tcfg.topology, n)
    algo = make_algorithm(tcfg.algorithm, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay)
    tokens, topics = make_lm_data(cfg.vocab_size, seq_len + 1, n_seqs,
                                  seed=tcfg.seed)
    parts = dirichlet_partition(topics, n, tcfg.alpha,
                                np.random.default_rng(tcfg.seed))
    public_tokens, _ = make_lm_data(cfg.vocab_size, seq_len, n_public,
                                    num_topics=10, seed=tcfg.seed + 99)
    params = stack_params(model.init(tcfg.seed, device), n)
    idkd_cfg = tcfg.idkd or IDKDConfig(label_topk=8)

    kd_fires = use_idkd and 0 <= idkd_cfg.start_step < tcfg.steps
    if schedule is None:
        rounds = (sched.idkd_round_steps(idkd_cfg, tcfg.steps)
                  if kd_fires else ())
        schedule = sched.compile_schedule(tcfg.steps, log_every,
                                          round_steps=rounds, events=events,
                                          gossip=tcfg.gossip)
    elif events:
        raise ValueError("pass events to compile_schedule, not alongside "
                         "a prebuilt schedule")
    if schedule.round_steps and not use_idkd:
        raise ValueError("schedule contains homogenization rounds but "
                         "use_idkd=False")

    fed = _LMFederation(model=model, algo=algo, tcfg=tcfg,
                        idkd_cfg=idkd_cfg, cfg=cfg, tokens=tokens,
                        parts=parts, public_tokens=public_tokens,
                        seq_len=seq_len, wire_dtype=wire_dtype,
                        verbose=verbose, device=device, pub_batch=pub_batch,
                        driver_mode=driver_mode)
    opt_state = algo.init(params)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed + 1)
    nparams = sum(v[0].numel() for v in params.values())
    ledger = sched.CommLedger(n, meta={
        "topology": topo.name, "wire_dtype": wire_dtype,
        "param_count": int(nparams), "compression": "none",
        "compression_frac": 0.0, "gossip": schedule.gossip})

    history = []
    t0 = time.time()

    def on_eval(params, step, losses):
        history.append(float(losses[-1]))
        if verbose:
            print(f"train.eval step={step} loss={history[-1]:.4f} "
                  f"elapsed_s={time.time() - t0:.1f}")

    fed.on_eval = on_eval
    params, opt_state, gen = sched.run_schedule(
        schedule, fed, params, opt_state, gen, topology=topo, ledger=ledger,
        param_count=int(nparams),
        elem_bytes=sched.wire_elem_bytes(wire_dtype, cfg.dtype))
    return {"params": consensus_params(params), "loss_history": history,
            "model": model, "topology": topo, "ledger": ledger.as_dict(),
            "schedule": schedule, "last_round": fed.last_round_stats,
            "pub_batch": fed.pub_batch}


def main():
    ap = argparse.ArgumentParser(
        description="Decentralized LM training with IDKD (the ported "
                    "flags of the reference's CLI).")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--idkd", action="store_true")
    ap.add_argument("--rounds", type=int, default=1,
                    help="IDKD homogenization rounds (spaced every-k)")
    ap.add_argument("--every-k", type=int, default=0,
                    help="steps between rounds (default: fit them evenly "
                         "into the post-start span)")
    ap.add_argument("--wire-dtype", default="native",
                    choices=["native", "float32"])
    ap.add_argument("--driver", default="scan", choices=["scan", "host"])
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    start = args.steps // 2
    every_k = args.every_k or sched.fit_every_k(args.steps, start,
                                                args.rounds)
    tcfg = TrainConfig(num_nodes=args.nodes, steps=args.steps, lr=0.1,
                       alpha=args.alpha, batch_size=8,
                       topology=args.topology,
                       idkd=IDKDConfig(start_step=start, label_topk=8,
                                       every_k_steps=every_k,
                                       num_rounds=args.rounds))
    out = run_training(cfg, tcfg, use_idkd=args.idkd,
                       wire_dtype=args.wire_dtype, driver_mode=args.driver,
                       device=args.device)
    print(f"final loss: {out['loss_history'][-1]:.4f}")
    led = out["ledger"]
    print(f"comm ledger: {led['gossip_bytes'] / 1e6:.2f} MB gossip + "
          f"{led['label_bytes'] / 1e6:.3f} MB labels over "
          f"{len(led['per_round'])} round bucket(s)")


if __name__ == "__main__":
    main()
