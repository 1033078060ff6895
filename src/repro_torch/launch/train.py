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

Churn (``freeze`` / ``isolate``), rewire and fault events, telemetry
(``repro_torch.obs``) and resilience (``repro_torch.resil``) ride the
scheduler as in the reference. ``driver_mode="shard"`` runs the sharded
driver SPMD, one process per mesh device (:mod:`repro_torch.launch.
dist`): each rank calls :func:`run_training` with the same arguments and
holds its block of nodes, and ``model_parallel > 1`` shards each replica
over the model axis of the 2-D federation mesh with vocab-sharded label
rounds; the CLI spawns the ranks itself (``--driver shard --ranks R
--model-parallel M``). ``tcfg.compression`` / ``compression_frac`` and
``tcfg.gossip`` select compressed (top-k / random-k with error
feedback) and delayed gossip on either driver, and ``--churn-mode
stale`` makes stragglers (node-stacked only, as in the reference).
Durable snapshots (``--snapshot-dir``) work under either driver: a
sharded run's file holds the whole federation and resumes a node-stacked
run, and the other way round.

Usage (CPU, reduced config; ``--arch`` defaults to the reference's
``qwen3-1.7b``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 8 --nodes 4 --idkd --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 8 --nodes 4 --idkd --device cpu --driver shard \
        --ranks 2 --model-parallel 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 8 --nodes 4 --idkd --device cpu --compression topk \
        --compression-frac 0.01 --gossip delayed
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
from repro_torch.core.mixing import (make_mixer, normalize_compression,
                                     payload_elem_count)
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
    """The (topology, mixer) pair the launch path gossips params on:
    ``make_mixer``'s default backend (``auto``: the roll mixer on a
    ring, neighbour-gather elsewhere) on ``tcfg.topology`` (or
    ``topology``), the same graph the label exchange uses, masked by the
    churn mask ``active``. ``stale`` / ``compression`` / ``gossip`` /
    ``stateful`` are the compressed-wire controls and ``wire_fault`` /
    ``wire_guard`` the resilience layer's, all forwarded to
    ``mixing.make_mixer``."""
    topo = topology or Topology.make(tcfg.topology, tcfg.num_nodes)
    return topo, make_mixer(topo, wire_dtype=wire_dtype, device=device,
                            active=active, stale=stale,
                            compression=compression, gossip=gossip,
                            stateful=stateful, wire_fault=wire_fault,
                            wire_guard=wire_guard)


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
                     backend: str = "sparse", active=None, mesh=None,
                     specs=None):
    """One LM IDKD round. ``public_tokens`` (P, S), ``private_tokens``
    (n, V, S), node-stacked ``params_stacked``. Returns (sparse labels
    (n, P, S, k_out), weights (n, P), id_mask (n, P), thresholds (n,)).

    With ``idkd_cfg.stream_labels`` and the fused or sparse backend the
    round streams the public corpus in ``stream_microbatch`` sequences
    through ``labeling.streaming_label_round``; otherwise it forms the
    node logits and runs ``labeling.label_round``.

    With ``mesh`` (the sharded driver's federation mesh) the round runs
    on this rank's block: ``params_stacked`` is the block
    (``launch.sharding.local_block``; on the 2-D mesh ``specs`` are the
    params' specs), the results are the block's rows, score and select
    stay local, and only top-k payloads cross the node group
    (``labeling.shard_streaming_label_round`` — vocab-sharded through
    ``head_select``'s ``raw_stats`` mode on the 2-D mesh — or
    ``labeling.shard_label_round``). Churn masks raise there."""
    _refuse_codebooks(model.cfg)
    if mesh is not None and active is not None:
        raise ValueError("sharded label rounds have no churn path; run "
                         "churn schedules node-stacked")
    dev = next(iter(params_stacked.values())).device
    pub = _tokens(public_tokens, dev)
    priv = _tokens(private_tokens, dev)
    if idkd_cfg.stream_labels and backend in ("fused", "sparse"):
        if mesh is not None:
            out = labeling.shard_streaming_label_round(
                model, params_stacked, pub, priv, topology, idkd_cfg,
                mesh=mesh, specs=specs)
        else:
            out = labeling.streaming_label_round(
                model, params_stacked, pub, priv, topology, idkd_cfg,
                active=active)
        return out.labels, out.weights, out.id_masks, out.thresholds
    if mesh is not None:
        from repro_torch.launch.sharding import gather_model_tree, like_params
        L = next(iter(params_stacked.values())).shape[0]
        if mesh.model.size > 1:
            params_stacked = gather_model_tree(
                params_stacked, like_params(params_stacked, specs, L), mesh)
        priv = labeling._local_rows(priv, topology.n, mesh)
        logits_pub, _ = model.forward(
            params_stacked, {"tokens": pub[None].expand((L,) + pub.shape)})
        logits_priv, _ = model.forward(params_stacked, {"tokens": priv})
        out = labeling.shard_label_round(logits_pub, logits_priv, topology,
                                         idkd_cfg, mesh=mesh)
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
                 driver_mode: str = "scan", model_parallel: int = 1):
        super().__init__()
        self.model_parallel = model_parallel
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
        # the compressed-wire spec; init_comm sets the gossip mode from
        # the schedule
        self.compression = tcfg.compression_spec

    def _make_mixer(self, topology: Topology, active, stale=None):
        return make_gossip_mixer(self.tcfg, self.wire_dtype,
                                 topology=topology, active=active,
                                 stale=stale, device=self.device,
                                 **self._mixer_opts())[1]

    def _adapter(self):
        return (driver.lm_adapter if self.phase == "plain"
                else driver.lm_sparse_kd_adapter(self.idkd_cfg))

    def _sampler(self):
        return (self.plain_sampler if self.phase == "plain"
                else self.kd_sampler)

    def restore_ctx(self, ctx: Dict, phase: str) -> None:
        """Mid-phase resume: the sparse LM-KD payload straight from the
        snapshot's flat ctx, on the federation's device."""
        self.ctx = {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in ctx.items()}
        if self.kd_sampler is None:
            self.kd_sampler = driver.make_lm_kd_sampler(
                self.priv_parts, self.tokens, self.tcfg.batch_size,
                self.public_tokens, self.ctx["pub_vals"],
                self.ctx["pub_idx"], self.ctx["pub_w"],
                pub_batch=self.pub_batch)
        self.phase = phase

    def on_round(self, params, round_index: int, step: int,
                 topology: Topology, active: np.ndarray) -> np.ndarray:
        cfg = self.idkd_cfg
        priv = private_sequences(self.tokens, self.parts, self.seq_len)
        backend = cfg.label_backend
        if backend not in ("fused", "sparse"):
            # the LM KD step consumes sparse payloads; the dense oracle
            # backend is not an option at vocabulary scale
            warnings.warn(f"LM label round: backend {backend!r} requested, "
                          "using 'sparse'")
            backend = "sparse"
        shard = self.driver_mode == "shard"
        sparse, w, id_mask, thr = idkd_label_round(
            self.model, params, self.public_tokens, priv, cfg, topology,
            backend=backend, active=None if active.all() else active,
            mesh=self._node_mesh if shard else None, specs=self.specs)
        if shard:
            # every rank draws the whole federation's KD batch: the
            # round's block gathered to the global node stack
            from repro_torch.launch.sharding import gather_nodes
            sparse, w, id_mask, thr = gather_nodes(
                (sparse, w, id_mask, thr), self._node_mesh)
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
        mean_ov, per_edge = labeling.neighbor_topk_overlap(sparse.indices,
                                                           topology)
        self.last_round_stats = {
            "thresholds": thr.cpu().numpy(), "selected": counts,
            "id_fraction": id_fraction, "detector": cfg.detector,
            "topk_overlap": mean_ov, "topk_overlap_per_edge": per_edge}
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
    logits would not fit the card (``lmpath.QWEN3_PUB_BATCH``).

    ``driver_mode="shard"`` is the sharded driver: call this on every
    rank of a ``launch.dist`` run with the same arguments; each rank
    trains its block of nodes (``model_parallel > 1``: one model shard
    of each weight leaf too) and the returned ``params`` are the
    consensus of all nodes on every rank. It refuses an f32 wire, a
    graph other than a ring or a complete graph, churn and wire faults
    (``sched.validate_shard_schedule``).

    ``events`` (churn, rewire, faults) feed the compiled schedule;
    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`) and ``resil``
    (a :class:`repro_torch.resil.Resilience`) turn those layers on, the
    trajectory bitwise the same with either off and no fault firing. A
    ``crash`` fault raises :class:`repro_torch.resil.SimulatedCrash`;
    rerun with the same ``resil.snapshot_dir`` to resume."""
    _refuse_codebooks(cfg)
    driver_mode = driver.resolve_runner_mode(driver_mode)
    if model_parallel != 1 and driver_mode != "shard":
        raise ValueError("model_parallel > 1 shards each replica over "
                         "the 2-D federation mesh and needs "
                         "driver_mode='shard'")
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
    if schedule.gossip != tcfg.gossip:
        raise ValueError(
            f"schedule gossip mode {schedule.gossip!r} disagrees with "
            f"TrainConfig.gossip={tcfg.gossip!r}; pass gossip= to "
            "compile_schedule (or drop the prebuilt schedule)")
    if schedule.round_steps and not use_idkd:
        raise ValueError("schedule contains homogenization rounds but "
                         "use_idkd=False")

    fed = _LMFederation(model=model, algo=algo, tcfg=tcfg,
                        idkd_cfg=idkd_cfg, cfg=cfg, tokens=tokens,
                        parts=parts, public_tokens=public_tokens,
                        seq_len=seq_len, wire_dtype=wire_dtype,
                        verbose=verbose, device=device, pub_batch=pub_batch,
                        driver_mode=driver_mode,
                        model_parallel=model_parallel)
    nparams = sum(v[0].numel() for v in params.values())
    if driver_mode == "shard":
        from repro_torch.launch import dist
        fed.verbose = verbose = verbose and dist.world()[0] == 0
        # shard-mode pre-flight: fail before training, not mid-schedule
        from repro_torch.core.mixing import shard_supported_topology
        from repro_torch.launch.sharding import federation_specs, local_block
        if wire_dtype != "native":
            raise ValueError("driver_mode='shard' moves shards in their "
                             f"storage dtype; wire_dtype={wire_dtype!r} "
                             "needs the node-stacked runners")
        if not shard_supported_topology(topo):
            raise ValueError(
                f"driver_mode='shard' gossips on ring/complete graphs "
                f"only; topology {topo.name!r} needs driver_mode="
                "'scan' or 'host'")
        if getattr(algo, "needs_topology", False):
            raise ValueError(f"algorithm {algo.name!r} cannot run under "
                             "the sharded driver")
        sched.validate_shard_schedule(schedule, n, model_parallel)
        mesh = fed.shard_mesh(n)
        fed.specs = federation_specs(params, n, mesh)
        params = local_block(params, fed.specs, mesh)
    opt_state = algo.init(params)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed + 1)
    comp = normalize_compression(tcfg.compression_spec)
    payload_elems = (payload_elem_count(params, comp, node_stacked=True)
                     if comp is not None else None)
    comp_kind, comp_frac = comp if comp is not None else ("none", 0.0)
    ledger = sched.CommLedger(n, meta={
        "topology": topo.name, "wire_dtype": wire_dtype,
        "param_count": int(nparams), "compression": comp_kind,
        "compression_frac": comp_frac, "gossip": schedule.gossip})

    history = []
    t0 = time.time()

    def on_eval(params, step, losses):
        history.append(float(losses[-1]))
        if verbose:
            print(f"train.eval step={step} loss={history[-1]:.4f} "
                  f"elapsed_s={time.time() - t0:.1f}")

    fed.on_eval = on_eval
    params, opt_state, gen, _ = sched.run_schedule(
        schedule, fed, params, opt_state, gen, topology=topo, ledger=ledger,
        param_count=int(nparams),
        elem_bytes=sched.wire_elem_bytes(wire_dtype, cfg.dtype),
        payload_elems=payload_elems,
        index_bytes=4 if comp is not None else 0,
        telemetry=telemetry, resil=resil)
    if driver_mode == "shard":
        from repro_torch.launch.sharding import (ShardReduce,
                                                 gather_model_tree)
        mean = ShardReduce(fed._node_mesh, n).node_means(params)
        if fed._node_mesh.model.size > 1:
            mean = gather_model_tree(mean, fed.specs, fed._node_mesh)
        consensus = {k: v[0] for k, v in mean.items()}
    else:
        consensus = consensus_params(params)
    return {"params": consensus, "loss_history": history,
            "model": model, "topology": topo, "ledger": ledger.as_dict(),
            "schedule": schedule, "last_round": fed.last_round_stats,
            "pub_batch": fed.pub_batch}


def _rank_main(rank: int, world: int, argv) -> None:
    """One rank of ``--driver shard`` (``launch.dist.spawn``'s target)."""
    main(argv, _rank=rank)


def main(argv=None, _rank=None):
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
    ap.add_argument("--churn", default="",
                    help="churn spec node@down-up[,...], e.g. 3@20-30")
    ap.add_argument("--churn-mode", default="freeze",
                    choices=list(sched.CHURN_MODES),
                    help="what --churn means: freeze (hold params), "
                         "isolate (train but no gossip), or stale "
                         "(straggler: neighbours mix its last payload)")
    ap.add_argument("--wire-dtype", default="native",
                    choices=["native", "float32"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "randk"],
                    help="gossip wire compression (top-k / random-k "
                         "deltas with error feedback)")
    ap.add_argument("--compression-frac", type=float, default=0.01,
                    help="share of each leaf kept per send (top-k / "
                         "random-k)")
    ap.add_argument("--gossip", default="sync",
                    choices=list(sched.GOSSIP_MODES),
                    help="sync mixes this step's params; delayed mixes "
                         "the previous step's payload (one-step-stale)")
    ap.add_argument("--driver", default="scan",
                    choices=["scan", "host", "shard"],
                    help="shard: the sharded driver, one spawned process "
                         "per mesh device (--ranks)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="--driver shard: processes to spawn (ranks "
                         "share one card through gloo, or take a card "
                         "each through NCCL when there are enough)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="--driver shard: width of the federation mesh's "
                         "model axis (2-D mesh when > 1)")
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--telemetry", default="", metavar="DIR",
                    help="write run.jsonl (events and metrics-bus "
                         "flushes) under DIR; off when empty")
    ap.add_argument("--trace", action="store_true",
                    help="also write trace spans to DIR/trace.json "
                         "(needs --telemetry)")
    ap.add_argument("--faults", default="", metavar="SPEC",
                    help="deterministic fault injection: comma-separated "
                         "kind@step[/nodes][/mode], e.g. "
                         "'corrupt@8/2/nan,crash@14,clear@16'")
    ap.add_argument("--guards", action="store_true",
                    help="on-device health guard; tripped nodes are "
                         "quarantined at the segment boundary")
    ap.add_argument("--snapshot-dir", default="", metavar="DIR",
                    help="durable snapshots under DIR at segment "
                         "boundaries; a DIR that holds snapshots resumes "
                         "from the newest valid one")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="min steps between snapshots (0 = every "
                         "segment boundary)")
    ap.add_argument("--rollback", action="store_true",
                    help="on a guard trip, restore the pre-segment state "
                         "and re-run with the offender quarantined "
                         "(implies --guards)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.trace and not args.telemetry:
        ap.error("--trace needs --telemetry DIR for the output location")
    if args.model_parallel != 1 and args.driver != "shard":
        ap.error("--model-parallel needs --driver shard")
    if args.driver == "shard" and _rank is None:
        import sys

        from repro_torch.launch import dist
        from repro_torch.runtime import resolve_device
        if args.device == "cuda":
            from repro_torch.kernels import build
            resolve_device("cuda")
            build.build(["head_select", "head_select_tc", "flash_attention",
                         "flash_attention_tc", "flash_attention_bwd",
                         "flash_attention_bwd_tc", "ssd_scan",
                         "ssd_scan_bwd", "msp_select"])
        dist.spawn(_rank_main, args.ranks,
                   sys.argv[1:] if argv is None else list(argv),
                   device=args.device)
        return
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    start = args.steps // 2
    every_k = args.every_k or sched.fit_every_k(args.steps, start,
                                                args.rounds)
    tcfg = TrainConfig(num_nodes=args.nodes, steps=args.steps, lr=0.1,
                       alpha=args.alpha, batch_size=8,
                       topology=args.topology,
                       compression=args.compression,
                       compression_frac=args.compression_frac,
                       gossip=args.gossip,
                       idkd=IDKDConfig(start_step=start, label_topk=8,
                                       every_k_steps=every_k,
                                       num_rounds=args.rounds))
    events = (sched.parse_churn(args.churn, args.nodes, args.steps,
                                mode=args.churn_mode)
              if args.churn else ())
    if args.faults:
        events = (*events, *sched.parse_faults(args.faults, args.nodes,
                                               args.steps))
    resil = None
    if args.guards or args.rollback or args.snapshot_dir:
        from repro_torch.resil import GuardSpec, Resilience
        resil = Resilience(
            guard=GuardSpec() if args.guards or args.rollback else None,
            snapshot_dir=args.snapshot_dir or None,
            snapshot_every=args.snapshot_every, rollback=args.rollback)
    telemetry = None
    if args.telemetry:
        from repro_torch.obs import Telemetry
        tel_dir = (args.telemetry if _rank in (None, 0)   # a dir a rank
                   else f"{args.telemetry}/rank{_rank}")
        telemetry = Telemetry(tel_dir, trace=args.trace,
                              meta={"arch": args.arch, "steps": args.steps,
                                    "nodes": args.nodes,
                                    "topology": args.topology,
                                    "driver": args.driver,
                                    "idkd": args.idkd})
    from repro_torch.resil import SimulatedCrash
    try:
        out = run_training(cfg, tcfg, use_idkd=args.idkd,
                           wire_dtype=args.wire_dtype,
                           driver_mode=args.driver, events=events,
                           model_parallel=args.model_parallel,
                           telemetry=telemetry, resil=resil,
                           device=args.device)
    except SimulatedCrash as e:
        print(f"simulated crash at step {e.step}; re-run with the same "
              "--snapshot-dir to resume from the last durable snapshot")
        return
    finally:
        if telemetry is not None:
            telemetry.close()
    if _rank not in (None, 0):
        return
    print(f"final loss: {out['loss_history'][-1]:.4f}")
    led = out["ledger"]
    print(f"comm ledger: {led['gossip_bytes'] / 1e6:.2f} MB gossip + "
          f"{led['label_bytes'] / 1e6:.3f} MB labels over "
          f"{len(led['per_round'])} round bucket(s)")
    if args.telemetry:
        print(f"telemetry: {args.telemetry}/run.jsonl"
              + (f" + {args.telemetry}/trace.json" if args.trace else ""))


if __name__ == "__main__":
    main()
