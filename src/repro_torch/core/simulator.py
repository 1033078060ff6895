"""In-process decentralized training simulator — the paper's experiment.

All n nodes live in one process on one device: parameters are
node-stacked (leading axis = node), every convolution is one grouped
cuDNN call over all nodes, gossip is the dense Metropolis mixing matrix
— mathematically the paper's synchronous cluster. The outer loop is the
federation scheduler (``repro_torch.sched``); the IDKD homogenization
round is the labeling engine, which on the ``fused``/``sparse`` backends
runs the hand-written ``head_select`` (streaming) or ``msp_select``
(one-shot) kernels.

``kd_mode``: None (no distillation), "vanilla" (KD without the OoD
filter) or "idkd" (MSP/energy-filtered — the paper's method). Runs on
``cuda`` unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import sched
from repro_torch.configs.base import IDKDConfig, ModelConfig, TrainConfig
from repro_torch.core import distill, driver, idkd, labeling
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.mixing import consensus_distance, make_mixer
from repro_torch.core.topology import Topology
from repro_torch.data.dirichlet import dirichlet_partition, partition_stats
from repro_torch.data.synthetic import ClassificationData
from repro_torch.models.resnet import build_model, stack_params
from repro_torch.optim.schedules import step_decay
from repro_torch.runtime import resolve_device


@dataclass
class SimResult:
    final_acc: float
    acc_history: List[float] = field(default_factory=list)
    loss_history: List[float] = field(default_factory=list)
    consensus_history: List[float] = field(default_factory=list)
    pre_hist: Optional[np.ndarray] = None    # (n, C) class hists pre-IDKD
    post_hist: Optional[np.ndarray] = None   # (n, C) class hists post-IDKD
    thresholds: Optional[np.ndarray] = None
    id_fraction: float = 0.0                 # fraction of D_P kept as ID
    comm_bytes_per_iter: float = 0.0
    label_bytes_total: float = 0.0
    wall_seconds: float = 0.0
    rounds: List[Dict] = field(default_factory=list)  # per-round diagnostics
    ledger: Optional[Dict] = None            # sched.CommLedger.as_dict()
    params: Optional[Dict] = None            # final node-stacked params


class _SimFederation(sched.FederationHooks):
    """Binds the simulator's samplers, steps and label round to the
    scheduler loop; ``phase`` is "plain" until the first round, then
    "kd_dense" or "kd_sparse"."""

    def __init__(self, sim: "DecentralizedSimulator", result: SimResult,
                 idkd_cfg: IDKDConfig):
        self.sim = sim
        self.result = result
        self.idkd_cfg = idkd_cfg
        self.phase = "plain"
        self.ctx = None
        parts = driver.pad_partitions(sim.parts, sim.device)
        C, B = sim.mcfg.num_classes, sim.tcfg.batch_size
        self.samplers = {
            "plain": driver.make_classification_sampler(
                parts, sim.train_x, sim.train_y, C, B)}
        if sim.public_x is not None:
            kd = driver.make_homogenized_sampler(
                parts, sim.train_x, sim.train_y, sim.public_x, C, B)
            self.samplers["kd_dense"] = self.samplers["kd_sparse"] = kd
        self._runners: Dict = {}

    def runner(self, topology: Topology):
        run = self._runners.get(self.phase)
        if run is None:
            run = driver.make_host_runner(self.sim.steps[self.phase],
                                          self.samplers[self.phase],
                                          self.sim.lr_fn)
            self._runners[self.phase] = run
        if self.phase == "plain":
            return run
        return lambda p, o, g, s0, ns: run(p, o, g, s0, ns, self.ctx)

    def on_round(self, params, round_index: int, step: int,
                 topology: Topology) -> np.ndarray:
        sim, cfg = self.sim, self.idkd_cfg
        hom = sim.homogenize(params, cfg, topology)
        sparse_round = isinstance(hom, labeling.SparseHomogenizedSet)
        payload = ((hom.labels.values, hom.labels.indices) if sparse_round
                   else hom.labels)
        weights = hom.weights.cpu().numpy()
        self.ctx = driver.homogenized_ctx(weights, payload,
                                          len(sim.public_x), sim.device)
        self.phase = "kd_sparse" if sparse_round else "kd_dense"

        res = self.result
        id_masks = hom.id_masks.cpu().numpy()
        res.thresholds = hom.thresholds.cpu().numpy()
        res.id_fraction = float(np.mean(id_masks))
        res.post_hist = sim._post_histograms(hom)
        k_wire = (min(cfg.label_topk or labeling.DEFAULT_TOPK,
                      sim.mcfg.num_classes) if sparse_round else 0)
        per_node = np.array([distill.label_bytes(int(c),
                                                 sim.mcfg.num_classes,
                                                 k_wire)
                             for c in id_masks.sum(axis=1)], np.float64)
        res.rounds.append({"step": step, "round": round_index,
                           "id_fraction": res.id_fraction,
                           "label_bytes": float(per_node.sum())})
        return per_node

    def on_eval(self, params, step: int, losses) -> None:
        acc, nll = self.sim._eval(params)
        self.result.acc_history.append(acc)
        self.result.loss_history.append(nll)
        self.result.consensus_history.append(
            float(consensus_distance(params)))


class DecentralizedSimulator:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 data: ClassificationData,
                 public_x: Optional[np.ndarray] = None,
                 kd_mode: Optional[str] = None, eval_every: int = 50,
                 eval_batches: int = 4, driver_mode: str = "auto",
                 wire_dtype: str = "float32", model_parallel: int = 1,
                 device="cuda"):
        if driver_mode not in ("auto", "host"):
            raise NotImplementedError(
                f"driver_mode={driver_mode!r} is not ported yet (the host "
                "runner is; CUDA-graph capture and the sharded driver are "
                "ROADMAP.md queue 1 items 8 and 13)")
        if model_parallel > 1:
            raise NotImplementedError(
                "model_parallel > 1 is not ported yet; see ROADMAP.md "
                "queue 1 item 13")
        if train_cfg.compression_spec is not None or \
                train_cfg.gossip != "sync":
            raise NotImplementedError(
                "compressed and delayed gossip are not ported yet; see "
                "ROADMAP.md queue 1 item 12")
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.data = data
        self.kd_mode = kd_mode
        self.eval_every = eval_every
        self.eval_batches = eval_batches
        self.wire_dtype = wire_dtype

        dev = self.device
        self.train_x = torch.as_tensor(data.train_x, device=dev)
        self.train_y = torch.as_tensor(data.train_y, device=dev)
        self.test_x = torch.as_tensor(data.test_x, device=dev)
        self.test_y = torch.as_tensor(data.test_y, device=dev)
        self.public_x = (None if public_x is None
                         else torch.as_tensor(public_x, device=dev))

        n = train_cfg.num_nodes
        self.topology = Topology.make(train_cfg.topology, n)
        self.mixer = make_mixer(self.topology, "dense",
                                wire_dtype=wire_dtype, device=dev)
        self.algo = make_algorithm(train_cfg.algorithm,
                                   topology=self.topology,
                                   momentum=train_cfg.momentum,
                                   weight_decay=train_cfg.weight_decay)
        self.model = build_model(model_cfg)
        rng = np.random.default_rng(train_cfg.seed)
        self.parts = dirichlet_partition(data.train_y, n,
                                         alpha=train_cfg.alpha, rng=rng)
        self.lr_fn = step_decay(train_cfg.lr, train_cfg.steps,
                                train_cfg.lr_decay_milestones,
                                train_cfg.lr_decay_factor)
        icfg = train_cfg.idkd or IDKDConfig()
        self.steps = {
            "plain": driver.make_step(self.model, self.algo, self.mixer,
                                      driver.classification_adapter),
            "kd_dense": driver.make_step(
                self.model, self.algo, self.mixer,
                driver.dense_kd_adapter(icfg.temperature, icfg.kd_weight)),
            "kd_sparse": driver.make_step(
                self.model, self.algo, self.mixer,
                driver.sparse_kd_adapter(icfg.temperature, icfg.kd_weight)),
        }

    def _stacked_init(self):
        gen = torch.Generator().manual_seed(self.tcfg.seed)
        params = self.model.init(gen)   # identical init on all nodes (paper)
        return {k: v.to(self.device) for k, v in
                stack_params(params, self.tcfg.num_nodes).items()}

    # -------------------------------------------------------------- inference
    @torch.no_grad()
    def node_logits(self, params, x, batch: int = 256) -> torch.Tensor:
        """All-node logits on a shared input set x: (n, len(x), C)."""
        n = self.tcfg.num_nodes
        outs = [self.model.forward(
                    params, {"images": xb[None].expand((n,) + xb.shape)})[0]
                for xb in x.split(batch)]
        return torch.cat(outs, dim=1)

    def _per_node_val_inputs(self, batch: int = 256) -> torch.Tensor:
        """Each node's own private samples (n, m, ...) — its ID set."""
        m = min(min(len(p) for p in self.parts), batch)
        idx = torch.as_tensor(np.stack([p[:m] for p in self.parts]),
                              device=self.device)
        return self.train_x[idx]

    # ------------------------------------------------------------------- run
    def default_schedule(self) -> sched.Schedule:
        idkd_cfg = self.tcfg.idkd or IDKDConfig()
        rounds = (sched.idkd_round_steps(idkd_cfg, self.tcfg.steps)
                  if self._kd_active(idkd_cfg) else ())
        return sched.compile_schedule(self.tcfg.steps, self.eval_every,
                                      round_steps=rounds)

    def _kd_active(self, idkd_cfg: IDKDConfig) -> bool:
        return (self.kd_mode is not None and self.public_x is not None
                and idkd_cfg.start_step < self.tcfg.steps)

    def run(self, schedule: Optional[sched.Schedule] = None) -> SimResult:
        t0 = time.time()
        tcfg = self.tcfg
        n = tcfg.num_nodes
        idkd_cfg = tcfg.idkd or IDKDConfig()
        if schedule is None:
            schedule = self.default_schedule()
        elif schedule.round_steps and not self._kd_active(idkd_cfg):
            raise ValueError(
                "schedule contains homogenization rounds but the simulator "
                "has no kd_mode/public data to run them")
        result = SimResult(final_acc=0.0)
        result.pre_hist = partition_stats(self.data.train_y, self.parts,
                                          self.mcfg.num_classes)
        params = self._stacked_init()
        opt_state = self.algo.init(params)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        nparams = sum(v[0].numel() for v in params.values())
        ledger = sched.CommLedger(n, meta={
            "topology": self.topology.name, "wire_dtype": self.wire_dtype,
            "param_count": int(nparams), "gossip": schedule.gossip})
        fed = _SimFederation(self, result, idkd_cfg)
        params, opt_state, gen = sched.run_schedule(
            schedule, fed, params, opt_state, gen, topology=self.topology,
            ledger=ledger, param_count=int(nparams),
            elem_bytes=sched.wire_elem_bytes(self.wire_dtype, "float32"))
        result.final_acc = (result.acc_history[-1]
                            if result.acc_history else 0.0)
        steps_run = ledger.gossip_steps()
        result.comm_bytes_per_iter = (
            ledger.gossip_bytes / steps_run / n if steps_run else 0.0)
        result.label_bytes_total = ledger.label_bytes
        result.ledger = ledger.as_dict()
        result.params = params
        result.wall_seconds = time.time() - t0
        return result

    # ------------------------------------------------------------ IDKD round
    def homogenize(self, params, idkd_cfg: IDKDConfig,
                   topology: Optional[Topology] = None
                   ) -> labeling.HomogenizedResult:
        """One homogenization round from node-stacked ``params``: the
        streaming round (``head_select``) on the fused/sparse backends
        with ``stream_labels``, else the one-shot round on the public
        logit stack (``msp_select`` on the fused backend)."""
        filter_ood = self.kd_mode != "vanilla"
        topo = topology or self.topology
        if idkd_cfg.stream_labels and idkd_cfg.label_backend != "dense":
            return labeling.streaming_label_round(
                self.model, params, self.public_x,
                self._per_node_val_inputs(), topo, idkd_cfg,
                filter_ood=filter_ood)
        val_x = self._per_node_val_inputs()
        with torch.no_grad():
            val_logits = self.model.forward(params, {"images": val_x})[0]
        return labeling.label_round(
            self.node_logits(params, self.public_x), val_logits, None, topo,
            idkd_cfg, backend=idkd_cfg.label_backend, filter_ood=filter_ood)

    def _post_histograms(self, hom) -> np.ndarray:
        C = self.mcfg.num_classes
        sparse_round = isinstance(hom, labeling.SparseHomogenizedSet)
        hists = []
        for i in range(self.tcfg.num_nodes):
            soft = (distill.SparseLabels(hom.labels.values[i],
                                         hom.labels.indices[i])
                    if sparse_round else hom.labels[i])
            h = idkd.class_histogram(
                torch.as_tensor(self.data.train_y[self.parts[i]],
                                device=self.device),
                soft, hom.weights[i], C)
            hists.append(h.cpu().numpy())
        return np.stack(hists)

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def _eval(self, params, batch: int = 256):
        """Consensus-model accuracy and NLL over the first
        ``eval_batches`` contiguous test batches, each sample once."""
        mean_p = {k: v.float().mean(dim=0, keepdim=True).to(v.dtype)
                  for k, v in params.items()}
        N = len(self.test_y)
        stop = min(N, self.eval_batches * batch)
        hits = nll = 0.0
        for lo in range(0, stop, batch):
            xb = self.test_x[lo:min(lo + batch, stop)]
            yb = self.test_y[lo:min(lo + batch, stop)]
            logits = self.model.forward(mean_p, {"images": xb[None]})[0][0]
            hits += float((logits.argmax(-1) == yb).float().sum())
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll += float(-logp.gather(1, yb[:, None]).sum())
        acc, nll = hits / stop, nll / stop
        if not (np.isfinite(nll) and np.isfinite(acc)):
            warnings.warn(f"non-finite eval: acc={acc}, nll={nll}")
        return acc, nll
