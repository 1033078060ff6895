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
filter) or "idkd" (MSP/energy-filtered — the paper's method). Every
algorithm of the registry runs here: ``centralized`` gossips on the
complete graph (its Metropolis matrix is exact uniform averaging) over
an IID partition, as the paper's upper bound; the rest take the
Dirichlet partition and the run topology (``relaysgd`` needs a tree).
Runs on ``cuda`` unless ``device="cpu"`` is passed.

The scheduler's dynamic settings ride :meth:`DecentralizedSimulator.run`:
churn and rewire events (masked Metropolis mixing, frozen nodes held by
``driver.make_frozen_step``), wire faults and crashes, mid-run capture
and resume, telemetry (``repro_torch.obs``) and resilience
(``repro_torch.resil``: guards, quarantine, rollback, durable snapshots
with auto-resume).
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
from repro_torch.obs import log
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
    captured: Optional[Dict] = None          # run(capture_at=...) copy


class _SimFederation(sched.CompiledFederationHooks):
    """Binds the simulator's samplers, steps, mixers and label round to
    the scheduler loop (the cache machinery is
    :class:`sched.CompiledFederationHooks`'); ``phase`` is "plain" until
    the first round, then "kd_dense" or "kd_sparse". The prebuilt steps
    (``sim.steps``) serve the all-up, fault-free segments on the run's
    own gossip graph with telemetry and guard off; every other segment
    builds its step through the cache."""

    def __init__(self, sim: "DecentralizedSimulator", result: SimResult,
                 idkd_cfg: IDKDConfig):
        super().__init__()
        self.sim = sim
        self.model = sim.model
        self.algo = sim.algo
        self.lr_fn = sim.lr_fn
        self.driver_mode = sim.driver_mode
        self.device = sim.device
        self.result = result
        self.idkd_cfg = idkd_cfg
        parts = driver.pad_partitions(sim.parts, sim.device)
        C, B = sim.mcfg.num_classes, sim.tcfg.batch_size
        self.samplers = {
            "plain": driver.make_classification_sampler(
                parts, sim.train_x, sim.train_y, C, B)}
        if sim.public_x is not None:
            kd = driver.make_homogenized_sampler(
                parts, sim.train_x, sim.train_y, sim.public_x, C, B)
            self.samplers["kd_dense"] = self.samplers["kd_sparse"] = kd

    def reset(self, result: SimResult) -> None:
        """Rebind for a fresh run, keeping the mixer, step and runner
        caches; each run passes its own telemetry and resilience."""
        self.result = result
        self.phase = "plain"
        self.ctx = None
        self.telemetry = None
        self.resil = None
        self.wire_fault = None
        self.last_round_stats = None

    def _make_mixer(self, topo: Topology, active, stale=None):
        sim = self.sim
        if (active is None and self._fault_key() is None
                and topo.edge_key() == sim.gossip_topo.edge_key()):
            return sim.mixer
        return make_mixer(topo, "dense", wire_dtype=sim.wire_dtype,
                          device=sim.device, active=active, stale=stale,
                          **self._mixer_opts())

    def _adapter(self):
        cfg = self.idkd_cfg
        return {
            "plain": driver.classification_adapter,
            "kd_dense": driver.dense_kd_adapter(cfg.temperature,
                                                cfg.kd_weight),
            "kd_sparse": driver.sparse_kd_adapter(cfg.temperature,
                                                  cfg.kd_weight),
        }[self.phase]

    def _sampler(self):
        return self.samplers[self.phase]

    def _base_step(self, topo: Topology, active: np.ndarray,
                   stale: np.ndarray):
        sim = self.sim
        if (active.all() and not self._metrics_on()
                and self._fault_key() is None
                and self._guard_spec() is None
                and topo.edge_key() == sim.gossip_topo.edge_key()):
            return sim.steps[self.phase]
        return super()._base_step(topo, active, stale)

    def restore_ctx(self, ctx: Dict, phase: str) -> None:
        """Mid-phase resume: the KD sampler state straight from the
        snapshot's flat payload, on the simulator's device."""
        self.ctx = {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in ctx.items()}
        self.phase = phase

    def on_round(self, params, round_index: int, step: int,
                 topology: Topology, active: np.ndarray) -> np.ndarray:
        sim, cfg = self.sim, self.idkd_cfg
        hom = sim.homogenize(params, cfg, topology,
                             active=None if active.all() else active,
                             wire_fault=self._fault_key())
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
        id_counts = id_masks.sum(axis=1)
        per_node = np.array([distill.label_bytes(int(c),
                                                 sim.mcfg.num_classes,
                                                 k_wire)
                             for c in id_counts], np.float64)
        res.rounds.append({"step": step, "round": round_index,
                           "id_fraction": res.id_fraction,
                           "label_bytes": float(per_node.sum())})
        stats = {"thresholds": res.thresholds, "selected": id_counts,
                 "id_fraction": res.id_fraction, "detector": cfg.detector}
        if sparse_round:
            mean_ov, per_edge = labeling.neighbor_topk_overlap(
                hom.labels.indices, topology)
            stats["topk_overlap"] = mean_ov
            stats["topk_overlap_per_edge"] = per_edge
        self.last_round_stats = stats
        return per_node

    def on_eval(self, params, step: int, losses) -> None:
        acc, nll = self.sim._eval(params)
        self.result.acc_history.append(acc)
        self.result.loss_history.append(nll)
        cons = float(consensus_distance(params))
        self.result.consensus_history.append(cons)
        tel = self.telemetry
        if tel is not None:
            tel.event("accuracy", step=step, acc=acc, nll=nll,
                      consensus=cons)
            if not (np.isfinite(nll) and np.isfinite(acc)):
                tel.event("health", step=step, kind="eval_nonfinite",
                          acc=acc, nll=nll)


class DecentralizedSimulator:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 data: ClassificationData,
                 public_x: Optional[np.ndarray] = None,
                 kd_mode: Optional[str] = None, eval_every: int = 50,
                 eval_batches: int = 4, driver_mode: str = "auto",
                 wire_dtype: str = "float32", model_parallel: int = 1,
                 device="cuda"):
        self.driver_mode = driver.resolve_runner_mode(driver_mode)
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
        # centralized: exact averaging on the complete graph
        self.gossip_topo = (Topology.make("full", n)
                            if train_cfg.algorithm == "centralized"
                            else self.topology)
        self.mixer = make_mixer(self.gossip_topo, "dense",
                                wire_dtype=wire_dtype, device=dev)
        self.algo = make_algorithm(train_cfg.algorithm,
                                   topology=self.topology,
                                   momentum=train_cfg.momentum,
                                   weight_decay=train_cfg.weight_decay)
        self.model = build_model(model_cfg)
        rng = np.random.default_rng(train_cfg.seed)
        if train_cfg.algorithm == "centralized":
            # the paper's centralized reference trains on an IID split
            idx = rng.permutation(len(data.train_y))
            self.parts = [np.asarray(p) for p in np.array_split(idx, n)]
        else:
            self.parts = dirichlet_partition(data.train_y, n,
                                             alpha=train_cfg.alpha, rng=rng)
        self.lr_fn = step_decay(train_cfg.lr, train_cfg.steps,
                                train_cfg.lr_decay_milestones,
                                train_cfg.lr_decay_factor)
        icfg = train_cfg.idkd or IDKDConfig()
        self._fed: Optional[_SimFederation] = None
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

    def run(self, schedule: Optional[sched.Schedule] = None,
            resume: Optional[Dict] = None,
            capture_at: Optional[int] = None,
            telemetry=None, resil=None) -> SimResult:
        """Replay the federation schedule through the scheduler.

        ``resume`` is a ``{"params", "opt_state", "key", "step"}`` state
        (``result.captured`` of a run with ``capture_at``; ``"key"`` the
        samplers' generator state) restarting at a legal boundary;
        ``capture_at`` copies the state at that boundary into
        ``result.captured``. ``telemetry`` (a
        :class:`repro_torch.obs.Telemetry`) turns the run log, the
        metrics bus and trace spans on; the trajectory is bitwise the
        same with it off. ``resil`` (a :class:`repro_torch.resil.
        Resilience`) turns the guard, quarantine, rollback and durable
        snapshots on; a ``crash`` fault raises
        :class:`repro_torch.resil.SimulatedCrash` out of this method, and
        calling it again with the same ``resil.snapshot_dir`` resumes
        from the newest snapshot."""
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
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        if resume is not None:
            params, opt_state = resume["params"], resume["opt_state"]
            key = resume["key"]
            gen.set_state(key.get_state() if isinstance(
                key, torch.Generator) else key)
            resume_step = int(resume["step"])
        else:
            params = self._stacked_init()
            opt_state = self.algo.init(params)
            resume_step = 0
        nparams = sum(v[0].numel() for v in params.values())
        ledger = sched.CommLedger(n, meta={
            "topology": self.gossip_topo.name,
            "wire_dtype": self.wire_dtype,
            "param_count": int(nparams), "gossip": schedule.gossip})
        if self._fed is None:
            self._fed = _SimFederation(self, result, idkd_cfg)
        else:
            self._fed.reset(result)
        params, opt_state, gen, captured = sched.run_schedule(
            schedule, self._fed, params, opt_state, gen,
            topology=self.gossip_topo,
            ledger=ledger, param_count=int(nparams),
            elem_bytes=sched.wire_elem_bytes(self.wire_dtype, "float32"),
            resume_step=resume_step, capture_at=capture_at,
            telemetry=telemetry, resil=resil)
        result.final_acc = (result.acc_history[-1]
                            if result.acc_history else 0.0)
        steps_run = ledger.gossip_steps()
        result.comm_bytes_per_iter = (
            ledger.gossip_bytes / steps_run / n if steps_run else 0.0)
        result.label_bytes_total = ledger.label_bytes
        result.ledger = ledger.as_dict()
        result.params = params
        result.captured = captured
        result.wall_seconds = time.time() - t0
        return result

    # ------------------------------------------------------------ IDKD round
    def homogenize(self, params, idkd_cfg: IDKDConfig,
                   topology: Optional[Topology] = None, active=None,
                   wire_fault=None) -> labeling.HomogenizedResult:
        """One homogenization round from node-stacked ``params``: the
        streaming round (``head_select``) on the fused/sparse backends
        with ``stream_labels``, else the one-shot round on the public
        logit stack (``msp_select`` on the fused backend). ``active`` is
        the churn mask (a down node neither gives nor takes labels).
        Under a ``wire_fault`` the faulted senders' label payloads are
        lost: the streaming round never forms the logits to corrupt, so
        both fault kinds drop them; the one-shot round corrupts their
        logits and drops the payloads that fail validation — merged out
        through the mask either way, as in the reference."""
        filter_ood = self.kd_mode != "vanilla"
        topo = topology or self.topology
        n = self.tcfg.num_nodes
        act = (np.ones(n, bool) if active is None
               else np.asarray(active, bool))
        streaming = (idkd_cfg.stream_labels
                     and idkd_cfg.label_backend != "dense")
        faulted = wire_fault is not None and not wire_fault.is_noop()
        if streaming:
            if faulted:
                lost = np.zeros(n, bool)
                lost[list(wire_fault.senders)] = True
                act = act & ~lost
                if not act.any():
                    raise RuntimeError("label-round fault leaves no "
                                       "valid label payloads")
                log.warning("label_payload_lost",
                            nodes=np.flatnonzero(lost).tolist())
            return labeling.streaming_label_round(
                self.model, params, self.public_x,
                self._per_node_val_inputs(), topo, idkd_cfg,
                filter_ood=filter_ood,
                active=None if act.all() else act)
        val_x = self._per_node_val_inputs()
        with torch.no_grad():
            val_logits = self.model.forward(params, {"images": val_x})[0]
        logits = self.node_logits(params, self.public_x)
        if faulted:
            from repro_torch.resil.faults import (DEFAULT_MAX_ABS,
                                                  corrupt_rows,
                                                  payload_valid)
            lost = np.zeros(n, bool)
            lost[list(wire_fault.drop)] = True
            if wire_fault.corrupt:
                rows = np.zeros(n, bool)
                rows[list(wire_fault.corrupt)] = True
                logits = corrupt_rows(logits, rows, wire_fault.mode)
                lost |= ~payload_valid(logits.reshape(n, -1),
                                       DEFAULT_MAX_ABS).cpu().numpy()
            act = act & ~lost
            if not act.any():
                raise RuntimeError(
                    "label-round fault leaves no valid label payloads")
            if lost.any():
                log.warning("label_payload_invalid",
                            nodes=np.flatnonzero(lost).tolist())
        return labeling.label_round(
            logits, val_logits, None, topo, idkd_cfg,
            backend=idkd_cfg.label_backend, filter_ood=filter_ood,
            active=None if act.all() else act)

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
