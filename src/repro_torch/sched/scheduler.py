"""Event-driven federation scheduler: the one outer loop of a run
(the reference's ``repro.sched.scheduler``).

:func:`run_schedule` replays a compiled :class:`~repro_torch.sched.
schedule.Schedule` against driver *hooks*: it owns segment iteration,
event application (churn masks, graph rewires, wire faults, crashes,
homogenization rounds), communication accounting, capture and resume,
telemetry, and the resilience layer (guards, quarantine, rollback,
durable snapshots); the hooks own everything model-specific (the runner
for the current phase, graph and masks, the label round, the eval).

The federation state threaded through the loop: ``topology`` (swapped by
``RewireEvent``), ``active`` (the availability mask), ``frozen`` (the
down nodes with ``freeze`` semantics: params and optimizer state held;
down nodes not in it are ``isolate`` stragglers that train locally but
miss gossip), ``stale`` (active stragglers whose outgoing payload is
frozen), ``quarantined`` (guard-tripped nodes, frozen and silent), the
wire-fault state, the stateful gossip mixers' comm state (from
``hooks.init_comm``, carried through every runner call, captured and
snapshotted with the params) and the rounds fired so far.

The port's updates write over their inputs, and its sampler state is a
``torch.Generator`` that a segment advances. So where the reference
keeps the pre-segment values by not overwriting them, the port copies
them: before each segment when rollback is on (params, optimizer state
and generator state, and the comm state, restored on a retry), and at
the ``capture_at`` boundary. Resume replays the topology and fault events before the
resume step but skips their training and rounds; the quarantine mask is
not part of a snapshot, as in the reference.

Under the sharded driver a durable snapshot still holds the whole
federation, in the node-stacked run's structure (the hooks'
``snapshot_view``), so one file resumes either driver: rank 0 writes it
and prunes, every rank waits at a barrier after the write, and on resume
rank 0 picks the newest valid step, broadcasts it, and every rank loads
that file and keeps its block (``snapshot_block``). Rank 0 also decides
whether a crash's tombstone is there, so every rank raises or none.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.resil.faults import SimulatedCrash, WireFault
from repro_torch.sched.ledger import CommLedger, gossip_bytes_per_step
from repro_torch.sched.schedule import (ChurnEvent, FaultEvent,
                                        HomogenizeEvent, RewireEvent,
                                        Schedule)


class FederationHooks:
    """Driver callbacks for :func:`run_schedule` (subclass and override;
    the base class documents the protocol, the reference's)."""

    def init_comm(self, params, topology: Topology,
                  schedule: Schedule) -> Optional[Any]:
        """The stateful gossip mixers' comm state (compressed, delayed or
        straggler gossip), carried through every runner call; None for
        synchronous uncompressed gossip."""
        return None

    def init_metrics(self, params, topology: Topology) -> Optional[Any]:
        """The metrics-bus dict (:mod:`repro_torch.obs.metrics`) carried
        through every runner call when telemetry is on; None keeps it
        off."""
        return None

    def init_guard(self, params, topology: Topology) -> Optional[Any]:
        """The health-guard dict (:mod:`repro_torch.resil.guards`)
        carried through every runner call when the guard is on; None
        keeps it off."""
        return None

    def restore_ctx(self, ctx: Dict, phase: str) -> None:
        """A durable snapshot taken mid-phase is being restored: rebuild
        the KD sampler state from its flat str→array payload and set the
        phase. The default refuses mid-phase resume."""
        raise NotImplementedError(
            "these hooks cannot restore a mid-phase homogenization "
            "context; resume from a round-boundary snapshot instead")

    def on_topology(self, topology: Topology, active: np.ndarray,
                    frozen: np.ndarray, stale: np.ndarray) -> None:
        """The gossip graph or the availability mask changed."""

    def on_segment(self, segment, index: int) -> None:
        """A schedule segment is about to run."""

    def on_round(self, params, round_index: int, step: int,
                 topology: Topology, active: np.ndarray
                 ) -> Optional[np.ndarray]:
        """Run one homogenization round from the current params and swap
        the KD sampler in. Returns (n,) label payload bytes (or None)."""
        return None

    def on_labels(self, round_index: int, step: int,
                  stats: Optional[Dict]) -> None:
        """Label-round statistics (``self.last_round_stats`` after
        ``on_round``) are available."""

    def runner(self, topology: Topology, active: np.ndarray,
               frozen: np.ndarray, stale: np.ndarray) -> Callable:
        """A ``run(params, opt_state, gen, step0, num_steps)`` runner for
        the current phase, graph and masks. One flagged ``run.comm`` /
        ``run.metrics`` / ``run.guard`` takes and returns those carries
        as keywords: ``run(..., comm=c, metrics=m, guard=g) -> (params,
        opt_state, gen, losses, c, m, g)``."""
        raise NotImplementedError

    def on_eval(self, params, step: int, losses) -> None:
        """An eval boundary was crossed after ``step``."""

    def global_carry(self, carry):
        """A metrics or guard carry as the whole federation's, for a flush
        (the sharded driver's hooks gather the rank's node block; the
        node-stacked carry is already whole)."""
        return carry

    # durable snapshots: the sharded driver's hooks override these so
    # that one file holds the whole federation, whichever driver wrote it
    def agree(self, value):
        """Rank 0's ``value`` on every rank (the value itself in one
        process)."""
        return value

    def snapshot_writer(self) -> bool:
        """Whether this process writes the snapshots (rank 0)."""
        return True

    def snapshot_view(self, state):
        """The whole federation's ``{"params", "opt_state", "key"[,
        "comm"]}`` from this process's (collective under the sharded
        driver; the node-stacked state is already whole)."""
        return state

    def snapshot_block(self, state, like):
        """This process's block of a whole-federation state, in the
        structure of its own ``like``."""
        return state

    def snapshot_barrier(self) -> None:
        """Wait until the snapshot is on disk for every process."""


class CompiledFederationHooks(FederationHooks):
    """:class:`FederationHooks` with the mixers, steps and host runners
    cached per (phase, graph, availability mask, frozen subset, straggler
    mask, metrics switch, wire fault, guard spec), and the round-varying
    sampler
    payload in ``self.ctx`` passed to the runner of every phase but
    "plain". Graphs are keyed by ``Topology.edge_key()``, so a rewire
    back to an equivalent graph finds its cached mixer.

    ``driver_mode="shard"`` routes step building through
    ``driver.make_shard_step`` on :meth:`shard_mesh` (the federation mesh
    of ``model_parallel``): this rank's node block, boundary-row or
    exact-average gossip (compressed or delayed through the stateful
    sharded mixer), with the params' ``specs`` on the 2-D mesh. The
    sharded driver has no churn, straggler or wire-fault path;
    :func:`validate_shard_schedule` refuses such schedules before the
    run, and the step builder refuses them too.

    ``compression`` (a spec for ``mixing.normalize_compression``) and
    ``gossip`` select compressed and delayed gossip; :meth:`init_comm`
    reads the schedule's gossip mode and, when the run needs state
    anywhere (compression, delayed gossip, a stale churn event), forces
    every mixer of the run stateful so the comm state keeps its
    structure.

    Subclasses set ``model``, ``algo``, ``lr_fn``, ``driver_mode`` and
    ``device``, and implement ``_make_mixer(topology, active,
    stale=None)`` (``active`` None for the all-up mask; forward
    ``_mixer_opts()`` to ``mixing.make_mixer``), ``_adapter()`` and
    ``_sampler()`` for the current ``phase``; ``on_round`` advances the
    phase and refreshes ``ctx``. ``telemetry``, ``resil`` and
    ``wire_fault`` are set by :func:`run_schedule` as the run goes."""

    model = None
    algo = None
    lr_fn = None
    driver_mode = "scan"
    device = "cuda"
    model_parallel = 1        # shard mode: width of the mesh "model" axis
    specs = None              # shard mode, 2-D mesh: the params' specs
    compression = None        # the run's compressed-wire spec
    gossip = "sync"           # set from the schedule by init_comm

    def __init__(self):
        self.phase = "plain"
        self.ctx = None
        self._mixers: Dict = {}
        self._steps: Dict = {}
        self._runners: Dict = {}
        self.telemetry = None
        self.resil = None
        self.wire_fault: Optional[WireFault] = None
        self.last_round_stats: Optional[Dict] = None
        self._node_mesh = None
        self._force_state = False

    def shard_mesh(self, num_nodes: int):
        """The (cached) federation mesh of the shard-mode steps — the 1-D
        node mesh at ``model_parallel == 1``, the 2-D ``(node, model)``
        mesh otherwise."""
        if self._node_mesh is None:
            from repro_torch.launch.mesh import make_federation_mesh
            self._node_mesh = make_federation_mesh(num_nodes,
                                                   self.model_parallel)
        return self._node_mesh

    def global_carry(self, carry):
        if self.driver_mode != "shard" or carry is None:
            return carry
        from repro_torch.launch.sharding import gather_nodes
        out = dict(gather_nodes({k: v for k, v in carry.items()
                                 if k != "steps"}, self._node_mesh))
        out["steps"] = carry["steps"]
        return out

    def agree(self, value):
        if self.driver_mode != "shard":
            return value
        from repro_torch.launch import dist
        return dist.broadcast_object(value, src=0)

    def snapshot_writer(self) -> bool:
        if self.driver_mode != "shard":
            return True
        from repro_torch.launch import dist
        return dist.world()[0] == 0

    def _local_rows(self, state) -> int:
        return next(iter(state["params"].values())).shape[0]

    def snapshot_view(self, state):
        """Under the sharded driver: the params and optimizer state
        gathered (``launch.sharding.global_stack``), the comm state in
        the node-stacked structure (``comm_global``), the samplers'
        generator state as it is (every rank draws the same)."""
        if self.driver_mode != "shard":
            return state
        from repro_torch.launch.sharding import (comm_global, global_stack,
                                                 like_params)
        mesh, L = self._node_mesh, self._local_rows(state)
        out = {"params": global_stack(state["params"], self.specs, mesh),
               "opt_state": global_stack(
                   state["opt_state"],
                   like_params(state["opt_state"], self.specs, L), mesh),
               "key": state["key"]}
        if "comm" in state:
            out["comm"] = comm_global(state["comm"], self.specs, mesh)
        return out

    def snapshot_block(self, state, like):
        """Under the sharded driver: this rank's block of each part
        (``local_block``; the comm state through ``comm_from_global``,
        which rebuilds the sharded mixer's replicas)."""
        if self.driver_mode != "shard":
            return state
        from repro_torch.launch.sharding import (comm_from_global,
                                                 like_params, local_block)
        mesh, n = self._node_mesh, self._local_rows(state)
        out = {"params": local_block(state["params"], self.specs, mesh),
               "opt_state": local_block(
                   state["opt_state"],
                   like_params(state["opt_state"], self.specs, n), mesh),
               "key": state["key"]}
        if "comm" in state:
            out["comm"] = comm_from_global(state["comm"], like["comm"],
                                           self.specs, mesh)
        return out

    def snapshot_barrier(self) -> None:
        if self.driver_mode == "shard":
            from repro_torch.launch import dist
            dist.barrier()

    def _metrics_on(self) -> bool:
        return self.telemetry is not None

    def _guard_spec(self):
        return None if self.resil is None else self.resil.guard

    def _fault_key(self) -> Optional[WireFault]:
        wf = self.wire_fault
        return None if wf is None or wf.is_noop() else wf

    def _mixer_opts(self) -> Dict:
        """What ``_make_mixer`` forwards to ``mixing.make_mixer``: the
        run's compression spec and gossip mode, ``stateful=True`` once
        :meth:`init_comm` found that the schedule needs state anywhere,
        and the currently injected wire fault and the guard spec
        (validation bound and switch); the last two None in a fault-free
        run, whose mixers come back unwrapped."""
        return {"compression": self.compression, "gossip": self.gossip,
                "stateful": True if self._force_state else None,
                "wire_fault": self._fault_key(),
                "wire_guard": self._guard_spec()}

    def init_comm(self, params, topology: Topology,
                  schedule: Schedule) -> Optional[Any]:
        """The comm state of a run that needs one: the all-up step's
        ``init_comm`` of the params. Under the sharded driver it takes
        the global params (gathered from the ranks' blocks) and keeps
        this rank's block (``launch.sharding.comm_block``)."""
        from repro_torch.core import mixing
        self.gossip = schedule.gossip
        self._force_state = bool(
            mixing.normalize_compression(self.compression) is not None
            or self.gossip == "delayed" or schedule.has_stale)
        if not self._force_state:
            return None
        n = topology.n
        step = self._step(topology, np.ones(n, bool), np.zeros(n, bool),
                          np.zeros(n, bool))
        if self.driver_mode != "shard":
            return step.init_comm(params)
        from repro_torch.launch.sharding import comm_block, global_stack
        mesh = self.shard_mesh(n)
        return comm_block(step.init_comm(global_stack(params, self.specs,
                                                       mesh)),
                          self.specs, mesh)

    def _carry_rows(self, topology: Topology) -> int:
        """Rows of a metrics or guard carry: every node, or under the
        sharded driver this rank's block of them."""
        if self.driver_mode == "shard":
            return topology.n // self.shard_mesh(topology.n).node.size
        return topology.n

    def init_metrics(self, params, topology: Topology) -> Optional[Any]:
        if not self._metrics_on():
            return None
        from repro_torch.obs import metrics as obs_metrics
        return obs_metrics.init_node_metrics(self._carry_rows(topology),
                                             self.device)

    def init_guard(self, params, topology: Topology) -> Optional[Any]:
        if self._guard_spec() is None:
            return None
        from repro_torch.resil import guards
        return guards.init_node_guard(self._carry_rows(topology),
                                      self.device)

    def _make_mixer(self, topology: Topology, active,
                    stale=None) -> Callable:
        raise NotImplementedError

    def _adapter(self):
        raise NotImplementedError

    def _sampler(self):
        raise NotImplementedError

    @staticmethod
    def _mask_key(active: np.ndarray):
        return None if active.all() else tuple(np.flatnonzero(~active))

    @staticmethod
    def _freeze_key(frozen: np.ndarray):
        return tuple(np.flatnonzero(frozen)) if frozen.any() else None

    @staticmethod
    def _stale_key(stale: np.ndarray):
        return tuple(np.flatnonzero(stale)) if stale.any() else None

    def _mixer(self, topo: Topology, active: np.ndarray, stale=None):
        mask = self._mask_key(active)
        sk = self._stale_key(stale) if stale is not None else None
        fault = self._fault_key()
        # a faulted mixer also depends on the guard's validation switch
        # and bound (the reference's key leaves the guard out, so a run
        # after another with the same fault reuses its mixer)
        key = (topo.edge_key(), mask, sk, fault,
               None if fault is None else self._guard_spec())
        if key not in self._mixers:
            if mask is None and sk is None:
                self._mixers[key] = self._make_mixer(topo, None)
            else:
                # churn: remake the all-up mixer for the new availability
                # and straggler masks
                base = self._mixer(topo, np.ones_like(active))
                remake = getattr(base, "remake", None)
                self._mixers[key] = (
                    remake(active=(active if mask is not None else None),
                           stale=stale)
                    if remake is not None
                    else self._make_mixer(topo, active, stale))
        return self._mixers[key]

    def _base_step(self, topo: Topology, active: np.ndarray,
                   stale: np.ndarray):
        from repro_torch.core import driver
        if self.driver_mode == "shard":
            if not active.all():
                raise ValueError(
                    "shard driver cannot apply churn availability masks "
                    "(freeze/isolate need the node-stacked dense mixer); "
                    "run churn schedules with driver_mode='scan' or "
                    "'host'")
            if stale.any():
                raise ValueError(
                    "shard driver cannot apply straggler (stale) masks — "
                    "run stale-churn schedules with driver_mode='scan' "
                    "or 'host'")
            if self._fault_key() is not None:
                raise ValueError(
                    "wire-fault injection (drop/corrupt) is unsupported "
                    "under driver_mode='shard' — the validated mixers are "
                    "node-stacked; run fault schedules with "
                    "driver_mode='scan' or 'host'")
            return driver.make_shard_step(
                self.model, self.algo, self._adapter(),
                mesh=self.shard_mesh(topo.n), topology=topo,
                specs=self.specs, compression=self.compression,
                gossip=self.gossip, telemetry=self._metrics_on(),
                guard=self._guard_spec())
        return driver.make_step(
            self.model, self.algo,
            self._mixer(topo, active, stale if stale.any() else None),
            self._adapter(), telemetry=self._metrics_on(),
            guard=self._guard_spec())

    def _cache_key(self, topo: Topology, active: np.ndarray,
                   frozen: np.ndarray, stale: np.ndarray):
        return (self.phase, topo.edge_key(), self._mask_key(active),
                self._freeze_key(frozen), self._stale_key(stale),
                self._metrics_on(), self._fault_key(), self._guard_spec())

    def _step(self, topo: Topology, active: np.ndarray,
              frozen: np.ndarray, stale: np.ndarray):
        from repro_torch.core import driver
        key = self._cache_key(topo, active, frozen, stale)
        if key not in self._steps:
            step = self._base_step(topo, active, stale)
            if self._freeze_key(frozen) is not None:
                # hold exactly the frozen subset; isolate stragglers
                # (down but not frozen) keep taking local steps
                step = driver.make_frozen_step(step, ~frozen)
            self._steps[key] = step
        return self._steps[key]

    def runner(self, topo: Topology, active: np.ndarray,
               frozen: np.ndarray, stale: np.ndarray) -> Callable:
        from repro_torch.core import driver
        key = self._cache_key(topo, active, frozen, stale)
        if key not in self._runners:
            self._runners[key] = driver.make_runner(
                self._step(topo, active, frozen, stale), self._sampler(),
                self.lr_fn, self.driver_mode)
        run = self._runners[key]
        ctx = None if self.phase == "plain" else self.ctx
        flags = [f for f in ("comm", "metrics", "guard")
                 if getattr(run, f, False)]

        def phase_run(p, o, g, s0, ns, **carries):
            return run(p, o, g, s0, ns, ctx,
                       **{f: carries.get(f) for f in flags})

        for f in ("comm", "metrics", "guard"):
            setattr(phase_run, f, f in flags)
        return phase_run


def validate_shard_schedule(schedule: Schedule, num_nodes: int,
                            model_parallel: int = 1) -> None:
    """Pre-flight for ``driver_mode="shard"``: the sharded gossip has no
    churn path and only ring/complete-graph rewire targets, so refuse
    unsupported schedules *before* the run starts instead of failing
    mid-schedule when the event fires.

    On the 2-D federation mesh (``model_parallel > 1``) rewires are
    refused too, as in the reference: run such schedules on the 1-D
    node mesh (``--model-parallel 1``) or node-stacked."""
    from repro_torch.core.mixing import shard_supported_topology
    for seg in schedule.segments:
        for ev in seg.events:
            if isinstance(ev, ChurnEvent):
                raise ValueError(
                    f"schedule has churn at step {ev.step}; churn "
                    "(freeze/isolate availability masks) is unsupported "
                    "under driver_mode='shard' — run it node-stacked "
                    "with driver_mode='scan' or 'host'")
            if isinstance(ev, FaultEvent) and ev.kind in ("drop", "corrupt"):
                raise ValueError(
                    f"schedule injects a wire fault ({ev.kind}) at step "
                    f"{ev.step}; wire-fault injection needs the "
                    "node-stacked validated mixers — run fault schedules "
                    "with driver_mode='scan' or 'host'. Crash faults are "
                    "fine under shard.")
            if isinstance(ev, RewireEvent):
                if model_parallel > 1:
                    raise ValueError(
                        f"rewire at step {ev.step} is unsupported on the "
                        "2-D (node, model) federation mesh — run this "
                        "schedule with --model-parallel 1 (the 1-D node "
                        "mesh) or driver_mode='scan'")
                topo = _resolve_topology(ev, num_nodes)
                if not shard_supported_topology(topo):
                    raise ValueError(
                        f"rewire at step {ev.step} targets "
                        f"{topo.name!r}; the shard driver gossips on "
                        "ring/complete graphs only — use "
                        "driver_mode='scan' or 'host' for this schedule")


def _resolve_topology(ev: RewireEvent, n: int) -> Topology:
    topo = ev.topology
    if isinstance(topo, str):
        topo = Topology.make(topo, n)
    if topo.n != n:
        raise ValueError(f"rewire topology has {topo.n} nodes, run has {n}")
    return topo


def _copy(tree):
    """A deep copy of a run's state: tensors cloned, arrays copied, a
    ``torch.Generator`` as its state tensor."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _put(dst, src):
    """Write a :func:`_copy` back into the live state it was taken from,
    in place where the state is mutable; returns the restored value."""
    if isinstance(dst, torch.Generator):
        dst.set_state(src)
        return dst
    if isinstance(dst, dict):
        return {k: _put(dst[k], v) for k, v in src.items()}
    if isinstance(dst, torch.Tensor):
        return dst.copy_(src)
    return src


def _key_state(key):
    return key.get_state() if isinstance(key, torch.Generator) else key


def _global(hooks, carry):
    """The whole federation's carry (``hooks.global_carry``; hooks
    without it hold the node-stacked one)."""
    fn = getattr(hooks, "global_carry", None)
    return carry if fn is None else fn(carry)


def _mean_loss(losses) -> Optional[float]:
    if isinstance(losses, torch.Tensor):
        return float(losses.float().mean()) if losses.numel() else None
    arr = np.asarray(losses)
    return float(np.mean(arr)) if arr.size else None


def run_schedule(schedule: Schedule, hooks: FederationHooks, params,
                 opt_state, key, *, topology: Topology,
                 ledger: Optional[CommLedger] = None, param_count: int = 0,
                 elem_bytes: int = 4, payload_elems: Optional[int] = None,
                 index_bytes: int = 0, resume_step: int = 0,
                 capture_at: Optional[int] = None, telemetry=None,
                 resil=None) -> Tuple[Any, Any, Any, Optional[Dict]]:
    """Drive the whole schedule. Returns ``(params, opt_state, key,
    captured)``: ``key`` the samplers' generator (or whatever key the
    hooks' runners take), ``captured`` the ``{"params", "opt_state",
    "key", "step"}`` copy taken at the ``capture_at`` boundary (None when
    not asked for; its ``"key"`` is the generator's state; plus
    ``"comm"`` on a stateful-gossip run).

    ``resume_step`` must satisfy ``schedule.validate_resume``; segments
    ending at or before it are skipped, their topology and fault events
    replayed. A run given ``resume_step`` starts its comm state afresh
    from the params (x̂ = x); a durable snapshot carries its own.

    ``payload_elems`` / ``index_bytes`` are the ledger's compressed-wire
    count (``mixing.payload_elem_count`` elements a node, each with a
    4-byte index); left as they are the charge is the dense
    ``param_count · elem_bytes``. Stale stragglers are charged 0.

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`; None = off)
    turns on the run log, the metrics bus (flushed and zeroed at each
    segment boundary) and trace spans around rounds, segments, snapshots
    and evals.

    ``resil`` (a :class:`repro_torch.resil.Resilience`; None = off):
    ``guard`` carries the on-device guard through every runner call and
    summarizes it at each boundary (one host read); a node that tripped
    an own-health check, or sent invalid wire payloads, is quarantined
    (frozen, identity mixing rows through the frozen step, the ledger's
    ``STATUS_QUARANTINED``, a ``health`` event). ``snapshot_dir`` writes
    a durable snapshot every ``snapshot_every`` steps; a run whose
    directory already holds snapshots (and ``resume_step`` 0) resumes
    from the newest valid one. ``rollback`` turns a trip into
    restore-and-rerun of the segment from its pre-segment state and
    generator state, the offenders quarantined, at most ``max_retries``
    times.

    ``FaultEvent`` s set the wire-fault state the hooks' mixers are
    rebuilt with; ``crash`` raises :class:`repro_torch.resil.
    SimulatedCrash`, and calling again with the same snapshot directory
    resumes past it.
    """
    from repro_torch.obs import log
    from repro_torch.sched.ledger import (STATUS_ACTIVE, STATUS_INACTIVE,
                                          STATUS_QUARANTINED, STATUS_STALE)

    tel = telemetry if telemetry is not None \
        else getattr(hooks, "telemetry", None)
    hooks.telemetry = tel

    def _ev(_event_kind, **fields):
        if tel is not None:
            tel.event(_event_kind, **fields)

    def _span(name, **args):
        return tel.span(name, **args) if tel is not None else nullcontext()

    res = resil if resil is not None else getattr(hooks, "resil", None)
    hooks.resil = res
    hooks.wire_fault = None       # faults come only from FaultEvents below
    n = topology.n
    active = np.ones(n, bool)
    frozen = np.zeros(n, bool)    # down nodes with freeze (vs isolate) mode
    stale = np.zeros(n, bool)     # active stragglers, frozen payloads
    quarantined = np.zeros(n, bool)
    fired = 0
    with _span("init_comm", cat="init"):
        comm = hooks.init_comm(params, topology, schedule)
    metrics = hooks.init_metrics(params, topology)
    guard_state = hooks.init_guard(params, topology)

    # the snapshot protocol (FederationHooks); hooks without it are
    # node-stacked, one process
    agree = getattr(hooks, "agree", lambda v: v)
    snapshot_view = getattr(hooks, "snapshot_view", lambda st: st)
    snapshot_barrier = getattr(hooks, "snapshot_barrier", lambda: None)
    mgr = None
    resumed_with_ctx = False
    if res is not None and getattr(res, "snapshots_on", False):
        from repro_torch.resil.snapshot import SnapshotManager
        # one file holds the whole federation: under the sharded driver
        # rank 0 writes it, and on resume picks the step every rank loads
        mgr = SnapshotManager(res.snapshot_dir, every=res.snapshot_every,
                              keep=res.keep,
                              writer=getattr(hooks, "snapshot_writer",
                                             lambda: True)())
        if resume_step == 0 and agree(bool(mgr.steps())):
            mine = {"params": params, "opt_state": opt_state,
                    "key": _key_state(key)}
            if comm is not None:
                mine["comm"] = comm
            like = snapshot_view(mine)
            loaded = mgr.load_latest(like) if mgr.writer else None
            step = agree(-1 if loaded is None else loaded["step"])
            if not mgr.writer and step >= 0:
                loaded = mgr.load(step, like)
            snapshot_barrier()
            if loaded is not None and loaded["step"] > 0:
                schedule.validate_resume(
                    loaded["step"], with_ctx=loaded["ctx"] is not None)
                state = getattr(hooks, "snapshot_block",
                                lambda st, _: st)(loaded["state"], mine)
                params, opt_state = state["params"], state["opt_state"]
                if isinstance(key, torch.Generator):
                    key.set_state(state["key"])
                else:
                    key = state["key"]
                if comm is not None:
                    comm = state["comm"]
                if loaded["ctx"] is not None:
                    hooks.restore_ctx(loaded["ctx"], loaded["phase"])
                    resumed_with_ctx = True
                resume_step = loaded["step"]
                log.info("snapshot_resume", step=resume_step,
                         phase=loaded["phase"], fired=loaded["fired"])
                _ev("resume", step=resume_step, phase=loaded["phase"],
                    fired=loaded["fired"])

    schedule.validate_resume(resume_step, with_ctx=resumed_with_ctx)
    if capture_at is not None:
        if capture_at != 0 and \
                capture_at not in {s.stop for s in schedule.segments}:
            raise ValueError(f"capture_at={capture_at} is not a segment "
                             "boundary of this schedule")
        if capture_at <= resume_step and not (capture_at == resume_step == 0):
            raise ValueError(
                f"capture_at={capture_at} lies in the span skipped by "
                f"resume_step={resume_step}; nothing would be captured")
    captured: Optional[Dict] = None
    _ev("schedule", segments=len(schedule.segments),
        steps=schedule.segments[-1].stop if schedule.segments else 0,
        rounds=schedule.num_rounds, gossip=schedule.gossip,
        nodes=n, topology=topology.name, resume_step=resume_step)
    drop_nodes: set = set()
    corrupt_nodes: set = set()
    corrupt_mode = "nan"

    def _snapshot(step):
        snap = {"params": params, "opt_state": opt_state, "key": key,
                "step": step}
        if comm is not None:
            snap["comm"] = comm
        return _copy(snap)

    if capture_at == 0:
        captured = _snapshot(0)

    for seg_index, seg in enumerate(schedule.segments):
        skipped = seg.stop <= resume_step
        for ev in seg.events:
            if isinstance(ev, ChurnEvent):
                active = active.copy()
                frozen = frozen.copy()
                stale = stale.copy()
                for i in (*ev.down, *ev.up):
                    if not 0 <= i < n:
                        raise ValueError(
                            f"churn event at step {ev.step} names node "
                            f"{i} outside [0, {n})")
                for i in ev.down:
                    if ev.mode == "stale":
                        # the straggler stays active (trains, receives);
                        # only its outgoing payload freezes
                        stale[i] = True
                    else:
                        active[i] = False
                        frozen[i] = ev.mode == "freeze"
                        stale[i] = False
                for i in ev.up:
                    active[i] = True
                    frozen[i] = False
                    stale[i] = False
                if not active.any():
                    raise ValueError(f"churn at step {ev.step} leaves no "
                                     "active nodes")
                hooks.on_topology(topology, active, frozen, stale)
                _ev("topology", step=ev.step, change="churn", mode=ev.mode,
                    down=list(ev.down), up=list(ev.up), active=active,
                    frozen=frozen, stale=stale,
                    mixing_rows=topology.mixing_matrix(
                        None if active.all() else active))
            elif isinstance(ev, RewireEvent):
                topology = _resolve_topology(ev, n)
                hooks.on_topology(topology, active, frozen, stale)
                _ev("topology", step=ev.step, change="rewire",
                    graph=topology.name, active=active, frozen=frozen,
                    stale=stale,
                    mixing_rows=topology.mixing_matrix(
                        None if active.all() else active))
            elif isinstance(ev, FaultEvent):
                for i in ev.nodes:
                    if not 0 <= i < n:
                        raise ValueError(
                            f"fault event at step {ev.step} names node "
                            f"{i} outside [0, {n})")
                if ev.kind == "crash":
                    if ev.step > resume_step and (
                            mgr is None
                            or not agree(mgr.crash_seen(ev.step))):
                        # no snapshot here: recovery rides the one of the
                        # last boundary; the tombstone makes the crash
                        # fire once across incarnations
                        if mgr is not None and mgr.writer:
                            mgr.mark_crash(ev.step)
                        _ev("fault", step=ev.step, kind="crash")
                        log.warning("fault_crash", step=ev.step)
                        raise SimulatedCrash(ev.step)
                    continue
                if ev.kind == "drop":
                    drop_nodes |= set(ev.nodes)
                elif ev.kind == "corrupt":
                    corrupt_nodes |= set(ev.nodes)
                    corrupt_mode = ev.mode
                elif ev.kind == "clear":
                    if ev.nodes:
                        drop_nodes -= set(ev.nodes)
                        corrupt_nodes -= set(ev.nodes)
                    else:
                        drop_nodes.clear()
                        corrupt_nodes.clear()
                hooks.wire_fault = (
                    WireFault(drop=tuple(sorted(drop_nodes)),
                              corrupt=tuple(sorted(corrupt_nodes)),
                              mode=corrupt_mode)
                    if (drop_nodes or corrupt_nodes) else None)
                _ev("fault", step=ev.step, kind=ev.kind,
                    nodes=list(ev.nodes), mode=ev.mode,
                    drop=sorted(drop_nodes), corrupt=sorted(corrupt_nodes))
                if not skipped:
                    log.warning("fault_injected", step=ev.step,
                                kind=ev.kind, nodes=list(ev.nodes))
            elif isinstance(ev, HomogenizeEvent):
                if skipped:
                    fired += 1      # the round happened before the resume
                    continue
                with _span("label_round", cat="round", step=ev.step,
                           round=fired):
                    label_bytes = hooks.on_round(params, fired, ev.step,
                                                 topology, active)
                stats = getattr(hooks, "last_round_stats", None)
                hooks.on_labels(fired, ev.step, stats)
                _ev("round", round=fired, step=ev.step)
                if stats:
                    _ev("labels", round=fired, step=ev.step, **stats)
                fired += 1
                if ledger is not None and label_bytes is not None:
                    per_node = np.asarray(label_bytes)
                    ledger.log_labels(fired, ev.step, per_node)
                    _ev("comm", kind="labels", round=fired, step=ev.step,
                        per_node=per_node)
        if skipped:
            continue

        hooks.on_segment(seg, seg_index)
        _ev("segment", index=seg_index, start=seg.start, stop=seg.stop,
            steps=seg.num_steps, round=fired, eval_after=seg.eval_after,
            phase=getattr(hooks, "phase", None))
        retries = 0
        # the updates write over params and the generator advances: keep
        # what a rollback restores
        pre = (_copy({"params": params, "opt_state": opt_state,
                      "key": key, "comm": comm})
               if res is not None and res.rollback else None)
        while True:
            # quarantined nodes are held like freeze-churned ones, in a
            # mask of their own so the ledger can tell them apart
            eff_active = active & ~quarantined
            eff_frozen = frozen | quarantined
            if not eff_active.any():
                raise RuntimeError(
                    f"segment [{seg.start}, {seg.stop}) has no active "
                    "nodes left after churn + quarantine")
            runner_cache = getattr(hooks, "_runners", None)
            cached_runners = (len(runner_cache)
                              if runner_cache is not None else 0)
            runner = hooks.runner(topology, eff_active, eff_frozen, stale)
            new_runner = (runner_cache is not None
                          and len(runner_cache) > cached_runners)
            run_kwargs = {}
            if getattr(runner, "comm", False):
                run_kwargs["comm"] = comm
            if getattr(runner, "metrics", False):
                run_kwargs["metrics"] = metrics
            if getattr(runner, "guard", False):
                run_kwargs["guard"] = guard_state
            with _span("segment", cat="train", start=seg.start,
                       stop=seg.stop, round=fired, compile=new_runner):
                out = runner(params, opt_state, key, seg.start,
                             seg.num_steps, **run_kwargs)
            new_params, new_opt, new_key, losses = out[:4]
            rest = list(out[4:])
            new_comm = rest.pop(0) if "comm" in run_kwargs else comm
            new_metrics = (rest.pop(0) if "metrics" in run_kwargs
                           else metrics)
            new_guard = rest.pop(0) if "guard" in run_kwargs else None

            to_q = np.zeros(n, bool)
            if new_guard is not None:
                # one host read per segment, as for the metrics bus
                from repro_torch.resil import guards
                summary = guards.summarize(_global(hooks, new_guard))
                tripped = guards.tripped_nodes(summary) & ~quarantined
                offenders = guards.wire_offenders(summary) & ~quarantined
                if tripped.any() or offenders.any():
                    # wire attribution wins when present: the offender is
                    # the sender of invalid payloads, tripped receivers
                    # its victims
                    to_q = offenders if offenders.any() else tripped
                    log.warning(
                        "guard_tripped", step=seg.stop,
                        tripped=np.flatnonzero(tripped).tolist(),
                        offenders=np.flatnonzero(offenders).tolist())
                new_guard = guards.reset(new_guard)

            if to_q.any() and not (eff_active & ~to_q).any():
                log.warning("quarantine_refused", step=seg.stop,
                            nodes=np.flatnonzero(to_q).tolist(),
                            reason="would leave no active nodes")
                _ev("health", step=seg.stop, action="refused",
                    tripped=to_q)
                to_q = np.zeros(n, bool)
            if to_q.any():
                quarantined = quarantined | to_q
                _ev("health", step=seg.stop, action="quarantine",
                    tripped=tripped, offenders=offenders,
                    quarantined=quarantined, retry=retries,
                    counters={k: summary[k]
                              for k in guards.GUARD_COUNTERS})
                log.warning("quarantine", step=seg.stop,
                            nodes=np.flatnonzero(to_q).tolist())
                if (res is not None and res.rollback
                        and retries < res.max_retries):
                    # discard the segment's state and re-run it from the
                    # pre-segment copy, the same generator state, with
                    # the offenders quarantined
                    retries += 1
                    guard_state = new_guard
                    params = _put(new_params, pre["params"])
                    opt_state = _put(new_opt, pre["opt_state"])
                    key = _put(new_key, pre["key"])
                    comm = (_put(new_comm, pre["comm"])
                            if comm is not None else None)
                    _ev("rollback", step=seg.stop, retry=retries,
                        quarantined=quarantined)
                    log.warning(
                        "segment_rollback", start=seg.start,
                        stop=seg.stop, retry=retries,
                        quarantined=np.flatnonzero(quarantined).tolist())
                    continue
            params, opt_state, key = new_params, new_opt, new_key
            comm, metrics = new_comm, new_metrics
            if new_guard is not None:
                guard_state = new_guard
            break

        if ledger is not None and param_count:
            status = np.where(
                eff_frozen & ~frozen, STATUS_QUARANTINED,
                np.where(~active, STATUS_INACTIVE,
                         np.where(stale, STATUS_STALE,
                                  STATUS_ACTIVE))).astype(np.int8)
            per_step = gossip_bytes_per_step(
                topology, eff_active, param_count, elem_bytes,
                payload_elems=payload_elems, index_bytes=index_bytes,
                stale=stale if stale.any() else None)
            ledger.log_gossip(fired, seg.start, seg.stop, per_step,
                              status=status)
            _ev("comm", kind="gossip", round=fired, start=seg.start,
                stop=seg.stop, per_node=per_step * seg.num_steps,
                status=status)
        if "metrics" in run_kwargs and tel is not None \
                and metrics is not None:
            # flush and zero at the boundary: the only host read the
            # metrics bus adds, once a segment
            tel.flush_metrics(seg.stop, _global(hooks, metrics),
                              round=fired,
                              active=eff_active, stale=stale)
            from repro_torch.obs import metrics as obs_metrics
            metrics = obs_metrics.reset(metrics)
        if capture_at == seg.stop:
            captured = _snapshot(seg.stop)
        if mgr is not None and mgr.due(seg.stop):
            state = {"params": params, "opt_state": opt_state,
                     "key": _key_state(key)}
            if comm is not None:
                state["comm"] = comm
            with _span("snapshot", cat="resil", step=seg.stop):
                mgr.save(seg.stop, snapshot_view(state),
                         ctx=getattr(hooks, "ctx", None),
                         phase=getattr(hooks, "phase", "plain"),
                         fired=fired)
                snapshot_barrier()
            _ev("snapshot", step=seg.stop, fired=fired)
        if seg.eval_after:
            with _span("eval", cat="eval", step=seg.stop - 1):
                hooks.on_eval(params, seg.stop - 1, losses)
            mean_loss = _mean_loss(losses)
            _ev("eval", step=seg.stop - 1, mean_loss=mean_loss)
            if mean_loss is not None and not np.isfinite(mean_loss):
                log.warning("eval_nonfinite", step=seg.stop - 1,
                            mean_loss=mean_loss)
                _ev("health", step=seg.stop - 1, kind="eval_nonfinite",
                    mean_loss=mean_loss)

    _ev("run_end", rounds=fired)
    return params, opt_state, key, captured
