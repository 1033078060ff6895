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
miss gossip), ``stale`` (always empty: straggler payloads are item 12),
``quarantined`` (guard-tripped nodes, frozen and silent), the wire-fault
state, and the rounds fired so far.

The port's updates write over their inputs, and its sampler state is a
``torch.Generator`` that a segment advances. So where the reference
keeps the pre-segment values by not overwriting them, the port copies
them: before each segment when rollback is on (params, optimizer state
and generator state, restored on a retry), and at the ``capture_at``
boundary. Resume replays the topology and fault events before the
resume step but skips their training and rounds; the quarantine mask is
not part of a snapshot, as in the reference.
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
        """The stateful gossip mixers' comm state; None for synchronous
        uncompressed gossip, the only kind ported (item 12)."""
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
        the current phase, graph and masks. One flagged ``run.metrics``
        / ``run.guard`` takes and returns those carries as keywords:
        ``run(..., metrics=m, guard=g) -> (params, opt_state, gen,
        losses, m, g)``."""
        raise NotImplementedError

    def on_eval(self, params, step: int, losses) -> None:
        """An eval boundary was crossed after ``step``."""


class CompiledFederationHooks(FederationHooks):
    """:class:`FederationHooks` with the mixers, steps and host runners
    cached per (phase, graph, availability mask, frozen subset, metrics
    switch, wire fault, guard spec), and the round-varying sampler
    payload in ``self.ctx`` passed to the runner of every phase but
    "plain". Graphs are keyed by ``Topology.edge_key()``, so a rewire
    back to an equivalent graph finds its cached mixer.

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

    def _metrics_on(self) -> bool:
        return self.telemetry is not None

    def _guard_spec(self):
        return None if self.resil is None else self.resil.guard

    def _fault_key(self) -> Optional[WireFault]:
        wf = self.wire_fault
        return None if wf is None or wf.is_noop() else wf

    def _mixer_opts(self) -> Dict:
        """What ``_make_mixer`` forwards to ``mixing.make_mixer``: the
        currently injected wire fault and the guard spec (validation
        bound and switch); both None in a fault-free run, whose mixers
        come back unwrapped."""
        return {"wire_fault": self._fault_key(),
                "wire_guard": self._guard_spec()}

    def init_metrics(self, params, topology: Topology) -> Optional[Any]:
        if not self._metrics_on():
            return None
        from repro_torch.obs import metrics as obs_metrics
        return obs_metrics.init_node_metrics(topology.n, self.device)

    def init_guard(self, params, topology: Topology) -> Optional[Any]:
        if self._guard_spec() is None:
            return None
        from repro_torch.resil import guards
        return guards.init_node_guard(topology.n, self.device)

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

    def _mixer(self, topo: Topology, active: np.ndarray):
        mask = self._mask_key(active)
        fault = self._fault_key()
        # a faulted mixer also depends on the guard's validation switch
        # and bound (the reference's key leaves the guard out, so a run
        # after another with the same fault reuses its mixer)
        key = (topo.edge_key(), mask, fault,
               None if fault is None else self._guard_spec())
        if key not in self._mixers:
            if mask is None:
                self._mixers[key] = self._make_mixer(topo, None)
            else:
                # churn: remake the all-up mixer for the new mask
                base = self._mixer(topo, np.ones_like(active))
                remake = getattr(base, "remake", None)
                self._mixers[key] = (remake(active=active)
                                     if remake is not None
                                     else self._make_mixer(topo, active))
        return self._mixers[key]

    def _base_step(self, topo: Topology, active: np.ndarray,
                   stale: np.ndarray):
        from repro_torch.core import driver
        return driver.make_step(
            self.model, self.algo, self._mixer(topo, active),
            self._adapter(), telemetry=self._metrics_on(),
            guard=self._guard_spec())

    def _cache_key(self, topo: Topology, active: np.ndarray,
                   frozen: np.ndarray):
        return (self.phase, topo.edge_key(), self._mask_key(active),
                self._freeze_key(frozen), self._metrics_on(),
                self._fault_key(), self._guard_spec())

    def _step(self, topo: Topology, active: np.ndarray,
              frozen: np.ndarray, stale: np.ndarray):
        from repro_torch.core import driver
        key = self._cache_key(topo, active, frozen)
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
        key = self._cache_key(topo, active, frozen)
        if key not in self._runners:
            self._runners[key] = driver.make_runner(
                self._step(topo, active, frozen, stale), self._sampler(),
                self.lr_fn, self.driver_mode)
        run = self._runners[key]
        ctx = None if self.phase == "plain" else self.ctx
        has_metrics = getattr(run, "metrics", False)
        has_guard = getattr(run, "guard", False)

        def phase_run(p, o, g, s0, ns, metrics=None, guard=None):
            kw = {}
            if has_metrics:
                kw["metrics"] = metrics
            if has_guard:
                kw["guard"] = guard
            return run(p, o, g, s0, ns, ctx, **kw)

        phase_run.metrics = has_metrics
        phase_run.guard = has_guard
        return phase_run


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


def _mean_loss(losses) -> Optional[float]:
    if isinstance(losses, torch.Tensor):
        return float(losses.float().mean()) if losses.numel() else None
    arr = np.asarray(losses)
    return float(np.mean(arr)) if arr.size else None


def run_schedule(schedule: Schedule, hooks: FederationHooks, params,
                 opt_state, key, *, topology: Topology,
                 ledger: Optional[CommLedger] = None, param_count: int = 0,
                 elem_bytes: int = 4, resume_step: int = 0,
                 capture_at: Optional[int] = None, telemetry=None,
                 resil=None) -> Tuple[Any, Any, Any, Optional[Dict]]:
    """Drive the whole schedule. Returns ``(params, opt_state, key,
    captured)``: ``key`` the samplers' generator (or whatever key the
    hooks' runners take), ``captured`` the ``{"params", "opt_state",
    "key", "step"}`` copy taken at the ``capture_at`` boundary (None when
    not asked for; its ``"key"`` is the generator's state).

    ``resume_step`` must satisfy ``schedule.validate_resume``; segments
    ending at or before it are skipped, their topology and fault events
    replayed.

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
                                          STATUS_QUARANTINED)

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
    stale = np.zeros(n, bool)     # straggler payloads: item 12, never set
    quarantined = np.zeros(n, bool)
    fired = 0
    with _span("init_comm", cat="init"):
        comm = hooks.init_comm(params, topology, schedule)
    if comm is not None:
        raise NotImplementedError(
            "stateful gossip (a comm state) is not ported yet; see "
            "ROADMAP.md queue 1 item 12")
    metrics = hooks.init_metrics(params, topology)
    guard_state = hooks.init_guard(params, topology)

    mgr = None
    resumed_with_ctx = False
    if res is not None and getattr(res, "snapshots_on", False):
        from repro_torch.resil.snapshot import SnapshotManager
        mgr = SnapshotManager(res.snapshot_dir, every=res.snapshot_every,
                              keep=res.keep)
        if resume_step == 0 and mgr.steps():
            like = {"params": params, "opt_state": opt_state,
                    "key": _key_state(key)}
            loaded = mgr.load_latest(like)
            if loaded is not None and loaded["step"] > 0:
                schedule.validate_resume(
                    loaded["step"], with_ctx=loaded["ctx"] is not None)
                state = loaded["state"]
                params, opt_state = state["params"], state["opt_state"]
                if isinstance(key, torch.Generator):
                    key.set_state(state["key"])
                else:
                    key = state["key"]
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
        return _copy({"params": params, "opt_state": opt_state, "key": key,
                      "step": step})

    if capture_at == 0:
        captured = _snapshot(0)

    for seg_index, seg in enumerate(schedule.segments):
        skipped = seg.stop <= resume_step
        for ev in seg.events:
            if isinstance(ev, ChurnEvent):
                active = active.copy()
                frozen = frozen.copy()
                for i in (*ev.down, *ev.up):
                    if not 0 <= i < n:
                        raise ValueError(
                            f"churn event at step {ev.step} names node "
                            f"{i} outside [0, {n})")
                for i in ev.down:
                    active[i] = False
                    frozen[i] = ev.mode == "freeze"
                for i in ev.up:
                    active[i] = True
                    frozen[i] = False
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
                            mgr is None or not mgr.crash_seen(ev.step)):
                        # no snapshot here: recovery rides the one of the
                        # last boundary; the tombstone makes the crash
                        # fire once across incarnations
                        if mgr is not None:
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
                      "key": key})
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
            new_metrics = (rest.pop(0) if "metrics" in run_kwargs
                           else metrics)
            new_guard = rest.pop(0) if "guard" in run_kwargs else None

            to_q = np.zeros(n, bool)
            if new_guard is not None:
                # one host read per segment, as for the metrics bus
                from repro_torch.resil import guards
                summary = guards.summarize(new_guard)
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
                    _ev("rollback", step=seg.stop, retry=retries,
                        quarantined=quarantined)
                    log.warning(
                        "segment_rollback", start=seg.start,
                        stop=seg.stop, retry=retries,
                        quarantined=np.flatnonzero(quarantined).tolist())
                    continue
            params, opt_state, key = new_params, new_opt, new_key
            metrics = new_metrics
            if new_guard is not None:
                guard_state = new_guard
            break

        if ledger is not None and param_count:
            status = np.where(
                eff_frozen & ~frozen, STATUS_QUARANTINED,
                np.where(~active, STATUS_INACTIVE,
                         STATUS_ACTIVE)).astype(np.int8)
            per_step = gossip_bytes_per_step(topology, eff_active,
                                             param_count, elem_bytes)
            ledger.log_gossip(fired, seg.start, seg.stop, per_step,
                              status=status)
            _ev("comm", kind="gossip", round=fired, start=seg.start,
                stop=seg.stop, per_node=per_step * seg.num_steps,
                status=status)
        if "metrics" in run_kwargs and tel is not None \
                and metrics is not None:
            # flush and zero at the boundary: the only host read the
            # metrics bus adds, once a segment
            tel.flush_metrics(seg.stop, metrics, round=fired,
                              active=eff_active, stale=stale)
            from repro_torch.obs import metrics as obs_metrics
            metrics = obs_metrics.reset(metrics)
        if capture_at == seg.stop:
            captured = _snapshot(seg.stop)
        if mgr is not None and mgr.due(seg.stop):
            state = {"params": params, "opt_state": opt_state,
                     "key": _key_state(key)}
            with _span("snapshot", cat="resil", step=seg.stop):
                mgr.save(seg.stop, state, ctx=getattr(hooks, "ctx", None),
                         phase=getattr(hooks, "phase", "plain"),
                         fired=fired)
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
