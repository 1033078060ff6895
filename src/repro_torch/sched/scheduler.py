"""The federation scheduler: one outer loop over a compiled schedule.

:func:`run_schedule` replays a :class:`~repro_torch.sched.schedule.
Schedule` against driver *hooks*: it owns segment iteration, the
homogenization rounds, communication accounting and eval boundaries;
the hooks own everything model-specific (the runner for the current
phase, the label round, the eval). :class:`CompiledFederationHooks`
adds the phase-keyed step and runner caches and threads the round's
sampler state (``self.ctx``) through the runner of every KD phase. This
is the reference's scheduler reduced to what the ported paths run:
churn, rewires, faults, telemetry, resilience, capture and resume are
still to port (ROADMAP.md queue 1 item 11) and raise.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.sched.ledger import CommLedger, gossip_bytes_per_step
from repro_torch.sched.schedule import HomogenizeEvent, Schedule


class FederationHooks:
    """Driver callbacks for :func:`run_schedule` (subclass and override)."""

    def on_round(self, params, round_index: int, step: int,
                 topology: Topology) -> Optional[np.ndarray]:
        """Run one homogenization round from the current params and swap
        the KD sampler in. Returns (n,) label payload bytes (or None)."""
        return None

    def runner(self, topology: Topology) -> Callable:
        """A ``run(params, opt_state, gen, step0, num_steps)`` runner for
        the current phase."""
        raise NotImplementedError

    def on_eval(self, params, step: int, losses) -> None:
        """An eval boundary was crossed after ``step``."""


class CompiledFederationHooks(FederationHooks):
    """:class:`FederationHooks` with the steps, mixers and host runners
    cached per (phase, graph), and the round-varying sampler payload in
    ``self.ctx`` passed to the runner of every phase but "plain".
    Subclasses set ``model``, ``algo`` and ``lr_fn`` and
    implement ``_make_mixer(topology)``, ``_adapter()`` and
    ``_sampler()`` for the current ``phase``; ``on_round`` advances the
    phase and refreshes ``ctx``. Only one graph per run is ported (no
    rewire events), so the graph key is the topology's name and size."""

    model = None
    algo = None
    lr_fn = None

    def __init__(self):
        self.phase = "plain"
        self.ctx = None
        self._mixers = {}
        self._steps = {}
        self._runners = {}

    def _make_mixer(self, topology: Topology) -> Callable:
        raise NotImplementedError

    def _adapter(self):
        raise NotImplementedError

    def _sampler(self):
        raise NotImplementedError

    def _mixer(self, topology: Topology) -> Callable:
        key = (topology.name, topology.n)
        if key not in self._mixers:
            self._mixers[key] = self._make_mixer(topology)
        return self._mixers[key]

    def _step(self, topology: Topology) -> Callable:
        from repro_torch.core import driver
        key = (self.phase, topology.name, topology.n)
        if key not in self._steps:
            self._steps[key] = driver.make_step(
                self.model, self.algo, self._mixer(topology),
                self._adapter())
        return self._steps[key]

    def runner(self, topology: Topology) -> Callable:
        from repro_torch.core import driver
        key = (self.phase, topology.name, topology.n)
        run = self._runners.get(key)
        if run is None:
            run = driver.make_host_runner(self._step(topology),
                                          self._sampler(), self.lr_fn)
            self._runners[key] = run
        if self.phase == "plain":
            return run
        return lambda p, o, g, s0, ns: run(p, o, g, s0, ns, self.ctx)


def run_schedule(schedule: Schedule, hooks: FederationHooks, params,
                 opt_state, gen, *, topology: Topology,
                 ledger: Optional[CommLedger] = None, param_count: int = 0,
                 elem_bytes: int = 4, resume_step: int = 0,
                 capture_at: Optional[int] = None, telemetry=None,
                 resil=None) -> Tuple[Any, Any, Any]:
    """Drive the full schedule; returns ``(params, opt_state, gen)``."""
    if resume_step or capture_at is not None:
        raise NotImplementedError(
            "capture/resume is not ported yet; see ROADMAP.md queue 1 "
            "item 11")
    if telemetry is not None or resil is not None:
        raise NotImplementedError(
            "telemetry and resilience are not ported yet; see ROADMAP.md "
            "queue 1 item 11")
    fired = 0
    for seg in schedule.segments:
        for ev in seg.events:
            if not isinstance(ev, HomogenizeEvent):
                raise NotImplementedError(
                    f"schedule event {ev!r} is not ported yet; see "
                    "ROADMAP.md queue 1 items 11 and 12")
            label_bytes = hooks.on_round(params, fired, ev.step, topology)
            fired += 1
            if ledger is not None and label_bytes is not None:
                ledger.log_labels(fired, ev.step, np.asarray(label_bytes))
        params, opt_state, gen, losses = hooks.runner(topology)(
            params, opt_state, gen, seg.start, seg.num_steps)
        if ledger is not None and param_count:
            ledger.log_gossip(fired, seg.start, seg.stop,
                              gossip_bytes_per_step(topology, None,
                                                    param_count, elem_bytes))
        if seg.eval_after:
            hooks.on_eval(params, seg.stop - 1, losses)
    return params, opt_state, gen
