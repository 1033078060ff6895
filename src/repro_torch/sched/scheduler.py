"""The federation scheduler: one outer loop over a compiled schedule.

:func:`run_schedule` replays a :class:`~repro_torch.sched.schedule.
Schedule` against driver *hooks*: it owns segment iteration, the
homogenization rounds, communication accounting and eval boundaries;
the hooks own everything model-specific (the runner for the current
phase, the label round, the eval). This is the reference's scheduler
reduced to what the main path runs: churn, rewires, faults, telemetry,
resilience, capture and resume are still to port (ROADMAP.md queue 1
item 11) and raise.
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
