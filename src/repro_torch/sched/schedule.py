"""Federation schedule compiler: the outer loop of a run as segments.

:func:`compile_schedule` turns (steps, eval boundaries, round steps) into
an ordered tuple of :class:`Segment` s — train chunks [start, stop) with
the homogenization round that fires at a segment's start and an eval
flag at its end — exactly as the reference compiles them. The
reference's scenario events (churn, rewire, faults) and delayed gossip
are still to port (ROADMAP.md queue 1 items 11–12) and raise here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from repro_torch.configs.base import IDKDConfig


@dataclass(frozen=True)
class HomogenizeEvent:
    """Run one IDKD labeling round at ``step`` (before training resumes)."""
    step: int
    round_index: int = 0


@dataclass(frozen=True)
class Segment:
    """One train chunk [start, stop); ``events`` fire at ``start``;
    ``eval_after`` marks an eval boundary at ``stop``."""
    start: int
    stop: int
    events: Tuple[HomogenizeEvent, ...] = ()
    eval_after: bool = False

    @property
    def num_steps(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class Schedule:
    steps: int
    eval_every: int
    segments: Tuple[Segment, ...] = ()
    round_steps: Tuple[int, ...] = ()
    gossip: str = "sync"


def fit_every_k(steps: int, start: int, rounds: int) -> int:
    """The even ``every_k_steps`` spacing that fits ``rounds`` rounds into
    ``[start, steps)``: the CLI's default when it is given a round count
    without a period."""
    return max(1, (steps - start) // max(rounds, 1))


def idkd_round_steps(cfg: IDKDConfig, steps: int) -> Tuple[int, ...]:
    """``num_rounds`` rounds spaced ``every_k_steps`` apart from
    ``start_step``, clipped to the run length."""
    rounds = int(cfg.num_rounds)
    if rounds < 0:
        raise ValueError(f"IDKDConfig.num_rounds must be >= 0, got {rounds}")
    if rounds > 1 and cfg.every_k_steps <= 0:
        raise ValueError(
            f"IDKDConfig.num_rounds={rounds} needs every_k_steps > 0 "
            f"to space the rounds, got {cfg.every_k_steps}")
    if rounds == 0 or cfg.start_step < 0:
        return ()
    out = [cfg.start_step + j * cfg.every_k_steps for j in range(rounds)]
    return tuple(s for s in out if s < steps)


def compile_schedule(steps: int, eval_every: int, *,
                     round_steps: Sequence[int] = (),
                     events: Sequence = (),
                     gossip: str = "sync") -> Schedule:
    """Cuts fall at 0/steps, after every eval step, and at every
    homogenization round; a segment's ``eval_after`` follows the
    ``last % eval_every == 0 or last == steps - 1`` rule."""
    if events:
        raise NotImplementedError(
            "churn, rewire and fault events are not ported yet; see "
            "ROADMAP.md queue 1 items 11 and 12")
    if gossip != "sync":
        raise NotImplementedError(
            f"gossip={gossip!r} is not ported yet (only 'sync'); see "
            "ROADMAP.md queue 1 item 12")
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if eval_every <= 0:
        raise ValueError(f"eval_every must be positive, got {eval_every}")
    rounds = sorted(set(int(s) for s in round_steps))
    for s in rounds:
        if not 0 <= s < steps:
            raise ValueError(f"round step {s} outside [0, {steps})")

    from repro_torch.core.driver import eval_boundaries
    cuts = {0} | {b for _, b in eval_boundaries(steps, eval_every)}
    cuts |= set(rounds)
    edges = sorted(cuts)
    by_step = {s: (HomogenizeEvent(s, round_index=i),)
               for i, s in enumerate(rounds)}
    segments = tuple(
        Segment(start=a, stop=b, events=by_step.get(a, ()),
                eval_after=((b - 1) % eval_every == 0 or b == steps))
        for a, b in zip(edges[:-1], edges[1:]))
    return Schedule(steps=steps, eval_every=eval_every, segments=segments,
                    round_steps=tuple(rounds), gossip=gossip)
