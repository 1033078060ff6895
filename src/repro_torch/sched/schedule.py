"""Federation schedule compiler: the outer loop of a run as segments.

:func:`compile_schedule` turns (steps, eval boundaries, round steps,
events) into an ordered tuple of :class:`Segment` s — train chunks
[start, stop) with the events that fire at a segment's start and an eval
flag at its end — exactly as the reference (``repro.sched.schedule``)
compiles them. Events make the federation dynamic: nodes leaving and
rejoining (:class:`ChurnEvent`), the gossip graph rewired
(:class:`RewireEvent`), and wire drops, corruption and crashes
(:class:`FaultEvent`). Topology events at a step fire before the
homogenization round of that step, so a round always runs on the graph
that is current at its step. ``ChurnEvent(mode="stale")`` marks
stragglers whose outgoing payload freezes, and ``gossip="delayed"``
mixes the previous step's payload: both run on the stateful gossip
mixers (``core.mixing``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

from repro_torch.configs.base import IDKDConfig
from repro_torch.core.topology import Topology
from repro_torch.resil.faults import CORRUPT_MODES, FAULT_KINDS

CHURN_MODES = ("freeze", "isolate", "stale")
GOSSIP_MODES = ("sync", "delayed")


@dataclass(frozen=True)
class HomogenizeEvent:
    """Run one IDKD labeling round at ``step`` (before training resumes)."""
    step: int
    round_index: int = 0


@dataclass(frozen=True)
class ChurnEvent:
    """Node availability change at ``step``: ``down`` nodes leave, ``up``
    nodes rejoin. ``mode="freeze"``: a down node neither trains nor
    gossips (its params and optimizer state are held);
    ``mode="isolate"``: it keeps training locally but misses every
    gossip exchange; ``mode="stale"``: a slow node stays in the
    federation (trains, receives, keeps its Metropolis weights) but its
    outgoing payload is frozen at the last one it produced, so the
    neighbours mix a stale snapshot. A schedule with stale nodes runs
    the stateful gossip mixers from step 0 (the comm state keeps its
    structure across the run)."""
    step: int
    down: Tuple[int, ...] = ()
    up: Tuple[int, ...] = ()
    mode: str = "freeze"


@dataclass(frozen=True)
class RewireEvent:
    """Swap the gossip graph at ``step``: ``topology`` is a kind string
    (``Topology.make`` against the run's node count) or a
    :class:`Topology`."""
    step: int
    topology: Union[str, Topology] = "ring"


@dataclass(frozen=True)
class FaultEvent:
    """Deterministic fault at ``step``: ``kind="drop"`` loses the listed
    nodes' outgoing gossip payloads from this step on; ``"corrupt"``
    corrupts them in flight with ``mode`` (``nan`` / ``inf`` /
    ``bitflip``); ``"crash"`` kills the run here
    (``resil.SimulatedCrash``), recovered by auto-resume from the newest
    durable snapshot; ``"clear"`` ends the listed nodes' wire faults (no
    nodes: all of them). The compiler cuts a boundary at every fault
    step, so a segment's fault state is a constant."""
    step: int
    kind: str = "drop"
    nodes: Tuple[int, ...] = ()
    mode: str = "nan"


Event = Union[HomogenizeEvent, ChurnEvent, RewireEvent, FaultEvent]
_EVENT_TYPES = (HomogenizeEvent, ChurnEvent, RewireEvent, FaultEvent)


@dataclass(frozen=True)
class Segment:
    """One train chunk [start, stop); ``events`` fire at ``start``;
    ``eval_after`` marks an eval boundary at ``stop``."""
    start: int
    stop: int
    events: Tuple[Event, ...] = ()
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
    gossip: str = "sync"    # "sync" | "delayed" (one-step-stale mixing)

    @property
    def has_stale(self) -> bool:
        """Whether a churn event marks a node a stale straggler: the run
        then needs the stateful gossip mixers from step 0."""
        return any(isinstance(ev, ChurnEvent) and ev.mode == "stale"
                   for seg in self.segments for ev in seg.events)

    @property
    def has_faults(self) -> bool:
        return any(isinstance(ev, FaultEvent)
                   for seg in self.segments for ev in seg.events)

    def boundaries(self) -> List[Tuple[int, int]]:
        return [(s.start, s.stop) for s in self.segments]

    @property
    def num_rounds(self) -> int:
        return len(self.round_steps)

    def validate_resume(self, step: int, with_ctx: bool = False) -> None:
        """Resume is legal at step 0 or at a segment start; after a
        round, only at a round step — unless ``with_ctx`` (a durable
        snapshot carries the homogenization ctx itself), which makes any
        segment boundary resumable."""
        if step == 0:
            return
        starts = {s.start for s in self.segments}
        if step not in starts:
            raise ValueError(
                f"cannot resume at step {step}: not a segment boundary "
                f"(boundaries: {sorted(starts)})")
        if not with_ctx and any(r < step for r in self.round_steps) and \
                step not in self.round_steps:
            raise ValueError(
                f"cannot resume at step {step}: a homogenization round "
                f"fired earlier ({[r for r in self.round_steps if r < step]}) "
                "and its sampler state is not part of the checkpoint; "
                "resume at a round boundary instead "
                f"(rounds: {list(self.round_steps)})")


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


def _validate_events(events: Sequence[Event], steps: int) -> List[Event]:
    out = []
    for ev in events:
        if not isinstance(ev, _EVENT_TYPES):
            raise TypeError(
                f"unknown schedule event {ev!r}; expected one of "
                f"{[t.__name__ for t in _EVENT_TYPES]}")
        if isinstance(ev, HomogenizeEvent):
            raise ValueError(
                "pass homogenization rounds via round_steps=, not "
                "events=; HomogenizeEvents are compiled from round_steps "
                "so resume validation and the drivers' KD guards see them")
        if not 0 <= ev.step < steps:
            raise ValueError(f"event step {ev.step} outside [0, {steps})")
        if isinstance(ev, ChurnEvent):
            if ev.mode not in CHURN_MODES:
                raise ValueError(f"unknown churn mode {ev.mode!r}; "
                                 f"expected one of {CHURN_MODES}")
            if not ev.down and not ev.up:
                raise ValueError(f"churn event at step {ev.step} names no "
                                 "nodes (empty down and up)")
        if isinstance(ev, FaultEvent):
            if ev.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}; "
                                 f"expected one of {FAULT_KINDS}")
            if ev.mode not in CORRUPT_MODES:
                raise ValueError(f"unknown corruption mode {ev.mode!r}; "
                                 f"expected one of {CORRUPT_MODES}")
            if ev.kind in ("drop", "corrupt") and not ev.nodes:
                raise ValueError(f"{ev.kind} fault at step {ev.step} "
                                 "names no sender nodes")
        out.append(ev)
    return out


def compile_schedule(steps: int, eval_every: int, *,
                     round_steps: Sequence[int] = (),
                     events: Sequence[Event] = (),
                     gossip: str = "sync") -> Schedule:
    """Cuts fall at 0/steps, after every eval step, at every
    homogenization round and at every event step; each segment carries
    the events that fire at its start (churn, rewire and faults before
    the round of the same step) and an ``eval_after`` flag following the
    ``last % eval_every == 0 or last == steps - 1`` rule."""
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if eval_every <= 0:
        raise ValueError(f"eval_every must be positive, got {eval_every}")
    if gossip not in GOSSIP_MODES:
        raise ValueError(f"unknown gossip mode {gossip!r}; expected one "
                         f"of {GOSSIP_MODES}")
    rounds = sorted(set(int(s) for s in round_steps))
    for s in rounds:
        if not 0 <= s < steps:
            raise ValueError(f"round step {s} outside [0, {steps})")
    events = _validate_events(events, steps)

    from repro_torch.core.driver import eval_boundaries
    cuts = {0} | {b for _, b in eval_boundaries(steps, eval_every)}
    cuts |= set(rounds)
    cuts |= {ev.step for ev in events}
    edges = sorted(cuts)

    by_step: dict = {}
    for ev in events:                          # churn / rewire / faults first
        by_step.setdefault(ev.step, []).append(ev)
    for i, s in enumerate(rounds):             # then the label exchange
        by_step.setdefault(s, []).append(HomogenizeEvent(s, round_index=i))
    segments = tuple(
        Segment(start=a, stop=b, events=tuple(by_step.get(a, ())),
                eval_after=((b - 1) % eval_every == 0 or b == steps))
        for a, b in zip(edges[:-1], edges[1:]))
    return Schedule(steps=steps, eval_every=eval_every, segments=segments,
                    round_steps=tuple(rounds), gossip=gossip)


# ------------------------------------------------------------- CLI parsing
def parse_churn(spec: str, num_nodes: int, steps: int,
                mode: str = "freeze") -> List[ChurnEvent]:
    """Parse ``node@down-up[,node@down-up...]`` into paired down/up
    events, e.g. ``"3@120-180"``: node 3 leaves at step 120 and rejoins
    at 180 (omit ``-up`` to keep it down to the end)."""
    events: List[ChurnEvent] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            node_s, window = part.split("@")
            node = int(node_s)
            lo_s, _, hi_s = window.partition("-")
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else None
        except ValueError as e:
            raise ValueError(
                f"malformed churn spec {part!r}; expected node@down-up "
                "(e.g. '3@120-180' or '3@120')") from e
        if not 0 <= node < num_nodes:
            raise ValueError(f"churn node {node} outside [0, {num_nodes})")
        if not 0 <= lo < steps or (hi is not None and not lo < hi < steps):
            raise ValueError(f"churn window {part!r} outside the "
                             f"[0, {steps}) run")
        events.append(ChurnEvent(step=lo, down=(node,), mode=mode))
        if hi is not None:
            events.append(ChurnEvent(step=hi, up=(node,), mode=mode))
    return events


def parse_faults(spec: str, num_nodes: int, steps: int) -> List[FaultEvent]:
    """Parse ``kind@step[/nodes][/mode]`` (comma-separated; nodes joined
    with ``+``), e.g. ``"corrupt@8/2/nan,crash@14"``; ``clear@step``
    ends all wire faults."""
    events: List[FaultEvent] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            kind, _, rest = part.partition("@")
            fields = rest.split("/")
            step = int(fields[0])
            nodes = tuple(int(v) for v in fields[1].split("+")) \
                if len(fields) > 1 and fields[1] else ()
            mode = fields[2] if len(fields) > 2 else "nan"
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"malformed fault spec {part!r}; expected "
                "kind@step[/nodes][/mode] (e.g. 'corrupt@8/2/nan', "
                "'drop@5/0+3', 'crash@14')") from e
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; expected one "
                             f"of {FAULT_KINDS}")
        if not 0 <= step < steps:
            raise ValueError(f"fault step {step} outside [0, {steps})")
        for node in nodes:
            if not 0 <= node < num_nodes:
                raise ValueError(f"fault node {node} outside "
                                 f"[0, {num_nodes})")
        events.append(FaultEvent(step=step, kind=kind, nodes=nodes,
                                 mode=mode))
    return events
