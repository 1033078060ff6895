"""Structured run events: append-only JSONL with a checked schema.

Every scheduler-visible occurrence of a run (segments, churn and rewire,
label rounds, ledger traffic, metric flushes, evals, faults, guard
trips, snapshots, resumes) is one JSON object per line of ``run.jsonl``.
:data:`EVENT_SCHEMA` is the reference's (``repro.obs.runlog``) kind for
kind and field for field, so the reference's ``python -m
repro.obs.check`` accepts the port's run logs, and
:func:`validate_runlog` is the port's own check.
"""
from __future__ import annotations

import json
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, Optional

# kind -> required field names (beyond "ev" and "t"); extra fields are
# always allowed
EVENT_SCHEMA: Dict[str, tuple] = {
    "run_meta": (),                              # free-form run header
    "schedule": ("segments", "steps"),           # compiled schedule shape
    "segment": ("index", "start", "stop"),       # one runner invocation
    "topology": ("step", "active"),              # churn / rewire
    "round": ("round", "step"),                  # homogenization fired
    "labels": ("round", "step"),                 # label-round statistics
    "comm": ("kind", "round", "per_node"),       # ledger row (gossip/labels)
    "metrics": ("step", "loss", "consensus"),    # metrics-bus flush
    "eval": ("step",),                           # scheduler eval boundary
    "accuracy": ("step",),                       # host-side eval metrics
    "fault": ("step", "kind"),                   # injected fault state change
    "health": ("step",),                         # guard trip / quarantine /
                                                 #   non-finite eval
    "rollback": ("step", "retry"),               # segment re-run after a trip
    "snapshot": ("step",),                       # durable snapshot written
    "resume": ("step",),                         # auto-resume from snapshot
    "run_end": (),                               # run summary footer
}


def _jsonable(v: Any) -> Any:
    """Plain JSON values from numpy / torch scalars and arrays."""
    if hasattr(v, "tolist"):                     # np.ndarray, torch.Tensor
        return v.tolist()
    if hasattr(v, "item") and not isinstance(v, (int, float, bool, str)):
        return v.item()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, Path):
        return str(v)
    return v


class RunLog:
    """Append-only JSONL event stream (line-buffered; valid mid-run)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.perf_counter()

    def emit(self, ev: str, **fields) -> None:
        if ev not in EVENT_SCHEMA:
            raise ValueError(f"unknown run-log event kind {ev!r}; "
                             f"add it to EVENT_SCHEMA")
        missing = [k for k in EVENT_SCHEMA[ev] if k not in fields]
        if missing:
            raise ValueError(f"event {ev!r} missing required fields "
                             f"{missing}")
        rec = {"ev": ev, "t": round(time.perf_counter() - self._t0, 6)}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def validate_runlog(path) -> Counter:
    """Parse and schema-check a run.jsonl; returns a Counter of kinds.
    Raises ``ValueError`` on bad JSON, unknown kinds, missing fields or
    an empty log."""
    counts: Counter = Counter()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad JSON: {e}") from e
            ev = rec.get("ev")
            if ev not in EVENT_SCHEMA:
                raise ValueError(f"{path}:{lineno}: unknown event {ev!r}")
            if "t" not in rec:
                raise ValueError(f"{path}:{lineno}: missing timestamp 't'")
            missing = [k for k in EVENT_SCHEMA[ev] if k not in rec]
            if missing:
                raise ValueError(f"{path}:{lineno}: event {ev!r} missing "
                                 f"required fields {missing}")
            counts[ev] += 1
    if not counts:
        raise ValueError(f"{path}: empty run log")
    return counts


def read_events(path, kind: Optional[str] = None):
    """All events (optionally of one kind) as a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("ev") == kind:
                out.append(rec)
    return out
