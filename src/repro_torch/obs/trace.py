"""Trace spans: Chrome ``trace_event`` JSON around scheduler phases.

A :class:`TraceRecorder` collects complete (``"ph": "X"``) spans with
microsecond wall-clock timestamps and exports the standard
``{"traceEvents": [...]}`` document that chrome://tracing and Perfetto
load. Spans wrap the scheduler's segments, label rounds, evals and
snapshots; a segment that built a fresh runner is tagged
``compile=True``, as the reference tags its compiles (the port builds
closures, not executables, so such a span costs what any other does).

For device-level detail :func:`start_torch_profiler` hands off to
``torch.profiler`` (the port's counterpart of the reference's
``start_jax_profiler``): a Chrome trace of host and CUDA activity,
written by :func:`stop_torch_profiler`. The hand-off is best-effort and
never fails a run.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional


class TraceRecorder:
    """In-memory span recorder exporting Chrome trace_event JSON."""

    def __init__(self, pid: int = 0):
        self.pid = pid if pid else os.getpid()
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextmanager
    def span(self, name: str, cat: str = "sched", **args):
        start = self._now_us()
        try:
            yield self
        finally:
            end = self._now_us()
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": round(start, 3), "dur": round(end - start, 3),
                "pid": self.pid, "tid": 0,
                "args": {k: _arg(v) for k, v in args.items()},
            })

    def export(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events, "displayTimeUnit": "ms"},
                      f)
        return path


def _arg(v: Any) -> Any:
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (int, float, bool, str)) or v is None:
        return v
    return str(v)


def validate_trace(path) -> int:
    """Check a trace JSON is Perfetto-loadable; returns the event count:
    a ``traceEvents`` list whose entries carry ``name``/``ph``/``ts``/
    ``pid`` (and ``dur`` for complete events)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    for i, ev in enumerate(events):
        for k in ("name", "ph", "ts", "pid"):
            if k not in ev:
                raise ValueError(f"{path}: traceEvents[{i}] missing {k!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"{path}: traceEvents[{i}] complete event "
                             f"without dur")
    if not events:
        raise ValueError(f"{path}: empty trace")
    return len(events)


_profiler: Optional[Any] = None
_profile_dir: Optional[Path] = None
PROFILE_NAME = "torch_trace.json"


def start_torch_profiler(log_dir) -> bool:
    """Best-effort ``torch.profiler`` start (host and, when there is a
    card, CUDA activity); :func:`stop_torch_profiler` writes
    ``log_dir/torch_trace.json``. Returns whether it started."""
    global _profiler, _profile_dir
    try:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception:
        return False
    _profiler, _profile_dir = prof, Path(log_dir)
    return True


def stop_torch_profiler() -> None:
    global _profiler, _profile_dir
    prof, out = _profiler, _profile_dir
    _profiler = _profile_dir = None
    if prof is None:
        return
    try:
        prof.stop()
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / PROFILE_NAME))
    except Exception:
        pass
