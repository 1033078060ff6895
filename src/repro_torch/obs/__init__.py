"""Run telemetry: metrics bus, structured events and trace spans.

Three layers, all on with a :class:`Telemetry` and all off without one
(a run with ``telemetry=None`` runs exactly the code it ran before):

  1. **metrics bus** (:mod:`repro_torch.obs.metrics`) — a dict of device
     tensors carried through the runner, per-node loss / grad norm /
     consensus distance, no host sync inside a segment;
  2. **run events** (:mod:`repro_torch.obs.runlog`) — schema-checked
     JSONL (``run.jsonl``) of segments, churn, label rounds, ledger
     traffic, metric flushes, evals, faults and snapshots;
  3. **trace spans** (:mod:`repro_torch.obs.trace`) — Chrome trace_event
     JSON (``trace.json``) around scheduler phases, with an optional
     ``torch.profiler`` hand-off.

:class:`Telemetry` is the facade the simulator, the launch driver and
the tests hold; the scheduler calls only ``event``, ``span`` and
``flush_metrics`` on it. The layout and the event schema are the
reference's (``repro.obs``), so either package's checker reads the
other's files.
"""
from __future__ import annotations

from contextlib import nullcontext
from pathlib import Path
from typing import Optional

from repro_torch.obs import log  # noqa: F401 (re-export)
from repro_torch.obs.runlog import (EVENT_SCHEMA, RunLog, read_events,
                                    validate_runlog)
from repro_torch.obs.trace import (TraceRecorder, start_torch_profiler,
                                   stop_torch_profiler, validate_trace)

RUNLOG_NAME = "run.jsonl"
TRACE_NAME = "trace.json"


class Telemetry:
    """One run's telemetry sinks: ``out_dir/run.jsonl`` streams as the
    run goes (the metrics bus flushes into it), ``trace=True`` records
    spans that :meth:`close` writes to ``out_dir/trace.json``, and
    ``torch_profile=True`` runs ``torch.profiler`` over the run and
    writes its trace under ``out_dir/torch_profile``."""

    def __init__(self, out_dir, *, trace: bool = False,
                 torch_profile: bool = False, meta: Optional[dict] = None):
        self.out_dir = Path(out_dir)
        self.runlog = RunLog(self.out_dir / RUNLOG_NAME)
        self.tracer: Optional[TraceRecorder] = (TraceRecorder() if trace
                                                else None)
        self._profiling = False
        if meta:
            self.event("run_meta", **meta)
        if torch_profile:
            self._profiling = start_torch_profiler(
                self.out_dir / "torch_profile")

    def event(self, ev: str, **fields) -> None:
        self.runlog.emit(ev, **fields)

    def span(self, name: str, cat: str = "sched", **args):
        if self.tracer is not None:
            return self.tracer.span(name, cat, **args)
        return nullcontext()

    def flush_metrics(self, step: int, metrics, **extra) -> None:
        """Summarize the metrics dict (one device-to-host copy) into one
        ``metrics`` event."""
        if metrics is None:
            return
        from repro_torch.obs import metrics as obs_metrics
        self.event("metrics", step=step, **obs_metrics.summarize(metrics),
                   **extra)

    def close(self) -> None:
        if self._profiling:
            stop_torch_profiler()
            self._profiling = False
        if self.tracer is not None:
            self.tracer.export(self.out_dir / TRACE_NAME)
        self.runlog.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["Telemetry", "RunLog", "TraceRecorder", "EVENT_SCHEMA",
           "RUNLOG_NAME", "TRACE_NAME", "log", "read_events",
           "validate_runlog", "validate_trace", "start_torch_profiler",
           "stop_torch_profiler"]
