"""Schema check of a run's telemetry files.

    PYTHONPATH=src python -m repro_torch.obs.check DIR [--require-trace]

Validates ``DIR/run.jsonl`` against :data:`repro_torch.obs.runlog.
EVENT_SCHEMA` and, when present (or with ``--require-trace``),
``DIR/trace.json`` against the Chrome trace_event shape. Exits non-zero
on a malformed file or a missing run log.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.obs import (RUNLOG_NAME, TRACE_NAME, validate_runlog,
                             validate_trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir", help="telemetry output directory")
    ap.add_argument("--require-trace", action="store_true",
                    help="fail when trace.json is absent")
    args = ap.parse_args(argv)

    out = Path(args.dir)
    runlog = out / RUNLOG_NAME
    if not runlog.exists():
        print(f"[obs.check] FAIL: {runlog} not found", file=sys.stderr)
        return 1
    try:
        counts = validate_runlog(runlog)
    except ValueError as e:
        print(f"[obs.check] FAIL: {e}", file=sys.stderr)
        return 1
    kinds = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"[obs.check] {runlog}: {sum(counts.values())} events OK "
          f"({kinds})")

    trace = out / TRACE_NAME
    if trace.exists():
        try:
            n = validate_trace(trace)
        except ValueError as e:
            print(f"[obs.check] FAIL: {e}", file=sys.stderr)
            return 1
        print(f"[obs.check] {trace}: {n} trace events OK")
    elif args.require_trace:
        print(f"[obs.check] FAIL: {trace} not found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
