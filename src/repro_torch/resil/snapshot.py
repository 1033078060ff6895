"""Durable on-disk snapshots: periodic checkpoints with a schema version
and a checksum, newest-valid auto-resume, and pruning (the reference's
``repro.resil.snapshot``).

A snapshot holds what a segment boundary needs to continue the run
exactly: params, optimizer state, the samplers' generator state, the
homogenization context (the KD sampler's flat str→array payload) and
the phase. State rides :func:`repro_torch.checkpoint.save_checkpoint`;
the ctx, whose shapes depend on the round, rides a sibling npz whose
checksum the snapshot's meta records.

**Deliberate difference.** Where the reference stores a JAX PRNG key,
the port stores its samplers' ``torch.Generator`` state
(``Generator.get_state()``, a uint8 tensor) under the same ``"key"``
entry, and a resumed run sets it back with ``set_state``: the draws
after a resume are the ones the uninterrupted run makes.

``load_latest`` scans newest to oldest and skips, with a logged warning,
any snapshot that fails validation (version skew, checksum mismatch, a
truncated or half-written file, a structure mismatch): a file cut short
by a crash costs one snapshot interval of recompute, never the resume.
A truncated npz is caught whatever numpy raises for it (the reference
catches the errors of a file of garbage but not a cut-short zip's).
"""
from __future__ import annotations

import json
import os
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.checkpoint import (checkpoint_checksum, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpoint import to_numpy
from repro_torch.obs import log
from repro_torch.resil.guards import GuardSpec

_UNREADABLE = (ValueError, OSError, KeyError, EOFError,
               json.JSONDecodeError, zipfile.BadZipFile)


@dataclass(frozen=True)
class Resilience:
    """Run-level resilience configuration.

    ``guard`` turns the on-device health guard on; ``snapshot_dir``
    turns durable snapshots on, every ``snapshot_every`` steps (0 = at
    every segment boundary), keeping the newest ``keep``; ``rollback``
    turns a guard trip into restore-and-rerun with the offender
    quarantined (at most ``max_retries`` times a segment)."""
    guard: Optional[GuardSpec] = None
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0
    keep: int = 3
    rollback: bool = False
    max_retries: int = 2

    @property
    def snapshots_on(self) -> bool:
        return self.snapshot_dir is not None


class SnapshotManager:
    """Writes, prunes and loads ``snap-<step>`` snapshots in a dir."""

    def __init__(self, directory, every: int = 0, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = int(every)
        self.keep = max(int(keep), 1)
        self._last: Optional[int] = None

    def _base(self, step: int) -> str:
        return str(self.dir / f"snap-{step:08d}")

    def steps(self):
        """Snapshot steps on disk, ascending."""
        out = []
        for p in self.dir.glob("snap-*.meta.json"):
            try:
                out.append(int(p.name[len("snap-"):-len(".meta.json")]))
            except ValueError:
                continue
        return sorted(out)

    def due(self, step: int) -> bool:
        if self._last is None or self.every <= 0:
            return True
        return step - self._last >= self.every

    # A simulated crash kills the run once; the resumed run must pass
    # through that step. The tombstone makes "once" survive the restart.
    def crash_seen(self, step: int) -> bool:
        return (self.dir / f"crash-{step:08d}.tomb").exists()

    def mark_crash(self, step: int) -> None:
        (self.dir / f"crash-{step:08d}.tomb").touch()

    def save(self, step: int, state, *, ctx=None, phase: str = "plain",
             fired: int = 0) -> None:
        """Persist one snapshot: ``state`` the checkpointable tree
        (params / opt_state / key), ``ctx`` the flat str→array
        homogenization payload (None before the first round)."""
        extra = {"phase": phase, "fired": int(fired), "has_ctx": False}
        if ctx is not None:
            flat = {k: to_numpy(v) for k, v in ctx.items()}
            np.savez(self._base(step) + ".ctx.npz", **flat)
            extra.update(has_ctx=True,
                         ctx_checksum=checkpoint_checksum(flat))
        save_checkpoint(self._base(step), state, step=step, extra=extra)
        self._last = step
        self._prune()

    def _prune(self) -> None:
        for step in self.steps()[:-self.keep]:
            base = self._base(step)
            for suffix in (".npz", ".meta.json", ".ctx.npz"):
                try:
                    os.unlink(base + suffix)
                except FileNotFoundError:
                    pass

    def load_latest(self, like) -> Optional[dict]:
        """The newest snapshot that validates, restored into ``like``'s
        structure, or None: ``{"state", "step", "phase", "fired",
        "ctx"}``."""
        for step in reversed(self.steps()):
            base = self._base(step)
            try:
                state, saved_step = load_checkpoint(base, like)
                with open(base + ".meta.json") as f:
                    extra = json.load(f).get("extra", {})
                ctx = None
                if extra.get("has_ctx"):
                    npz = np.load(base + ".ctx.npz")
                    ctx = {k: npz[k] for k in npz.files}
                    crc = checkpoint_checksum(ctx)
                    if extra.get("ctx_checksum") != crc:
                        raise ValueError(
                            f"snapshot ctx checksum mismatch at step "
                            f"{step}: meta {extra.get('ctx_checksum')!r}"
                            f" != arrays {crc}")
                self._last = saved_step
                return {"state": state, "step": saved_step,
                        "phase": extra.get("phase", "plain"),
                        "fired": int(extra.get("fired", 0)), "ctx": ctx}
            except _UNREADABLE as e:
                log.warning("snapshot_invalid", step=step, error=str(e))
        return None
