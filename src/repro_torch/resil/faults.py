"""Deterministic wire-fault injection and receive-side payload validation
(the reference's ``repro.resil.faults``).

Faults are per-segment static: the schedule compiler cuts a segment
boundary at every ``FaultEvent`` step, so within one runner call the
fault state is a constant — injection is a mixer wrapper, never a
step-dependent branch. A :class:`WireFault` is that state, frozen and
hashable (part of the scheduler's mixer cache keys).

``drop``
    The listed senders' payloads never arrive; receivers fall back to
    self-weight through the masked Metropolis matrix ``W_eff``.
``corrupt``
    The listed senders' payloads are corrupted in flight (``nan`` /
    ``inf``, or ``bitflip``: an XOR of f32 exponent bit 30 through an
    int32 view, which makes small values huge). With receive-side
    validation (the default) a corrupted payload fails the
    finite-and-bounded check and is treated exactly as dropped, so
    detected-corrupt and drop runs are bitwise equal. With
    ``GuardSpec.validate_wire=False`` nan/inf reach the receivers.
``crash``
    The process dies mid-run (:class:`SimulatedCrash`); recovery is the
    durable-snapshot auto-resume, not the mixer.

Without a fault the mixers come back unwrapped, so fault-free runs are
bitwise untouched. Whether a leaf's payloads are all valid is a device
value: the wrapper computes the base mix and the degraded mix and
selects with ``torch.where``, so that no host sync enters a step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

FAULT_KINDS = ("drop", "corrupt", "crash", "clear")
CORRUPT_MODES = ("nan", "inf", "bitflip")
# receive-side payload magnitude bound: larger (or non-finite) fails
DEFAULT_MAX_ABS = 1e8


@dataclass(frozen=True)
class WireFault:
    """Static wire-fault state of one schedule segment: ``drop`` and
    ``corrupt`` sender node indices and the corruption ``mode``."""
    drop: Tuple[int, ...] = ()
    corrupt: Tuple[int, ...] = ()
    mode: str = "nan"

    def __post_init__(self):
        object.__setattr__(self, "drop", tuple(sorted(set(self.drop))))
        object.__setattr__(self, "corrupt",
                           tuple(sorted(set(self.corrupt))))
        if self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}; "
                             f"expected one of {CORRUPT_MODES}")

    @property
    def senders(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.drop) | set(self.corrupt)))

    def is_noop(self) -> bool:
        return not self.drop and not self.corrupt


class SimulatedCrash(RuntimeError):
    """A ``FaultEvent(kind="crash")`` fired: the run dies here. Recovery
    is a fresh call with the same snapshot directory, which resumes from
    the newest durable snapshot."""

    def __init__(self, step: int):
        super().__init__(f"simulated crash at step {step}")
        self.step = step


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row vector broadcast over a (rows, ...) tensor."""
    return v.reshape(v.shape[:1] + (1,) * (ndim - 1))


def corrupt_values(xf: torch.Tensor, mode: str) -> torch.Tensor:
    """A fully corrupted f32 copy of ``xf`` (callers mask rows in)."""
    if mode == "nan":
        return torch.full_like(xf, float("nan"))
    if mode == "inf":
        return torch.full_like(xf, float("inf"))
    if mode == "bitflip":
        return (xf.contiguous().view(torch.int32) ^ (1 << 30)).view(
            torch.float32)
    raise ValueError(f"unknown corruption mode {mode!r}; expected one of "
                     f"{CORRUPT_MODES}")


def corrupt_rows(x: torch.Tensor, rows, mode: str) -> torch.Tensor:
    """``mode`` corruption on the leading-axis rows that the (rows,) bool
    mask ``rows`` marks (f32)."""
    xf = x.float()
    r = torch.as_tensor(rows, dtype=torch.bool, device=xf.device)
    return torch.where(_col(r, xf.dim()), corrupt_values(xf, mode), xf)


def payload_valid(x: torch.Tensor, max_abs: float = DEFAULT_MAX_ABS
                  ) -> torch.Tensor:
    """(rows,) bool — each row entirely finite and within ``max_abs``."""
    flat = x.float().reshape(x.shape[0], -1)
    return torch.all(torch.isfinite(flat) & (flat.abs() <= max_abs), dim=1)


def make_validated_mixer(base, W, fault: Optional[WireFault] = None, *,
                         max_abs: float = DEFAULT_MAX_ABS,
                         validate: bool = True, device="cpu"):
    """Wrap a node-stacked mixer with fault injection and receive-side
    payload validation.

    ``W`` is the (masked) Metropolis matrix the base mixer applies. Per
    leaf: corruption is injected into the senders' wire rows, every
    sender's wire payload is validated, and where any payload fails — or
    is dropped — the mix is a degraded dense pass with ``W_eff``: the
    invalid senders' off-diagonal columns zeroed and their mass returned
    to each receiver's self-weight. The degraded pass reads the clean
    ``x``, which is why detected-corrupt ≡ drop holds bitwise; the
    all-valid case is the base mixer's output untouched.

    With ``validate=False`` nan/inf corruption propagates: every receiver
    with a corrupted in-neighbour gets a fully poisoned row. ``bitflip``
    without validation is refused, as in the reference.

    The wrapper carries ``wire_check(tree) -> (n,) bool``: the senders
    whose actual wire values fail validation on any leaf (drop is a
    network fault and excluded), which the guard uses for sender
    attribution."""
    Wnp = np.asarray(W, np.float64)
    n = Wnp.shape[0]
    Wt = torch.as_tensor(Wnp, dtype=torch.float32, device=device)
    eye = torch.eye(n, dtype=torch.float32, device=device)
    drop_np = np.zeros(n, bool)
    corrupt_np = np.zeros(n, bool)
    mode = "nan"
    if fault is not None:
        drop_np[list(fault.drop)] = True
        corrupt_np[list(fault.corrupt)] = True
        mode = fault.mode
    drop_t = torch.as_tensor(drop_np, device=device)
    keep_t = ~drop_t
    has_drop = bool(drop_np.any())
    has_corrupt = bool(corrupt_np.any())
    corrupt_t = torch.as_tensor(corrupt_np, device=device)
    if not validate and has_corrupt and mode == "bitflip":
        raise ValueError(
            "bitflip wire corruption requires receive-side validation "
            "(GuardSpec.validate_wire=True): its finite values cannot "
            "propagate exactly through the masked mixing path")

    def wire_rows(xf):
        """The f32 values each sender puts on the wire."""
        if has_corrupt:
            return torch.where(_col(corrupt_t, xf.dim()),
                               corrupt_values(xf, mode), xf)
        return xf

    def _degraded(xf, valid):
        mask = valid.float()[None, :] * (1.0 - eye) + eye
        W_eff = Wt * mask
        W_eff = W_eff + torch.diag(1.0 - W_eff.sum(dim=1))
        return (W_eff @ xf.reshape(n, -1)).reshape(xf.shape)

    if validate:
        def mix_leaf(x):
            xf = x.float()
            valid = payload_valid(wire_rows(xf), max_abs) & keep_t
            degraded = _degraded(xf, valid).to(x.dtype)
            if has_drop:                # never all valid
                return degraded
            return torch.where(valid.all(), base.mix_leaf(x), degraded)
    else:
        affected_np = ((Wnp * (1.0 - np.eye(n)))
                       @ corrupt_np.astype(np.float64)) > 0
        affected_t = torch.as_tensor(affected_np, device=device)
        bad = float("nan") if mode == "nan" else float("inf")

        def mix_leaf(x):
            if has_drop:
                y = _degraded(x.float(), keep_t).to(x.dtype)
            else:
                y = base.mix_leaf(x)
            if has_corrupt:
                y = torch.where(_col(affected_t, y.dim()),
                                torch.full_like(y, bad), y)
            return y

    def wire_check(tree) -> torch.Tensor:
        flags = torch.zeros((n,), dtype=torch.bool, device=device)
        for x in tree.values():
            flags = flags | ~payload_valid(wire_rows(x.float()), max_abs)
        return flags

    def mix(tree):
        return {k: mix_leaf(v) for k, v in tree.items()}

    mix.mix_leaf = mix_leaf
    mix.wire_check = wire_check
    mix.wire_fault = fault
    return mix
