"""On-device health guards: a dict of tensors carried through the runner
(the reference's ``repro.resil.guards``, node-stacked).

The guard rides the host runner's carry like the metrics bus: updated
on the device inside every step with no host sync, read once at each
segment boundary, where the scheduler turns counters into quarantine
and rollback decisions. Layout:

  ``steps``             ()   int32 — steps since the last flush
  ``loss_ema``          (n,) f32   — EMA of per-node train loss
  ``nonfinite_loss``    (n,) int32 — steps the node's loss was nan/inf
  ``nonfinite_grad``    (n,) int32 — steps any grad element was nan/inf
  ``nonfinite_param``   (n,) int32 — steps any param element was nan/inf
  ``loss_spike``        (n,) int32 — steps loss exceeded factor × EMA
  ``consensus_blowup``  (n,) int32 — steps ‖x_i − x̄‖ exceeded the bound
  ``wire_invalid``      (n,) int32 — steps the node's outgoing wire
                                     payload failed validation

Every check only reads the step's values, so a guard-on run without
faults is bitwise the guard-off run.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.runtime import resolve_device

from repro_torch.resil.faults import DEFAULT_MAX_ABS

GUARD_COUNTERS = ("nonfinite_loss", "nonfinite_grad", "nonfinite_param",
                  "loss_spike", "consensus_blowup", "wire_invalid")
# counters that indict the node's own health (wire_invalid attributes
# the sender of a bad payload instead)
OWN_HEALTH_COUNTERS = GUARD_COUNTERS[:-1]
_EMA_DECAY = 0.9


@dataclass(frozen=True)
class GuardSpec:
    """Static guard thresholds (hashable: part of the step cache keys).

    ``loss_spike_factor``/``consensus_max`` of 0 turn those checks off;
    non-finite detection is always on (params and grads gated by the
    ``check_*`` flags). ``max_abs`` bounds wire payload magnitudes;
    ``validate_wire=False`` turns the mixer's receive-side degradation
    off (injected corruption then propagates — the rollback path's test
    bed) while ``wire_check`` sender attribution keeps running."""
    loss_spike_factor: float = 0.0
    warmup_steps: int = 5
    consensus_max: float = 0.0
    check_grads: bool = True
    check_params: bool = True
    max_abs: float = DEFAULT_MAX_ABS
    validate_wire: bool = True


def init_node_guard(n: int, device="cuda"):
    """Zeroed guard dict for ``n`` nodes on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    g = {"steps": torch.zeros((), dtype=torch.int32, device=device),
         "loss_ema": torch.zeros((n,), dtype=torch.float32, device=device)}
    for k in GUARD_COUNTERS:
        g[k] = torch.zeros((n,), dtype=torch.int32, device=device)
    return g


def _row_bad(x: torch.Tensor) -> torch.Tensor:
    """(rows, ...) -> (rows,) bool: any non-finite element in the row."""
    return (~torch.isfinite(x.reshape(x.shape[0], -1))).any(dim=1)


def _bad_rows(tree, keys, shard):
    """(rows,) bool: any non-finite element in the node's leaves; under
    the sharded driver a model-sharded leaf's rows are completed over the
    model group."""
    if shard is not None:
        return shard.rows({k: _row_bad(tree[k]).float() for k in keys}) > 0
    bad = None
    for k in keys:
        b = _row_bad(tree[k])
        bad = b if bad is None else bad | b
    return bad


def update(guard, spec: GuardSpec, losses, grads, params, *,
           wire_invalid=None, shard=None):
    """One guard step on node-stacked dicts; reads only, no host sync.
    ``wire_invalid`` is the validated mixer's per-sender (n,) bool
    (None without fault injection). ``shard`` (a ``launch.sharding.
    ShardReduce``): the dicts and the carry are one rank's node block,
    with the reference's model-axis reduction split."""
    keys = sorted(params)                      # the reference's leaf order
    lf = losses.float()
    finite_loss = torch.isfinite(lf)
    none = torch.zeros_like(finite_loss)
    bad_grad = none
    if spec.check_grads:
        bad_grad = none | _bad_rows(grads, keys, shard)
    bad_param = none
    if spec.check_params:
        bad_param = none | _bad_rows(params, keys, shard)

    ema = guard["loss_ema"]
    if spec.loss_spike_factor > 0:
        warm = guard["steps"] >= spec.warmup_steps
        spike = (warm & finite_loss & (ema > 0)
                 & (lf > np.float32(spec.loss_spike_factor) * ema))
    else:
        spike = none
    safe_lf = torch.where(finite_loss, lf, ema)
    new_ema = torch.where(guard["steps"] == 0, safe_lf,
                          _EMA_DECAY * ema + (1.0 - _EMA_DECAY) * safe_lf)

    if spec.consensus_max > 0:
        from repro_torch.obs.metrics import consensus_rows
        cons = consensus_rows(params, shard)
        blowup = cons > np.float32(spec.consensus_max) ** 2
    else:
        blowup = none

    def bump(name, flag):
        return guard[name] + flag.to(torch.int32)

    out = {"steps": guard["steps"] + 1, "loss_ema": new_ema,
           "nonfinite_loss": bump("nonfinite_loss", ~finite_loss),
           "nonfinite_grad": bump("nonfinite_grad", bad_grad),
           "nonfinite_param": bump("nonfinite_param", bad_param),
           "loss_spike": bump("loss_spike", spike),
           "consensus_blowup": bump("consensus_blowup", blowup)}
    out["wire_invalid"] = (guard["wire_invalid"] if wire_invalid is None
                           else bump("wire_invalid", wire_invalid))
    return out


def reset(guard):
    """Zeroed accumulators of the same structure and placement."""
    return {k: torch.zeros_like(v) for k, v in guard.items()}


def summarize(guard) -> dict:
    """Host-side flush, one device-to-host copy: the counters as plain
    int lists, ``loss_ema`` as floats."""
    n = guard["loss_ema"].shape[0]
    names = ("loss_ema",) + GUARD_COUNTERS
    flat = torch.cat([guard["steps"].double().reshape(1)]
                     + [guard[k].double() for k in names]).cpu().numpy()
    rows = flat[1:].reshape(len(names), n)
    out = {"accum_steps": int(flat[0]),
           "loss_ema": [float(np.float32(v)) for v in rows[0]]}
    for k, row in zip(GUARD_COUNTERS, rows[1:]):
        out[k] = [int(v) for v in row]
    return out


def tripped_nodes(summary: dict) -> np.ndarray:
    """(n,) bool — nodes any own-health counter flagged this flush."""
    bad = np.zeros(len(summary["nonfinite_loss"]), bool)
    for k in OWN_HEALTH_COUNTERS:
        bad |= np.asarray(summary[k], np.int64) > 0
    return bad


def wire_offenders(summary: dict) -> np.ndarray:
    """(n,) bool — senders attributed by wire validation. Under
    propagation (validation off) poisoned victims start failing wire
    checks too, but strictly later than the offender, so only the
    max-count senders are indicted."""
    wire = np.asarray(summary["wire_invalid"], np.int64)
    if not (wire > 0).any():
        return np.zeros(wire.shape, bool)
    return wire == wire.max()
