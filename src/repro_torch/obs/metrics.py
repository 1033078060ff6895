"""On-device metrics bus: a dict of tensors carried through the runner.

The metrics dict rides the host runner's carry next to params, is
updated on the device inside every step with no host sync, and is read
once at each segment boundary (:func:`summarize`). Layout (the
reference's ``repro.obs.metrics``, node-stacked):

  ``steps``        ()   int32 — steps accumulated since the last flush
  ``loss_sum``     (n,) f32   — per-node train-loss sum (mean at flush)
  ``grad_sq_sum``  (n,) f32   — per-node squared grad-norm sum
  ``consensus_sq`` (n,) f32   — ‖x_i − x̄‖² after the latest update
  ``ef_sq``        (n,) f32   — ‖x_i − x̂_i‖² error-feedback residual
                                of a stateful mixer (``ef_ref``; zeros
                                without one)

``consensus_sq`` and ``ef_sq`` are latest-step snapshots; the sums are
averaged at flush. ``sqrt(sum(consensus_sq))`` equals
``mixing.consensus_distance(params)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import resolve_device

METRIC_FIELDS = ("loss_sum", "grad_sq_sum", "consensus_sq", "ef_sq")
CHUNK = 1 << 26   # elements of a leaf whose f32 temporaries live at once


def init_node_metrics(n: int, device="cuda"):
    """Zeroed metrics dict for ``n`` nodes on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return {"steps": torch.zeros((), dtype=torch.int32, device=device),
            "loss_sum": z, "grad_sq_sum": z.clone(),
            "consensus_sq": z.clone(), "ef_sq": z.clone()}


def _blocks(x):
    """Column blocks of a (rows, ...) leaf as (rows, flat) views of at
    most CHUNK elements each: the sums' f32 temporaries stay that wide
    (a layer-stacked Hymba-1.5B leaf is 4 x 282 M elements)."""
    xr = x.reshape(x.shape[0], -1)
    per = max(1, CHUNK // max(xr.shape[0], 1))
    return [xr[:, a:a + per] for a in range(0, xr.shape[1], per)]


def _rows_sq(x, ref=None) -> torch.Tensor:
    """(rows,) Σ (x − ref)² per leading row, in f32, block by block
    (``ref`` row-congruent with ``x``; None: 0)."""
    total = None
    pairs = zip(_blocks(x), _blocks(ref) if ref is not None
                else [None] * len(_blocks(x)))
    for xb, rb in pairs:
        d = xb.float() if rb is None else xb.float() - rb.float()
        part = torch.sum(d * d, dim=1)
        total = part if total is None else total + part
    return total


def consensus_rows(params, shard=None) -> torch.Tensor:
    """(n,) ‖x_i − x̄‖² per node of node-stacked params. Under the
    sharded driver (``shard``, a ``launch.sharding.ShardReduce``) the
    params are one rank's block: the node mean is summed over the node
    group and model-sharded leaves' rows over the model group."""
    keys = sorted(params)                      # the reference's leaf order
    if shard is not None:
        means = shard.node_means({k: params[k].float() for k in keys})
        return shard.rows({k: _rows_sq(params[k].float() - means[k])
                           for k in keys})
    cons = None
    for k in keys:
        for xb in _blocks(params[k]):
            xf = xb.float()
            d = xf - xf.mean(dim=0, keepdim=True)
            c = torch.sum(d * d, dim=1)
            cons = c if cons is None else cons + c
    return cons


def update(metrics, losses, grads, params, *, ef_ref=None, shard=None):
    """One metrics-bus step on node-stacked dicts; reads only, no host
    sync. ``ef_ref`` (the mixer's shared estimate x̂, congruent with
    ``params``) fills ``ef_sq``; None leaves it zero. ``shard`` (a
    ``launch.sharding.ShardReduce``): the dicts and the carry are one
    rank's node block, and the per-node sums are completed over the
    mesh as the reference's ``model_dims`` split does."""
    keys = sorted(params)                      # the reference's leaf order
    if shard is not None:
        grad_sq = shard.rows({k: _rows_sq(grads[k]) for k in keys})
    else:
        grad_sq = sum(_rows_sq(grads[k]) for k in keys)
    cons = consensus_rows(params, shard)
    if ef_ref is not None:
        # x̂ leaves are (rows, flat) for compressed wires, params-shaped
        # for the uncompressed state
        ef = {k: _rows_sq(params[k], ef_ref[k]) for k in keys}
        ef_sq = shard.rows(ef) if shard is not None else sum(ef.values())
    else:
        ef_sq = torch.zeros_like(metrics["ef_sq"])
    return {"steps": metrics["steps"] + 1,
            "loss_sum": metrics["loss_sum"] + losses.float(),
            "grad_sq_sum": metrics["grad_sq_sum"] + grad_sq,
            "consensus_sq": cons, "ef_sq": ef_sq}


def reset(metrics):
    """Zeroed accumulators of the same structure and placement."""
    return {k: torch.zeros_like(v) for k, v in metrics.items()}


def summarize(metrics) -> dict:
    """Host-side flush, one device-to-host copy: per-node ``loss``,
    ``grad_norm``, ``consensus`` and ``ef_residual`` lists plus
    ``consensus_total`` = ‖X − 1x̄ᵀ‖_F."""
    n = metrics["loss_sum"].shape[0]
    flat = torch.cat([metrics["steps"].double().reshape(1)]
                     + [metrics[k].double() for k in METRIC_FIELDS]
                     ).cpu().numpy()
    steps_raw = int(flat[0])
    loss_sum, grad_sq, cons_sq, ef_sq = flat[1:].reshape(4, n)
    steps = max(steps_raw, 1)
    cons_sq = np.maximum(cons_sq, 0.0)
    ef_sq = np.maximum(ef_sq, 0.0)
    return {
        "accum_steps": steps_raw,
        "loss": [float(v) for v in loss_sum / steps],
        "grad_norm": [float(v) for v in np.sqrt(grad_sq / steps)],
        "consensus": [float(v) for v in np.sqrt(cons_sq)],
        "consensus_total": float(np.sqrt(cons_sq.sum())),
        "ef_residual": [float(v) for v in np.sqrt(ef_sq)],
    }
