"""The dry run: every (arch × shape × mesh) sized on the meta device
(``src/repro/launch/dryrun.py``).

The reference lowers and compiles each combination with XLA over 256 or
512 forced host devices and reads the compiler's memory and cost
analyses and the HLO's collectives. The port has no partitioner: its dry
run traces one step on the ``meta`` device — shapes and dtypes flow
through every op, nothing is allocated or computed — and sizes the
mesh's shards by the reference's rules (``launch.sharding``). For each
combination it writes a JSON record under ``--out`` with the
reference's keys:

* ``status``: "skipped" with the reference's reason where
  ``shape_supported`` says so (a full-attention arch at 524k context),
  else "ok";
* ``memory_analysis``, bytes per device:
  ``argument_bytes`` / ``output_bytes``, the sum over the step's inputs
  / outputs of one device's shard (``sharding.shard_shape``) — a train
  step's node-stacked params, its optimizer state (``init_opt`` of the
  port's ``make_train_step``), batch and lr (one f32) in, params,
  optimizer state and the loss out; a prefill's params and batch in, its
  logits out; a decode step's params, tokens, state (and conditioning)
  in, logits and state out. Token ids, cache positions and lengths are
  int64 (8 B where the reference's int32 are 4). ``alias_bytes`` is 0:
  the reference donates no buffer. ``temp_bytes`` is an estimate, where
  XLA's is the partitioner's own: the peak of the intermediates live
  during one trace of the step (each op's result storage added when made
  and taken off when it dies), for one node at its per-node batch (a
  train step) or the whole request batch (serving), divided over the
  devices that hold it;
* ``hlo_flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
  over that trace (the products: matmuls, batched matmuls,
  convolutions), divided the same way; ``hlo_bytes_per_device``: each
  traced op's operand and result bytes summed, as XLA's "bytes accessed"
  sums an instruction's, views (which XLA lays out for free) left out;
* ``model_flops_total``, ``model_flops_per_device``,
  ``useful_flop_ratio``: the reference's 6 (train) or 2 · active params
  · tokens;
* ``collectives``: the reference's five kinds with ``count`` and
  ``total``, each the bytes one device hands to the port's wire in one
  step (``launch.dist``'s counter counts the same way): a train step's
  ring gossip over the node axes (``collective-permute``: the first and
  last rows of the device's node block, every leaf, at the ledger's
  ``wire_elem_bytes`` — twice the shard at one node a device), the
  all-gathers that bring every leaf cut beyond the node axes to full
  width (``all-gather``: the device's shard once; model-sharded leaves,
  and data-sharded ones too in pod scope), and the loss's and
  QG-DSGDm-N's grad norm's scalar all-reduces, as
  ``launch.sharding.ShardReduce`` makes them; a serving step's
  all-gathers of the sharded weights, once a step;
* ``compute_s``, ``memory_s``, ``collective_s``, ``dominant``: the
  FLOPs, bytes and collective bytes over ``launch.mesh``'s H100
  constants (collectives at the NVLink rate: an axis wider than one
  8-card NVLink domain would cross the network, which is not modelled);
* ``n_chips`` (the mesh's size), ``lower_s`` (the trace's seconds; a
  trace is made once a process for each config, shape and per-node
  batch, so the two meshes of a serving shape share one), ``compile_s``
  0.0. No HLO is written.

**What the trace counts.** On meta the kernels' plain versions run (the
kernels launch only on the card), so ``temp_bytes`` and the FLOPs are
those of the plain versions: the plain attention's (B, S, heads, 512)
score chunks, every key chunk of a causal row computed and masked; the
plain SSD scan's chunked einsums. A layer under per-layer recompute is
traced twice in a train step, as the card runs it.

``sharded_out=True`` pins GSPMD's residual-stream layout in the
reference; the port has no partitioner to pin, and it raises.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import weakref
from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_supported)
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import sharding as shd
from repro_torch.launch.dist import KINDS
from repro_torch.launch.mesh import (HBM_BANDWIDTH, LINK_BANDWIDTH,
                                     PEAK_FLOPS_BF16, make_production_mesh,
                                     node_axes_for, num_nodes)
from repro_torch.obs import log

META = torch.device("meta")
LR_BYTES = 4            # the train step's lr, one f32
LOSS_BYTES = 4          # the train step's mean loss, one f32
SCALAR_BYTES = 4        # an f32 all-reduced scalar (loss, grad norm)
NORMALIZED = ("qg-dsgdm-n",)    # algorithms that all-reduce a grad norm

_aten = torch.ops.aten
_VIEWS = {_aten.view.default, _aten._unsafe_view.default,
          _aten.reshape.default, _aten.expand.default,
          _aten.permute.default, _aten.transpose.int, _aten.t.default,
          _aten.slice.Tensor, _aten.select.int, _aten.unsqueeze.default,
          _aten.squeeze.dim, _aten.squeeze.default, _aten.squeeze.dims,
          _aten.as_strided.default, _aten.alias.default,
          _aten.detach.default, _aten.unbind.int, _aten.split.Tensor,
          _aten.split_with_sizes.default, _aten.chunk.default,
          _aten.view_as_real.default, _aten.view_as_complex.default,
          _aten.lift_fresh.default}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Trace(TorchDispatchMode):
    """Live intermediate bytes (each result storage counted from its
    creation to its death; the peak kept) and the bytes every op reads
    and writes."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._seen: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def exclude(self, tree) -> None:
        """Count nothing for the storages of ``tree``'s tensors (the
        step's arguments, which an in-place op may hand back)."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in self._seen:
                self._seen[id(st)] = 0
                weakref.finalize(st, self._free, id(st))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if func not in _VIEWS:
            self.accessed += sum(_nbytes(t) for t in
                                 _tensors((args, kwargs)) + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


def trace(fn, *args):
    """Run ``fn(*args)`` on meta tensors under the counters: (result,
    seconds, FLOPs, bytes accessed, peak live intermediate bytes)."""
    t0 = time.perf_counter()
    tr = _Trace()
    tr.exclude(args)
    with FlopCounterMode(display=False) as fc, tr:
        out = fn(*args)
    return (out, time.perf_counter() - t0, float(fc.get_total_flops()),
            float(tr.accessed), float(tr.peak))


def _fresh(tree):
    """Contiguous meta tensors of ``tree``'s shapes and dtypes (the
    expanded stand-ins cannot be written in place)."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META)
            for k, v in tree.items()}


def _shard_sum(tree, specs, mesh) -> int:
    return sum(shd.shard_bytes(leaf, spec, mesh)
               for _, leaf, spec in shd.spec_leaves(tree, specs))


def _gathers(tree, specs, mesh, exempt=()):
    """(bytes, calls) of the all-gathers that bring every leaf cut over
    an axis outside ``exempt`` to full width: each device's shard once,
    batched as ``sharding.gather_model_tree`` batches (up to
    ``GATHER_BYTES`` a call)."""
    total = calls = batch = 0
    for _, leaf, spec in shd.spec_leaves(tree, specs):
        if not set(shd.spec_axes(spec)) - set(exempt):
            continue
        b = shd.shard_bytes(leaf, spec, mesh)
        if batch and batch + b > shd.GATHER_BYTES:
            calls, batch = calls + 1, 0
        batch += b
        total += b
    return total, calls + (1 if batch else 0)


def _record(sent: Dict[str, float], calls: int) -> Dict[str, float]:
    out = {k: float(sent.get(k, 0.0)) for k in KINDS}
    out["count"] = float(calls)
    out["total"] = sum(out[k] for k in KINDS)
    return out


def train_collectives(params, specs, mesh, scope: str, algorithm: str,
                      wire_elem_bytes: int) -> Dict[str, float]:
    """One train step's collectives on the port's wire, per device (see
    the module docstring): the ring exchange of the node block's first
    and last rows, the gathers of the leaves cut beyond the node axes,
    the loss's all-reduce and the grad norm's, as
    ``sharding.ShardReduce`` splits it (a sum over the shard group for
    the cut leaves, then over the node axes)."""
    node_axes = node_axes_for(mesh, scope)
    nodes = num_nodes(mesh, scope)
    group = mesh.size // nodes           # devices that hold one node
    ring = 0
    cut = whole = False
    for _, leaf, spec in shd.spec_leaves(params, specs):
        shape = shd.shard_shape(tuple(leaf.shape), spec, mesh)
        ring += 2 * math.prod(shape[1:]) * wire_elem_bytes
        if set(shd.spec_axes(spec)) - set(node_axes):
            cut = True
        else:
            whole = True
    gather, gather_calls = _gathers(params, specs, mesh, node_axes)
    reduce_calls = 1 if nodes > 1 else 0       # the loss
    if algorithm in NORMALIZED:
        if cut and group > 1:
            reduce_calls += (nodes > 1) + 1
        else:
            whole = True
        if whole and nodes > 1:
            reduce_calls += 1
    sent = {"collective-permute": ring if nodes > 1 else 0,
            "all-gather": gather,
            "all-reduce": SCALAR_BYTES * reduce_calls}
    return _record(sent, reduce_calls + gather_calls
                   + (len(specs) if nodes > 1 else 0))


def serve_collectives(params, specs, mesh) -> Dict[str, float]:
    """A serving step's: the sharded weights gathered once."""
    gather, calls = _gathers(params, specs, mesh)
    return _record({"all-gather": gather}, calls)


def _train_step(model, tcfg: TrainConfig):
    """One node's train step (the port's ``make_train_step`` at one
    node: ``core.driver.make_step`` with ``tcfg``'s algorithm and a
    one-node ring, whose mix is the identity)."""
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.driver import lm_adapter, make_step
    from repro_torch.core.mixing import make_roll_mixer
    algo = make_algorithm(tcfg.algorithm, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay)
    return make_step(model, algo, make_roll_mixer(1), lm_adapter)


def _logits(cfg: ModelConfig, lead) -> torch.Tensor:
    """The step's logits on meta: ``lead`` (B, S) positions, K
    codebooks, V classes, in the params' dtype."""
    tail = ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()) \
        + (cfg.vocab_size,)
    return torch.empty(tuple(lead) + tail, dtype=getattr(torch, cfg.dtype),
                       device=META)


def setup(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
          scope: Optional[str] = None,
          tcfg: Optional[TrainConfig] = None) -> SimpleNamespace:
    """``cfg`` at ``shape`` on ``mesh``: the inputs (``inputs``: name ->
    tree) and outputs (``outputs``) the memory analysis sums, their spec
    trees (``specs``), the step (``step``) and the one-node or
    one-model arguments it is traced with (``trace_args``), the devices
    a trace is divided over (``per``) and the train step's ``nodes``,
    ``scope`` and ``tcfg``. ``scope`` is ``cfg.node_scope`` unless
    given; ``tcfg`` the reference's ``TrainConfig(num_nodes=nodes)``
    unless given."""
    from repro_torch.models.model import build_model
    scope = scope or cfg.node_scope
    model = build_model(cfg)
    nodes, per = 1, mesh.size
    if shape.mode == "train":
        nodes = num_nodes(mesh, scope)
        per = mesh.size // nodes
        tcfg = tcfg or TrainConfig(num_nodes=nodes)
        step = _train_step(model, tcfg)
        p_spec = ispec.stacked_params_specs(model, nodes)
        opt_spec = step.init_opt(p_spec)
        batch = ispec.train_specs(cfg, shape, nodes)
        inputs = {"params": p_spec, "opt_state": opt_spec, "batch": batch,
                  "lr": torch.empty((), device=META)}
        outputs = {"params": p_spec, "opt_state": opt_spec,
                   "loss": torch.empty((), device=META)}
        specs = {"params": shd.param_shardings(p_spec, mesh, scope),
                 "opt_state": shd.param_shardings(opt_spec, mesh, scope),
                 "batch": shd.batch_shardings(batch, mesh, scope),
                 "lr": shd.PSpec(), "loss": shd.PSpec()}
        params = _fresh({k: v[:1] for k, v in p_spec.items()})
        trace_args = (params, step.init_opt(params),
                      {k: v[:1] for k, v in batch.items()}, tcfg.lr)
    else:
        from repro_torch.launch.steps import (make_decode_step,
                                              make_prefill_step)
        p_spec = ispec.params_specs(model)
        specs = {"params": shd.serve_param_shardings(p_spec, mesh)}
        B = shape.global_batch
        if shape.mode == "prefill":
            batch = ispec.prefill_specs(cfg, shape)
            logits = _logits(cfg, (B, shape.seq_len))
            inputs = {"params": p_spec, "batch": batch}
            outputs = {"logits": logits}
            step = make_prefill_step(model)
            trace_args = ({k: v[None] for k, v in p_spec.items()},
                          {k: v[None] for k, v in batch.items()})
        else:
            tok, state, extras = ispec.decode_specs(cfg, shape, model)
            logits = _logits(cfg, (B, 1))
            batch = {"tokens": tok, **{f"extra{i}": e
                                       for i, e in enumerate(extras)}}
            inputs = {"params": p_spec, "batch": batch, "state": state}
            outputs = {"logits": logits, "state": state}
            specs["state"] = shd.serve_state_shardings(state, mesh)
            step = make_decode_step(model)
            trace_args = (p_spec, tok, state, *extras)
        specs["batch"] = shd.serve_batch_shardings(batch, mesh)
        specs["logits"] = shd.serve_batch_shardings(logits, mesh)
    return SimpleNamespace(
        scope=scope, nodes=nodes, tcfg=tcfg, step=step, per=per,
        inputs=inputs, outputs=outputs, specs=specs, trace_args=trace_args,
        argument_bytes=sum(_shard_sum(t, specs[k], mesh)
                           for k, t in inputs.items()),
        output_bytes=sum(_shard_sum(t, specs[k], mesh)
                         for k, t in outputs.items()))


# a trace depends on the config, the shape and the per-node batch only:
# the single- and multi-pod meshes of a serving shape share one
_TRACES: Dict[Any, tuple] = {}


def model_flops_total(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The reference's model FLOPs: 6 (train) or 2 · active params ·
    tokens (one a sequence in decode)."""
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    factor = 6 if shape.mode == "train" else 2
    return factor * cfg.active_param_count() * tokens


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
            scope: Optional[str] = None, wire_dtype: str = "float32",
            tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """The record's measured part for ``cfg`` at ``shape`` on ``mesh``
    (an ``AxisMesh``, production or host; :func:`setup`): memory,
    FLOPs, bytes, collectives, the roofline terms."""
    from repro_torch.sched.ledger import wire_elem_bytes
    su = setup(cfg, shape, mesh, scope=scope, tcfg=tcfg)
    n_chips = mesh.size
    key = (cfg, shape, su.tcfg, su.nodes)
    if key not in _TRACES:
        _TRACES[key] = trace(su.step, *su.trace_args)[1:]
    secs, flops, accessed, peak = _TRACES[key]
    rec: Dict[str, Any] = {"memory_analysis": {
        "argument_bytes": su.argument_bytes,
        "output_bytes": su.output_bytes,
        "temp_bytes": peak / su.per, "alias_bytes": 0}}
    if shape.mode == "train":
        colls = train_collectives(su.inputs["params"], su.specs["params"],
                                  mesh, su.scope, su.tcfg.algorithm,
                                  wire_elem_bytes(wire_dtype, cfg.dtype))
        rec["num_nodes"] = su.nodes
    else:
        colls = serve_collectives(su.inputs["params"], su.specs["params"],
                                  mesh)
    hw_flops, hw_bytes = flops / su.per, accessed / su.per
    compute_s = hw_flops / PEAK_FLOPS_BF16
    memory_s = hw_bytes / HBM_BANDWIDTH
    collective_s = colls["total"] / LINK_BANDWIDTH
    rec.update({
        "hlo_flops_per_device": hw_flops,
        "hlo_bytes_per_device": hw_bytes,
        "collective_bytes_per_device": colls["total"],
        "collectives": colls,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max((("compute", compute_s), ("memory", memory_s),
                         ("collective", collective_s)),
                        key=lambda kv: kv[1])[0],
        "n_chips": n_chips, "lower_s": secs, "compile_s": 0.0})
    rec["model_flops_total"] = model_flops_total(cfg, shape)
    rec["model_flops_per_device"] = rec["model_flops_total"] / n_chips
    hw = rec["hlo_flops_per_device"]
    rec["useful_flop_ratio"] = (rec["model_flops_per_device"] / hw
                                if hw else 0.0)
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool,
            verbose: bool = True, wire_dtype: str = "float32",
            cfg_overrides: Dict[str, Any] | None = None,
            label: str = "", sharded_out: bool = False) -> Dict[str, Any]:
    """One combination's record (the reference's ``run_one``):
    ``wire_dtype`` the gossip wire the collectives charge,
    ``cfg_overrides`` fields replaced in the arch's config."""
    if sharded_out:
        raise ValueError(
            "sharded_out pins GSPMD's residual-stream and logits layouts "
            "in the reference; the port has no partitioner to pin, so its "
            "dry run has no sharded_out variant")
    shape = SHAPES[shape_name]
    cfg = get_config(arch, shape=shape_name)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi_pod else "single",
                           "variant": label or "baseline"}
    if not shape_supported(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("full-attention architecture: no sub-quadratic "
                         "variant for 524k context (DESIGN.md)")
        return rec
    rec.update(analyze(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                       wire_dtype=wire_dtype))
    rec["status"] = "ok"
    if verbose:
        log.info("dryrun.ok", arch=arch, shape=shape_name, mesh=rec["mesh"],
                 lower_s=round(rec["lower_s"], 1),
                 compute_ms=round(rec["compute_s"] * 1e3, 2),
                 memory_ms=round(rec["memory_s"] * 1e3, 2),
                 collective_ms=round(rec["collective_s"] * 1e3, 2),
                 dominant=rec["dominant"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Size every (arch x shape x mesh) on the meta device.")
    ap.add_argument("--arch", default=None, help="one arch id (or --all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape_name}_{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    log.info("dryrun.cached", tag=tag)
                    continue
                try:
                    rec = run_one(arch, shape_name, multi)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e)[:2000]}
                    failures.append(tag)
                    log.warning("dryrun.failed", tag=tag, error=repr(e))
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")
    log.info("dryrun.done", seconds=round(time.perf_counter() - t0, 1),
             status="every requested combination traced")


if __name__ == "__main__":
    main()
