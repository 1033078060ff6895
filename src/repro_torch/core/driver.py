"""The decentralized training driver: loss adapters, the one train step,
per-node samplers and the host runner.

**Adapters + step.** A loss adapter turns the model into
``node_loss(params, batch) -> (L,)``, one loss per node of the
node-stacked params. :func:`make_step` differentiates the sum of the
node losses — node params touch only their own loss, so that is every
node's own gradient at once — and hands the grads to the algorithm with
the gossip mixer.

**Sampling.** Batches are drawn on the params' device from a
``torch.Generator`` over padded partition-index arrays
(:class:`PaddedParts`), with replacement, and the KD phase's
private/public merge happens on the device too. The reference draws
with ``jax.random``; the two streams differ, so parity tests replay
index draws instead of reseeding.

**Runner.** :func:`make_host_runner` is a per-step Python loop. The
reference's ``lax.scan`` runner follows the same trajectory as its host
runner by its own contract, so the port's ``"scan"`` is that loop too
(:func:`make_runner`); capturing it in a CUDA graph is speed work
(ROADMAP.md §2, host dispatch).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import IDKDConfig
from repro_torch.core import distill
from repro_torch.runtime import resolve_device

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]
NodeLoss = Callable[[Params, Batch], torch.Tensor]

RUNNER_MODES = ("scan", "host", "auto", "shard")


def resolve_runner_mode(mode: str) -> str:
    """The reference's runner names: ``"auto"`` resolves to ``"scan"``,
    and ``"scan"`` and ``"host"`` both run the Python step loop. The
    sharded driver (``"shard"``) is not ported and raises."""
    if mode not in RUNNER_MODES:
        raise ValueError(f"unknown driver mode {mode!r}; "
                         f"expected one of {RUNNER_MODES}")
    if mode == "shard":
        raise NotImplementedError(
            "driver_mode='shard' (the sharded driver) is not ported yet; "
            "see ROADMAP.md queue 1 item 13")
    return "scan" if mode == "auto" else mode


def _weighted_mean(nll, w):
    return (nll * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)


# --------------------------------------------------------------- adapters
def classification_adapter(model) -> NodeLoss:
    """Weighted soft-CE on (soft or one-hot) labels — the plain phase."""
    def node_loss(params, batch):
        logits, _ = model.forward(params, {"images": batch["images"]})
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -(batch["labels"] * logp).sum(-1)
        return _weighted_mean(nll, batch["weights"])
    return node_loss


def dense_kd_adapter(temperature: float, kd_weight: float = 1.0):
    """Private rows: hard CE. Public rows: the T²-scaled KD loss, scaled
    by ``kd_weight``."""
    def adapter(model) -> NodeLoss:
        def node_loss(params, batch):
            logits, _ = model.forward(params, {"images": batch["images"]})
            logp = torch.log_softmax(logits.float(), dim=-1)
            hard = -(batch["labels"] * logp).sum(-1)
            kd = distill.kd_loss(logits, batch["labels"], temperature)
            nll = torch.where(batch["is_pub"], kd_weight * kd, hard)
            return _weighted_mean(nll, batch["weights"])
        return node_loss
    return adapter


def sparse_kd_adapter(temperature: float, kd_weight: float = 1.0):
    """dense_kd on top-k sparse labels, never densified: private rows
    carry their one-hot as a k=1 sparse label, so hard CE is the T=1
    sparse soft-CE on the same payload."""
    def adapter(model) -> NodeLoss:
        def node_loss(params, batch):
            logits, _ = model.forward(params, {"images": batch["images"]})
            sp = distill.SparseLabels(batch["values"], batch["indices"])
            hard = distill.sparse_kd_loss(logits, sp, 1.0)
            kd = distill.sparse_kd_loss(logits, sp, temperature)
            nll = torch.where(batch["is_pub"], kd_weight * kd, hard)
            return _weighted_mean(nll, batch["weights"])
        return node_loss
    return adapter


def lm_adapter(model) -> NodeLoss:
    """Next-token LM loss: the whole batch goes to ``model.loss``."""
    def node_loss(params, batch):
        loss, _ = model.loss(params, batch)
        return loss
    return node_loss


def lm_sparse_kd_adapter(idkd_cfg: IDKDConfig):
    """LM next-token loss + sparse KD on the public sub-batch: the
    T²-scaled ``distill.sparse_kd_loss`` against the neighbours' averaged
    top-k labels, averaged over tokens, weighted by ``pub_w`` and scaled
    by ``kd_weight``."""
    def adapter(model) -> NodeLoss:
        def node_loss(params, batch):
            base, _ = model.loss(params, batch)
            logits, _ = model.forward(params, {"tokens": batch["pub_tokens"]})
            kd = distill.sparse_kd_loss(
                logits, distill.SparseLabels(batch["pub_vals"],
                                             batch["pub_idx"]),
                idkd_cfg.temperature)                       # (L, Bp, S)
            w = batch["pub_w"]
            kd = (kd.mean(-1) * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
            return base + idkd_cfg.kd_weight * kd
        return node_loss
    return adapter


# ----------------------------------------------------------- step factory
def make_step(model, algo, mixer, loss_adapter, telemetry: bool = False,
              guard=None) -> Callable:
    """``step(params, opt_state, batch, lr) -> (params, opt_state, loss)``
    on node-stacked params; ``loss`` is the mean node loss.

    ``telemetry=True`` adds the metrics bus (:mod:`repro_torch.obs.
    metrics`) as a trailing carry, ``step(..., metrics) -> (...,
    metrics)``, flagged ``step.metrics``; ``guard`` (a
    ``resil.GuardSpec``) adds the health guard (:mod:`repro_torch.resil.
    guards`) after it, flagged ``step.guard``. When the mixer injects
    faults, its ``wire_check`` of the pre-mix params feeds the guard's
    sender attribution. Both only read the step's values, so the
    trajectory is bitwise the plain step's."""
    node_loss = loss_adapter(model)
    if telemetry:
        from repro_torch.obs import metrics as obs_metrics
    if guard is not None:
        from repro_torch.resil import guards as resil_guards
    wire_check = getattr(mixer, "wire_check", None)

    def grad_fn(params, batch):
        keys = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in keys]
        losses = node_loss(dict(zip(keys, leaves)), batch)
        grads = torch.autograd.grad(losses.sum(), leaves)
        return dict(zip(keys, grads)), losses.detach()

    def step(params, opt_state, batch, lr, *rest):
        rest = list(rest)
        metrics = rest.pop(0) if telemetry else None
        guard_state = rest.pop(0) if guard is not None else None
        # sender attribution reads the pre-mix payload: the update below
        # writes over params, and after the mix propagated corruption has
        # reached the victims too
        wire_invalid = (wire_check(params)
                        if guard is not None and wire_check is not None
                        else None)
        grads, losses = grad_fn(params, batch)
        new_params, opt_state = algo.step(
            {k: p.detach() for k, p in params.items()}, grads, opt_state,
            lr, mixer)
        out = [new_params, opt_state, losses.mean()]
        if telemetry:
            out.append(obs_metrics.update(metrics, losses, grads,
                                          new_params))
        if guard is not None:
            out.append(resil_guards.update(guard_state, guard, losses,
                                           grads, new_params,
                                           wire_invalid=wire_invalid))
        return tuple(out)

    step.metrics = telemetry
    step.guard = guard is not None
    step.init_opt = algo.init
    step.grads = grad_fn           # (grads, node losses) alone, for traces
    return step


def _node_rows(tree, n: int, prefix: str = ""):
    """(path, tensor) of every leaf of a nested dict / list whose leading
    axis is the node axis."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _node_rows(v, n, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _node_rows(v, n, f"{prefix}#{i}/")
    elif isinstance(tree, torch.Tensor) and tree.dim() >= 1 \
            and tree.shape[0] == n:
        yield prefix, tree


def make_frozen_step(step_fn, active) -> Callable:
    """Churn wrapper: nodes with ``active[i] == False`` hold their params
    and node-stacked optimizer state — they neither train nor gossip
    (pair with a masked mixer, ``make_mixer(..., active=...)``). Leaves
    without a leading node axis (D²'s step count) pass through. The
    frozen nodes still draw their batches, so a node that rejoins leaves
    every other node's trajectory as it was.

    The port's updates write over their inputs, so each frozen node's
    rows are copied out before the inner step and written back into the
    step's outputs after it, through views of the node rows (``x[i]``):
    on the device, never a host round trip, and no index kernel that
    deterministic mode would refuse. The trailing metrics / guard
    carries pass through with the inner step's values, as in the
    reference."""
    act = np.asarray(active, bool)
    n = act.shape[0]
    nodes = [int(i) for i in np.flatnonzero(~act)]

    def step(params, opt_state, batch, lr, *rest):
        held = {}
        for which, tree in (("p", params), ("o", opt_state)):
            for path, x in _node_rows(tree, n):
                held[which, path] = [x[i].clone() for i in nodes]
        out = step_fn(params, opt_state, batch, lr, *rest)
        for which, tree in (("p", out[0]), ("o", out[1])):
            for path, x in _node_rows(tree, n):
                for i, row in zip(nodes, held.get((which, path), ())):
                    x[i].copy_(row)
        return out

    step.metrics = getattr(step_fn, "metrics", False)
    step.guard = getattr(step_fn, "guard", False)
    step.init_opt = step_fn.init_opt
    return step


# ------------------------------------------------------ on-device sampling
class PaddedParts(NamedTuple):
    """Padded per-node partition indices."""
    idx: torch.Tensor    # (n, Pmax) int64 — rows padded (never drawn)
    size: torch.Tensor   # (n,) int64 — true row lengths (may be 0)


def pad_partitions(parts: List[np.ndarray], device="cuda") -> PaddedParts:
    device = resolve_device(device)
    n = len(parts)
    pmax = max(max((len(p) for p in parts), default=0), 1)
    idx = np.zeros((n, pmax), np.int64)
    size = np.zeros((n,), np.int64)
    for i, p in enumerate(parts):
        idx[i, :len(p)] = p
        size[i] = len(p)
    return PaddedParts(torch.as_tensor(idx, device=device),
                       torch.as_tensor(size, device=device))


def sample_partition(parts: PaddedParts, gen: torch.Generator,
                     batch_size: int) -> torch.Tensor:
    """(n, B) global indices, node i drawn uniformly from its partition.
    Empty partitions yield index 0 — mask on ``parts.size > 0``."""
    n = parts.idx.shape[0]
    size = torch.clamp(parts.size, min=1)
    u = torch.rand((n, batch_size), generator=gen, device=parts.idx.device)
    r = torch.minimum((u * size[:, None]).long(), size[:, None] - 1)
    return torch.gather(parts.idx, 1, r)


def _require_nonempty(parts: PaddedParts, what: str) -> None:
    sizes = parts.size.cpu().numpy()
    if (sizes == 0).any():
        empty = np.flatnonzero(sizes == 0).tolist()
        raise ValueError(f"empty {what} partition for node(s) {empty}; "
                         "cannot sample a training batch from them")


def make_classification_sampler(parts: PaddedParts, train_x, train_y,
                                num_classes: int, batch_size: int):
    """Plain-phase batches: private images + one-hot labels."""
    _require_nonempty(parts, "private")

    def sample(gen, step) -> Batch:
        idx = sample_partition(parts, gen, batch_size)
        return {"images": train_x[idx],
                "labels": F.one_hot(train_y[idx], num_classes).float(),
                "weights": torch.ones(idx.shape, device=idx.device)}

    return sample


def homogenized_ctx(hom_weights, payload, capacity: int, device="cuda"
                    ) -> Dict:
    """Round-varying KD sampler state: ``pub_idx`` (n, capacity) — each
    node's D_ID ∪ neighbour rows, padded — ``pub_size`` (n,),
    ``weights`` (n, P), and ``labels`` (dense) or ``values``/``indices``
    (sparse payload)."""
    device = resolve_device(device)
    w = np.asarray(hom_weights, np.float32)
    n = w.shape[0]
    idx = np.zeros((n, max(capacity, 1)), np.int64)
    size = np.zeros((n,), np.int64)
    for i, row in enumerate(w):
        nz = np.flatnonzero(row > 0)
        idx[i, :len(nz)] = nz
        size[i] = len(nz)
    ctx = {"pub_idx": torch.as_tensor(idx, device=device),
           "pub_size": torch.as_tensor(size, device=device),
           "weights": torch.as_tensor(w, device=device)}
    if isinstance(payload, (tuple, list)):
        ctx["values"] = torch.as_tensor(payload[0], device=device)
        ctx["indices"] = torch.as_tensor(payload[1], device=device)
    else:
        ctx["labels"] = torch.as_tensor(payload, device=device)
    return ctx


def make_homogenized_sampler(priv_parts: PaddedParts, train_x, train_y,
                             public_x, num_classes: int, batch_size: int):
    """KD-phase batches from D_T^i ∪ D_ID (Algorithm 1 line 15):
    ``sample(gen, step, ctx)`` with ``ctx`` from :func:`homogenized_ctx`.
    Each slot is public with probability |D_ID| / (|D_T| + |D_ID|);
    images, labels and weights are selected from the private or public
    source. A sparse payload rides through un-densified, private
    one-hots as k=1 sparse labels."""
    _require_nonempty(priv_parts, "private")

    def sample(gen, step, ctx) -> Batch:
        pub_c = PaddedParts(ctx["pub_idx"], ctx["pub_size"])
        n = pub_c.idx.shape[0]
        p_pub = ctx["pub_size"] / torch.clamp(
            priv_parts.size + ctx["pub_size"], min=1)
        priv = sample_partition(priv_parts, gen, batch_size)    # (n, B)
        pub = sample_partition(pub_c, gen, batch_size)
        u = torch.rand(priv.shape, generator=gen, device=priv.device)
        is_pub = (u < p_pub[:, None]) & (ctx["pub_size"] > 0)[:, None]
        img_priv = train_x[priv]
        sel = is_pub.reshape(is_pub.shape + (1,) * (img_priv.dim() - 2))
        nidx = torch.arange(n, device=priv.device)[:, None]
        batch = {"images": torch.where(sel, public_x[pub], img_priv),
                 "weights": torch.where(is_pub, ctx["weights"][nidx, pub],
                                        1.0),
                 "is_pub": is_pub}
        if "values" in ctx:
            vals = ctx["values"][nidx, pub]                     # (n, B, k)
            cls = ctx["indices"][nidx, pub]
            pv = torch.zeros_like(vals)
            pv[..., 0] = 1.0
            pi = torch.zeros_like(cls)
            pi[..., 0] = train_y[priv].to(cls.dtype)
            batch["values"] = torch.where(is_pub[..., None], vals, pv)
            batch["indices"] = torch.where(is_pub[..., None], cls, pi)
        else:
            lab_priv = F.one_hot(train_y[priv], num_classes).float()
            batch["labels"] = torch.where(is_pub[..., None],
                                          ctx["labels"][nidx, pub], lab_priv)
        return batch

    return sample


def make_lm_sampler(parts: PaddedParts, tokens, batch_size: int):
    """LM batches: (n, B, S) token / next-token pairs from each node's
    partition of ``tokens`` (n_seqs, S + 1), drawn on the device."""
    _require_nonempty(parts, "private")
    tokens = torch.as_tensor(tokens, device=parts.idx.device).long()

    def sample(gen, step) -> Batch:
        seq = tokens[sample_partition(parts, gen, batch_size)]  # (n,B,S+1)
        return {"tokens": seq[..., :-1], "labels": seq[..., 1:]}

    return sample


def lm_kd_ctx(pub_vals, pub_idx, pub_w) -> Dict:
    """Round-varying LM-KD sampler state: the sparse label payload
    (n, P, S, k) and the weights (n, P) each homogenization round
    refreshes, passed through the runner."""
    return {"pub_vals": torch.as_tensor(pub_vals),
            "pub_idx": torch.as_tensor(pub_idx),
            "pub_w": torch.as_tensor(pub_w).float()}


def draw_public(gen: torch.Generator, n: int, pub_batch: int,
                n_public: int, device) -> torch.Tensor:
    """(n, pub_batch) public sequence indices, uniform with replacement."""
    return torch.randint(0, n_public, (n, pub_batch), generator=gen,
                         device=device)


def make_lm_kd_sampler(parts: PaddedParts, tokens, batch_size: int,
                       public_tokens, pub_vals, pub_idx, pub_w,
                       pub_batch: int):
    """LM batches plus a per-node public sub-batch with its sparse
    payload: ``sample(gen, step, ctx=None)``, where ``ctx``
    (:func:`lm_kd_ctx`) overrides the factory's payload after later
    rounds."""
    base = make_lm_sampler(parts, tokens, batch_size)
    dev = parts.idx.device
    public_tokens = torch.as_tensor(public_tokens, device=dev).long()
    default_ctx = lm_kd_ctx(pub_vals, pub_idx, pub_w)
    n = default_ctx["pub_w"].shape[0]
    nidx = torch.arange(n, device=dev)[:, None]

    def sample(gen, step, ctx=None) -> Batch:
        c = default_ctx if ctx is None else ctx
        batch = base(gen, step)
        pb = draw_public(gen, n, pub_batch, len(public_tokens), dev)
        batch["pub_tokens"] = public_tokens[pb]
        batch["pub_vals"] = c["pub_vals"][nidx, pb]
        batch["pub_idx"] = c["pub_idx"][nidx, pb]
        batch["pub_w"] = c["pub_w"][nidx, pb]
        return batch

    return sample


# ---------------------------------------------------------------- runners
def make_host_runner(step_fn, sample_fn, lr_fn) -> Callable:
    """``run(params, opt_state, gen, step0, num_steps, ctx=None) ->
    (params, opt_state, gen, losses (num_steps,))``: one sampled batch
    and one train step per iteration of a Python loop. A step flagged
    ``metrics`` / ``guard`` makes the runner take and return those
    carries the same way: ``run(..., metrics=m, guard=g) -> (...,
    losses, m, g)``, flagged ``run.metrics`` / ``run.guard``."""
    has_metrics = getattr(step_fn, "metrics", False)
    has_guard = getattr(step_fn, "guard", False)

    def run(params, opt_state, gen, step0, num_steps, ctx=None,
            metrics=None, guard=None):
        losses = []
        for t in range(step0, step0 + num_steps):
            batch = (sample_fn(gen, t) if ctx is None
                     else sample_fn(gen, t, ctx))
            args = (params, opt_state, batch, lr_fn(t))
            if has_metrics:
                args += (metrics,)
            if has_guard:
                args += (guard,)
            out = step_fn(*args)
            params, opt_state, loss = out[:3]
            rest = list(out[3:])
            if has_metrics:
                metrics = rest.pop(0)
            if has_guard:
                guard = rest.pop(0)
            losses.append(loss)
        dev = next(iter(params.values())).device
        out = (params, opt_state, gen,
               torch.stack(losses) if losses else torch.zeros((0,),
                                                              device=dev))
        if has_metrics:
            out += (metrics,)
        if has_guard:
            out += (guard,)
        return out

    run.metrics = has_metrics
    run.guard = has_guard
    return run


def make_runner(step_fn, sample_fn, lr_fn, mode: str = "scan"
                ) -> Callable:
    """The runner of ``mode`` (:func:`resolve_runner_mode`): the host
    runner under every name the port takes."""
    resolve_runner_mode(mode)
    return make_host_runner(step_fn, sample_fn, lr_fn)


def eval_boundaries(steps: int, eval_every: int) -> List[Tuple[int, int]]:
    """Chunk [start, stop) spans ending right after each eval step
    (``s % eval_every == 0`` or the last step)."""
    cuts = {0, steps}
    cuts |= {s + 1 for s in range(steps)
             if s % eval_every == 0 or s == steps - 1}
    edges = sorted(cuts)
    return list(zip(edges[:-1], edges[1:]))
