"""The decoder stack of ``src/repro/models/transformer.py``, node-stacked.

Parameters are a flat dict of tensors keyed by the reference's pytree
paths joined with ``/`` (``"embed"``, ``"head"``, ``"meta_tokens"``,
``"layers_0/attn/wq"``, ``"layers_0/ssm/w_in"``, ``"ln_f/scale"``, ...);
layer leaves carry the reference's leading layer axis. :meth:`init`
makes one node's params; node-stacked params (a leading node axis on
every leaf, as the port's ResNet has) are what :meth:`forward_features`,
:meth:`logits`, :meth:`forward` and :meth:`head_params` take, with
tokens (L, B, S), or (L, B, S, K) for K codebooks, and, for a
cross-attention model, ``batch["conditioning"]`` (L, B, Sk, d), for a
VLM ``batch["patch_embeddings"]`` (L, B, P, d). The
trunk loops over nodes and layers in Python: the kernels launch through
ctypes, which ``torch.func.vmap`` cannot batch. Node and layer slices are taken with ``torch.unbind``, so autograd
stacks a leaf's gradient once instead of adding one zero-filled copy
of the whole stacked leaf per slice. With grad enabled, ``cfg.remat``
recomputes each layer in the backward pass (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` per layer). :meth:`loss` is the
next-token loss of every node.

Ported: dense and hybrid stacks — attention, SSM and Hymba's parallel
attention ∥ SSM heads with branch norms, per-layer sliding windows,
meta tokens —, MusicGen's — summed codebook embeddings, per-codebook
heads and a cross-attention block per layer over the conditioning — and
PaliGemma's: patch embeddings before the tokens, attended under the
prefix-LM mask and stripped after the final norm. MoE, MLA, multi-token
prediction (ROADMAP.md item 10c) and decode (item 10b) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.convert import _flatten
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_init, init_mlp, init_norm,
                                       normal_init)
from repro_torch.runtime import resolve_device

Params = Dict[str, torch.Tensor]
LAYERS = "layers_0/"


def sub(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix``, keyed by the rest of their path."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _rms(x, scale, eps: float):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device
    p = {"ln1": init_norm(cfg, cfg.d_model, dtype, dev)}
    if not cfg.is_attention_free:
        p["attn"] = attn.init_attention(gen, cfg, dtype)
    if cfg.ssm.enabled:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype)
        if cfg.hybrid_parallel:
            p["attn_branch_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                               device=dev)
            p["ssm_branch_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                              device=dev)
    if cfg.cross_attention:
        p["ln_cross"] = init_norm(cfg, cfg.d_model, dtype, dev)
        p["cross"] = attn.init_cross_attention(gen, cfg, dtype)
    if cfg.d_ff:
        p["ln2"] = init_norm(cfg, cfg.d_model, dtype, dev)
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, dtype)
    return dict(_flatten(p))


def _mix_forward(p: Params, h, cfg: ModelConfig, window: int):
    """Token-mixing sub-block (attention / SSM / hybrid-parallel)."""
    if cfg.hybrid_parallel:
        a = attn.attention_forward(sub(p, "attn/"), h, cfg,
                                   layer_window=window)
        s = ssm_mod.ssm_forward(sub(p, "ssm/"), h, cfg)
        return 0.5 * (_rms(a, p["attn_branch_norm"], cfg.norm_eps)
                      + _rms(s, p["ssm_branch_norm"], cfg.norm_eps))
    if cfg.ssm.enabled:
        return ssm_mod.ssm_forward(sub(p, "ssm/"), h, cfg)
    return attn.attention_forward(sub(p, "attn/"), h, cfg,
                                  layer_window=window)


def _layer_forward(p: Params, x, cfg: ModelConfig, window: int,
                   memory=None):
    """One layer; the cross-attention block runs only with a ``memory``
    (a batch without conditioning skips it, as the reference's)."""
    h = apply_norm(sub(p, "ln1/"), x, cfg)
    x = x + _mix_forward(p, h, cfg, window)
    if memory is not None:
        h = apply_norm(sub(p, "ln_cross/"), x, cfg)
        x = x + attn.cross_attention_forward(sub(p, "cross/"), h, memory,
                                             cfg)
    if "ln2/scale" in p:
        h = apply_norm(sub(p, "ln2/"), x, cfg)
        x = x + apply_mlp(sub(p, "mlp/"), h, cfg)
    return x


def _remat(cfg: ModelConfig) -> bool:
    """Whether each layer is recomputed in the backward pass: the
    reference's ``cfg.remat`` with policy "nothing" (or its alias
    "full"); "everything" saves every residual, as no checkpoint does.
    The "dots" policy (``dots_with_no_batch_dims_saveable``: keep the
    matmul outputs) is not ported (ROADMAP.md item 10d)."""
    if not cfg.remat:
        return False
    if cfg.remat_policy in ("nothing", "full"):
        return True
    if cfg.remat_policy == "everything":
        return False
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' (dots_with_no_batch_dims_saveable) is not "
            "ported (ROADMAP.md item 10d)")
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: expected "
                     "'nothing', 'dots', or 'everything'")


class DecoderModel:
    """init / forward_features / head_params / logits / forward / loss."""

    input_key = "tokens"

    def __init__(self, cfg: ModelConfig):
        missing = [name for name, on in (
            ("MoE", cfg.moe.enabled), ("MLA", cfg.mla.enabled),
            ("multi-token prediction", cfg.mtp_depth > 0)) if on]
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} not ported (ROADMAP.md "
                "item 10c)")
        self.cfg = cfg

    def layer_windows(self) -> List[int]:
        """Per-layer sliding window (0 = global): Hymba's pattern keeps
        every ``global_attn_every``-th layer and the last one global."""
        cfg = self.cfg
        L = cfg.num_layers
        if not cfg.sliding_window:
            return [0] * L
        return [0 if cfg.global_attn_every and (
            i % cfg.global_attn_every == 0 or i == L - 1)
            else cfg.sliding_window for i in range(L)]

    # -- init -----------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int, device="cuda") -> Params:
        """One node's params, drawn on ``device`` from ``seed`` (a
        ``torch.Generator``: not the reference's threefry numbers, the
        same distributions and dtypes)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        V, d, K = cfg.vocab_size, cfg.d_model, cfg.num_codebooks
        p: Params = {"embed": embed_init(gen, V, d, dtype)}
        if K > 1:                           # (K - 1, V, d), stacked
            p["embed_cb"] = torch.stack([embed_init(gen, V, d, dtype)
                                         for _ in range(K - 1)])
        if not cfg.tie_embeddings:          # (K, d, V) for K codebooks
            p["head"] = torch.stack([dense_init(gen, d, V, dtype)
                                     for _ in range(K)]) if K > 1 else \
                dense_init(gen, d, V, dtype)
        if cfg.num_prefix_tokens and cfg.arch_type == "hybrid":
            p["meta_tokens"] = normal_init(
                gen, (cfg.num_prefix_tokens, cfg.d_model), 0.02, dtype)
        layers = [_init_layer(gen, cfg, dtype) for _ in range(cfg.num_layers)]
        for k in layers[0]:
            p[LAYERS + k] = torch.stack([lp[k] for lp in layers])
        del layers
        p.update({f"ln_f/{k}": v for k, v in
                  init_norm(cfg, cfg.d_model, dtype, gen.device).items()})
        return p

    # -- one node -------------------------------------------------------
    def _hidden_one(self, p: Params, tokens, memory=None, patches=None):
        """One node's post-stack, post-final-norm hidden states (B, S, d)
        with the meta tokens or patches stripped; ``memory`` (B, Sk, d),
        the conditioning that every layer's cross-attention reads;
        ``patches`` (B, P, d), a VLM's patch embeddings, put before the
        tokens."""
        cfg = self.cfg
        if cfg.num_codebooks > 1:           # tokens (B, S, K): summed
            h = p["embed"][tokens[..., 0]]
            for i, table in enumerate(torch.unbind(p["embed_cb"])):
                h = h + table[tokens[..., i + 1]]
        else:
            h = p["embed"][tokens]
        n_prefix = 0
        if cfg.arch_type == "hybrid" and cfg.num_prefix_tokens:
            meta = p["meta_tokens"][None].expand(
                (h.shape[0],) + p["meta_tokens"].shape)
            h = torch.cat([meta, h], dim=1)
            n_prefix = cfg.num_prefix_tokens
        if patches is not None:
            h = torch.cat([patches, h], dim=1)
            n_prefix = patches.shape[1]
        layers = {k: torch.unbind(v) for k, v in sub(p, LAYERS).items()}
        remat = _remat(cfg) and torch.is_grad_enabled()
        for li, window in enumerate(self.layer_windows()):
            lp = {k: v[li] for k, v in layers.items()}
            if remat:
                h = checkpoint(_layer_forward, lp, h, cfg, window, memory,
                               use_reentrant=False)
            else:
                h = _layer_forward(lp, h, cfg, window, memory)
        h = apply_norm(sub(p, "ln_f/"), h, cfg)
        return h[:, n_prefix:] if n_prefix else h

    # -- node-stacked ---------------------------------------------------
    def forward_features(self, params: Params, batch):
        """Pre-head activations (L, B, S, d) of every node on its tokens
        (L, B, S[, K]) and, for a cross-attention model, its
        ``batch["conditioning"]`` (L, B, Sk, d), for a VLM its
        ``batch["patch_embeddings"]`` (L, B, P, d) (a VLM batch without
        them raises ``KeyError``, as the reference's), each cast to the
        params' dtype; returns (h, aux) with aux 0 (no MoE)."""
        tokens = torch.as_tensor(batch[self.input_key])
        dev, dtype = params["embed"].device, params["embed"].dtype
        tokens = tokens.to(device=dev, dtype=torch.long)
        memory = batch.get("conditioning") if self.cfg.cross_attention \
            else None
        if memory is not None:
            memory = torch.as_tensor(memory).to(device=dev, dtype=dtype)
        patches = None
        if self.cfg.arch_type == "vlm":
            if "patch_embeddings" not in batch:
                raise KeyError(f"{self.cfg.name}: a VLM batch needs "
                               f"'patch_embeddings' (L, B, P, d) beside "
                               f"'{self.input_key}', got {sorted(batch)}")
            patches = torch.as_tensor(batch["patch_embeddings"]).to(
                device=dev, dtype=dtype)
        nodes = {k: torch.unbind(v) for k, v in params.items()}
        h = torch.stack([self._hidden_one(
            {k: v[i] for k, v in nodes.items()}, tokens[i],
            None if memory is None else memory[i],
            None if patches is None else patches[i])
            for i in range(tokens.shape[0])])
        return h, torch.zeros((), device=dev)

    def head_params(self, params: Params):
        """(unembedding (L, d, V), bias None) — the matrix head_select
        tiles over the vocabulary. Multi-codebook heads (MusicGen) have
        no single one and raise, as the reference's."""
        if self.cfg.num_codebooks > 1:
            raise ValueError("streaming head-select supports a single "
                             "unembedding head; num_codebooks > 1 uses "
                             "the one-shot labeling path")
        if self.cfg.tie_embeddings:
            return params["embed"].transpose(-1, -2), None
        return params["head"], None

    def logits(self, params: Params, h):
        """h (L, ..., d) -> logits (L, ..., V), or (L, ..., K, V) through
        K untied codebook heads (the reference's ``"...d,kdv->...kv"``)."""
        cfg = self.cfg
        lead = (h.shape[0],) + h.shape[1:-1]
        flat = h.reshape(h.shape[0], -1, h.shape[-1])
        if cfg.num_codebooks > 1 and not cfg.tie_embeddings:
            w = params["head"]                               # (L, K, d, V)
            out = torch.einsum("lnd,lkdv->lnkv", flat, w)
            return out.reshape(lead + (w.shape[1], w.shape[3]))
        w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
            else params["head"]
        return torch.bmm(flat, w).reshape(lead + (w.shape[-1],))

    def forward(self, params: Params, batch):
        """(logits (L, B, S[, K], V), aux)."""
        h, aux = self.forward_features(params, batch)
        return self.logits(params, h), aux

    def loss(self, params: Params, batch):
        """Next-token loss of every node: ``(loss (L,), metrics)``, the
        f32 log-sum-exp of the logits minus the gold logit, averaged over
        ``batch["loss_mask"]`` (all positions when absent; over (B, S, K)
        with K codebooks), as the reference's ``loss``. MTP and MoE terms
        are not ported (the constructor refuses those configs)."""
        h, aux = self.forward_features(params, batch)
        logits = self.logits(params, h).float()
        labels = torch.as_tensor(batch["labels"]).to(device=logits.device,
                                                     dtype=torch.long)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = lse - gold                                     # (L, B, S)
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones_like(nll)
        else:
            mask = torch.as_tensor(mask).to(device=nll.device,
                                            dtype=torch.float32)
            mask = (mask[..., None] if mask.dim() < nll.dim() else mask
                    ).expand(nll.shape)
        dims = tuple(range(1, nll.dim()))
        loss = (nll * mask).sum(dims) / torch.clamp(mask.sum(dims), min=1.0)
        return loss, {"nll": loss, "aux": aux}

    def init_decode_state(self, batch: int, context: int):
        raise NotImplementedError("decode (KV cache, SSM state) is not "
                                  "ported (ROADMAP.md item 10b)")

    def decode_step(self, params: Params, tokens, states, memory=None):
        raise NotImplementedError("decode (KV cache, SSM state) is not "
                                  "ported (ROADMAP.md item 10b)")
