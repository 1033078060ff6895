"""The decoder stack of ``src/repro/models/transformer.py``, node-stacked.

Parameters are a flat dict of tensors keyed by the reference's pytree
paths joined with ``/`` (``"embed"``, ``"head"``, ``"meta_tokens"``,
``"layers_0/attn/wq"``, ``"layers_0/ssm/w_in"``, ``"ln_f/scale"``, ...);
layer leaves carry the reference's leading layer axis, one ``layers_<i>``
per segment (:attr:`DecoderModel.segments`: DeepSeek-V3's leading dense
layers then its MoE layers, each segment its own stack). :meth:`init`
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
the reference's ``jax.checkpoint`` per layer): all of it under
``remat_policy`` "nothing", all but the projections' outputs under
"dots" (a selective checkpoint, :func:`dots_policy`), none of it under
"everything". :meth:`loss` is the
next-token loss of every node.

Ported: dense and hybrid stacks — attention, SSM and Hymba's parallel
attention ∥ SSM heads with branch norms, per-layer sliding windows,
meta tokens —, MusicGen's — summed codebook embeddings, per-codebook
heads and a cross-attention block per layer over the conditioning — and
PaliGemma's: patch embeddings before the tokens, attended under the
prefix-LM mask and stripped after the final norm —, and the MoE family's:
mixture-of-experts FFNs (``models/moe.py``; their aux loss summed over
layers into :meth:`forward_features`' aux and weighted by
``router_aux_coef`` in :meth:`loss`), DeepSeek-V3's multi-head latent
attention and its multi-token prediction (``mtp_proj``, ``mtp_layer``,
``mtp_ln``; one extra layer predicting the token after next, 0.1 of
its loss added).

Decode (:meth:`DecoderModel.init_decode_state`,
:meth:`DecoderModel.decode_step`) takes one model's params, what
:meth:`init` and ``launch.steps.consensus_params`` return, not the
node-stacked tree: per segment a dict of per-layer caches stacked on a
leading layer axis (``"kv"``: ``attention.KVCache``, or
``attention.MLACache`` for MLA; ``"ssm"``: ``ssm.SSMState``), a ring of
capacity ``window`` only when every layer is windowed. A step embeds the
tokens alone, as the reference's does: Hymba's meta tokens and a VLM's
patches, which the forward pass puts first, are not read (a fault of the
reference, kept; ROADMAP.md §3). The caches are written in place.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.convert import _flatten
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_init, init_mlp, init_norm,
                                       normal_init, rms_norm_f32, sub)
from repro_torch.runtime import MetaGenerator, resolve_or_meta

Params = Dict[str, torch.Tensor]


class Segment(NamedTuple):
    kind: str        # 'dense' | 'moe'
    num_layers: int


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype):
    """One layer's leaves as ``(key, shape, index, piece)``, as
    ``moe.init_moe`` yields them (an expert bank one expert at a time;
    every other leaf whole, ``index`` ())."""
    dev = gen.device
    p = {"ln1": init_norm(cfg, cfg.d_model, dtype, dev)}
    if cfg.mla.enabled:
        p["attn"] = attn.init_mla(gen, cfg, dtype)
    elif not cfg.is_attention_free:
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
    if cfg.d_ff or kind == "moe":
        p["ln2"] = init_norm(cfg, cfg.d_model, dtype, dev)
        if kind != "moe":
            p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, dtype)
    for k, v in _flatten(p):
        yield k, tuple(v.shape), (), v
    if kind == "moe":
        for k, shape, idx, v in moe_mod.init_moe(gen, cfg, dtype):
            yield "moe/" + k, shape, idx, v


def _mix_forward(p: Params, h, cfg: ModelConfig, window: int):
    """Token-mixing sub-block (attention / SSM / hybrid-parallel)."""
    if cfg.hybrid_parallel:
        a = attn.attention_forward(sub(p, "attn/"), h, cfg,
                                   layer_window=window)
        s = ssm_mod.ssm_forward(sub(p, "ssm/"), h, cfg)
        return 0.5 * (rms_norm_f32(a, p["attn_branch_norm"], cfg.norm_eps)
                      + rms_norm_f32(s, p["ssm_branch_norm"], cfg.norm_eps))
    if cfg.ssm.enabled:
        return ssm_mod.ssm_forward(sub(p, "ssm/"), h, cfg)
    if cfg.mla.enabled:
        return attn.mla_forward(sub(p, "attn/"), h, cfg)
    return attn.attention_forward(sub(p, "attn/"), h, cfg,
                                  layer_window=window)


def _layer_forward(p: Params, x, cfg: ModelConfig, kind: str, window: int,
                   memory=None):
    """One layer -> (x, its MoE aux loss, 0 for a dense FFN); the
    cross-attention block runs only with a ``memory`` (a batch without
    conditioning skips it, as the reference's)."""
    h = apply_norm(sub(p, "ln1/"), x, cfg)
    x = x + _mix_forward(p, h, cfg, window)
    aux = torch.zeros((), device=x.device)
    if memory is not None:
        h = apply_norm(sub(p, "ln_cross/"), x, cfg)
        x = x + attn.cross_attention_forward(sub(p, "cross/"), h, memory,
                                             cfg)
    if "ln2/scale" in p:
        h = apply_norm(sub(p, "ln2/"), x, cfg)
        if kind == "moe":
            y, aux = moe_mod.moe_forward(sub(p, "moe/"), h, cfg)
        else:
            y = apply_mlp(sub(p, "mlp/"), h, cfg)
        x = x + y
    return x, aux


def _mix_decode(p: Params, h, cfg: ModelConfig, window: int, state):
    """One token's token-mixing sub-block against the layer's ``state``
    (updated in place)."""
    if cfg.hybrid_parallel:
        a, _ = attn.attention_decode(sub(p, "attn/"), h, cfg, state["kv"],
                                     layer_window=window)
        s, _ = ssm_mod.ssm_decode(sub(p, "ssm/"), h, cfg, state["ssm"])
        return 0.5 * (rms_norm_f32(a, p["attn_branch_norm"], cfg.norm_eps)
                      + rms_norm_f32(s, p["ssm_branch_norm"], cfg.norm_eps))
    if cfg.ssm.enabled:
        return ssm_mod.ssm_decode(sub(p, "ssm/"), h, cfg, state["ssm"])[0]
    if cfg.mla.enabled:
        return attn.mla_decode(sub(p, "attn/"), h, cfg, state["kv"])[0]
    return attn.attention_decode(sub(p, "attn/"), h, cfg, state["kv"],
                                 layer_window=window)[0]


def _layer_decode(p: Params, x, cfg: ModelConfig, kind: str, window: int,
                  state, memory=None):
    """One layer of a decode step: the mixer against the layer's state,
    the cross-attention block over ``memory`` (recomputed every step, no
    cross K/V cache, as the reference's), the FFN (MoE over the B
    tokens; its aux dropped)."""
    h = apply_norm(sub(p, "ln1/"), x, cfg)
    x = x + _mix_decode(p, h, cfg, window, state)
    if cfg.cross_attention and memory is not None:
        h = apply_norm(sub(p, "ln_cross/"), x, cfg)
        x = x + attn.cross_attention_forward(sub(p, "cross/"), h, memory,
                                             cfg)
    if "ln2/scale" in p:
        h = apply_norm(sub(p, "ln2/"), x, cfg)
        if kind == "moe":
            y, _ = moe_mod.moe_forward(sub(p, "moe/"), h, cfg)
        else:
            y = apply_mlp(sub(p, "mlp/"), h, cfg)
        x = x + y
    return x


def _layer_state(state, li: int):
    """Layer ``li``'s caches: views into the segment's stacked ones."""
    return {name: type(c)(*(t[li] for t in c)) for name, c in state.items()}


def _remat(cfg: ModelConfig) -> str:
    """How each layer is recomputed in the backward pass, from the
    reference's ``cfg.remat`` and ``cfg.remat_policy``: "" (no
    checkpoint: without remat, or with "everything", which saves every
    residual as no checkpoint does), "full" (policy "nothing", or its
    alias "full": the whole layer recomputed) or "dots"
    (:func:`dots_policy`)."""
    if not cfg.remat:
        return ""
    if cfg.remat_policy in ("nothing", "full"):
        return "full"
    if cfg.remat_policy == "everything":
        return ""
    if cfg.remat_policy == "dots":
        return "dots"
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: expected "
                     "'nothing', 'dots', or 'everything'")


# what a sub-block's last product writes into the residual stream
_OUT_PROJ = {"attn": ("attn/wo",), "cross": ("cross/wo",),
             "ssm": ("ssm/w_out",),
             "ffn": ("mlp/wo", "moe/shared/wo", "moe/dense_residual/wo")}


def dots_saved_keys(p: Params, cfg: ModelConfig, memory=None) -> List[str]:
    """The weights whose products' outputs the "dots" policy saves in one
    layer with params ``p``: the reference's
    ``dots_with_no_batch_dims_saveable`` keeps the output of every
    ``dot_general`` without batch dimensions that the backward pass reads.
    Those are the layer's projections by a 2-D weight: attention's q, k,
    v and o (and MLA's ``wq_a``, ``wq_b`` or ``wq``, ``wkv_a``, ``w_uk``,
    ``w_uv``, ``wo``), the SSM's in projections (``w_in``, or ``w_z``,
    ``w_x``, ``w_b``, ``w_c``, ``w_dt``) and ``w_out``, the
    cross-attention's, the MLP's ``wg`` and ``wi``, the MoE router and
    its shared and dense-residual MLPs — less the last sub-block's
    output projection, which only adds into the residual stream at the
    layer's end, so that nothing in the backward reads it (the FFN's
    ``wo``; the mixer's own when the layer has no FFN and no
    cross-attention, unless Hymba's branch norms read both branches).
    Attention's per-head products, the expert bank's products over its
    expert dim (``torch.bmm``), norms, elementwise ops and the kernels
    are recomputed."""
    if "ln2/scale" in p:
        last = "ffn"
    elif memory is not None and cfg.cross_attention:
        last = "cross"
    elif cfg.hybrid_parallel:
        last = None
    elif cfg.ssm.enabled:
        last = "ssm"
    else:
        last = "attn"
    drop = set(_OUT_PROJ.get(last, ()))
    return [k for k, v in p.items()
            if v.dim() == 2 and k not in drop
            and k.split("/")[0] in ("attn", "ssm", "cross", "mlp", "moe")
            and not k.startswith("moe/experts/")]


def dots_policy(p: Params, cfg: ModelConfig, memory=None):
    """The selective-checkpoint policy of remat_policy "dots" for one
    layer (``torch.utils.checkpoint.create_selective_checkpoint_contexts``):
    an ``aten.mm`` / ``aten.addmm`` whose right operand is one of
    :func:`dots_saved_keys`' weights is saved, every other op
    recomputed. The policy goes by the weight, not by the op's name: a
    2-D product inside a kernel's plain version, which the reference
    computes with batch dimensions, is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    keep = {(p[k].data_ptr(), tuple(p[k].shape))
            for k in dots_saved_keys(p, cfg, memory)}
    aten = torch.ops.aten
    ops = {aten.mm.default: 1, aten.addmm.default: 2}

    def policy(ctx, op, *args, **kwargs):
        i = ops.get(op)
        if i is not None:
            w = args[i]
            if (w.data_ptr(), tuple(w.shape)) in keep:
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _checkpointed(mode: str, lp: Params, h, cfg: ModelConfig, kind: str,
                  window: int, memory):
    """One layer under per-layer recompute ("full") or the "dots"
    policy."""
    if mode == "dots":
        import functools

        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                dots_policy(lp, cfg, memory))
        return checkpoint(_layer_forward, lp, h, cfg, kind, window, memory,
                          use_reentrant=False, context_fn=ctx)
    return checkpoint(_layer_forward, lp, h, cfg, kind, window, memory,
                      use_reentrant=False)


class DecoderModel:
    """init / forward_features / head_params / logits / forward / loss."""

    input_key = "tokens"

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.moe.enabled and cfg.moe.first_k_dense:
            self.segments = [Segment("dense", cfg.moe.first_k_dense),
                             Segment("moe", cfg.num_layers
                                     - cfg.moe.first_k_dense)]
        elif cfg.moe.enabled:
            self.segments = [Segment("moe", cfg.num_layers)]
        else:
            self.segments = [Segment("dense", cfg.num_layers)]

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

    def _segment_windows(self) -> List[List[int]]:
        w = self.layer_windows()
        out, off = [], 0
        for seg in self.segments:
            out.append(w[off:off + seg.num_layers])
            off += seg.num_layers
        return out

    # -- init -----------------------------------------------------------
    @torch.no_grad()
    def pieces(self, seed: int, device="cuda"):
        """One node's params drawn on ``device`` from ``seed`` (on "meta"
        drawn as shapes only, for the dry run), yielded as
        ``(path, shape, index, piece)``: leaf ``path`` of ``shape`` gets
        ``piece`` at ``index`` (a layer, or a layer and an expert, or ()
        for a whole leaf). :meth:`init` assembles them; ``lmpath.
        node_params`` writes them straight into a node-stacked leaf, so a
        full-width model is never held twice."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        dev = resolve_or_meta(device)
        gen = (MetaGenerator() if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        V, d, K = cfg.vocab_size, cfg.d_model, cfg.num_codebooks

        def whole(path, t):
            return path, tuple(t.shape), (), t
        yield whole("embed", embed_init(gen, V, d, dtype))
        if K > 1:                           # (K - 1, V, d), stacked
            for i in range(K - 1):
                yield "embed_cb", (K - 1, V, d), (i,), \
                    embed_init(gen, V, d, dtype)
        if not cfg.tie_embeddings:          # (K, d, V) for K codebooks
            if K > 1:
                for i in range(K):
                    yield "head", (K, d, V), (i,), dense_init(gen, d, V,
                                                              dtype)
            else:
                yield whole("head", dense_init(gen, d, V, dtype))
        if cfg.num_prefix_tokens and cfg.arch_type == "hybrid":
            yield whole("meta_tokens", normal_init(
                gen, (cfg.num_prefix_tokens, cfg.d_model), 0.02, dtype))
        for si, seg in enumerate(self.segments):
            for li in range(seg.num_layers):
                for k, shape, idx, v in _init_layer(gen, cfg, seg.kind,
                                                    dtype):
                    yield (f"layers_{si}/{k}", (seg.num_layers,) + shape,
                           (li,) + idx, v)
        for k, v in init_norm(cfg, cfg.d_model, dtype, gen.device).items():
            yield whole(f"ln_f/{k}", v)
        if cfg.mtp_depth:
            yield whole("mtp_proj", dense_init(gen, 2 * d, d, dtype))
            for k, shape, idx, v in _init_layer(gen, cfg,
                                                self.segments[-1].kind,
                                                dtype):
                yield "mtp_layer/" + k, shape, idx, v
            for k, v in init_norm(cfg, d, dtype, gen.device).items():
                yield whole(f"mtp_ln/{k}", v)

    @torch.no_grad()
    def init(self, seed: int, device="cuda") -> Params:
        """One node's params, drawn on ``device`` from ``seed`` (a
        ``torch.Generator``: not the reference's threefry numbers, the
        same distributions and dtypes)."""
        p: Params = {}
        for path, shape, idx, piece in self.pieces(seed, device):
            if not idx:
                p[path] = piece
                continue
            if path not in p:
                p[path] = piece.new_empty(shape)
            p[path][idx] = piece
        return p

    # -- one node -------------------------------------------------------
    def _embed(self, p: Params, tokens):
        if self.cfg.num_codebooks > 1:      # tokens (B, S, K): summed
            h = p["embed"][tokens[..., 0]]
            for i, table in enumerate(torch.unbind(p["embed_cb"])):
                h = h + table[tokens[..., i + 1]]
            return h
        return p["embed"][tokens]

    def _hidden_one(self, p: Params, tokens, memory=None, patches=None):
        """One node's post-stack, post-final-norm hidden states (B, S, d)
        with the meta tokens or patches stripped, and the sum of its MoE
        layers' aux losses; ``memory`` (B, Sk, d), the conditioning that
        every layer's cross-attention reads; ``patches`` (B, P, d), a
        VLM's patch embeddings, put before the tokens."""
        cfg = self.cfg
        h = self._embed(p, tokens)
        n_prefix = 0
        if cfg.arch_type == "hybrid" and cfg.num_prefix_tokens:
            meta = p["meta_tokens"][None].expand(
                (h.shape[0],) + p["meta_tokens"].shape)
            h = torch.cat([meta, h], dim=1)
            n_prefix = cfg.num_prefix_tokens
        if patches is not None:
            h = torch.cat([patches, h], dim=1)
            n_prefix = patches.shape[1]
        remat = _remat(cfg) if torch.is_grad_enabled() else ""
        aux = torch.zeros((), device=h.device)
        for si, (seg, windows) in enumerate(zip(self.segments,
                                                self._segment_windows())):
            layers = {k: torch.unbind(v)
                      for k, v in sub(p, f"layers_{si}/").items()}
            for li, window in enumerate(windows):
                lp = {k: v[li] for k, v in layers.items()}
                if remat:
                    h, a = _checkpointed(remat, lp, h, cfg, seg.kind,
                                         window, memory)
                else:
                    h, a = _layer_forward(lp, h, cfg, seg.kind, window,
                                          memory)
                aux = aux + a
        h = apply_norm(sub(p, "ln_f/"), h, cfg)
        return (h[:, n_prefix:] if n_prefix else h), aux

    # -- node-stacked ---------------------------------------------------
    def forward_features(self, params: Params, batch):
        """Pre-head activations (L, B, S, d) of every node on its tokens
        (L, B, S[, K]) and, for a cross-attention model, its
        ``batch["conditioning"]`` (L, B, Sk, d), for a VLM its
        ``batch["patch_embeddings"]`` (L, B, P, d) (a VLM batch without
        them raises ``KeyError``, as the reference's), each cast to the
        params' dtype; returns (h, aux): aux (L,) f32, each node's MoE
        aux loss summed over its layers, or 0 without MoE."""
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
        hs, auxs = zip(*(self._hidden_one(
            {k: v[i] for k, v in nodes.items()}, tokens[i],
            None if memory is None else memory[i],
            None if patches is None else patches[i])
            for i in range(tokens.shape[0])))
        aux = torch.stack(auxs) if self.cfg.moe.enabled \
            else torch.zeros((), device=dev)
        return torch.stack(hs), aux

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
        with K codebooks), plus, as the reference's ``loss``, the
        multi-token-prediction loss (:meth:`_mtp_loss`) with
        ``mtp_depth`` and ``router_aux_coef`` times the MoE aux loss;
        ``metrics`` holds the next-token loss alone (``"nll"``) and the
        aux loss (``"aux"``)."""
        cfg = self.cfg
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
        metrics = {"nll": loss, "aux": aux}
        if cfg.mtp_depth:
            loss = loss + self._mtp_loss(params, batch, h, labels)
        if cfg.moe.enabled:
            loss = loss + cfg.moe.router_aux_coef * aux
        return loss, metrics

    def _mtp_loss(self, params: Params, batch, h, labels):
        """DeepSeek-V3's multi-token prediction, per node: [mtp_ln(h_t) ;
        emb(token t+1)] through ``mtp_proj`` and one extra layer of the
        last segment's kind (its aux dropped), the shared head predicting
        token t+2 (labels rolled by one); the wrapped last position
        masked; 0.1 times the mean."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch[self.input_key]).to(
            device=h.device, dtype=torch.long)
        kind = self.segments[-1].kind
        nodes = {k: torch.unbind(v) for k, v in params.items()
                 if k.startswith(("mtp_", "embed"))}
        out = []
        for i, hi in enumerate(torch.unbind(h)):
            p = {k: v[i] for k, v in nodes.items()}
            x = apply_norm(sub(p, "mtp_ln/"), hi, cfg)
            emb = self._embed(p, torch.roll(tokens[i], -1, dims=1))
            x = torch.cat([x, emb], dim=-1) @ p["mtp_proj"]
            x, _ = _layer_forward(sub(p, "mtp_layer/"), x, cfg, kind, 0)
            out.append(x)
        logits = self.logits(params, torch.stack(out)).float()
        lab = torch.roll(labels, -1, dims=2)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        S = tokens.shape[2]
        mask = (torch.arange(S, device=h.device) < S - 1).float()
        mask = mask.expand(lse.shape)
        return 0.1 * ((lse - gold) * mask).sum((1, 2)) / torch.clamp(
            mask.sum((1, 2)), min=1.0)

    # -- decode (one model) --------------------------------------------
    def init_decode_state(self, batch: int, context: int, device="cuda"):
        """Empty decode state on ``device``: per segment {"kv": a
        ``KVCache`` (capacity ``context``, or the window when every layer
        is windowed) or an ``MLACache``; "ssm": an ``SSMState``}, each
        field stacked on a leading layer axis."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        dev = resolve_or_meta(device)
        states = []
        for seg in self.segments:
            st = {}
            if cfg.ssm.enabled:
                st["ssm"] = ssm_mod.make_ssm_state(cfg, batch, dtype, dev)
            if cfg.mla.enabled:
                st["kv"] = attn.make_mla_cache(cfg, batch, context, dtype,
                                               dev)
            elif not cfg.is_attention_free:
                # one cache shape for every layer of the segment: a ring
                # of capacity window only when every layer is windowed
                uniform = cfg.sliding_window and not cfg.global_attn_every
                st["kv"] = attn.make_kv_cache(
                    cfg, batch, context, dtype,
                    window_override=cfg.sliding_window if uniform else 0,
                    device=dev)
            L = seg.num_layers
            states.append({name: type(c)(*(
                t[None].expand((L,) + t.shape).clone() for t in c))
                for name, c in st.items()})
        return states

    def _logits_one(self, p: Params, h):
        """One model's logits (..., V), or (..., K, V) through K
        codebook heads."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            return h @ p["embed"].transpose(0, 1)
        if cfg.num_codebooks > 1:
            return torch.einsum("...d,kdv->...kv", h, p["head"])
        return h @ p["head"]

    def decode_step(self, params: Params, tokens, states, memory=None):
        """One decode step of one model: tokens (B, 1[, K]) against
        ``states`` (from :meth:`init_decode_state`, updated in place),
        ``memory`` (B, Sk, d) the conditioning a cross-attention model
        reads -> (logits (B, 1[, K], V), states)."""
        cfg = self.cfg
        dev, dtype = params["embed"].device, params["embed"].dtype
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
        if memory is not None:
            memory = torch.as_tensor(memory).to(device=dev, dtype=dtype)
        h = self._embed(params, tokens)
        for si, (seg, windows) in enumerate(zip(self.segments,
                                                self._segment_windows())):
            layers = {k: torch.unbind(v)
                      for k, v in sub(params, f"layers_{si}/").items()}
            for li, window in enumerate(windows):
                h = _layer_decode({k: v[li] for k, v in layers.items()}, h,
                                  cfg, seg.kind, window,
                                  _layer_state(states[si], li), memory)
        h = apply_norm(sub(params, "ln_f/"), h, cfg)
        return self._logits_one(params, h), states
