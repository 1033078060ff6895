"""flash_attention: grouped-query attention, causal with a sliding window
or the prefix-LM mask, or bidirectional over a key set of its own length.

Replaces the Pallas TPU kernel ``flash_attention_pallas`` (body
``_flash_kernel``) of ``src/repro/kernels/flash_attention/kernel.py``,
and computes what the decoder's ``chunked_attention`` computes on its
path: q (B, Sq, H, D), k (B, Sk, KVH, D), v (B, Sk, KVH, DV), head h
reading kv head h // (H // KVH). DV = D, except in MLA's mode
(DeepSeek-V3's multi-head latent attention), where q and k carry the
nope and rope dims and v fewer: (D, DV) = (192, 128), and (48, 32) in
its ``reduced()`` config (:data:`MLA_HEAD_DIMS`); the scores run over D,
the output (B, Sq, H, DV) over DV. Causal (the default, self-attention:
Sk = Sq): key kp is visible to row qp iff kp <= qp and, for ``window``
> 0, qp - window < kp; with ``prefix_len`` P > 0 (PaliGemma's prefix-LM
mask, ``chunked_attention``'s, not the Pallas kernel's) also iff both
qp and kp are below P, so the prefix attends bidirectionally and P >= S
makes every key visible to every row. ``causal=False``
(cross-attention, any Sk >= 1): every key kp < Sk is visible to every
row. The reference would still apply a window one-sided there, and
ignores a prefix; a prefix with a window, and either with
``causal=False``, are combinations nothing calls, so they raise.
The offset mode (``chunked_attention``'s ``q_offset`` and
``kv_valid_len``: a decode step, or a chunked prefill over a cache; not
the Pallas kernel's): q's rows sit at positions ``q_offset`` + their
index, the causal mask and the window measure from there, k may be of
any length Sk, and batch b's keys at or past ``kv_valid_len[b]`` are
masked; never with a prefix, forward only. A row that then sees no key
(``kv_valid_len[b]`` 0, or a window that hides every valid key) is the
reference's edge case: its -1e30 mask gives every key of the padded key
set (n_chunks · chunk keys, the padding's v zeros) the weight exp(0), so
the plain version, which pads as the reference does there, returns V's
sum over the keys divided by n_chunks · chunk; the kernels write 0
(ROADMAP.md §3, a deliberate difference; nothing in the port makes such
a row).
f32 math, q scaled by 1/sqrt(D) first, output in q's dtype.

Two CUDA kernels compute it, neither forming the (S, S) scores; their
header notes give each design and what bounds it on the H100:
``csrc/flash_attention_tc.cu`` (``tc``: bf16 at head_dim 64, 96, 128 or
256 and MLA's (192, 128), on the tensor cores; 96 runs in two 64-dim
column blocks whose second half TMA fills with zeros, 256 in 64-key
tiles) and ``csrc/flash_attention.cu`` (``simt``: f32, and bf16 at
head_dim 32 and MLA's (48, 32)). :func:`_variant` picks one from dtype
and the head dims alone; :func:`flash_attention` runs it on CUDA tensors
and counts the launch in ``launches``, ``launches_by_variant``,
``launches_by_head_dim`` (keyed by D, or by the pair (D, DV) in MLA's
mode) and ``launches_by_mode`` ({"causal", "cross", "prefix",
"offset"} × variant: "cross" counts every non-causal launch, "prefix"
every causal one with ``prefix_len`` > 0, "offset" every one with a
``q_offset`` or a ``kv_valid_len``), and :func:`flash_attention_plain` — the reference's
chunked online softmax in plain PyTorch — runs on CPU tensors only; a
CUDA call that no kernel takes raises.

The backward pass. With grad enabled and an input that requires grad,
:func:`flash_attention` on CUDA tensors goes through
:class:`FlashAttentionFn`: its forward launches the same kernel with the
rows' log-sum-exp written to a (B, H, S) f32 buffer (under
``torch.no_grad`` the kernel is passed no buffer and writes nothing
more), and its backward is :func:`flash_attention_bwd`
(FlashAttention-2's formulas) on CUDA tensors and
:func:`flash_attention_bwd_plain` on CPU tensors. The backward has the
forward's two variants, picked by the same :func:`_variant`:
``csrc/flash_attention_bwd_tc.cu`` (``tc``: bf16 at head_dim 64, 96,
128 or 256 and MLA's (192, 128), P and dS rounded to bf16 as the tensor
cores' operands, which ``flash_attention_bwd_plain(...,
operands="bf16")`` reproduces)
and ``csrc/flash_attention_bwd.cu`` (``simt``: f32 math). The JAX
package has no backward kernel (its training differentiates
``chunked_attention``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128, 256)
TC_HEAD_DIMS = (64, 96, 128, 256)
MLA_HEAD_DIMS = ((48, 32), (192, 128))      # MLA's (qk, v) head dims
TC_MLA_HEAD_DIMS = ((192, 128),)
MODES = ("causal", "cross", "prefix", "offset")
TC_BWD_TILE = 64       # the tc backward's query tile and a warpgroup's keys
TC_BWD_KEYS = 128      # its keys a block at head_dim 64, 96 and 128 (64
                       # in MLA's mode and at 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_mode(Sq: int, Sk: int, causal: bool, window: int,
                prefix_len: int = 0, q_offset: int = 0,
                kv_valid: bool = False):
    """Raise on a (causal, window, prefix_len, Sk, offset mode)
    combination no kernel takes."""
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len must be >= 0, got "
                         f"{prefix_len}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    offset = bool(q_offset) or kv_valid
    if offset and prefix_len:
        raise ValueError("flash_attention: q_offset / kv_valid_len with the "
                         "prefix-LM mask is not ported (nothing calls it)")
    if prefix_len and (window > 0 or not causal):
        raise ValueError("flash_attention: the prefix-LM mask is ported "
                         "for causal attention without a window only (the "
                         "reference applies a window beside it and ignores "
                         "it when causal=False; nothing calls either)")
    if causal and Sk != Sq and not offset:
        raise ValueError(f"flash_attention: causal attention takes k, v of "
                         f"q's length ({Sq}), got {Sk}; cross-attention "
                         f"is causal=False, a cache takes q_offset / "
                         f"kv_valid_len")
    if not causal and window > 0:
        raise ValueError("flash_attention: causal=False with a window is "
                         "not ported (the reference would apply the window "
                         "one-sided; nothing calls it)")


def _allow(q_pos, k_pos, causal: bool, window: int, prefix_len: int = 0):
    """(len(q_pos), len(k_pos)) mask of the visible (row, key) pairs."""
    if causal:
        allow = k_pos[None, :] <= q_pos[:, None]
        if prefix_len:
            allow = allow | ((q_pos[:, None] < prefix_len)
                             & (k_pos[None, :] < prefix_len))
        if window > 0:
            allow = allow & (q_pos[:, None] - k_pos[None, :] < window)
        return allow
    return torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                      device=q_pos.device)


def flash_attention_plain(q, k, v, *, window: int = 0, causal: bool = True,
                          prefix_len: int = 0, chunk: int = 512,
                          q_offset: int = 0, kv_valid_len=None):
    """The plain PyTorch version: ``chunked_attention``'s online softmax
    over ``chunk``-long key blocks, masked with -1e30 as the reference
    masks; in the offset mode (``q_offset``, ``kv_valid_len`` (B,)) the
    key set is zero-padded to whole chunks, as the reference pads it,
    so a row that sees no key gets the reference's value."""
    B, S, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    _check_mode(S, Sk, causal, window, prefix_len, int(q_offset),
                kv_valid_len is not None)
    G = H // KVH
    scale = 1.0 / torch.sqrt(torch.tensor(float(D)))   # q's D, not v's
    qf = q.reshape(B, S, KVH, G, D).float() * scale
    q_pos = int(q_offset) + torch.arange(S, device=q.device)
    n_chunks = -(-Sk // chunk)
    if q_offset or kv_valid_len is not None:
        pad = n_chunks * chunk - Sk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((B, S, KVH, G), NEG_INF, device=q.device)
    l = torch.zeros((B, S, KVH, G), device=q.device)
    acc = torch.zeros((B, S, KVH, G, v.shape[-1]), device=q.device)
    for c in range(n_chunks):
        kc = k[:, c * chunk:(c + 1) * chunk].float()
        vc = v[:, c * chunk:(c + 1) * chunk].float()
        k_pos = c * chunk + torch.arange(kc.shape[1], device=q.device)
        allow = _allow(q_pos, k_pos, causal, window, prefix_len) \
            & (k_pos < Sk)[None, :]
        allow = allow[None, :, None, None, :]
        if kv_valid_len is not None:
            allow = allow & (k_pos[None, :] < kv_valid_len.to(
                q.device)[:, None])[:, None, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc)
        s = torch.where(allow, s, torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, -1).to(q.dtype)


def _dims(head_dim: int, v_head_dim: int | None = None):
    """The counters' key of a launch: D, or the pair (D, DV) in MLA's
    mode."""
    if v_head_dim is None or v_head_dim == head_dim:
        return head_dim
    return (head_dim, v_head_dim)


def _variant(dtype, head_dim: int, v_head_dim: int | None = None) -> str:
    """The kernel that takes (dtype, head_dim[, v_head_dim]): ``"tc"``
    (tensor cores) for bf16 at head_dim 64, 96, 128 or 256 and at MLA's
    (192, 128), ``"simt"`` for f32 and for bf16 at head_dim 32 and MLA's
    (48, 32); anything else raises."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v, got {dtype}")
    dims = _dims(head_dim, v_head_dim)
    if isinstance(dims, tuple):
        if dims not in MLA_HEAD_DIMS:
            raise ValueError(
                f"flash_attention kernel takes (qk, v) head dims in "
                f"{MLA_HEAD_DIMS} (MLA's mode), got {dims}; other pairs are "
                f"not ported (ROADMAP.md §2)")
        return "tc" if dtype == torch.bfloat16 and \
            dims in TC_MLA_HEAD_DIMS else "simt"
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {head_dim}")
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, window: int = 0,
                              causal: bool = True, prefix_len: int = 0,
                              chunk: int = 512, operands: str = "f32"):
    """The plain PyTorch version of the backward pass, the explicit
    FlashAttention-2 formulas: D = rowsum(dO∘O); P = exp(Q·Kᵀ·scale −
    lse) under the forward's mask (causal / window / prefix, or none);
    dV = Pᵀ·dO;
    dS = P∘(dO·Vᵀ − D); dQ = dS·K·scale; dK = dSᵀ·Q·scale; dK and dV
    summed over each KV head's group. In MLA's mode v, o and dO carry DV
    dims and q, k D: D and dO·Vᵀ sum over DV, the rest over D, and scale
    is 1/sqrt(D). ``lse`` (B, H, S) f32 is the
    forward's row log-sum-exp of the scaled scores. Query rows run in
    ``chunk``-long blocks; math in f32 (or float64 inputs' float64),
    gradients in q's dtype. ``operands="bf16"`` rounds P and dS to bf16
    before the products that take them (dV, dK, dQ), as the ``tc``
    kernel feeds them to the tensor cores; sums stay in the working
    dtype. ``"f32"`` rounds nothing."""
    if operands not in ("f32", "bf16"):
        raise ValueError(f"operands must be 'f32' or 'bf16', got "
                         f"{operands!r}")
    B, S, H, D = q.shape
    KVH, DV = k.shape[2], v.shape[-1]
    _check_mode(S, k.shape[1], causal, window, prefix_len)
    G = H // KVH
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / float(D) ** 0.5
    qf = q.to(wd).reshape(B, S, KVH, G, D)
    kf, vf = k.to(wd), v.to(wd)
    dof = do.to(wd).reshape(B, S, KVH, G, DV)
    delta = (do.to(wd) * o.to(wd)).sum(-1).reshape(B, S, KVH, G)
    lsef = lse.to(wd).permute(0, 2, 1).reshape(B, S, KVH, G)
    pos = torch.arange(S, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in range(0, S, chunk):
        allow = _allow(pos[c0:c0 + chunk], k_pos, causal, window,
                       prefix_len)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf[:, c0:c0 + chunk], kf)
        p = torch.exp(s * scale - lsef[:, c0:c0 + chunk, ..., None])
        p = torch.where(allow[None, :, None, None, :], p, 0.0)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof[:, c0:c0 + chunk], vf)
        ds = p * (dp - delta[:, c0:c0 + chunk, ..., None])
        if operands == "bf16":
            p = p.to(torch.bfloat16).to(wd)
            ds = ds.to(torch.bfloat16).to(wd)
        dv += torch.einsum("bqhgk,bqhgd->bkhd", p, dof[:, c0:c0 + chunk])
        dq[:, c0:c0 + chunk] = torch.einsum("bqhgk,bkhd->bqhgd", ds,
                                            kf) * scale
        dk += torch.einsum("bqhgk,bqhgd->bkhd", ds,
                           qf[:, c0:c0 + chunk]) * scale
    out = q.dtype
    return (dq.reshape(B, S, H, D).to(out), dk.to(out), dv.to(out))


def _bf16_ulp(x):
    """One bf16 ulp at each element's |x| (0 where x is 0)."""
    _, e = torch.frexp(x.abs())             # |x| = m · 2^e, m in [0.5, 1)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def _to_bf16_midpoint(x):
    """|x|'s distance to the nearest midpoint between two bf16 values:
    how far x may move before its bf16 rounding flips (inf at 0)."""
    u = _bf16_ulp(x)
    t = x.abs() / torch.where(u == 0, 1.0, u)
    return torch.where(x == 0, torch.inf, (t - t.floor() - 0.5).abs() * u)


def flash_attention_bwd_flip_bound(q, k, v, o, lse, do, *, window: int = 0,
                                   causal: bool = True, prefix_len: int = 0,
                                   chunk: int = 512, n: int | None = None):
    """How far an f32 evaluation of the tc backward's function
    (``flash_attention_bwd_plain(..., operands="bf16")``) may lie from
    its exact value (the same on float64 inputs) through the bf16
    roundings of P and dS alone: per gradient element, the sum of
    |a bf16 ulp of the term x the other operand| over every P and dS that
    lies within such an evaluation's error of a midpoint between two bf16
    values, where its rounding can go either way. (A P or dS rounded one
    ulp the other way moves dV, dK, dQ by that term; the f32 error itself
    is far below the elementwise rule's.) The evaluation's error, after
    Higham's bound on an f32 dot product of length n (|error| <= n 2^-24
    sum |terms|; n = the head_dim D by default): the exp argument
    s scale - lse within n 2^-24 (sum |q k| scale + |lse| + 1), so P
    within P times that (plus n 2^-24 P for the exp), and dS = P (dP - D)
    within n 2^-24 (|dS| + P (sum |dO V| + sum |dO O|)) plus |dS| times
    P's relative error. Float64 (B, S, H, D), (B, Sk, KVH, D), (B, Sk,
    KVH, DV) bounds; query rows in ``chunk``-long blocks."""
    B, S, H, D = q.shape
    Sk, KVH, DV = k.shape[1], k.shape[2], v.shape[-1]
    _check_mode(S, Sk, causal, window, prefix_len)
    G, f = H // KVH, torch.float64
    eps = (D if n is None else n) * 2.0 ** -24
    scale = 1.0 / float(D) ** 0.5
    qf, dof, of = q.to(f), do.to(f), o.to(f)
    kf, vf = (t.to(f).repeat_interleave(G, 2) for t in (k, v))
    lsef = lse.to(f).permute(0, 2, 1)[..., None]             # b q h 1
    pos, k_pos = (torch.arange(n_, device=q.device) for n_ in (S, Sk))
    bq = torch.empty_like(qf)
    bk = torch.zeros((B, Sk, H, D), dtype=f, device=q.device)
    bv = torch.zeros((B, Sk, H, DV), dtype=f, device=q.device)
    for c0 in range(0, S, chunk):
        rows = slice(c0, c0 + chunk)
        allow = _allow(pos[rows], k_pos, causal, window, prefix_len)
        s = torch.einsum("bqhd,bkhd->bqhk", qf[:, rows], kf)
        arg = s * scale - lsef[:, rows]
        p = torch.where(allow[None, :, None], torch.exp(arg), 0.0)
        d_arg = eps * (torch.einsum("bqhd,bkhd->bqhk", qf[:, rows].abs(),
                                    kf.abs()) * scale
                       + lsef[:, rows].abs() + 1.0)
        del s, arg
        dp = torch.einsum("bqhd,bkhd->bqhk", dof[:, rows], vf)
        prod = dof[:, rows] * of[:, rows]
        ds = p * (dp - prod.sum(-1)[..., None])
        mag = (torch.einsum("bqhd,bkhd->bqhk", dof[:, rows].abs(), vf.abs())
               + prod.abs().sum(-1)[..., None])
        del dp, prod
        fp = torch.where(_to_bf16_midpoint(p) < p * (d_arg + eps),
                         _bf16_ulp(p), 0.0)
        fds = torch.where(_to_bf16_midpoint(ds)
                          < ds.abs() * (d_arg + eps) + eps * p * mag,
                          _bf16_ulp(ds), 0.0)
        del p, ds, mag, d_arg
        bq[:, rows] = torch.einsum("bqhk,bkhd->bqhd", fds, kf.abs()) * scale
        bk += torch.einsum("bqhk,bqhd->bkhd", fds, qf[:, rows].abs()) * scale
        bv += torch.einsum("bqhk,bqhd->bkhd", fp, dof[:, rows].abs())
    return (bq, bk.reshape(B, Sk, KVH, G, D).sum(3),
            bv.reshape(B, Sk, KVH, G, DV).sum(3))


def _bwd_tc_tile_masked(q0, kw0, Sk, causal, window, prefix):
    """Whether the tc backward masks the 64 keys from ``kw0`` against the
    64 rows from ``q0`` (``fbt_tile_masked``, ``FBT_NEED_MASK``): the
    tile holds a masked pair, or keys past Sk."""
    T = TC_BWD_TILE
    if not causal:
        return kw0 + T > Sk
    if prefix:
        return kw0 + T - 1 > (prefix - 1 if q0 < prefix else q0)
    return kw0 + T - 1 > q0 or (window > 0 and q0 + T - 1 - kw0 >= window)


def bwd_tc_schedule(Sq: int, Sk: int, *, keys: int = TC_BWD_KEYS,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0):
    """The tc backward's walk, as ``fbt_main128`` (``keys`` 128) and
    ``fbt_mla`` / ``fbt_main256`` (64) run it: for each key block (its
    first key k0) the 64-row query tiles t from the first that sees one
    of its keys (its diagonal, causal; row 0 for a block that starts in
    the prefix, or cross) to the window's far edge or the last row, and
    for each 64-key part of the block (a warpgroup's keys, from kw0) on
    that tile, whether it is masked. Every part is computed, one whose
    pairs are all masked too (it gives zeros). Yields (k0, t, [(kw0,
    masked), ...])."""
    T = TC_BWD_TILE
    prefix = min(int(prefix_len), Sk)
    for k0 in range(0, Sk, keys):
        k_last = min(k0 + keys, Sk) - 1
        q_last = min(Sq - 1, k_last + window - 1) if window > 0 else Sq - 1
        if not causal:
            t_begin = 0
        else:
            t_begin = (0 if k0 < prefix else k0) // T
        for t in range(t_begin, q_last // T + 1):
            yield k0, t, [(kw0, _bwd_tc_tile_masked(t * T, kw0, Sk, causal,
                                                    window, prefix))
                          for kw0 in range(k0, k0 + keys, T)]


def flash_attention_bwd_blocks_plain(q, k, v, o, lse, do, *, window: int = 0,
                                     causal: bool = True,
                                     prefix_len: int = 0):
    """The tc backward's blocking in plain PyTorch: its function
    (``flash_attention_bwd_plain(..., operands="bf16")``) computed as the
    kernels compute it. Key blocks of :data:`TC_BWD_KEYS` keys at head_dim
    64, 96 and 128 (``fbt_main128``), a 64-key half a warpgroup (each
    forms S^T and dP^T of its own keys; dQ's columns split at 32 at
    head_dim 64, else at 64); of 64 keys in MLA's mode and at 256
    (``fbt_mla``, ``fbt_main256``), whose two warpgroups split the query
    rows of S^T and dP^T 32 / 32 and deal out the 64-column blocks of dK,
    dV and dQ. Each block walks :func:`bwd_tc_schedule`'s query tiles and
    masks only the parts it flags; P and dS rounded to bf16 as the
    products' operands; dQ summed over the key blocks in an f32
    accumulator; dK and dV a block's own sums, written (dK scaled) by
    ``fbt_main128`` and ``fbt_mla`` where the group is one head, else
    per-query-head partials summed over the group in order. Math in f32
    (float64 inputs' float64); rows past S take lse = 1e30 (P = 0) and
    keys past Sk are zero rows, as the kernels' padding."""
    B, S, H, D = q.shape
    Sk, KVH, DV = k.shape[1], k.shape[2], v.shape[-1]
    _check_mode(S, Sk, causal, window, prefix_len)
    T, G = TC_BWD_TILE, H // KVH
    shared = D != DV or D == 256       # two warpgroups share 64 keys
    keys = T if shared else TC_BWD_KEYS
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / float(D) ** 0.5
    prefix = min(int(prefix_len), Sk)
    sp, kp = -(-S // T) * T, -(-Sk // keys) * keys
    pad = lambda x, n: torch.nn.functional.pad(
        x.to(wd), (0, 0, 0, 0, 0, n - x.shape[1]))
    qf, dof = pad(q, sp), pad(do, sp)
    kf = pad(k, kp).repeat_interleave(G, 2)      # head h reads h // G
    vf = pad(v, kp).repeat_interleave(G, 2)
    delta = pad((do.to(wd) * o.to(wd)).sum(-1, keepdim=True), sp)[..., 0]
    lsef = torch.full((B, sp, H), 1e30, dtype=wd)
    lsef[:, :S] = lse.to(wd).permute(0, 2, 1)
    bf = lambda x: x.to(torch.bfloat16).to(wd)
    dq_acc = torch.zeros((B, sp, H, D), dtype=wd)
    dk_part = torch.zeros((B, kp, H, D), dtype=wd)
    dv_part = torch.zeros((B, kp, H, DV), dtype=wd)
    q_pos, k_pos = torch.arange(sp), torch.arange(kp)
    for k0, t, parts in bwd_tc_schedule(S, Sk, keys=keys, causal=causal,
                                        window=window, prefix_len=prefix):
        rows = slice(t * T, t * T + T)
        ds_block = torch.zeros((B, T, H, keys), dtype=wd)
        for kw0, masked in parts:
            cols = slice(kw0, kw0 + T)
            s = torch.einsum("bqhd,bkhd->bqhk", qf[:, rows], kf[:, cols])
            p = torch.exp(s * scale - lsef[:, rows, :, None])
            if masked:
                allow = _allow(q_pos[rows], k_pos[cols], causal, window,
                               prefix) & (k_pos[cols] < Sk)[None, :]
                p = torch.where(allow[None, :, None, :], p, 0.0)
            dp = torch.einsum("bqhd,bkhd->bqhk", dof[:, rows], vf[:, cols])
            ds = bf(p * (dp - delta[:, rows, :, None]))
            dv_part[:, cols] += torch.einsum("bqhk,bqhd->bkhd", bf(p),
                                             dof[:, rows])
            dk_part[:, cols] += torch.einsum("bqhk,bqhd->bkhd", ds,
                                             qf[:, rows])
            ds_block[..., kw0 - k0:kw0 - k0 + T] = ds
        # dQ = dS K over the block's keys, its columns split over the two
        # warpgroups (128 + 64 in MLA's mode, 128 + 128 at 256), added
        # into the accumulator
        kb = kf[:, k0:k0 + keys]
        dq0 = 128 if shared else 32 if D == 64 else 64
        for c0, c1 in ((0, dq0), (dq0, D)):
            dq_acc[:, rows, :, c0:c1] += torch.einsum(
                "bqhk,bkhd->bqhd", ds_block, kb[..., c0:c1])
    dk_part, dv_part = dk_part[:, :Sk], dv_part[:, :Sk]
    if G == 1 and D != 256:       # written by the block itself
        dk, dv = dk_part * scale, dv_part
    else:                         # fbt_finish: the group's partials, in order
        dk = dk_part.reshape(B, Sk, KVH, G, D)[..., 0, :].clone()
        dv = dv_part.reshape(B, Sk, KVH, G, DV)[..., 0, :].clone()
        for g in range(1, G):
            dk += dk_part.reshape(B, Sk, KVH, G, D)[..., g, :]
            dv += dv_part.reshape(B, Sk, KVH, G, DV)[..., g, :]
        dk = dk * scale
    out = q.dtype
    return (dq_acc[:, :S] * scale).to(out), dk.to(out), dv.to(out)


def _fn(variant: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant == "tc":
        fn = build.load("flash_attention_tc").flash_attention_tc_launch
        args = [p] * 5 + [i] * 11 + [p, p]
    elif variant == "bwd_simt":
        fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
        args = [i] + [p] * 10 + [i] * 10 + [p]
    elif variant == "bwd_tc":
        fn = build.load("flash_attention_bwd_tc").flash_attention_bwd_tc_launch
        args = [p] * 13 + [i] * 10 + [p]
    else:
        fn = build.load("flash_attention").flash_attention_launch
        args = [i] + [p] * 5 + [i] * 11 + [p, p]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = i
    return fn


def _shape(q, k, window: int, causal: bool, prefix_len: int, stream,
           v=None):
    """The kernels' trailing integer arguments (D, then v's DV: k's D
    without ``v``) and stream; a prefix past the last key is the whole
    sequence (every key visible to every row)."""
    B, S, H, D = q.shape
    DV = k.shape[-1] if v is None else v.shape[-1]
    return (B, S, k.shape[1], H, k.shape[2], D, DV, int(window),
            int(causal), min(int(prefix_len), k.shape[1]), stream)


def _mode(causal: bool, prefix_len: int, offset: bool = False) -> str:
    return "offset" if offset else "prefix" if causal and prefix_len else \
        "causal" if causal else "cross"


def _count(fn, variant: str, dims, causal: bool, prefix_len: int,
           offset: bool = False):
    fn.launches += 1
    fn.launches_by_variant[variant] += 1
    fn.launches_by_head_dim[dims] += 1
    fn.launches_by_mode[_mode(causal, prefix_len, offset)][variant] += 1


def _launch(variant: str, q, k, v, window: int, causal: bool = True,
            lse=None, prefix_len: int = 0, q_offset: int = 0,
            kv_valid=None):
    """Run one forward kernel on checked CUDA tensors and count the
    launch; ``lse`` (B, H, Sq) f32, when given, receives the rows'
    log-sum-exp (training only); ``q_offset`` and ``kv_valid`` (B,)
    int32 on the card, the offset mode."""
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    shape = _shape(q, k, window, causal, prefix_len, stream, v)
    shape = shape[:-1] + (int(q_offset), None if kv_valid is None
                          else kv_valid.data_ptr(), stream)
    with torch.cuda.device(q.device):
        if variant == "tc":
            rc = _fn("tc")(*ptrs, *shape)
        else:
            rc = _fn("simt")(_DTYPES[q.dtype], *ptrs, *shape)
    if rc != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch "
                           f"failed: CUDA error {rc}")
    _count(flash_attention, variant, _dims(q.shape[-1], v.shape[-1]), causal,
           prefix_len, bool(q_offset) or kv_valid is not None)
    return out


def _check(q, k, v, *, causal: bool = True, window: int = 0,
           prefix_len: int = 0, q_offset: int = 0, kv_valid=None):
    """Raise on what the CUDA kernels do not take; returns the variant.
    ``kv_valid``, when given, must be (B,) int32, contiguous, on q's
    device."""
    B, S, H, D = q.shape
    Sk, KVH, DV = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, Sk, KVH, D) or v.shape != (B, Sk, KVH, DV) or Sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: the kernel "
                         f"takes k (B, Sk, KVH, D), v (B, Sk, KVH, DV) with "
                         f"Sk >= 1")
    _check_mode(S, Sk, causal, window, prefix_len, q_offset,
                kv_valid is not None)
    if kv_valid is not None and (
            tuple(kv_valid.shape) != (B,) or kv_valid.dtype != torch.int32
            or kv_valid.device != q.device or not kv_valid.is_contiguous()):
        raise ValueError(f"flash_attention: kv_valid_len must be a "
                         f"contiguous int32 ({B},) tensor on {q.device}, got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)} on "
                         f"{kv_valid.device}")
    if KVH < 1 or H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} kv heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    variant = _variant(q.dtype, D, DV)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {q.device}")
        if variant == "tc" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary (TMA)")
    return variant


def _bwd_tc_run(fn, q, k, v, o, lse, do, window: int, causal: bool = True,
                prefix_len: int = 0):
    """One call of the tc backward's C entry ``fn`` (the committed one, or
    an ablation's copy) on checked CUDA tensors, with the scratch it
    takes: the rows' (lse, D) pairs (B, H, Sp, 2) and the dQ accumulator
    (B, H, Sp, D), f32 with Sp = S rounded up to 64 (the key blocks add
    their dQ rows into it, so dQ's summation order varies between runs);
    the f32 per-query-head partials of dK (B, Sk, H, D) and dV (B, Sk, H,
    DV), which ``fbt_finish`` sums over each group in a fixed order, only
    where the main kernel does not write dK and dV itself (a group of
    H / KVH > 1 heads, or head_dim 256). dK and dV are the same from run
    to run. Returns (rc, dq, dk, dv)."""
    B, S, H, D = q.shape
    Sk, KVH, DV = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sp = -(-S // TC_BWD_TILE) * TC_BWD_TILE
    dev = q.device
    ld = torch.empty((B, H, sp, 2), device=dev)
    dq_acc = torch.empty((B, H, sp, D), device=dev)
    dk_part = dv_part = None
    if H != KVH or D == 256:
        dk_part = torch.empty((B, Sk, H, D), device=dev)
        dv_part = torch.empty((B, Sk, H, DV), device=dev)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), ld.data_ptr(),
                dq_acc.data_ptr(),
                None if dk_part is None else dk_part.data_ptr(),
                None if dv_part is None else dv_part.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_shape(q, k, window, causal, prefix_len, stream, v))
    return rc, dq, dk, dv


def _bwd_launch(variant: str, q, k, v, o, lse, do, window: int,
                causal: bool = True, prefix_len: int = 0):
    """Run one backward call of the given variant on checked CUDA
    tensors and count it (each variant issues three kernels a call;
    ``tc``'s scratch: :func:`_bwd_tc_run`)."""
    B, S, H, D = q.shape
    DV = v.shape[-1]
    if variant == "tc":
        rc, dq, dk, dv = _bwd_tc_run(_fn("bwd_tc"), q, k, v, o, lse, do,
                                     window, causal, prefix_len)
    else:
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        delta = torch.empty((B, H, S), device=q.device)
        with torch.cuda.device(q.device):
            rc = _fn("bwd_simt")(_DTYPES[q.dtype], q.data_ptr(),
                                 k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(),
                                 *_shape(q, k, window, causal, prefix_len,
                                         stream, v))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward {variant} kernel "
                           f"launch failed: CUDA error {rc}")
    _count(flash_attention_bwd, variant, _dims(D, DV), causal, prefix_len)
    return dq, dk, dv


def _bwd_check(q, k, v, o, lse, do, *, causal: bool = True,
               window: int = 0, prefix_len: int = 0):
    """Raise on what the backward kernels do not take; returns the
    variant, the forward's (:func:`_variant`)."""
    variant = _check(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len)
    B, S, H, D = q.shape
    o_shape = (B, S, H, v.shape[-1])
    for name, t in (("o", o), ("do", do)):
        if t.shape != o_shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {q.dtype} {o_shape} tensor on "
                             f"{q.device}")
        if variant == "tc" and t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must start on a "
                             f"16-byte boundary (TMA)")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 {(B, H, S)} on {q.device}")
    return variant


def flash_attention_bwd(q, k, v, o, lse, do, *, window: int = 0,
                        causal: bool = True, prefix_len: int = 0,
                        chunk: int = 512):
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, its
    rows' log-sum-exp ``lse`` (B, H, Sq) f32 and dO: on CUDA tensors the
    kernels of the forward's variant (``csrc/flash_attention_bwd_tc.cu``
    for bf16 at head_dim 64/96/128/256 and MLA's (192, 128),
    ``csrc/flash_attention_bwd.cu`` otherwise; one launch counted per
    call), on CPU tensors
    :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, window=window,
                                         causal=causal,
                                         prefix_len=prefix_len, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    variant = _bwd_check(q, k, v, o, lse, do, causal=causal, window=window,
                         prefix_len=prefix_len)
    return _bwd_launch(variant, q, k, v, o, lse, do, window, causal,
                       prefix_len)


def _zero_counts(fn):
    """Set a kernel entry's launch counters to zero."""
    fn.launches = 0
    fn.launches_by_variant = {"tc": 0, "simt": 0}
    fn.launches_by_head_dim = dict.fromkeys(HEAD_DIMS + MLA_HEAD_DIMS, 0)
    fn.launches_by_mode = {m: {"tc": 0, "simt": 0} for m in MODES}


_zero_counts(flash_attention_bwd)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on CUDA tensors with a kernel backward: the
    forward launches the forward kernel of :func:`_variant` with its
    rows' log-sum-exp written, the backward the same variant's backward
    kernels through :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool = True,
                prefix_len: int = 0):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), device=q.device)
        out = _launch(_variant(q.dtype, q.shape[-1], v.shape[-1]), q, k, v,
                      window, causal, lse, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal, ctx.prefix_len = window, causal, prefix_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         window=ctx.window,
                                         causal=ctx.causal,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, window: int = 0, causal: bool = True,
                    prefix_len: int = 0, chunk: int = 512, q_offset: int = 0,
                    kv_valid_len=None):
    """GQA attention: causal with a per-layer ``window`` (0 = full) or a
    bidirectional prefix of ``prefix_len`` positions (the prefix-LM
    mask), or with ``causal=False`` every key of k (B, Sk, KVH, D), v (B,
    Sk, KVH, DV) visible to every row (cross-attention); the output is
    (B, Sq, H, DV). In the offset mode q's rows sit at positions
    ``q_offset`` + their index and batch b sees only its first
    ``kv_valid_len[b]`` keys (see the module note). ``chunk`` is the
    plain version's key block; the kernels tile keys by 64 (``simt``,
    and ``tc`` at head_dim 256) or 128 (``tc``). With grad enabled and an
    input that requires grad the call goes through
    :class:`FlashAttentionFn` (the offset mode then raises: its backward
    is not ported); under ``torch.no_grad`` no log-sum-exp is written."""
    q_offset = int(q_offset)
    # meta tensors (the dry run's shapes) take the plain version too
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, window=window, causal=causal,
                                     prefix_len=prefix_len, chunk=chunk,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if kv_valid_len is not None:
        kv_valid_len = torch.as_tensor(kv_valid_len).to(
            device=q.device, dtype=torch.int32).contiguous()
    variant = _check(q, k, v, causal=causal, window=window,
                     prefix_len=prefix_len, q_offset=q_offset,
                     kv_valid=kv_valid_len)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        if q_offset or kv_valid_len is not None:
            raise NotImplementedError(
                "flash_attention: the backward of the offset mode "
                "(q_offset, kv_valid_len) is not ported (ROADMAP.md item "
                "10b.1: nothing trains through decode)")
        return FlashAttentionFn.apply(q, k, v, int(window), bool(causal),
                                      int(prefix_len))
    return _launch(variant, q, k, v, window, causal, prefix_len=prefix_len,
                   q_offset=q_offset, kv_valid=kv_valid_len)


_zero_counts(flash_attention)
