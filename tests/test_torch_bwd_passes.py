"""The math of the two tensor-core-era backward kernels, on the CPU.

``ssd_scan_bwd_passes_plain`` states the passes of ``csrc/ssd_scan_bwd.cu``
(tile states forward and reverse, state passing both ways, per-tile
products with strictly causal masks, the reverse cumulative sum in
double) at a tile length other than the model's chunk. It is held to the
sequential ``ssd_scan_bwd_plain`` (exactly, in float64) and, in float32,
by the repo's float64 rule: against float64 gradients its error is at
most ``SSD_VS_F32`` times that of the sequential f32 version and of
``jax.vjp`` of the reference's ``ssd_chunked``, plus a sliver of each
gradient's max |value|. Ragged tails, grouped B/C, N 4 to 128 and decays
steep enough that exp underflows to 0.

``flash_attention_bwd_plain(..., operands="bf16")`` is the function of
``csrc/flash_attention_bwd_tc.cu``: P and dS rounded to bf16 before the
products that take them. With ``operands="f32"`` it is bitwise the
unrounded formulas; with ``"bf16"`` on bf16 inputs it lies within
``BF16_GRAD_TOL`` of ``jax.vjp`` of the reference's ``chunked_attention``
in f32. ``flash_attention_bwd_blocks_plain`` states that kernel's
blocking (key blocks split over two warpgroups, each block's walk over
query tiles, the tiles it masks, dQ summed over key blocks,
dK and dV written by the block or summed over the group); it is held to
that function and to ``jax.vjp``, and ``bwd_tc_schedule`` visits every
visible (row, key) pair once and leaves no masked pair on a tile it does
not mask. ``flash_attention_bwd_flip_bound``, the card tests' allowance
for P and dS that an f32 evaluation may round to the other bf16
neighbour, holds f32 evaluations of the function (two orders, lse off by
8 ulps) to its float64 statement and catches a dS or P rounded toward
zero and a P rounded before dS is formed. Inputs come from numpy seeds."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_bwd_blocks_plain
from repro_torch.kernels.ssd_scan import ops as ssd_ops

from test_torch_common import t

torch.set_num_threads(1)

SSD_VS_F32 = 4.0        # the float64 rule of the repo's SSD checks
SSD_GRAD_TOL = 1e-6     # its additive term, of each gradient's max |value|
EXACT64 = 1e-10         # the passes against the recurrence, both float64
BF16_GRAD_TOL = 2.0 ** -7   # of each gradient's max |value|: the output's
                        # bf16 rounding (up to 2^-8 of it) plus P and dS
                        # rounded to bf16 (2^-9 relative per term, summed)


def _ssd_inputs(seed, B, S, H, P, G, N, steep):
    """x, dt, a_log (A = −steep·(1..H)), grouped b, c and dy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    a_log = np.log(steep * np.arange(1, H + 1)).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    return x, dt, a_log, b, c, dy


def _prologue(x, dt, a_log, dtype):
    """xdt = x·dt and dta = dt·A, as the model's SSD prologue forms them."""
    tx, tdt = (torch.tensor(a, dtype=dtype) for a in (x, dt))
    A = -torch.exp(torch.tensor(a_log, dtype=dtype))
    return (tx * tdt[..., None]).contiguous(), (tdt * A).contiguous(), A


def _no_less_exact(got, ref, exact, what):
    scale = float(np.abs(exact).max())
    e_got = float(np.abs(np.asarray(got, np.float64) - exact).max())
    e_ref = float(np.abs(np.asarray(ref, np.float64) - exact).max())
    assert e_got <= SSD_VS_F32 * e_ref + SSD_GRAD_TOL * scale, (
        what, e_got, e_ref, scale)


SSD_CASES = [
    # B, S, H, P, G, N, tile, steep
    (2, 100, 4, 16, 2, 8, 32, 1.0),     # ragged tail, two groups
    (1, 77, 6, 16, 3, 12, 16, 1.0),     # ragged, N % 8 == 4
    (2, 45, 4, 8, 2, 4, 16, 1.0),       # N 4
    (1, 70, 2, 16, 1, 128, 32, 1.0),    # N 128
    (2, 96, 4, 32, 1, 8, 32, 50.0),     # steep: exp underflows to 0
    (1, 40, 2, 16, 1, 4, 1, 1.0),       # a tile of one position
]


@pytest.mark.parametrize("B,S,H,P,G,N,tile,steep", SSD_CASES)
def test_ssd_bwd_passes_match_the_recurrence(B, S, H, P, G, N, tile, steep):
    """Float64: the passes equal the sequential recurrence to EXACT64 of
    each gradient's max |value|. Float32: against those float64
    gradients, no less exact than the sequential f32 version (the
    float64 rule)."""
    x, dt, a_log, b, c, dy = _ssd_inputs(31 + S, B, S, H, P, G, N, steep)
    ins = {}
    for dtype in (torch.float64, torch.float32):
        xdt, dta, _ = _prologue(x, dt, a_log, dtype)
        ins[dtype] = (xdt, dta) + tuple(torch.tensor(a, dtype=dtype)
                                        for a in (b, c, dy))
    exact = ssd_ops.ssd_scan_bwd_plain(*ins[torch.float64])
    got64 = ssd_ops.ssd_scan_bwd_passes_plain(*ins[torch.float64], tile=tile)
    got32 = ssd_ops.ssd_scan_bwd_passes_plain(*ins[torch.float32], tile=tile)
    seq32 = ssd_ops.ssd_scan_bwd_plain(*ins[torch.float32])
    for name, g64, g32, s32, e in zip(("dxdt", "ddta", "db", "dc"), got64,
                                      got32, seq32, exact):
        assert g32.dtype == torch.float32 and g32.shape == e.shape, name
        scale = float(e.abs().max())
        assert float((g64 - e).abs().max()) <= EXACT64 * scale, name
        _no_less_exact(g32.numpy(), s32.numpy(), e.numpy(), name)


def _tf32(t):
    """f32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return ((i + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("B,S,H,P,G,N,tile,steep", [
    SSD_CASES[0], SSD_CASES[4], (1, 130, 6, 64, 1, 16, 64, 1.0)])
def test_ssd_bwd_passes_tf32_split_no_less_exact(monkeypatch, B, S, H, P,
                                                 G, N, tile, steep):
    """The f32 passes with every two-operand product's operands split into
    TF32 high and low parts and taken as the three products of 3xTF32
    (the low parts' product dropped), as csrc/ssd_scan_bwd.cu splits
    them, summed exactly: against float64 gradients, no less exact than
    the sequential f32 version (the float64 rule). So neither the passes
    nor the split cost accuracy; the kernel's sums (mma3_rn) are its
    own."""
    x, dt, a_log, b, c, dy = _ssd_inputs(51 + S, B, S, H, P, G, N, steep)
    ins = {}
    for dtype in (torch.float64, torch.float32):
        xdt, dta, _ = _prologue(x, dt, a_log, dtype)
        ins[dtype] = (xdt, dta) + tuple(torch.tensor(a, dtype=dtype)
                                        for a in (b, c, dy))
    exact = ssd_ops.ssd_scan_bwd_plain(*ins[torch.float64])
    seq32 = ssd_ops.ssd_scan_bwd_plain(*ins[torch.float32])
    einsum = torch.einsum

    def split3(eq, *ops):
        if len(ops) != 2 or any(o.dtype != torch.float32 for o in ops):
            return einsum(eq, *ops)
        parts = []
        for o in ops:
            hi = _tf32(o)
            parts.append((hi.double(), _tf32(o - hi).double()))
        (ah, al), (bh, bl) = parts
        return (einsum(eq, al, bh) + einsum(eq, ah, bl)
                + einsum(eq, ah, bh)).float()
    monkeypatch.setattr(torch, "einsum", split3)
    got = ssd_ops.ssd_scan_bwd_passes_plain(*ins[torch.float32], tile=tile)
    monkeypatch.undo()
    for name, g, s32, e in zip(("dxdt", "ddta", "db", "dc"), got, seq32,
                               exact):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        _no_less_exact(g.numpy(), s32.numpy(), e.numpy(), name)


@pytest.mark.parametrize("B,S,H,P,G,N,tile,steep,chunk", [
    (2, 100, 4, 16, 2, 8, 32, 1.0, 25),
    (1, 70, 2, 16, 1, 128, 32, 1.0, 16),
    (2, 96, 4, 32, 1, 8, 32, 50.0, 16),
])
def test_ssd_bwd_passes_match_jax_vjp(B, S, H, P, G, N, tile, steep, chunk):
    """The passes' f32 gradients, chained through the prologue to
    (x, dt, a_log, b, c), against jax.vjp of the reference's ssd_chunked
    at another chunk than the passes' tile: both against float64
    gradients of the same function, the passes no less exact than the
    reference (the float64 rule)."""
    x, dt, a_log, b, c, dy = _ssd_inputs(41 + S, B, S, H, P, G, N, steep)
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk=chunk)[0],
                     x, dt, a_log, b, c)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    grads = {}
    for dtype in (torch.float64, torch.float32):
        xdt, dta, A = _prologue(x, dt, a_log, dtype)
        tx, tdt = (torch.tensor(a, dtype=dtype) for a in (x, dt))
        dxdt, ddta, db, dc = ssd_ops.ssd_scan_bwd_passes_plain(
            xdt, dta, *(torch.tensor(a, dtype=dtype) for a in (b, c, dy)),
            tile=tile)
        grads[dtype] = [g.numpy() for g in (
            dxdt * tdt[..., None], (dxdt * tx).sum(-1) + ddta * A,
            (ddta * tdt * A).sum((0, 1)), db, dc)]
    for name, g, r, e in zip(("x", "dt", "a_log", "b", "c"),
                             grads[torch.float32], ref,
                             grads[torch.float64]):
        _no_less_exact(g, r, e, f"d{name}")


def _lse(q, k, window):
    """The forward's row log-sum-exp (B, H, S) of the scaled scores."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 2)) / math.sqrt(D)
    pos = torch.arange(S)
    allow = pos[None, :] <= pos[:, None]
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    return torch.logsumexp(s.masked_fill(~allow, -1e30), -1)


def _unrounded_formulas(q, k, v, o, lse, do, window, chunk):
    """FlashAttention-2's backward formulas over chunk-long row blocks,
    written out as the plain version computed them before it took the
    operands switch; the yardstick of operands="f32" bit for bit."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    wd = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / float(D) ** 0.5
    qf = q.to(wd).reshape(B, S, KVH, G, D)
    kf, vf = k.to(wd), v.to(wd)
    dof = do.to(wd).reshape(B, S, KVH, G, D)
    delta = (do.to(wd) * o.to(wd)).sum(-1).reshape(B, S, KVH, G)
    lsef = lse.to(wd).permute(0, 2, 1).reshape(B, S, KVH, G)
    pos = torch.arange(S)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in range(0, S, chunk):
        rows = pos[c0:c0 + chunk]
        allow = pos[None, :] <= rows[:, None]
        if window > 0:
            allow = allow & (rows[:, None] - pos[None, :] < window)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf[:, c0:c0 + chunk], kf)
        p = torch.exp(s * scale - lsef[:, c0:c0 + chunk, ..., None])
        p = torch.where(allow[None, :, None, None, :], p, 0.0)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof[:, c0:c0 + chunk], vf)
        ds = p * (dp - delta[:, c0:c0 + chunk, ..., None])
        dv += torch.einsum("bqhgk,bqhgd->bkhd", p, dof[:, c0:c0 + chunk])
        dq[:, c0:c0 + chunk] = torch.einsum("bqhgk,bkhd->bqhgd", ds,
                                            kf) * scale
        dk += torch.einsum("bqhgk,bqhgd->bkhd", ds,
                           qf[:, c0:c0 + chunk]) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _attn_inputs(seed, B, S, H, KVH, D, dtype):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    return [t(a).to(dtype) for a in (q, k, v, do)]


ATTN_CASES = [(2, 75, 4, 2, 16, 0), (2, 75, 4, 2, 16, 20),
              (1, 130, 4, 1, 64, 0), (1, 90, 6, 3, 64, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,D,window", ATTN_CASES)
def test_flash_bwd_plain_f32_operands_round_nothing(dtype, B, S, H, KVH, D,
                                                    window):
    """operands="f32" (the default) is bitwise the unrounded formulas, in
    f32 and on bf16 inputs; an unknown operands value raises."""
    q, k, v, do = _attn_inputs(51 + S, B, S, H, KVH, D, dtype)
    o = flash_attention_plain(q, k, v, window=window, chunk=32)
    lse = _lse(q, k, window)
    want = _unrounded_formulas(q, k, v, o, lse, do, window, 32)
    for got in (flash_attention_bwd_plain(q, k, v, o, lse, do, window=window,
                                          chunk=32),
                flash_attention_bwd_plain(q, k, v, o, lse, do, window=window,
                                          chunk=32, operands="f32")):
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    with pytest.raises(ValueError, match="operands"):
        flash_attention_bwd_plain(q, k, v, o, lse, do, operands="fp8")


@pytest.mark.parametrize("B,S,H,KVH,D,window", ATTN_CASES)
def test_flash_bwd_plain_bf16_operands_match_jax_vjp(B, S, H, KVH, D,
                                                     window):
    """operands="bf16" on bf16 inputs against jax.vjp of the reference's
    chunked_attention in f32 on the same (bf16-representable) values:
    each gradient within BF16_GRAD_TOL of its max |value|; and the
    rounding is real (the result differs from operands="f32")."""
    q, k, v, do = _attn_inputs(61 + S, B, S, H, KVH, D, torch.bfloat16)
    f32 = [x.float().numpy() for x in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, causal=True, window=window, chunk=32), *f32[:3])
    ref = [np.asarray(g) for g in vjp(jnp.asarray(f32[3]))]
    o = flash_attention_plain(q, k, v, window=window, chunk=32)
    lse = _lse(q, k, window)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, window=window,
                                    chunk=32, operands="bf16")
    unrounded = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                          window=window, chunk=32)
    assert any(not torch.equal(g, u) for g, u in zip(got, unrounded))
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16, name
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= BF16_GRAD_TOL * float(np.abs(r).max()), (name, err)


# the tc backward's blocking: (B, S, Sk, H, KVH, D, DV, causal, window,
# prefix) — head_dim 96 and MLA's (192, 128) at G = 1 and G > 1, a window
# crossing the 128-key blocks' edges, S and Sk ragged against the block,
# cross at Sk 64 and a ragged Sk, prefixes ending mid-block, head_dim 64,
# 128 and 256
BLOCK_CASES = [
    (1, 200, 200, 2, 2, 96, 96, True, 0, 0),
    (1, 300, 300, 4, 2, 96, 96, True, 100, 0),
    (1, 200, 200, 2, 2, 192, 128, True, 0, 0),
    (1, 150, 150, 4, 1, 192, 128, True, 70, 0),
    (2, 150, 64, 2, 2, 64, 64, False, 0, 0),
    (1, 100, 200, 4, 2, 128, 128, False, 0, 0),
    (1, 200, 200, 2, 1, 64, 64, True, 0, 77),
    (1, 300, 300, 2, 2, 128, 128, True, 0, 150),
    (1, 290, 290, 2, 2, 64, 64, True, 130, 0),
    (1, 130, 130, 2, 1, 256, 256, True, 0, 70),
]
BLOCKS_EXACT64 = 1e-10   # blocked against whole in float64, of each
                         # gradient's max |value|: the same bf16 roundings
                         # of the same float64 P and dS, sums reordered


def _block_inputs(seed, B, S, Sk, H, KVH, D, DV, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    do = rng.normal(size=(B, S, H, DV)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KVH, DV)).astype(np.float32)
    return [t(a).to(dtype) for a in (q, k, v, do)]


def _masked_lse(q, k, causal, window, prefix):
    """The forward's row log-sum-exp (B, H, S) under any of the masks."""
    B, S, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k.double().repeat_interleave(G, 2)) / math.sqrt(D)
    allow = flash_ops._allow(torch.arange(S), torch.arange(Sk), causal,
                             window, prefix)
    return torch.logsumexp(s.masked_fill(~allow, -1e30), -1)


@pytest.mark.parametrize("B,S,Sk,H,KVH,D,DV,causal,window,prefix",
                         BLOCK_CASES)
def test_flash_bwd_blocks_match_plain(B, S, Sk, H, KVH, D, DV, causal,
                                      window, prefix):
    """The blocked statement equals flash_attention_bwd_plain(operands=
    "bf16") in float64 (BLOCKS_EXACT64): the walk, the masks, the skipped
    parts, the dQ sums over key blocks and the dK / dV paths lose and add
    nothing."""
    q, k, v, do = _block_inputs(71 + S + Sk, B, S, Sk, H, KVH, D, DV,
                                torch.float64)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o = flash_attention_plain(q, k, v, **kw).double()
    lse = _masked_lse(q, k, causal, window, prefix)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, operands="bf16",
                                     **kw)
    got = flash_attention_bwd_blocks_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        err = float((g - w).abs().max())
        assert err <= BLOCKS_EXACT64 * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("B,S,Sk,H,KVH,D,DV,causal,window,prefix",
                         [BLOCK_CASES[i] for i in (0, 3, 4, 6)])
def test_flash_bwd_blocks_bf16_match_jax_vjp(B, S, Sk, H, KVH, D, DV,
                                             causal, window, prefix):
    """On bf16 inputs the blocked statement lies within BF16_GRAD_TOL of
    each gradient's max |value| of jax.vjp of the reference's
    chunked_attention in f32 on the same values."""
    q, k, v, do = _block_inputs(81 + S, B, S, Sk, H, KVH, D, DV,
                                torch.bfloat16)
    f32 = [x.float().numpy() for x in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, causal=causal, window=window, prefix_len=prefix,
        chunk=64), *f32[:3])
    ref = [np.asarray(g) for g in vjp(jnp.asarray(f32[3]))]
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o = flash_attention_plain(q, k, v, **kw)
    lse = _masked_lse(q, k, causal, window, prefix).float()
    got = flash_attention_bwd_blocks_plain(q, k, v, o, lse, do, **kw)
    for name, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16, name
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= BF16_GRAD_TOL * float(np.abs(r).max()), (name, err)


@pytest.mark.parametrize("Sq,Sk,causal,window,prefix", [
    (2176, 2176, True, 0, 0), (2176, 2176, True, 1024, 0),
    (300, 300, True, 100, 0), (290, 290, True, 130, 0), (75, 75, True, 20, 0),
    (200, 200, True, 0, 77), (512, 512, True, 0, 256),
    (200, 200, True, 0, 300), (1500, 64, False, 0, 0),
    (333, 700, False, 0, 0), (64, 3, False, 0, 0)])
@pytest.mark.parametrize("keys", [flash_ops.TC_BWD_KEYS,
                                  flash_ops.TC_BWD_TILE])
def test_flash_bwd_tc_schedule_visits_each_pair_once(Sq, Sk, causal, window,
                                                     prefix, keys):
    """bwd_tc_schedule at 128-key and 64-key blocks: every visible (row,
    key) pair lies on exactly one part of one block's walk, and a part the
    schedule leaves unmasked holds no pair the mask hides (rows past Sq
    aside: their P is 0 by their lse; keys past Sk count as hidden)."""
    T = flash_ops.TC_BWD_TILE
    allow = flash_ops._allow(torch.arange(Sq), torch.arange(Sk), causal,
                             window, min(prefix, Sk)).numpy()
    seen = np.zeros((Sq, Sk), dtype=np.int64)
    for k0, t, parts in flash_ops.bwd_tc_schedule(
            Sq, Sk, keys=keys, causal=causal, window=window,
            prefix_len=prefix):
        assert len(parts) == keys // T and parts[0][0] == k0
        rows = slice(t * T, min(t * T + T, Sq))
        for kw0, masked in parts:
            tile = np.zeros((rows.stop - rows.start, T), dtype=bool)
            n = max(0, min(kw0 + T, Sk) - kw0)
            tile[:, :n] = allow[rows, kw0:kw0 + n]
            if not masked:
                assert tile.all(), (k0, t, kw0)
            seen[rows, kw0:kw0 + n] += tile[:, :n]
    assert np.array_equal(seen, allow.astype(np.int64))


def _flip_excess(got, exact, bound):
    """Worst |got - exact| less ``bound`` (at least 0) over the element-wise
    rule of the card tests (1e-4 of max |exact| plus two bf16 ulps of the
    element), over the three gradients."""
    worst = 0.0
    for g, x, b in zip(got, exact, bound):
        tol = 1e-4 * x.abs().max() + 2.0 * flash_ops._bf16_ulp(x)
        d = ((g.double() - x).abs() - b).clamp_min(0.0)
        worst = max(worst, float((d / tol).max()))
    return worst


def _planted(q, k, v, o, lse, do, fault, causal, window, prefix_len):
    """The tc backward's function in f32 with one planted fault: dS or P
    rounded toward zero to bf16, or P rounded to bf16 before dS is
    formed."""
    B, S, H, D = q.shape
    Sk, G, f = k.shape[1], H // k.shape[2], torch.float32
    qf, dof = q.to(f), do.to(f)
    kf, vf = (x.to(f).repeat_interleave(G, 2) for x in (k, v))
    allow = flash_ops._allow(torch.arange(S), torch.arange(Sk), causal,
                             window, prefix_len)
    s = torch.einsum("bqhd,bkhd->bqhk", qf, kf) / math.sqrt(D)
    p = torch.where(allow[None, :, None],
                    torch.exp(s - lse.to(f).permute(0, 2, 1)[..., None]),
                    0.0)
    dp = torch.einsum("bqhd,bkhd->bqhk", dof, vf)
    delta = (dof * o.to(f)).sum(-1)[..., None]

    def rz(x):                      # bf16 by truncation
        return (x.view(torch.int32) & ~0xFFFF).view(torch.float32)

    def rn(x):
        return x.to(torch.bfloat16).to(f)
    ds = (rn(p) if fault == "P rounded before dS" else p) * (dp - delta)
    ds = rz(ds) if fault == "dS toward zero" else rn(ds)
    pb = rz(p) if fault == "P toward zero" else rn(p)
    kv = lambda x, n: x.reshape(B, Sk, k.shape[2], G, n).sum(3)
    dv = kv(torch.einsum("bqhk,bqhd->bkhd", pb, dof), v.shape[-1])
    dk = kv(torch.einsum("bqhk,bqhd->bkhd", ds, qf), D) / math.sqrt(D)
    dq = torch.einsum("bqhk,bkhd->bqhd", ds, kf) / math.sqrt(D)
    return [x.to(torch.bfloat16) for x in (dq, dk, dv)]


@pytest.mark.parametrize("B,S,Sk,H,KVH,D,DV,causal,window,prefix",
                         [BLOCK_CASES[i] for i in (1, 3, 5, 7)]
                         + [(1, 150, 200, 8, 2, 128, 128, False, 0, 0)])
def test_flash_bwd_flip_bound_holds_f32_and_catches_faults(
        B, S, Sk, H, KVH, D, DV, causal, window, prefix):
    """flash_attention_bwd_flip_bound, on which the card tests' rule (a)
    for the tc backward rests: on bf16 inputs, two f32 evaluations of the
    function in different orders (flash_attention_bwd_plain(operands=
    "bf16") and the kernel's blocking) and one whose lse is 8 ulps off lie
    within the element-wise rule plus that bound of the float64
    statement; the same function with dS or P rounded toward zero, or P
    rounded before dS is formed, does not."""
    q, k, v, do = _block_inputs(91 + S + Sk, B, S, Sk, H, KVH, D, DV,
                                torch.bfloat16)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o = flash_attention_plain(q, k, v, **kw)
    lse = _masked_lse(q, k, causal, window, prefix).float()
    ins = (q, k, v, o, lse, do)
    exact = flash_attention_bwd_plain(*(x.double() for x in ins),
                                      operands="bf16", **kw)
    bound = flash_ops.flash_attention_bwd_flip_bound(*ins, **kw)
    lse8 = lse
    for _ in range(8):
        lse8 = torch.nextafter(lse8, torch.full_like(lse8, math.inf))
    for what, got in (
            ("plain", flash_attention_bwd_plain(*ins, operands="bf16", **kw)),
            ("blocks", flash_attention_bwd_blocks_plain(*ins, **kw)),
            ("lse 8 ulps", flash_attention_bwd_plain(
                q, k, v, o, lse8, do, operands="bf16", **kw))):
        assert _flip_excess(got, exact, bound) <= 1.0, what
    for fault in ("dS toward zero", "P toward zero", "P rounded before dS"):
        got = _planted(*ins, fault, **kw)
        assert _flip_excess(got, exact, bound) > 2.0, fault
