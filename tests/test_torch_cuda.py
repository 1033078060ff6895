"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test decides inside its body whether a card is
there and skips elsewhere. This file imports no JAX, so it runs on a
GPU machine without it: ``PYTHONPATH=src python -m pytest
tests/test_torch_cuda.py -q``."""
import math

import pytest
import torch

from repro_torch.kernels.head_select import head_select, head_select_plain
from repro_torch.kernels.msp_select import msp_select, msp_select_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    """On the card: each CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    h = torch.randn((3, 70, 48), generator=g, device="cuda").to(dt)
    w = (torch.randn((3, 48, 300), generator=g, device="cuda") / 7).to(dt)
    b = torch.randn((3, 300), generator=g, device="cuda")
    x = (torch.randn((70, 3000), generator=g, device="cuda") * 4).to(dt)
    for det in ("msp", "energy"):
        for k in (1, 8, 16):
            kw = dict(temperature=10.0, k=k, detector=det)
            n0 = head_select.launches
            out, ref = head_select(h, w, b, **kw), head_select_plain(h, w, b,
                                                                     **kw)
            assert head_select.launches == n0 + 1
            for a, r in zip(out[:2], ref[:2]):
                torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
            assert torch.equal(out[2], ref[2])
            out, ref = msp_select(x, **kw), msp_select_plain(x, **kw)
            for a, r in zip(out[:2], ref[:2]):
                torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
            assert torch.equal(out[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KVH,D,window", [(75, 4, 2, 64, 20),
                                              (130, 4, 1, 32, 0),
                                              (200, 2, 2, 128, 64),
                                              (197, 4, 4, 96, 0),
                                              (300, 4, 2, 96, 100),
                                              (512, 8, 1, 256, 0),
                                              (333, 8, 2, 256, 100)])
def test_cuda_flash_attention_matches_plain(dtype, S, H, KVH, D, window):
    """On the card: flash_attention against its plain version — GQA,
    windows, ragged S, every head_dim the kernel takes (2e-5 in f32, one
    bf16 ulp of the output in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    q = torch.randn((2, S, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((2, S, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((2, S, KVH, D), generator=g, device="cuda").to(dt)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    assert flash_attention.launches == n0 + 1 and out.dtype == dt
    ref = flash_attention_plain(q, k, v, window=window)
    atol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,steep", [
    (2, 100, 4, 16, 2, 8, 32, 1.0),
    (1, 77, 4, 32, 4, 16, 64, 1.0),
    (1, 300, 2, 64, 1, 128, 256, 1.0),
    (1, 2176, 50, 64, 1, 16, 256, 1.0),     # Hymba-1.5B's layout
    (1, 2048, 48, 64, 1, 128, 256, 1.0),    # Mamba-2-780M's layout
    (1, 130, 4, 64, 2, 8, 64, 1.0),         # N 8
    (1, 70, 4, 32, 2, 12, 64, 1.0),         # N % 8 == 4
    (1, 150, 2, 16, 1, 512, 128, 1.0),      # the largest state, P·N 8192
    (1, 40, 4, 16, 2, 8, 1, 1.0),           # chunk 1
    (1, 64, 3, 16, 3, 8, 64, 1.0),          # a single tile
    (2, 200, 4, 64, 1, 16, 64, 50.0)])      # steep: exp underflows to 0
def test_cuda_ssd_scan_matches_plain(B, S, H, P, G, N, chunk, steep):
    """On the card: ssd_scan against its plain version — grouped B/C,
    ragged chunks, Hymba's and Mamba-2's layouts, state sizes 8 to 512,
    chunk 1, and decays steep enough that most exponentials underflow.
    Against the plain version in float64, the kernel's max error is
    within 4x that of the plain version in float32 (plus 1e-5): the
    decays difference two cumulative log-decay sums, whose f32 rounding
    either order shares."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    a = -steep * torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
    xdt, dta = (x * dt[..., None]).contiguous(), (dt * a).contiguous()
    b = torch.randn((B, S, G, N), generator=g, device="cuda")
    c = torch.randn((B, S, G, N), generator=g, device="cuda")
    n0 = ssd_scan.launches
    y = ssd_scan(xdt, dta, b, c, chunk=chunk)
    assert ssd_scan.launches == n0 + 1
    assert bool(torch.isfinite(y).all())
    exact = ssd_scan_plain(*(t.double() for t in (xdt, dta, b, c)),
                           chunk=chunk)
    e_plain = (ssd_scan_plain(xdt, dta, b, c, chunk=chunk).double()
               - exact).abs().max()
    assert (y.double() - exact).abs().max() <= 4 * e_plain + 1e-5


@pytest.mark.cuda
def test_cuda_ssd_scan_raises_on_what_it_cannot_take():
    """No fallback on the card: head dims, state sizes, dtypes and
    layouts the kernels do not take raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.ssd_scan import ssd_scan

    def call(P=16, N=8, chunk=16, dtype=torch.float32, G=1):
        z = torch.zeros((1, 32, 2, P), device="cuda", dtype=dtype)
        bc = torch.zeros((1, 32, G, N), device="cuda", dtype=dtype)
        return ssd_scan(z, z[..., 0].contiguous(), bc, bc, chunk=chunk)
    for kw in (dict(P=48), dict(N=6), dict(P=64, N=256), dict(chunk=257),
               dict(chunk=0), dict(dtype=torch.float64), dict(G=3)):
        with pytest.raises((ValueError, TypeError)):
            call(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,C,offset", [(40, 32001, 0), (40, 32001, 1),
                                        (4100, 32001, 3), (300, 1000, 0),
                                        (70, 7, 1), (5000, 15, 0)])
def test_cuda_msp_select_rows_of_every_alignment(dtype, N, C, offset):
    """On the card: msp_select on rows that start at every alignment mod
    16 bytes (odd C, views that start ``offset`` elements in), a few rows
    per block (C >= 2048 with fewer than 4096 rows) and one warp per row,
    narrow rows shorter than a vector, k 1/8/16, both detectors — and
    small-integer logits with duplicated columns, whose ties must resolve
    to the plain version's indices exactly (``torch.equal``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    g = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)
    x = (torch.randn((N + 1, C), generator=g, device="cuda") * 4).to(dt)
    ints = torch.randint(-3, 4, (N + 1, C), generator=g,
                         device="cuda").to(dt)
    half = C // 2
    ints[:, C - half:] = ints[:, :half]       # duplicated columns
    for logits, exact in ((x, False), (ints, True)):
        rows = logits.reshape(-1)[offset:offset + N * C].view(N, C)
        for det in ("msp", "energy"):
            for k in (k for k in (1, 8, 16) if k <= C):
                kw = dict(temperature=10.0, k=k, detector=det)
                n0 = msp_select.launches
                out = msp_select(rows, **kw)
                assert msp_select.launches == n0 + 1
                ref = msp_select_plain(rows, **kw)
                for a, r in zip(out[:2], ref[:2]):
                    torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
                if exact:
                    assert torch.equal(out[2], ref[2])
                else:
                    diff = out[2] != ref[2]
                    if diff.any():   # near-ties the summation may flip
                        lf = rows.float()
                        li = torch.gather(lf, -1, out[2].long())[diff]
                        lr = torch.gather(lf, -1, ref[2].long())[diff]
                        assert float((li - lr).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("H,KVH", [(5, 5), (5, 1)])
@pytest.mark.parametrize("window", [0, 20, 100, 1024])
@pytest.mark.parametrize("S", [75, 128, 2176])
def test_cuda_flash_attention_tc_matches_plain(S, window, H, KVH, D):
    """On the card: bf16 at head_dim 64, 96 and 128 goes through the
    tensor-core kernel (``launches_by_variant``) and matches the plain f32
    version within one bf16 ulp of the output (2e-2) — ragged S, windows
    smaller than a tile and not a multiple of it, GQA groups of 1 and 5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    B = 2 if S < 2176 else 1
    q = torch.randn((B, S, H, D), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, KVH, D), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, KVH, D), generator=g, device="cuda").bfloat16()
    n0 = dict(flash_attention.launches_by_variant)
    out = flash_attention(q, k, v, window=window)
    assert flash_attention.launches_by_variant == {
        "tc": n0["tc"] + 1, "simt": n0["simt"]}
    assert out.dtype == torch.bfloat16
    ref = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


def _head_inputs(g, L, N, D, C, bias):
    h = torch.randn((L, N, D), generator=g, device="cuda").bfloat16()
    w = (torch.randn((L, D, C), generator=g, device="cuda")
         / D ** 0.5).bfloat16()
    b = torch.randn((L, C), generator=g, device="cuda") if bias else None
    return h, w, b


def _check_head_tc(h, w, b, ks=(1, 8, 16)):
    from repro_torch.kernels.head_select import (head_select,
                                                 head_select_plain)
    logits = torch.matmul(h.float(), w.float())
    if b is not None:
        logits = logits + b[:, None, :]
    for det in ("msp", "energy"):
        for k in (k for k in ks if k <= w.shape[-1]):
            kw = dict(temperature=10.0, k=k, detector=det)
            n0 = dict(head_select.launches_by_variant)
            out = head_select(h, w, b, **kw)
            assert head_select.launches_by_variant == {
                **n0, "tc": n0["tc"] + 1}
            ref = head_select_plain(h, w, b, **kw)
            for a, r in zip(out[:2], ref[:2]):
                torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
            diff = out[2] != ref[2]
            if diff.any():   # near-ties the summation order may flip
                li = torch.gather(logits, -1, out[2].long())[diff]
                lr = torch.gather(logits, -1, ref[2].long())[diff]
                assert float((li - lr).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("L,N,D,C", [(1, 200, 48, 10), (4, 333, 48, 300),
                                     (1, 130, 1600, 32001),
                                     (4, 8500, 48, 300)])
def test_cuda_head_select_tc_matches_plain(L, N, D, C, bias):
    """On the card: bf16 goes through the tensor-core kernel and matches
    the plain version — ragged N and C, D = 48 zero-padded in depth,
    Hymba's D and vocabulary, k 1/8/16, both detectors, with and without
    bias (k up to C); (1, 130, 1600, 32001) splits C over 126 blocks and
    (4, 8500, 48, 300) does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    g = torch.Generator(device="cuda").manual_seed(4)
    _check_head_tc(*_head_inputs(g, L, N, D, C, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 3, 7])
def test_cuda_head_select_tc_forced_split_and_ties(monkeypatch, nsplit):
    """On the card: a column split forced at 1, 3 and 7 slices over logits
    with exact duplicates (small-integer hidden and head: every product
    and sum is exact in any order, so tied logits are bit-equal in the
    kernel and the plain version) — the indices must equal the plain
    version's, ties to the lowest index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.head_select import (head_select,
                                                 head_select_plain, ops)
    C = 7 * 256 - 50

    def forced(L, N, C_, D, sms):
        col_tiles = -(-C_ // ops.TC_COLS)
        slice_w = -(-col_tiles // nsplit) * ops.TC_COLS
        return slice_w, -(-C_ // slice_w)
    monkeypatch.setattr(ops, "_column_splits", forced)
    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randint(-2, 3, (2, 150, 40), generator=g,
                      device="cuda").bfloat16()
    w = torch.randint(-1, 2, (2, 40, C), generator=g,
                      device="cuda").bfloat16()
    b = torch.randint(-1, 2, (2, C), generator=g, device="cuda").float()
    w[:, :, C - 300:] = w[:, :, :300]     # duplicated columns, across slices
    b[:, C - 300:] = b[:, :300]
    assert forced(2, 150, C, 40, 132)[1] == nsplit
    for det in ("msp", "energy"):
        for k in (1, 8, 16):
            kw = dict(temperature=10.0, k=k, detector=det)
            n0 = head_select.launches_by_variant["tc"]
            out = head_select(h, w, b, **kw)
            assert head_select.launches_by_variant["tc"] == n0 + 1
            ref = head_select_plain(h, w, b, **kw)
            for a, r in zip(out[:2], ref[:2]):
                torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-5)
            assert torch.equal(out[2], ref[2])


def _bf16_ulp(r):
    """One bf16 ulp at each element's |r| (0 where r is 0)."""
    _, e = torch.frexp(r.abs())             # |r| = m · 2^e, m in [0.5, 1)
    return torch.where(r == 0, 0.0, torch.ldexp(torch.ones_like(r), e - 8))


def _bwd_excess(a, r, dtype, off=None):
    """Max over elements of |a - r| over the element-wise rule: 1e-4 of
    max |r|, in bf16 plus two bf16 ulps of the element's own |r|; with
    ``off``, |a - r| less ``off`` (at least 0)."""
    rf = r.float()
    tol = 1e-4 * rf.abs().max()
    if dtype == "bfloat16":
        tol = tol + 2.0 * _bf16_ulp(rf)
    d = (a.float() - rf).abs()
    if off is not None:
        d = (d - off.float()).clamp_min(0.0)
    return float((d / tol).max())


def _max_err(a, r):
    return float((a.float() - r.float()).abs().max())


def _allow(S, window, prefix_len=0):
    """(S, S) mask of the causal attention's visible pairs: the window's,
    the prefix-LM's."""
    pos = torch.arange(S, device="cuda")
    allow = pos[None, :] <= pos[:, None]
    if prefix_len:
        allow |= (pos[:, None] < prefix_len) & (pos[None, :] < prefix_len)
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    return allow


def _sdpa_bwd_grads(q, k, v, do, window, causal=True, prefix_len=0):
    """(dq, dk, dv) of scaled_dot_product_attention (enable_gqa, the same
    causal / window / prefix mask, or none) on the same inputs, in their
    (B, S, h, D) layout: the yardstick of the tc backward's rules."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    S = q.shape[1]
    mask = None
    if window or prefix_len:
        mask = _allow(S, window, prefix_len)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None,
                                         enable_gqa=True)
    grads = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    return [g.transpose(1, 2) for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KVH,D,window", [
    (75, 4, 2, 64, 20), (130, 4, 1, 32, 0), (200, 2, 2, 128, 64),
    (130, 5, 5, 64, 0), (300, 5, 1, 64, 1024), (2176, 25, 5, 64, 0),
    (2176, 25, 5, 64, 1024), (517, 6, 3, 128, 0), (2176, 25, 5, 128, 1024),
    (75, 4, 4, 96, 20), (517, 6, 3, 96, 0), (2048, 32, 32, 96, 0),
    (300, 4, 2, 96, 1024), (512, 8, 1, 256, 0), (333, 8, 2, 256, 100),
    (200, 4, 4, 64, 0), (333, 4, 4, 96, 100), (390, 8, 2, 128, 130),
    (1000, 8, 8, 96, 300)])
def test_cuda_flash_attention_bwd_matches_plain(dtype, S, H, KVH, D,
                                                window):
    """On the card: the backward kernels against flash_attention_bwd_plain
    on the same q, k, v, o, lse and dO — GQA ratios 1, 2, 4, 5, windows
    0, 20, 64, 100, 130, 300 and 1024 (some crossing the tc kernel's
    128-key blocks), ragged S up to Hymba's 2176 (S not a multiple of 128
    too), every head_dim the kernels take. The SIMT kernel (f32; bf16 at head_dim 32): each
    gradient's error is at most 1e-4 of its max |value| (sums of up to S
    products reordered, in f32 either way), in bf16 plus two bf16 ulps of
    the element's own |value| (each side rounds its f32 sum to bf16, and
    a sum a hair either side of a rounding boundary moves by one ulp of
    itself). The tc kernel (bf16 at head_dim 64, 96, 128, 256 and MLA's)
    rounds P and dS to bf16 as the tensor cores' operands, as
    scaled_dot_product_attention's backward does. (a) Against that
    function's exact value (flash_attention_bwd_plain(operands="bf16") on
    float64 inputs), element by element: within the element-wise rule
    plus flash_attention_bwd_flip_bound, the most that the bf16 roundings
    of the P and dS lying within an f32 evaluation's error (Higham's bound
    on a dot product of length D) of a rounding midpoint can move the
    element: any f32 evaluation, the kernel's exp2 of its own f32
    argument and its sums in their order included, may round each of
    those either way, and one such term moves an element by many times
    the element-wise rule. Beside
    it, each gradient's max error against that version and (b) against
    the plain version in f32 operands is at most twice SDPA's on the same
    inputs. Through autograd, the forward's lse matches the plain
    log-sum-exp within 1e-5 and the gradients come from the kernel of the
    forward's variant: dK and dV bitwise; the tc kernel's dQ within one
    bf16 ulp of each element plus 1e-4 of max |dQ| (its key tiles add
    into an f32 sum in the order they run; it is rounded to bf16 once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    _check_bwd(dtype, 2 if S < 2176 else 1, S, S, H, KVH, D, window, True)


def _check_bwd(dtype, B, S, Sk, H, KVH, D, window, causal, prefix_len=0,
               Dv=None):
    """The body of the backward tests: causal (Sk = S; with a prefix-LM
    mask of ``prefix_len``) or not, by the rules
    test_cuda_flash_attention_bwd_matches_plain states; ``Dv``, v's head
    dim in MLA's mode (D by default)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention.ops import (
        _variant, flash_attention_bwd_flip_bound)
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    Dv = D if Dv is None else Dv
    variant = _variant(dt, D, Dv)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Sk, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Sk, KVH, Dv), generator=g, device="cuda").to(dt)
    do = torch.randn((B, S, H, Dv), generator=g, device="cuda").to(dt)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    n_var = flash_attention_bwd.launches_by_variant[variant]
    mode = "prefix" if prefix_len else "causal" if causal else "cross"
    n_mode = flash_attention_bwd.launches_by_mode[mode][variant]
    kw = dict(window=window, causal=causal, prefix_len=prefix_len)
    out = flash_attention(qr, kr, vr, **kw)
    assert out.grad_fn is not None and out.dtype == dt
    out.backward(do)
    assert flash_attention.launches == n_fwd + 1
    assert flash_attention_bwd.launches == n_bwd + 1
    assert flash_attention_bwd.launches_by_variant[variant] == n_var + 1
    assert flash_attention_bwd.launches_by_mode[mode][variant] == n_mode + 1
    # the forward's lse against the plain log-sum-exp
    G = H // KVH
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 2)) / math.sqrt(D)
    if causal:
        s = s.masked_fill(~_allow(S, window, prefix_len), -1e30)
    lse_ref = torch.logsumexp(s, -1)
    del s
    _, _, _, o, lse = (x.detach() for x in _saved_lse(q, k, v, window,
                                                      causal, prefix_len))
    assert torch.equal(o, out.detach())
    assert float((lse - lse_ref).abs().max()) <= 1e-5 * max(
        1.0, float(lse_ref.abs().max()))
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    if variant == "tc":
        ref_b = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw,
                                          operands="bf16")
        exact = flash_attention_bwd_plain(
            *(t.double() for t in (q, k, v, o, lse, do)), **kw,
            operands="bf16")
        bound = flash_attention_bwd_flip_bound(q, k, v, o, lse, do, **kw)
        lib = _sdpa_bwd_grads(q, k, v, do, window, causal, prefix_len)
    for i, (name, a, r, viaf) in enumerate(zip("qkv", got, ref,
                                               (qr, kr, vr))):
        assert a.dtype == dt and bool(torch.isfinite(a).all()), name
        if variant == "simt":
            assert _bwd_excess(a, r, dtype) <= 1.0, name
            assert torch.equal(viaf.grad, a), name
            continue
        excess = _bwd_excess(a, exact[i], dtype, bound[i])
        assert excess <= 1.0, (name, excess)
        for rule, yard in (("a", ref_b[i]), ("b", r)):
            e_kernel = _max_err(a, yard)
            e_lib = _max_err(lib[i], yard)
            assert e_kernel <= 2.0 * e_lib, (name, rule, e_kernel, e_lib)
        if name == "q":
            gq, aq = viaf.grad.float(), a.float()
            tol = (_bf16_ulp(torch.maximum(gq.abs(), aq.abs()))
                   + 1e-4 * aq.abs().max())
            assert bool(((gq - aq).abs() <= tol).all()), name
        else:
            assert torch.equal(viaf.grad, a), name


def _saved_lse(q, k, v, window, causal=True, prefix_len=0):
    """The tensors FlashAttentionFn saves for its backward."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    qr = q.clone().requires_grad_(True)
    out = FlashAttentionFn.apply(qr, k, v, window, causal, prefix_len)
    return out.grad_fn.saved_tensors


# cross-attention (causal=False, Sk != Sq): MusicGen's layer (Sq 1500,
# Sk 64: one key tile, the key tail in the tc forward's 128-key tile), a
# key set longer than the queries over several tiles with GQA, a key set
# of 3, ragged both ways, every head_dim
CROSS = [(2, 1500, 64, 24, 24, 64), (1, 333, 700, 8, 2, 64),
         (2, 100, 8, 4, 2, 64), (2, 75, 129, 4, 4, 96),
         (1, 64, 256, 4, 1, 128), (2, 200, 3, 4, 2, 32),
         (1, 200, 130, 4, 4, 96), (1, 150, 200, 8, 8, 128),
         (1, 150, 200, 8, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D", CROSS)
def test_cuda_flash_attention_cross_matches_plain(dtype, B, Sq, Sk, H, KVH,
                                                  D):
    """On the card: the non-causal forward (the SIMT kernel in f32 and at
    head_dim 32, the tc kernel in bf16 at 64/96/128) against its plain
    version within 2e-5 in f32 and one bf16 ulp of the output in bf16,
    counted as a cross launch of its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import _variant
    g = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Sk, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Sk, KVH, D), generator=g, device="cuda").to(dt)
    variant = _variant(dt, D)
    n0 = flash_attention.launches_by_mode["cross"][variant]
    out = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches_by_mode["cross"][variant] == n0 + 1
    assert out.dtype == dt and out.shape == q.shape
    ref = flash_attention_plain(q, k, v, causal=False)
    atol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D", CROSS)
def test_cuda_flash_attention_cross_bwd_matches_plain(dtype, B, Sq, Sk, H,
                                                      KVH, D):
    """On the card: the non-causal backward kernels against
    flash_attention_bwd_plain(causal=False), dK and dV of k's length, by
    the rules of test_cuda_flash_attention_bwd_matches_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    _check_bwd(dtype, B, Sq, Sk, H, KVH, D, 0, False)


# the prefix-LM mask (PaliGemma's): its training layer (B 2, S 512 = 256
# patches + 256 tokens, 8/1 heads x 256, the prefix on a tile edge), a
# prefix ending mid-tile with GQA, a prefix past the sequence (every key
# for every row), and the other head_dims
PREFIX = [(2, 512, 256, 8, 1, 256), (1, 333, 200, 8, 2, 256),
          (1, 200, 300, 8, 1, 256), (2, 75, 30, 4, 2, 64),
          (1, 130, 64, 4, 1, 32), (2, 200, 77, 4, 4, 96),
          (1, 300, 129, 4, 2, 128), (1, 300, 100, 4, 4, 96),
          (1, 333, 190, 8, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,P,H,KVH,D", PREFIX)
def test_cuda_flash_attention_prefix_matches_plain(dtype, B, S, P, H, KVH,
                                                   D):
    """On the card: the prefix-LM forward (the SIMT kernel in f32 and at
    head_dim 32, the tc kernel in bf16 at 64/96/128/256) against its plain
    version within 2e-5 in f32 and one bf16 ulp of the output in bf16,
    counted as a prefix launch of its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import _variant
    g = torch.Generator(device="cuda").manual_seed(8)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, KVH, D), generator=g, device="cuda").to(dt)
    variant = _variant(dt, D)
    n0 = flash_attention.launches_by_mode["prefix"][variant]
    out = flash_attention(q, k, v, prefix_len=P)
    assert flash_attention.launches_by_mode["prefix"][variant] == n0 + 1
    assert out.dtype == dt and out.shape == q.shape
    ref = flash_attention_plain(q, k, v, prefix_len=P)
    atol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,P,H,KVH,D", PREFIX)
def test_cuda_flash_attention_prefix_bwd_matches_plain(dtype, B, S, P, H,
                                                       KVH, D):
    """On the card: the prefix-LM backward kernels against
    flash_attention_bwd_plain(prefix_len=P), by the rules of
    test_cuda_flash_attention_bwd_matches_plain (MQA's 8 query heads
    summed into one KV head's dK and dV at PaliGemma's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    _check_bwd(dtype, B, S, S, H, KVH, D, 0, True, P)


# MLA's mode (qk head dim D, v head dim Dv): DeepSeek-V3's (192, 128) on
# both variants, its reduced (48, 32) on the SIMT kernels; ragged S, GQA
MLA = [(2, 75, 4, 4, 48, 32), (2, 200, 4, 1, 48, 32),
       (1, 333, 8, 8, 192, 128), (1, 130, 4, 2, 192, 128),
       (1, 2048, 16, 16, 192, 128), (2, 130, 4, 4, 192, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,Dv", MLA)
def test_cuda_flash_attention_mla_matches_plain(dtype, B, S, H, KVH, D, Dv):
    """On the card: MLA's mode, forward (2e-5 in f32, one bf16 ulp of the
    output in bf16; (B, S, H, Dv) out, counted under the (D, Dv) pair)
    and backward (the rules of
    test_cuda_flash_attention_bwd_matches_plain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(9)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, S, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, S, KVH, Dv), generator=g, device="cuda").to(dt)
    n0 = flash_attention.launches_by_head_dim[(D, Dv)]
    out = flash_attention(q, k, v)
    assert flash_attention.launches_by_head_dim[(D, Dv)] == n0 + 1
    assert out.dtype == dt and out.shape == (B, S, H, Dv)
    ref = flash_attention_plain(q, k, v)
    atol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    _check_bwd(dtype, B, S, S, H, KVH, D, 0, True, Dv=Dv)


# MLA's mode with a window (no model calls it; the kernel's walk and masks
# take it as in the other modes): G 1 and 2, ragged S
MLA_WINDOW = [(1, 333, 4, 4, 192, 128, 100), (1, 200, 4, 2, 192, 128, 64),
              (2, 200, 4, 2, 192, 128, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,D,Dv,window", MLA_WINDOW)
def test_cuda_flash_attention_mla_window_bwd_matches_plain(dtype, B, S, H,
                                                           KVH, D, Dv,
                                                           window):
    """On the card: MLA's backward with a sliding window, by the rules of
    test_cuda_flash_attention_bwd_matches_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    _check_bwd(dtype, B, S, S, H, KVH, D, window, True, Dv=Dv)


@pytest.mark.cuda
def test_cuda_flash_attention_no_grad_writes_no_lse():
    """Under torch.no_grad the forward launches as before: one forward
    launch, no autograd record, no backward launch, the same variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    q = torch.randn((1, 200, 4, 64), device="cuda",
                    dtype=torch.bfloat16).requires_grad_(True)
    k = torch.randn((1, 200, 2, 64), device="cuda", dtype=torch.bfloat16)
    n, nb = flash_attention.launches, flash_attention_bwd.launches
    tc = flash_attention.launches_by_variant["tc"]
    with torch.no_grad():
        out = flash_attention(q, k, k, window=64)
    assert out.grad_fn is None
    assert flash_attention.launches == n + 1
    assert flash_attention.launches_by_variant["tc"] == tc + 1
    assert flash_attention_bwd.launches == nb


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N,steep", [
    (2, 100, 4, 16, 2, 8, 1.0),
    (1, 77, 4, 32, 4, 16, 1.0),
    (2, 130, 4, 64, 2, 16, 1.0),
    (1, 300, 2, 64, 1, 128, 1.0),
    (1, 2176, 50, 64, 1, 16, 1.0),     # Hymba-1.5B's layout
    (1, 2048, 48, 64, 1, 128, 1.0),    # Mamba-2-780M's layout
    (1, 40, 4, 16, 2, 4, 1.0),         # a short sequence, N 4
    (2, 200, 4, 64, 1, 16, 50.0)])     # steep: exp underflows to 0
def test_cuda_ssd_scan_bwd_matches_plain(B, S, H, P, G, N, steep):
    """On the card: the backward kernel against ssd_scan_bwd_plain.
    Against the plain version in float64, each gradient's max error is
    within 4x that of the plain version in float32 plus 1e-5 of the
    gradient's max |value| (ddta is a cumulative sum over S); through
    autograd, ssd_scan's output carries a grad_fn and its backward is the
    kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                              ssd_scan_bwd_plain)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    a = -steep * torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
    xdt, dta = (x * dt[..., None]).contiguous(), (dt * a).contiguous()
    b = torch.randn((B, S, G, N), generator=g, device="cuda")
    c = torch.randn((B, S, G, N), generator=g, device="cuda")
    dy = torch.randn((B, S, H, P), generator=g, device="cuda")
    ins = [t.clone().requires_grad_(True) for t in (xdt, dta, b, c)]
    n0, nb = ssd_scan.launches, ssd_scan_bwd.launches
    y = ssd_scan(*ins, chunk=64)
    assert y.grad_fn is not None
    y.backward(dy)
    assert ssd_scan.launches == n0 + 1 and ssd_scan_bwd.launches == nb + 1
    got = ssd_scan_bwd(xdt, dta, b, c, dy)
    exact = ssd_scan_bwd_plain(*(t.double() for t in (xdt, dta, b, c, dy)))
    plain = ssd_scan_bwd_plain(xdt, dta, b, c, dy)
    for name, a_, p_, e_, t_ in zip(("dxdt", "ddta", "db", "dc"), got,
                                    plain, exact, ins):
        assert bool(torch.isfinite(a_).all()), name
        assert torch.equal(t_.grad, a_), name
        e_k = float((a_.double() - e_).abs().max())
        e_p = float((p_.double() - e_).abs().max())
        assert e_k <= 4 * e_p + 1e-5 * float(e_.abs().max()), (name, e_k,
                                                                e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nsplit", [("float32", 1), ("bfloat16", 1),
                                          ("bfloat16", 3)])
@pytest.mark.parametrize("pad", [0, 300, "all"])
def test_cuda_head_select_raw_stats_matches_plain(monkeypatch, dtype,
                                                  nsplit, pad):
    """On the card: head_select's raw_stats mode (the vocab-sharded
    round's per-slice carry) on both kernels — the tc one written by the
    main kernel (one slice) and by its merge kernel (a forced split) —
    against head_select_stats_plain, on a slice whose last ``pad``
    columns are zero weights with a -1e30 bias, as the round pads C
    ("all": every column padding, where m is -1e30 and z the width).
    Small-integer inputs make every logit exact in any summation order:
    m, the top-k logits and the real slots' indices equal, z within
    1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.head_select import head_select_stats_plain, ops
    C = 3 * 256 - 20
    if nsplit > 1:
        def forced(L, N, C_, D, sms):
            col_tiles = -(-C_ // ops.TC_COLS)
            slice_w = -(-col_tiles // nsplit) * ops.TC_COLS
            return slice_w, -(-C_ // slice_w)
        monkeypatch.setattr(ops, "_column_splits", forced)
    g = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)
    h = torch.randint(-2, 3, (2, 150, 40), generator=g, device="cuda").to(dt)
    w = torch.randint(-1, 2, (2, 40, C), generator=g, device="cuda").float()
    b = torch.randint(-1, 2, (2, C), generator=g, device="cuda").float()
    npad = C if pad == "all" else pad
    if npad:
        w[..., C - npad:] = 0.0
        b[..., C - npad:] = -1e30
    w = w.to(dt)
    variant = "tc_raw" if dtype == "bfloat16" else "simt_raw"
    for k in (1, 5, 16):
        n0 = head_select.launches_by_variant.get(variant, 0)
        m, z, tv, ti = head_select(h, w, b, k=k, raw_stats=True)
        assert head_select.launches_by_variant[variant] == n0 + 1
        mr, zr, tvr, tir = head_select_stats_plain(h, w, b, k=k)
        assert torch.equal(m, mr) and torch.equal(tv, tvr)
        torch.testing.assert_close(z, zr, rtol=1e-5, atol=0)
        real = tvr > -1e29
        assert torch.equal(ti[real], tir[real])
        if pad == "all":
            assert bool((m == -1e30).all()) and bool((z == C).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,flat,top", [(4, 1000, 5), (3, 65_537, 40),
                                           (2, 4_000_000, 1000)])
def test_cuda_topk_tie_rule_matches_cpu(rows, flat, top):
    """On the card: the compressed wire's top-k selection
    (``mixing.topk_indices``) on integer magnitudes with many duplicates
    across the k-th value, against the same call on the CPU: the indices
    torch.equal (ties to the lowest index on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.core.mixing import topk_indices
    g = torch.Generator().manual_seed(rows)
    a = torch.randint(0, top, (rows, flat), generator=g).float()
    for k in (1, 7, flat // 100 + 1, flat // 3, flat - 1):
        cpu = topk_indices(a, k)
        card = topk_indices(a.cuda(), k)
        assert torch.equal(card.cpu(), cpu), k
        kth = a.topk(k, dim=1).values[:, -1:]
        assert bool(((a.gather(1, cpu) >= kth)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,gossip", [("topk", "sync"),
                                         ("topk", "delayed"),
                                         ("none", "delayed")])
def test_cuda_compressed_mixer_step_matches_cpu(kind, gossip):
    """On the card: one stateful mixer step (top-k 1% on bf16 leaves, the
    roll backend on a ring of 4) against the same step on the CPU from
    identical inputs: the payload indices torch.equal, x̂ within 1e-6 and
    the mixed leaves within one bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.core import mixing
    from repro_torch.core.topology import Topology
    g = torch.Generator().manual_seed(3)
    x0 = {"a": torch.randn((4, 300, 7), generator=g).bfloat16(),
          "b": torch.randn((4, 50_000), generator=g).bfloat16()}
    x1 = {k: (v.float() + 0.01 * torch.randn(v.shape, generator=g))
          .bfloat16() for k, v in x0.items()}
    comp = ("topk", 0.01) if kind == "topk" else None
    out = {}
    for dev in ("cpu", "cuda"):
        mix = mixing.make_mixer(Topology.make("ring", 4), "auto", device=dev,
                                compression=comp, gossip=gossip)
        xs = {k: v.to(dev) for k, v in x1.items()}
        comm = mix.init_state({k: v.to(dev) for k, v in x0.items()})
        if comp is not None:
            out[dev, "idx"] = {k: mixing.topk_indices(
                (xs[k].float().reshape(4, -1) - comm["hat"][k]).abs(),
                mixing.payload_k(comm["hat"][k].shape[1], 0.01)).cpu()
                for k in xs}
        bound = mix.bind(comm)
        out[dev, "y"] = {k: v.cpu() for k, v in bound(xs).items()}
        comm = bound.finalize()
        name = "hat" if comp is not None else "prev"
        out[dev, "state"] = {k: v.cpu() for k, v in comm[name].items()}
    for k in x0:
        if comp is not None:
            assert torch.equal(out["cuda", "idx"][k], out["cpu", "idx"][k])
        torch.testing.assert_close(out["cuda", "state"][k].float(),
                                   out["cpu", "state"][k].float(),
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(out["cuda", "y"][k].float(),
                                   out["cpu", "y"][k].float(),
                                   atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N,split", [
    (2, 2176, 50, 64, 1, 16, 1000),         # Hymba-1.5B's layout
    (2, 2176, 48, 64, 1, 128, 1000),        # Mamba-2-780M's state size
    (2, 100, 4, 16, 2, 8, 37),
    (1, 40, 4, 32, 4, 12, 21),              # one tile: the final state
    (1, 128, 3, 16, 3, 8, 64)])             # the split on a tile edge
def test_cuda_ssd_scan_state_matches_plain(B, S, H, P, G, N, split):
    """On the card: ssd_scan from a random initial state with its final
    state, y and h_T by the float64 rule of
    test_cuda_ssd_scan_matches_plain; the continuation identity (split at
    ``split``: the second part from the first's h_T) within the same
    rule; with grad on, an initial state raises and the final state has
    no gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    a = -torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
    xdt, dta = (x * dt[..., None]).contiguous(), (dt * a).contiguous()
    b = torch.randn((B, S, G, N), generator=g, device="cuda")
    c = torch.randn((B, S, G, N), generator=g, device="cuda")
    h0 = torch.randn((B, H, P, N), generator=g, device="cuda")
    n0, m0 = ssd_scan.launches, dict(ssd_scan.launches_by_mode)
    y, h = ssd_scan(xdt, dta, b, c, chunk=64, initial_state=h0,
                    return_final_state=True)
    assert ssd_scan.launches == n0 + 1
    assert ssd_scan.launches_by_mode == {"y": m0["y"],
                                         "state": m0["state"] + 1}
    ins = (xdt, dta, b, c)
    ey, eh = ssd_scan_plain(*(t.double() for t in ins), chunk=64,
                            initial_state=h0.double(),
                            return_final_state=True)
    py, ph = ssd_scan_plain(*ins, chunk=64, initial_state=h0,
                            return_final_state=True)
    for got, plain, exact in ((y, py, ey), (h, ph, eh)):
        e_plain = (plain.double() - exact).abs().max()
        assert (got.double() - exact).abs().max() <= 4 * e_plain + 1e-5
    y1, h1 = ssd_scan(*(t[:, :split].contiguous() for t in ins), chunk=64,
                      initial_state=h0, return_final_state=True)
    y2, h2 = ssd_scan(*(t[:, split:].contiguous() for t in ins), chunk=64,
                      initial_state=h1, return_final_state=True)
    e_plain = (py.double() - ey).abs().max()
    assert (torch.cat([y1, y2], 1).double() - ey).abs().max() \
        <= 4 * e_plain + 1e-5
    e_plain = (ph.double() - eh).abs().max()
    assert (h2.double() - eh).abs().max() <= 4 * e_plain + 1e-5
    xg = xdt.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_scan(xg, dta, b, c, chunk=64, initial_state=h0)
    yg, hg = ssd_scan(xg, dta, b, c, chunk=64, return_final_state=True)
    assert yg.requires_grad and not hg.requires_grad
    m1 = dict(ssd_scan.launches_by_mode)
    ssd_scan(xdt, dta, b, c, chunk=64)
    assert ssd_scan.launches_by_mode == {"y": m1["y"] + 1,
                                         "state": m1["state"]}


# (B, Sq, Sk, H, KVH, D, window, q_offset, kv_valid)
OFFSET = [(4, 512, 2048, 16, 8, 128, 0, 1536, None),   # Qwen3 prefill
          (4, 1, 2048, 16, 8, 128, 0, 2047, [1, 700, 2048, 1500]),
          (2, 64, 1164, 25, 5, 64, 1024, 1100, None),   # Hymba windowed
          (2, 5, 300, 4, 2, 64, 0, 17, [22, 300]),
          (2, 1, 40, 4, 2, 32, 3, 30, [31, 5]),         # row 1 sees none
          (1, 70, 200, 4, 4, 96, 20, 100, [0]),          # no key at all
          (2, 3, 256, 8, 1, 256, 0, 250, [253, 100])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,window,off,valid", OFFSET)
def test_cuda_flash_attention_offset_matches_plain(dtype, B, Sq, Sk, H, KVH,
                                                   D, window, off, valid):
    """On the card: flash_attention's offset mode (q_offset,
    kv_valid_len) against its plain version, both variants (f32 SIMT,
    bf16 tc where the head_dim has it), by the other flash rows' rule
    (2e-5 f32, 2e-2 bf16) on the rows that see a key; a row that sees
    none is 0 (the kernels' deliberate difference); the launch counted
    as "offset"; with grad on it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dt)
    k = torch.randn((B, Sk, KVH, D), generator=g, device="cuda").to(dt)
    v = torch.randn((B, Sk, KVH, D), generator=g, device="cuda").to(dt)
    kv = None if valid is None else torch.tensor(valid, device="cuda")
    kw = dict(window=window, q_offset=off, kv_valid_len=kv)
    variant = ops._variant(dt, D)
    n0 = flash_attention.launches_by_mode["offset"][variant]
    out = flash_attention(q, k, v, **kw)
    assert flash_attention.launches_by_mode["offset"][variant] == n0 + 1
    ref = flash_attention_plain(q, k, v, **kw)
    pos = off + torch.arange(Sq, device="cuda")
    kp = torch.arange(Sk, device="cuda")
    lim = torch.full((B,), Sk, device="cuda") if kv is None else kv
    sees = ((kp[None, None] <= pos[None, :, None])
            & (kp[None, None] < lim[:, None, None])
            & ((window <= 0) | (pos[None, :, None] - kp[None, None] < window))
            ).any(-1)                                           # (B, Sq)
    atol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float()[sees], ref.float()[sees],
                               atol=atol, rtol=0)
    assert bool((out[~sees] == 0).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q.clone().requires_grad_(True), k, v, **kw)
