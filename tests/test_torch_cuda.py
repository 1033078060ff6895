"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test decides inside its body whether a card is
there and skips elsewhere. This file imports no JAX, so it runs on a
GPU machine without it: ``PYTHONPATH=src python -m pytest
tests/test_torch_cuda.py -q``."""
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
                                              (200, 2, 2, 128, 64)])
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
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [(2, 100, 4, 16, 2, 8, 32),
                                               (1, 77, 4, 32, 4, 16, 64),
                                               (1, 300, 2, 64, 1, 128, 256)])
def test_cuda_ssd_scan_matches_plain(B, S, H, P, G, N, chunk):
    """On the card: ssd_scan against its plain version — grouped B/C,
    ragged chunks, Hymba's and Mamba-2's state sizes. Against the plain
    version in float64, the kernel's max error is within 4x that of the
    plain version in float32 (plus 1e-5): the decays difference two
    cumulative log-decay sums, whose f32 rounding either order shares."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see README.md)")
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    a = -torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
    xdt, dta = (x * dt[..., None]).contiguous(), (dt * a).contiguous()
    b = torch.randn((B, S, G, N), generator=g, device="cuda")
    c = torch.randn((B, S, G, N), generator=g, device="cuda")
    n0 = ssd_scan.launches
    y = ssd_scan(xdt, dta, b, c, chunk=chunk)
    assert ssd_scan.launches == n0 + 1
    exact = ssd_scan_plain(*(t.double() for t in (xdt, dta, b, c)),
                           chunk=chunk)
    e_plain = (ssd_scan_plain(xdt, dta, b, c, chunk=chunk).double()
               - exact).abs().max()
    assert (y.double() - exact).abs().max() <= 4 * e_plain + 1e-5
