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
