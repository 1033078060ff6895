"""The kernels' plain PyTorch versions against the reference: the Pallas
kernels in interpret mode and their jnp oracles (``ref.py``), at 1e-5 in
f32 — ragged C, k = 1, both detectors and the leading node axis. The
CUDA kernels themselves run only on the card (``test_torch_cuda.py``
and ``chip_smoke.py``); here the wrappers take their plain path, which
they do only for CPU tensors."""
import numpy as np
import pytest
import torch

from repro.kernels.head_select import head_select as j_head_select
from repro.kernels.head_select import head_select_ref as j_head_ref
from repro.kernels.msp_select import msp_select as j_msp_select
from repro.kernels.msp_select import msp_select_ref as j_msp_ref
from repro_torch.kernels.head_select import head_select, head_select_plain
from repro_torch.kernels.msp_select import msp_select, msp_select_plain

torch.set_num_threads(1)


def _close(out, ref):
    c, v, i = (np.asarray(a) for a in out)
    cr, vr, ir = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(c, cr, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v, vr, atol=1e-5)
    np.testing.assert_array_equal(i, ir)


@pytest.mark.parametrize("L,rows,D,C,k,det,bc", [
    (2, 16, 32, 200, 4, "msp", 64),      # ragged C: 200 % 64 != 0
    (1, 8, 16, 50, 1, "energy", 16),     # k = 1 (the validation pass)
    (3, 8, 24, 10, 8, "msp", 512),       # the ResNet head: C = 10, k = 8
    (2, 8, 24, 96, 8, "energy", 32),
])
def test_head_select_plain_matches_reference(L, rows, D, C, k, det, bc):
    """Per node: the Pallas kernel (interpret mode) and the jnp oracle
    against one node-stacked call of the port."""
    rng = np.random.default_rng(rows * C + k)
    h = rng.normal(size=(L, rows, D)).astype(np.float32)
    w = (rng.normal(size=(L, D, C)) * 0.3).astype(np.float32)
    b = rng.normal(size=(L, C)).astype(np.float32)
    out = head_select(torch.as_tensor(h), torch.as_tensor(w),
                      torch.as_tensor(b), temperature=10.0, k=k,
                      detector=det)
    assert out[0].shape == (L, rows) and out[1].shape == (L, rows, k)
    assert out[2].dtype == torch.int32
    for l in range(L):
        mine = tuple(a[l] for a in out)
        _close(mine, j_head_ref(h[l], w[l], b[l], temperature=10.0, k=k,
                                detector=det))
        _close(mine, j_head_select(h[l], w[l], b[l], temperature=10.0, k=k,
                                   block_rows=8, block_c=bc, interpret=True,
                                   detector=det))


def test_head_select_no_bias():
    """bias=None (a head without a bias) on one node."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=(8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    out = head_select(torch.as_tensor(h)[None], torch.as_tensor(w)[None],
                      None, temperature=5.0, k=4)
    _close(tuple(a[0] for a in out),
           j_head_ref(h, w, None, temperature=5.0, k=4))


@pytest.mark.parametrize("N,C,k,det", [(16, 64, 4, "msp"),
                                       (8, 257, 1, "energy"),
                                       (32, 10, 8, "msp"),
                                       (16, 96, 8, "energy")])
def test_msp_select_plain_matches_reference(N, C, k, det):
    rng = np.random.default_rng(N + C)
    x = (rng.normal(size=(N, C)) * 4).astype(np.float32)
    out = msp_select(torch.as_tensor(x), temperature=10.0, k=k, detector=det)
    _close(out, j_msp_ref(x, temperature=10.0, k=k, detector=det))
    _close(out, j_msp_select(x, temperature=10.0, k=k, block_n=8,
                             interpret=True, detector=det))


def test_top_k_ties_go_to_lowest_index():
    """Exact ties keep lax.top_k's order (lowest index first)."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0]])
    _, _, idx = msp_select(x, temperature=1.0, k=4)
    assert idx.tolist() == [[1, 2, 4, 5]]
    # identity hidden: every row's logits are the head's row, x
    _, _, idx = head_select(torch.eye(6)[None],
                            x.expand(6, 6)[None].contiguous(), None,
                            temperature=1.0, k=3)
    assert idx[0].tolist() == [[1, 2, 4]] * 6


def test_wrappers_take_plain_path_only_on_cpu():
    """CPU tensors: the plain version, no launch counted. Any other
    device that is not CUDA: an error, never a silent fallback."""
    before = (head_select.launches, msp_select.launches)
    x = torch.randn(4, 10)
    for a, b in zip(msp_select(x, k=3), msp_select_plain(x, temperature=10.0,
                                                         k=3)):
        assert torch.equal(a, b)
    h, w = torch.randn(2, 4, 8), torch.randn(2, 8, 10)
    for a, b in zip(head_select(h, w, k=3),
                    head_select_plain(h, w, temperature=10.0, k=3)):
        assert torch.equal(a, b)
    assert (head_select.launches, msp_select.launches) == before
    with pytest.raises(ValueError, match="device"):
        msp_select(x.to("meta"), k=3)
    with pytest.raises(ValueError, match="device"):
        head_select(h.to("meta"), w.to("meta"), k=3)
    with pytest.raises(ValueError, match="detector"):
        msp_select(x, k=3, detector="odin")
