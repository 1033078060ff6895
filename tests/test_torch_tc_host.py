"""The host side of the tensor-core kernels, which the CPU reaches: the
choice between the ``tc`` and ``simt`` kernels from dtype and shape (the
attention backward's included, with its checks),
``head_select``'s K-major repack of the head and its padding, its column
split, and the split's merge (``merge_head_stats``' math) in plain
PyTorch — against ``head_select_plain`` and against the reference's
``head_select_stats_ref`` / ``merge_head_stats``. The kernels themselves
run only on the card (``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.head_select.ref import (head_select_stats_ref,
                                           merge_head_stats)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.head_select import head_select
from repro_torch.kernels.head_select import ops as head_ops

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float16, 64, TypeError), (torch.bfloat16, 96, ValueError),
    (torch.float32, 256, ValueError)])
def test_flash_variant_from_dtype_and_head_dim(dtype, D, want):
    """bf16 at head_dim 64/128 takes the tensor cores, f32 and bf16 at 32
    the SIMT kernel; anything else raises, never falls back."""
    if isinstance(want, str):
        assert flash_ops._variant(dtype, D) == want
    else:
        with pytest.raises(want):
            flash_ops._variant(dtype, D)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float16, 64, TypeError),
    (torch.bfloat16, 96, ValueError)])
def test_flash_bwd_variant_is_the_forwards(dtype, D, want):
    """The backward's checks pick the forward's variant from dtype and
    head_dim (the bf16 tensor-core backward at 64/128, the SIMT one
    otherwise) and raise on the rest, never falling back."""
    q = torch.zeros((1, 9, 4, D), dtype=dtype)
    k = torch.zeros((1, 9, 2, D), dtype=dtype)
    lse = torch.zeros((1, 4, 9))
    if isinstance(want, str):
        assert flash_ops._bwd_check(q, k, k, q, lse, q) == want
    else:
        with pytest.raises(want):
            flash_ops._bwd_check(q, k, k, q, lse, q)


def test_flash_bwd_checks_refuse_what_the_kernels_do_not_take():
    """o and dO of q's shape and dtype, contiguous; for the tc variant
    16-byte aligned (TMA); lse (B, H, S) f32."""
    q = torch.zeros((1, 9, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 9, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 9))
    odd = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    for o, do, ls in ((q.float(), q, lse), (q, q.transpose(1, 2), lse),
                      (q, odd, lse), (q, q, lse.double()),
                      (q, q, torch.zeros((1, 9, 4)))):
        with pytest.raises(ValueError):
            flash_ops._bwd_check(q, k, k, o, ls, do)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "tc"), (torch.float32, "simt"),
    (torch.float16, TypeError), (torch.float64, TypeError)])
def test_head_select_variant_from_dtype(dtype, want):
    if isinstance(want, str):
        assert head_ops._variant(dtype) == want
    else:
        with pytest.raises(want):
            head_ops._variant(dtype)


def test_cpu_calls_count_no_variant():
    """CPU tensors take the plain versions: no launch, of any kernel."""
    before = (dict(head_select.launches_by_variant),
              dict(flash_attention.launches_by_variant),
              dict(flash_attention_bwd.launches_by_variant))
    head_select(torch.randn(1, 4, 8).bfloat16(),
                torch.randn(1, 8, 12).bfloat16(), k=2)
    x = torch.randn(1, 9, 2, 64).bfloat16()
    flash_attention(x, x, x)
    flash_attention_bwd(x, x, x, x, torch.zeros((1, 2, 9)), x)
    assert (head_select.launches_by_variant,
            flash_attention.launches_by_variant,
            flash_attention_bwd.launches_by_variant) == before
    assert set(before[0]) == set(before[1]) == set(before[2]) == {"tc",
                                                                 "simt"}


@pytest.mark.parametrize("L,N,D,C", [(2, 5, 48, 300), (1, 7, 50, 301),
                                     (3, 4, 7, 10), (1, 3, 1600, 1001)])
@pytest.mark.parametrize("tied", [False, True])
def test_head_repack_keeps_the_product(L, N, D, C, tied):
    """The K-major head wt (L, C, D8) and hidden (L, N, D8), D padded with
    zeros to 16-byte bf16 rows: the product through them is hidden @ w,
    for ragged C and D, untied (L, D, C) heads and tied ones (a
    transposed view of the (L, C, D) table, passed without a copy when D
    needs no padding)."""
    rng = np.random.default_rng(L * 1000 + D + C)
    h = torch.as_tensor(rng.normal(size=(L, N, D))).float()
    if tied:
        table = torch.as_tensor(rng.normal(size=(L, C, D))).float()
        w = table.transpose(-1, -2)
    else:
        w = torch.as_tensor(rng.normal(size=(L, D, C))).float()
    hp, wt = head_ops._tc_operands(h, w)
    D8 = -(-D // 8) * 8
    assert hp.shape == (L, N, D8) and wt.shape == (L, C, D8)
    assert hp.is_contiguous() and wt.is_contiguous()
    assert (D8 * 2) % 16 == 0
    assert not hp[..., D:].any() and not wt[..., D:].any()
    if tied and D == D8:
        assert wt.data_ptr() == table.data_ptr()
    got = torch.matmul(hp.double(), wt.double().transpose(-1, -2))
    want = torch.matmul(h.double(), w.double())
    torch.testing.assert_close(got, want, atol=1e-9, rtol=1e-12)


@pytest.mark.parametrize("L,N,C,D,want", [
    (4, 16384, 32001, 1600, 2),  # Hymba's round: 512 row tiles fill the
                                 # card, but a wave's hidden tiles (54 MB)
                                 # would not sit in half the L2
    (4, 16384, 32001, 512, 1),   # ... and at D 512 (17 MB) they would
    (1, 512, 151936, 2048, 66),  # Qwen3-1.7B's head: 4 row tiles
    (16, 256, 10, 64, 1),        # the ResNet head: one column tile
    (3, 70, 300, 48, 2), (1, 130, 32001, 1600, 126)])
def test_column_splits(L, N, C, D, want):
    """Slices are whole 256-column tiles, cover C, none empty; C is split
    when the row tiles cannot fill twice the SMs, and in two when a
    wave's hidden tiles would crowd the L2."""
    slice_w, nsplit = head_ops._column_splits(L, N, C, D, 132)
    assert nsplit == want
    assert slice_w % head_ops.TC_COLS == 0
    assert slice_w * (nsplit - 1) < C <= slice_w * nsplit
    tiles = L * -(-N // head_ops.TC_ROWS)
    if nsplit > 2:
        assert tiles < 2 * 132


def _inputs(seed, L, N, D, C, bias, integer=False):
    rng = np.random.default_rng(seed)
    if integer:     # small integers: every logit exact, many exact ties
        h = rng.integers(-2, 3, size=(L, N, D))
        w = rng.integers(-1, 2, size=(L, D, C))
        w[..., C - 40:] = w[..., :40]
        b = rng.integers(-1, 2, size=(L, C)) if bias else None
    else:
        h = rng.normal(size=(L, N, D))
        w = rng.normal(size=(L, D, C)) * 0.3
        b = rng.normal(size=(L, C)) * 0.1 if bias else None
    t = (lambda a: None if a is None else torch.as_tensor(a).float())
    return t(h), t(w), t(b)


@pytest.mark.parametrize("det", ["msp", "energy"])
@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("slice_w,integer", [(256, False), (512, False),
                                             (256, True)])
def test_split_merge_equals_plain(det, k, slice_w, integer):
    """Split C into slices, reduce each to (m, z, top-k logits, global
    indices), merge: the same (conf, vals, idx) as head_select_plain —
    ragged last slice, with and without ties (integer logits with
    duplicated columns: the indices must be equal, ties to the lowest)."""
    h, w, b = _inputs(k + slice_w, 2, 9, 24, 1000, bias=True,
                      integer=integer)
    kw = dict(temperature=10.0, k=k, detector=det)
    got = head_ops.head_select_split_plain(h, w, b, slice_w=slice_w, **kw)
    want = head_ops.head_select_plain(h, w, b, **kw)
    for a, r in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("det", ["msp", "energy"])
@pytest.mark.parametrize("integer", [False, True])
def test_split_stats_and_merge_match_reference(det, integer):
    """Each slice's raw stats against the reference's head_select_stats_ref
    (its local indices shifted to global), and the merge against its
    merge_head_stats, on the same per-slice stats."""
    h, w, b = _inputs(7, 1, 6, 16, 700, bias=False, integer=integer)
    k, slice_w = 8, 256
    stats = []
    for c0 in range(0, 700, slice_w):
        ws = w[..., c0:c0 + slice_w]
        m, z, tv, ti = head_ops.head_select_stats_plain(h, ws, k=k, col0=c0)
        jm, jz, jtv, jti = head_select_stats_ref(
            jnp.asarray(h[0].numpy()), jnp.asarray(ws[0].numpy()), k=k)
        np.testing.assert_allclose(m[0].numpy(), np.asarray(jm), rtol=1e-6)
        np.testing.assert_allclose(z[0].numpy(), np.asarray(jz), rtol=1e-5)
        np.testing.assert_allclose(tv[0].numpy(), np.asarray(jtv),
                                   rtol=1e-6)
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(jti) + c0)
        stats.append((m, z, tv, ti))
    ms, zs, tvs, tis = zip(*stats)
    kw = dict(temperature=10.0, k=k, detector=det)
    got = head_ops.merge_head_stats_plain(ms, zs, tvs, tis, **kw)
    want = merge_head_stats(*(jnp.stack([jnp.asarray(t[0].numpy())
                                         for t in ts])
                              for ts in (ms, zs, tvs, tis)), **kw)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
