"""The LM kernels' plain versions against the reference on the CPU:
``flash_attention_plain`` against the Pallas kernel (interpret mode) and
the model's ``chunked_attention`` — grouped-query heads, sliding windows,
a sequence that is not a multiple of the chunk — and ``ssd_scan_plain``
against the Pallas ``ssd_scan`` (interpret mode) and the model's
``ssd_chunked`` with grouped B/C. Inputs are made with numpy seeds and
cross as numpy arrays. On the card the wrappers launch the CUDA kernels
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models.attention import chunked_attention as j_chunked_attention
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.attention import chunked_attention
from repro_torch.models.ssm import ssd_chunked

from test_torch_common import t

torch.set_num_threads(1)

FLASH_F32 = 2e-5          # the reference's flash tolerance in f32
SSD_VS_PALLAS = 2e-3      # the reference's ssd kernel tolerance
SSD_VS_CHUNKED = 1e-4     # the same chunked algorithm, f32 sums reordered


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def test_flash_plain_matches_pallas_kernel():
    """GQA 2:1, causal, f32: the plain version against the Pallas kernel
    in interpret mode (it takes S a multiple of its block and no
    window)."""
    rng = np.random.default_rng(0)
    B, S, H, KVH, D = 2, 128, 4, 2, 64
    q, k, v = (_normal(rng, (B, S, h, D)) for h in (H, KVH, KVH))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=64, block_k=64, interpret=True)
    out = flash_attention_plain(t(q), t(k), t(v), chunk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_F32)


@pytest.mark.parametrize("window", [0, 1, 24])
@pytest.mark.parametrize("S,chunk", [(75, 32), (40, 64)])
def test_flash_plain_matches_chunked_attention(window, S, chunk):
    """Windowed and global, a ragged last chunk (75 = 2·32 + 11) or a
    chunk past the sequence: the wrapper on CPU tensors (the plain
    version) and the model's chunked_attention against the reference's
    chunked_attention."""
    rng = np.random.default_rng(1)
    B, H, KVH, D = 2, 4, 2, 32
    q, k, v = (_normal(rng, (B, S, h, D)) for h in (H, KVH, KVH))
    ref = np.asarray(j_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, chunk=min(chunk, S)))
    out = flash_attention(t(q), t(k), t(v), window=window, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_F32)
    out = chunked_attention(t(q), t(k), t(v), window=window,
                            chunk=min(chunk, S))
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_F32)


def test_flash_plain_keeps_bf16_and_unported_masks_raise():
    """bf16 stays bf16; q_offset and kv_valid_len raise, naming
    ROADMAP.md. causal=False, ported with MusicGen's cross-attention, is
    bidirectional attention against the reference's
    (tests/test_torch_musicgen.py holds it at Sk != Sq), and so is the
    prefix-LM mask over a prefix as long as the sequence (ported with
    PaliGemma, tests/test_torch_paligemma.py)."""
    rng = np.random.default_rng(2)
    q = t(_normal(rng, (1, 20, 2, 32))).bfloat16()
    assert flash_attention(q, q, q, window=4).dtype == torch.bfloat16
    for kw in ({"q_offset": 3}, {"kv_valid_len": torch.ones(1)}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            chunked_attention(q, q, q, **kw)
    qf = q.float()
    ref = np.asarray(j_chunked_attention(*(jnp.asarray(qf.numpy()),) * 3,
                                         causal=False, chunk=8))
    out = chunked_attention(qf, qf, qf, causal=False, chunk=8)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_F32)
    out = chunked_attention(qf, qf, qf, prefix_len=20, chunk=8)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_F32)


def _ssd_inputs(rng, B, S, H, P, G, N):
    x = _normal(rng, (B, S, H, P))
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5 + 0.1).astype(np.float32)
    a_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    b, c = _normal(rng, (B, S, G, N)), _normal(rng, (B, S, G, N))
    return x, dt, a_log, b, c


def test_ssd_plain_matches_pallas_kernel():
    """Per-head B/C (G = H, the Pallas kernel's layout), S a multiple of
    the chunk."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 2, 128, 4, 16, 8
    xdt = _normal(rng, (B, S, H, P))
    dta = (-np.abs(rng.normal(size=(B, S, H))) * 0.2).astype(np.float32)
    b, c = _normal(rng, (B, S, H, N)), _normal(rng, (B, S, H, N))
    ref = j_ssd_scan(*map(jnp.asarray, (xdt, dta, b, c)), chunk=64,
                     interpret=True)
    out = ssd_scan_plain(t(xdt), t(dta), t(b), t(c), chunk=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=SSD_VS_PALLAS, rtol=SSD_VS_PALLAS)


@pytest.mark.parametrize("S,chunk", [(100, 32), (64, 64), (20, 32)])
def test_ssd_chunked_matches_reference_grouped(S, chunk):
    """Grouped B/C (4 heads over 2 groups), ragged and single chunks: the
    port's ssd_chunked (prologue + the wrapper's plain version) against
    the reference's."""
    rng = np.random.default_rng(4)
    x, dt, a_log, b, c = _ssd_inputs(rng, 2, S, 4, 16, 2, 8)
    ref, _ = j_ssd_chunked(*map(jnp.asarray, (x, dt, a_log, b, c)),
                           chunk=chunk)
    out = ssd_chunked(t(x), t(dt), t(a_log), t(b), t(c), chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=SSD_VS_CHUNKED, rtol=SSD_VS_CHUNKED)


def test_ssd_scan_takes_no_initial_state():
    z = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_scan(z, z[..., 0], z[..., :4], z[..., :4], chunk=4,
                 initial_state=torch.zeros((1, 2, 16, 4)))
