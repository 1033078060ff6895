"""The SSD scan's three-pass decomposition — the math of the CUDA kernels
in ``csrc/ssd_scan.cu`` — against the reference on the CPU.

``ssd_scan_passes_plain`` (tile states, state passing, tile scan with
C·Bᵀ once per group) tiles the sequence by its own length, which differs
from the model's ``chunk``. It is held to the JAX package's sequential
``ssd_scan_ref`` (ragged S, grouped B/C, a tile of 1, decays steep
enough that most exponentials underflow to 0), to the Pallas
``ssd_scan`` in interpret mode, and to the port's own ``ssd_scan_plain``
at another chunk; the states that the first two passes produce are held
to the reference's final state. Inputs are made with numpy seeds.

Tolerance: 1e-4 absolute and relative (tighter than the reference's own
2e-3 for its kernel): both sides run in f32, and the two orders of the
cumulative log-decay sums differ by a few f32 ulps of max |y| (~30)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_ref
from repro_torch.kernels.ssd_scan import ops

from test_torch_common import t

torch.set_num_threads(1)

SSD_PASSES = 1e-4


def _inputs(seed, B, S, H, P, G, N, steep=1.0):
    """xdt, dta (dt·A with A = −steep·(1..H), as Hymba's a_log gives at
    steep 1), grouped b and c."""
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5 + 0.1).astype(np.float32)
    dta = (dt * -steep * np.arange(1, H + 1, dtype=np.float32)
           ).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    return xdt, dta, b, c


def _sequential(xdt, dta, b, c):
    """The reference's sequential recurrence, B/C expanded per head."""
    rep = xdt.shape[2] // b.shape[2]
    y, final = ssd_scan_ref(*map(jnp.asarray, (
        xdt, dta, np.repeat(b, rep, axis=2), np.repeat(c, rep, axis=2))))
    return np.asarray(y), np.asarray(final)


@pytest.mark.parametrize("B,S,H,P,G,N,tile,steep", [
    (2, 100, 4, 16, 2, 8, 32, 1.0),      # ragged S, two groups
    (1, 77, 6, 16, 3, 12, 16, 1.0),      # ragged, N % 8 == 4
    (1, 40, 2, 16, 1, 4, 1, 1.0),        # a tile of one position
    (2, 96, 4, 32, 1, 8, 64, 50.0),      # steep: exp underflows to 0
])
def test_ssd_passes_match_sequential_reference(B, S, H, P, G, N, tile,
                                               steep):
    xdt, dta, b, c = _inputs(5, B, S, H, P, G, N, steep)
    ref, _ = _sequential(xdt, dta, b, c)
    out = ops.ssd_scan_passes_plain(t(xdt), t(dta), t(b), t(c), tile=tile)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, atol=SSD_PASSES,
                               rtol=SSD_PASSES)


def test_ssd_passes_steep_decays_underflow_without_nan():
    """At A = −50·h the within-tile decays exp(cum_t − cum_u) underflow
    to exactly 0 for most (t, u), and exp(cum_end) too, yet no inf or NaN
    reaches the states or y."""
    xdt, dta, b, c = _inputs(6, 1, 130, 4, 16, 1, 8, 50.0)
    cum = np.cumsum(dta[0, :64, 0].astype(np.float64))
    assert np.exp(np.float32(cum[-1] - cum[0])) == 0.0
    states, cum_end = ops.ssd_chunk_states_plain(t(xdt), t(dta), t(b),
                                                 tile=64)
    assert float(torch.exp(cum_end).min()) == 0.0
    state_in = ops.ssd_state_passing_plain(states, cum_end)
    y = ops.ssd_chunk_scan_plain(t(xdt), t(dta), t(b), t(c), state_in,
                                 tile=64)
    for x in (states, state_in, y):
        assert bool(torch.isfinite(x).all())
    np.testing.assert_allclose(y.numpy(), _sequential(xdt, dta, b, c)[0],
                               atol=SSD_PASSES, rtol=SSD_PASSES)


def test_ssd_passes_match_pallas_kernel():
    """Per-head B/C (G = H, the Pallas kernel's layout) at chunk 64,
    against the passes at tile 16."""
    xdt, dta, b, c = _inputs(7, 2, 128, 4, 16, 4, 8)
    ref = j_ssd_scan(*map(jnp.asarray, (xdt, dta, b, c)), chunk=64,
                     interpret=True)
    out = ops.ssd_scan_passes_plain(t(xdt), t(dta), t(b), t(c), tile=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=SSD_PASSES, rtol=SSD_PASSES)


@pytest.mark.parametrize("S,chunk,tile", [(200, 256, 64), (150, 32, 64),
                                          (64, 1, 16)])
def test_ssd_passes_match_plain_at_another_chunk(S, chunk, tile):
    """The kernels' tile need not be the model's chunk: the passes at
    ``tile`` equal ssd_scan_plain at ``chunk``."""
    xdt, dta, b, c = _inputs(8, 1, S, 4, 16, 2, 8)
    ref = ops.ssd_scan_plain(t(xdt), t(dta), t(b), t(c), chunk=chunk)
    out = ops.ssd_scan_passes_plain(t(xdt), t(dta), t(b), t(c), tile=tile)
    torch.testing.assert_close(out, ref, atol=SSD_PASSES, rtol=SSD_PASSES)


def test_ssd_pass_states_match_reference_final_state():
    """Passes 1 and 2 carry the state: the state after the last tile,
    exp(cum_end) state_in + S, is the reference's final state."""
    xdt, dta, b, c = _inputs(9, 2, 100, 4, 16, 2, 8)
    states, cum_end = ops.ssd_chunk_states_plain(t(xdt), t(dta), t(b),
                                                 tile=32)
    assert states.shape == (2, 4, 4, 16, 8) and cum_end.shape == (2, 4, 4)
    state_in = ops.ssd_state_passing_plain(states, cum_end)
    assert float(state_in[:, 0].abs().max()) == 0.0
    final = state_in[:, -1] * torch.exp(cum_end[:, -1])[..., None, None] \
        + states[:, -1]
    np.testing.assert_allclose(final.numpy(),
                               _sequential(xdt, dta, b, c)[1],
                               atol=SSD_PASSES, rtol=SSD_PASSES)
