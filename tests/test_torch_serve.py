"""The serving path's kernel modes and server against the reference on
the CPU.

* ``ssd_scan``'s initial / final state: ``ssd_scan_plain`` and
  ``ssd_scan_passes_plain`` (the CUDA kernel's three passes) from a
  random initial state against the reference's sequential
  ``ssd_scan_ref`` (y and h_T), the continuation identity (split at a
  position that is not a multiple of the tile: the second half from the
  first's h_T gives the rest of y and the same h_T), and the port's
  ``ssd_chunked`` ``(y, final_state)`` against the reference's.
* ``flash_attention``'s offset mode: ``chunked_attention`` with
  ``q_offset`` / ``kv_valid_len`` (GQA, windows, a chunked prefill, a
  decode-shaped call) against the reference's, including rows that see
  no key, where both give the reference's -1e30 value (V summed over the
  keys over n_chunks · chunk).
* ``BatchedServer`` against the reference's on ``tests/test_serve.py``'s
  tiny config, the reference's params the port's (converted): every
  step's logits within 1e-5 of max(1, max |x|) and the generated tokens
  equal, except after a step whose two best logits lie within 1e-5 (a
  near-tie either side may break); the CLI and ``serve_batched.py`` on
  the CPU.

Tolerances (f32, sums reordered): 1e-5 of max(1, max |x|); the SSD
scans against the sequential recurrence 1e-4 (``ssd_scan``'s own
tolerance in the reference's tests is 2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.launch.serve import BatchedServer as JServer
from repro.launch.serve import Request as JRequest
from repro.models import attention as jattn
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
from repro_torch import serve_batched
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import to_jax_lm_params

torch.set_num_threads(1)

RTOL = 1e-5
SSD_ATOL = 1e-4


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol} x {scale:.3g}"


def _ssd_inputs(rng, B, S, H, P, G, N):
    xdt = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dta = (-rng.uniform(0.01, 0.5, size=(B, S, H))).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return xdt, dta, b, c, h0


@pytest.mark.parametrize("S,split", [(150, 37), (40, 21)])
def test_ssd_scan_initial_and_final_state_match_reference(S, split):
    """Both plain versions from h0 against ssd_scan_ref (y, h_T); the
    continuation identity; grouped B/C (H 4 over G 2)."""
    rng = np.random.default_rng(0)
    xdt, dta, b, c, h0 = _ssd_inputs(rng, 2, S, 4, 8, 2, 4)
    rep = lambda a: np.repeat(a, 2, axis=2)          # noqa: E731
    y_ref, h_ref = ssd_scan_ref(*map(jnp.asarray, (xdt, dta, rep(b),
                                                   rep(c))),
                                initial_state=jnp.asarray(h0))
    T = torch.from_numpy
    for name, fn, kw in (("plain", ssd_ops.ssd_scan_plain, {"chunk": 16}),
                         ("passes", ssd_ops.ssd_scan_passes_plain,
                          {"tile": 16})):
        y, h = fn(T(xdt), T(dta), T(b), T(c), initial_state=T(h0),
                  return_final_state=True, **kw)
        _close(y, y_ref, f"{name} y", SSD_ATOL)
        _close(h, h_ref, f"{name} h_T", SSD_ATOL)
        # continuation: the second part from the first part's h_T
        parts = [fn(*(T(a[:, lo:hi]) for a in (xdt, dta, b, c)),
                    initial_state=h_in, return_final_state=True, **kw)
                 for lo, hi, h_in in ((0, split, T(h0)),)]
        parts.append(fn(*(T(a[:, split:]) for a in (xdt, dta, b, c)),
                        initial_state=parts[0][1], return_final_state=True,
                        **kw))
        _close(torch.cat([parts[0][0], parts[1][0]], dim=1), y,
               f"{name} continued y")
        _close(parts[1][1], h, f"{name} continued h_T")
    # without the state, the plain version is the old y
    _close(ssd_ops.ssd_scan_plain(T(xdt), T(dta), T(b), T(c), chunk=16),
           ssd_scan_ref(*map(jnp.asarray, (xdt, dta, rep(b), rep(c))))[0],
           "y from zeros", SSD_ATOL)


def test_ssd_chunked_returns_the_reference_final_state():
    """The port's ssd_chunked (x, dt, a_log, b, c, initial_state) -> (y,
    final_state) against the reference's, from a state and from zeros;
    with return_final_state=False (ssm_forward's call) the same y and no
    state."""
    rng = np.random.default_rng(1)
    B, S, H, P, G, N = 2, 45, 4, 8, 2, 4
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, S, H)).astype(np.float32)
    a_log = rng.normal(size=H).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    for init in (None, h0):
        jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, b, c)),
                                  chunk=16, initial_state=None
                                  if init is None else jnp.asarray(init))
        y, h = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, b, c)),
                                chunk=16, initial_state=None
                                if init is None else torch.from_numpy(init))
        _close(y, jy, "ssd_chunked y")
        _close(h, jh, "ssd_chunked final state")
        y_only, none = tssm.ssd_chunked(
            *map(torch.from_numpy, (x, dt, a_log, b, c)), chunk=16,
            initial_state=None if init is None else torch.from_numpy(init),
            return_final_state=False)
        assert none is None and torch.equal(y_only, y)


# (Sq, Sk, H, KVH, window, q_offset, kv_valid_len)
OFFSET = [(5, 23, 4, 2, 0, 18, [23, 20]),          # chunked prefill
          (6, 30, 4, 1, 5, 10, None),               # window, offset alone
          (1, 17, 4, 2, 0, 9, [10, 1]),             # decode-shaped
          (1, 17, 4, 2, 3, 16, [17, 4]),            # window hides row 1
          (3, 12, 2, 2, 0, 0, [12, 0])]             # a batch with no key


@pytest.mark.parametrize("Sq,Sk,H,KVH,window,off,valid", OFFSET)
def test_offset_mode_matches_reference(Sq, Sk, H, KVH, window, off, valid):
    """chunked_attention(q_offset=, kv_valid_len=) against the
    reference's, at chunk 8 (a ragged last chunk); rows that see no key
    get the reference's value."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, Sq, H, 16)).astype(np.float32)
    k = rng.normal(size=(2, Sk, KVH, 16)).astype(np.float32)
    v = rng.normal(size=(2, Sk, KVH, 16)).astype(np.float32)
    kw = dict(q_offset=off, window=window, chunk=8)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.int32)
    ref = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                  kv_valid_len=jvalid, **kw)
    out = tattn.chunked_attention(
        *map(torch.from_numpy, (q, k, v)),
        kv_valid_len=None if valid is None else torch.tensor(valid), **kw)
    _close(out, ref, "offset mode")
    if valid is not None and valid[1] == 0:       # the reference's value
        want = np.repeat(v[1].sum(0), H // KVH, axis=0) / (-(-Sk // 8) * 8)
        _close(out[1, 0], want, "a row that sees no key")


def _tiny_serve_cfg(get):
    return get("qwen1.5-0.5b").reduced().replace(
        num_layers=1, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128, dtype="float32")


def _record(server, logs):
    real = server._decode

    def decode(*a):
        logits, state = real(*a)
        logs.append(np.asarray(logits[:, -1], np.float64))
        return logits, state
    server._decode = decode


def test_batched_server_matches_reference():
    """The port's BatchedServer against the reference's on test_serve's
    tiny config: 5 requests of mixed prompt and generation lengths on 2
    slots (3 waves), the same params; every step's logits, and the
    tokens up to a near-tie."""
    jserver = JServer(_tiny_serve_cfg(jconfigs.get_config), batch_slots=2,
                      context=32)
    server = serve.BatchedServer(_tiny_serve_cfg(tconfigs.get_config),
                                 batch_slots=2, context=32, device="cpu")
    jserver.params = jax.tree.map(jnp.asarray,
                                  to_jax_lm_params(server.params))
    rng = np.random.default_rng(0)
    spec = [(4, 3), (6, 2), (3, 5), (5, 4), (2, 3)]
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n, _ in spec]
    jlogs, logs = [], []
    _record(jserver, jlogs)
    _record(server, logs)
    jout = jserver.submit_all([JRequest(i, p.copy(), m)
                               for i, (p, (_, m)) in
                               enumerate(zip(prompts, spec))])
    out = server.submit_all([serve.Request(i, p.copy(), m)
                             for i, (p, (_, m)) in
                             enumerate(zip(prompts, spec))])
    assert set(out) == set(jout) == set(range(len(spec)))
    assert len(logs) == len(jlogs)
    tied = set()
    for i, (a, b) in enumerate(zip(logs, jlogs)):
        _close(a, b, f"server step {i} logits")
        for s in range(a.shape[0]):
            if np.argmax(a[s]) != np.argmax(b[s]):
                top = np.sort(b[s])[-2:]
                assert top[1] - top[0] <= RTOL * max(1.0, abs(top[1])), \
                    f"step {i} slot {s}: argmax differs off a near-tie"
                tied.add(s)
    if not tied:
        assert out == jout
    assert all(len(out[i]) == m for i, (_, m) in enumerate(spec))


def test_serve_cli_and_example_on_cpu():
    """``python -m repro_torch.launch.serve`` and ``serve_batched`` with
    --device cpu: every request answered with --gen-len tokens in the
    vocabulary; greedy decode of one prompt alone is deterministic."""
    out = serve.main(["--arch", "qwen3-1.7b", "--requests", "3", "--slots",
                      "2", "--prompt-len", "4", "--gen-len", "3",
                      "--device", "cpu"])
    V = tconfigs.get_config("qwen3-1.7b").reduced().vocab_size
    assert set(out) == {0, 1, 2}
    assert all(len(v) == 3 and all(0 <= x < V for x in v)
               for v in out.values())
    out = serve_batched.main(["--arch", "mamba2-780m", "--device", "cpu"])
    assert set(out) == {0, 1, 2, 3} and all(len(v) == 8
                                            for v in out.values())
    server = serve.BatchedServer(_tiny_serve_cfg(tconfigs.get_config),
                                 batch_slots=2, context=32, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 128, 4).astype(np.int32)
    first = server.submit_all([serve.Request(0, prompt.copy(), 4)])
    assert server.submit_all([serve.Request(0, prompt.copy(), 4)]) == first
    with pytest.raises(SystemExit, match="token-only"):
        serve.main(["--arch", "musicgen-medium", "--device", "cpu"])
