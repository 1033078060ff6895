"""Gradients of the LM path against the reference on the CPU: the
attention and SSD backward passes (the kernels' plain versions and
autograd through the port's model functions) against ``jax.vjp`` of the
reference's ``chunked_attention`` and ``ssd_chunked``, and
``DecoderModel.loss`` with its gradients against the reference's
``loss`` and ``jax.grad`` on a reduced Hymba, with per-layer recompute
on and off. Inputs come from numpy seeds; weights are made by the
port's ``init`` and carried to the reference with
``convert.to_jax_lm_params``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.models import ssm as jssm
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_plain
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import to_jax_lm_params
from repro_torch.models.transformer import DecoderModel

from test_torch_common import hymba_small, leaves, t

torch.set_num_threads(1)

ATTN_GRAD_TOL = 1e-5     # f32 gradients of |value| ~ 1, sums reordered
SSD_GRAD_TOL = 1e-5      # relative to each gradient's max |value|
SSD_VS_F32 = 4.0         # the float64 rule of the repo's SSD checks
LOSS_TOL = 1e-5          # f32 loss ~ 6.3 after 3 layers
GRAD_TOL = 2e-4          # relative to each leaf's max |grad|: 3 f32 layers


def _lse(q, k, window):
    """The forward's row log-sum-exp (B, H, S) of the scaled scores."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(G, 2))
    pos = torch.arange(S)
    allow = pos[None, :] <= pos[:, None]
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    return torch.logsumexp((s / math.sqrt(D)).masked_fill(~allow, -1e30), -1)


@pytest.mark.parametrize("window", [0, 20])
def test_attention_backward_matches_jax_vjp(window):
    """flash_attention_bwd_plain (through the wrapper's CPU branch) and
    autograd through the port's chunked_attention against jax.vjp of the
    reference's: GQA 4:2, S 75 over 32-key chunks (a ragged last chunk),
    a window that bites."""
    rng = np.random.default_rng(21)
    B, S, H, KVH, D = 2, 75, 4, 2, 16
    q, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    ref_o, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, causal=True, window=window, chunk=32), q, k, v)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    o = tattn.chunked_attention(tq, tk, tv, window=window, chunk=32)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o),
                               atol=ATTN_GRAD_TOL)
    o.backward(t(do))
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_GRAD_TOL)

    lse = _lse(t(q), t(k), window)
    for fn in (flash_attention_bwd_plain, flash_attention_bwd):
        got = fn(t(q), t(k), t(v), o.detach(), lse, t(do), window=window,
                 chunk=32)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r, atol=ATTN_GRAD_TOL)


def _ssd_inputs(seed, B=2, S=45, H=4, P=8, G=2, N=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    a_log = np.log(np.arange(1, H + 1)).astype(np.float32)
    b = rng.normal(size=(B, S, G, N)).astype(np.float32)
    c = rng.normal(size=(B, S, G, N)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    return x, dt, a_log, b, c, dy


def _close_rel(got, ref, tol, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _ssd_truth(x, dt, a_log, b, c, dy, chunk):
    """Float64 gradients of the port's ssd_chunked (plain chunked form,
    torch autograd): the yardstick of the f32 parity rule."""
    ins = [torch.tensor(a, dtype=torch.float64).requires_grad_(True)
           for a in (x, dt, a_log, b, c)]
    tssm.ssd_chunked(*ins, chunk=chunk)[0].backward(
        torch.tensor(dy, dtype=torch.float64))
    return [g.grad.numpy() for g in ins]


def _no_less_exact(got, ref, exact, what):
    """The SSD rule of the repo's kernel checks: against float64, the
    port's f32 gradient is within SSD_VS_F32 times the reference's f32
    error, plus SSD_GRAD_TOL of the gradient's max |value|/10. Where the
    decays are steep, da_log sums B·S terms of cumulative log-decays of
    both signs, and no f32 order keeps more than a few digits of it."""
    scale = float(np.abs(exact).max())
    e_port = float(np.abs(np.asarray(got, np.float64) - exact).max())
    e_ref = float(np.abs(np.asarray(ref, np.float64) - exact).max())
    assert e_port <= SSD_VS_F32 * e_ref + 0.1 * SSD_GRAD_TOL * scale, (
        what, e_port, e_ref, scale)


SSD_NAMES = ("x", "dt", "a_log", "b", "c")


def test_ssd_backward_matches_jax_vjp():
    """Autograd through the port's ssd_chunked, and ssd_scan_bwd_plain
    (through the wrapper's CPU branch) chained with the prologue
    (xdt = x·dt, dta = dt·A, A = −exp(a_log)), against jax.vjp of the
    reference's ssd_chunked w.r.t. (x, dt, a_log, b, c): grouped B/C (4
    heads over 2 groups), S 45 over chunks of 16 (a ragged last chunk).
    x, dt, b and c within SSD_GRAD_TOL of their max |value|; a_log by the
    float64 rule (see _no_less_exact)."""
    x, dt, a_log, b, c, dy = _ssd_inputs(22)
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk=16)[0],
                     x, dt, a_log, b, c)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    exact = _ssd_truth(x, dt, a_log, b, c, dy, 16)

    ins = [t(a).requires_grad_(True) for a in (x, dt, a_log, b, c)]
    tssm.ssd_chunked(*ins, chunk=16)[0].backward(t(dy))
    tx, tdt, ta, tb, tc = (t(a) for a in (x, dt, a_log, b, c))
    A = -torch.exp(ta)
    dxdt, ddta, db, dc = ssd_scan_bwd((tx * tdt[..., None]).contiguous(),
                                      (tdt * A).contiguous(), tb, tc, t(dy))
    chained = (dxdt * tdt[..., None], (dxdt * tx).sum(-1) + ddta * A,
               (ddta * tdt * A).sum((0, 1)), db, dc)
    for path, grads in (("autograd", [i.grad for i in ins]),
                        ("ssd_scan_bwd", chained)):
        for name, g, r, e in zip(SSD_NAMES, grads, ref, exact):
            what = f"{path} d{name}"
            if name == "a_log":
                _no_less_exact(g.numpy(), r, e, what)
            else:
                _close_rel(g.numpy(), r, SSD_GRAD_TOL, what)


def test_ssd_backward_formulas_are_exact():
    """ssd_scan_bwd_plain's formulas in float64 equal torch autograd of
    the plain chunked scan in float64 (to 1e-10 of each gradient's max
    |value|); in float32 they are no less exact than f32 autograd of the
    chunked form (the float64 rule)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    x, dt, a_log, b, c, dy = _ssd_inputs(25, S=50)
    A = -np.exp(a_log)
    xdt = (x * dt[..., None]).astype(np.float32)
    dta = (dt * A).astype(np.float32)
    grads = {}
    for dtype in (torch.float64, torch.float32):
        ins = [torch.tensor(a, dtype=dtype).requires_grad_(True)
               for a in (xdt, dta, b, c)]
        ssd_scan_plain(*ins, chunk=16).backward(torch.tensor(dy, dtype=dtype))
        grads[dtype] = [i.grad.double().numpy() for i in ins]
    got64 = ssd_scan_bwd_plain(*(torch.tensor(a, dtype=torch.float64)
                                 for a in (xdt, dta, b, c, dy)))
    got32 = ssd_scan_bwd_plain(*(t(a) for a in (xdt, dta, b, c, dy)))
    for name, g64, g32, e, r32 in zip(("dxdt", "ddta", "db", "dc"), got64,
                                      got32, grads[torch.float64],
                                      grads[torch.float32]):
        _close_rel(g64.numpy(), e, 1e-10, f"float64 {name}")
        _no_less_exact(g32.numpy(), r32, e, f"float32 {name}")


def test_ssd_backward_steep_decays_and_chunk_one():
    """Autograd through the port's ssd_chunked against jax.vjp at decays
    steep enough that exp(dta) underflows (A = −50 per head index) and
    at a chunk of 1, where the reference's dual form is the plain
    recurrence: every gradient by the float64 rule."""
    x, dt, a_log, b, c, dy = _ssd_inputs(23, S=30)
    a_log = (a_log + np.log(50.0)).astype(np.float32)
    for chunk in (1, 16):
        _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk=chunk)[0],
                         x, dt, a_log, b, c)
        ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
        exact = _ssd_truth(x, dt, a_log, b, c, dy, chunk)
        ins = [t(a).requires_grad_(True) for a in (x, dt, a_log, b, c)]
        tssm.ssd_chunked(*ins, chunk=chunk)[0].backward(t(dy))
        for name, g, r, e in zip(SSD_NAMES, ins, ref, exact):
            _no_less_exact(g.grad.numpy(), r, e, f"chunk {chunk} d{name}")


def _loss_case():
    """One reduced-Hymba node (3 layers, GQA 4:2, layer 1 windowed at 16
    so that S = 40 + 8 meta tokens crosses it), its batch, and the
    reference's loss and gradients."""
    jcfg = hymba_small("jax").replace(sliding_window=16)
    tcfg = hymba_small("torch").replace(sliding_window=16)
    one = DecoderModel(tcfg).init(3, "cpu")
    rng = np.random.default_rng(24)
    seq = rng.integers(0, tcfg.vocab_size, size=(3, 41))
    mask = (rng.random(size=(3, 40)) > 0.2).astype(np.float32)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:], "loss_mask": mask}
    jm = j_build(jcfg)
    jp = jax.tree.map(jnp.asarray, to_jax_lm_params(one))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # XLA's optimization passes take most of the reference's compile time
    # on the CPU and change no result here beyond f32 rounding
    fast = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        ref_loss, ref_grads = jax.value_and_grad(
            lambda p: jm.loss(p, jb)[0])(jp)
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)
    return tcfg, one, batch, float(ref_loss), leaves(
        jax.tree.map(np.asarray, ref_grads))


@pytest.fixture(scope="module")
def loss_case():
    return _loss_case()


def _port_loss_and_grads(tcfg, one, batch):
    model = DecoderModel(tcfg)
    keys = list(one)
    ps = [one[k][None].clone().requires_grad_(True) for k in keys]
    tb = {k: t(v)[None] for k, v in batch.items()}
    loss, metrics = model.loss(dict(zip(keys, ps)), tb)
    assert loss.shape == (1,) and torch.equal(metrics["nll"], loss)
    grads = torch.autograd.grad(loss.sum(), ps)
    return float(loss.detach()), {k: g[0] for k, g in zip(keys, grads)}


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_loss_and_grads_match_reference(loss_case, remat):
    """DecoderModel.loss (masked next-token NLL) and its gradient on every
    leaf against the reference's loss and jax.grad, with the per-layer
    recompute (``cfg.remat``, policy "nothing") off and on."""
    tcfg, one, batch, ref_loss, ref_grads = loss_case
    loss, grads = _port_loss_and_grads(tcfg.replace(remat=remat), one,
                                       batch)
    assert loss == pytest.approx(ref_loss, abs=LOSS_TOL)
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        assert float(g.abs().max()) > 0, k
        _close_rel(g.numpy(), ref_grads[k], GRAD_TOL, k)


def test_remat_on_and_off_give_the_same_gradients(loss_case):
    """Recomputing each layer in the backward pass changes no gradient:
    the recomputed forward is the same arithmetic."""
    tcfg, one, batch, _, _ = loss_case
    _, off = _port_loss_and_grads(tcfg.replace(remat=False), one, batch)
    _, on = _port_loss_and_grads(
        tcfg.replace(remat=True, remat_policy="nothing"), one, batch)
    for k in off:
        torch.testing.assert_close(on[k], off[k], atol=1e-7, rtol=1e-6)


def test_remat_dots_policy_is_not_ported(loss_case):
    """The "dots" policy, which once raised here, now runs: on the
    reduced Hymba its loss and gradients are per-layer recompute's, and
    an unknown policy still raises with the valid choices
    (``tests/test_torch_remat.py`` holds "dots" to the reference)."""
    tcfg, one, batch, _, _ = loss_case
    loss, dots = _port_loss_and_grads(
        tcfg.replace(remat=True, remat_policy="dots"), one, batch)
    ref, full = _port_loss_and_grads(
        tcfg.replace(remat=True, remat_policy="nothing"), one, batch)
    assert loss == ref
    for k in full:
        torch.testing.assert_close(dots[k], full[k], atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(tcfg.replace(remat=True, remat_policy="bogus"),
                             one, batch)


def test_inference_kernels_refuse_grad():
    """head_select and msp_select have no backward: called with grad
    enabled on an input that requires grad they raise, before any device
    dispatch, instead of cutting the graph; under no_grad they run."""
    from repro_torch.kernels.head_select import head_select
    from repro_torch.kernels.msp_select import msp_select
    h = torch.randn((1, 5, 8), requires_grad=True)
    w = torch.randn((1, 8, 12))
    with pytest.raises(RuntimeError, match="inference-only"):
        head_select(h, w, None, k=2)
    with pytest.raises(RuntimeError, match="inference-only"):
        head_select(h.detach(), w.requires_grad_(True), None, k=2)
    with pytest.raises(RuntimeError, match="inference-only"):
        msp_select(torch.randn((5, 12), requires_grad=True), k=2)
    with torch.no_grad():
        conf, vals, idx = head_select(h, w, None, k=2)
        assert conf.shape == (1, 5) and not conf.requires_grad
        assert msp_select(h[0], k=2)[0].shape == (5,)


def test_sparse_kd_loss_on_bf16_logits_matches_reference():
    """distill.sparse_kd_loss on (B, S, V) bf16 logits with (B, S, k)
    labels (the LM KD step's shapes) against the reference's: both upcast
    the same bf16 values to f32, so within 1e-5 of the T²-scaled loss."""
    from repro.core import distill as jdistill
    from repro_torch.core import distill as tdistill
    rng = np.random.default_rng(26)
    logits = (3 * rng.normal(size=(2, 7, 512))).astype(np.float32)
    vals = rng.dirichlet(np.ones(24), size=(2, 7)).astype(np.float32)
    idx = rng.integers(0, 512, size=(2, 7, 24)).astype(np.int32)
    ref = jdistill.sparse_kd_loss(
        jnp.asarray(logits, jnp.bfloat16),
        jdistill.SparseLabels(jnp.asarray(vals), jnp.asarray(idx)), 10.0)
    got = tdistill.sparse_kd_loss(
        t(logits).to(torch.bfloat16),
        tdistill.SparseLabels(t(vals), t(idx)), 10.0)
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("chunk,slices", [(64, 3), (1 << 26, 1)])
def test_qg_dsgdm_n_on_bf16_leaves_matches_reference(monkeypatch, chunk,
                                                     slices):
    """QG-DSGDm-N with the dense mixer on bf16 node-stacked leaves and
    bf16 momentum (the reference's tree_zeros_like keeps the params'
    dtype), as the LM path runs it: in place, with the leaves whole and
    cut into slices (CHUNK shrunk to 64 elements so that they are). New
    params within one bf16 ulp of the reference's (plus 2^-24 of the max
    |param| where the reference's value is 0); momentum within one bf16
    ulp of itself plus (1 − β)/η times one ulp of the params: it is the
    EMA of (x − y)/η, whose ends are bf16 params, so one ulp of y moves
    it by that much."""
    from repro.core.algorithms import make_algorithm as j_algo
    from repro.core.mixing import make_mixer as j_mixer
    from repro.core.topology import Topology as JTopology
    from repro_torch.core import algorithms as talgos
    from repro_torch.core.mixing import make_mixer as t_mixer
    from repro_torch.core.topology import Topology as TTopology
    monkeypatch.setattr(talgos, "CHUNK", chunk)
    rng = np.random.default_rng(27)
    shapes = {"embed": (4, 40, 8), "layers_0/w": (4, 3, 8, 12),
              "ln_f/scale": (4, 8)}
    p, g, m = ({k: (s * rng.normal(size=v)).astype(np.float32)
                for k, v in shapes.items()} for s in (0.5, 1e-2, 1e-3))
    lr, beta = 0.1, 0.9
    ja = j_algo("qg-dsgdm-n", momentum=beta)
    ta = talgos.make_algorithm("qg-dsgdm-n", momentum=beta)
    assert len(talgos.leaf_slices(
        torch.zeros(shapes["layers_0/w"]))) == slices

    def bf(x):
        return {k: jnp.asarray(v, jnp.bfloat16) for k, v in x.items()}

    def ulp(x):
        return 2.0 ** (np.floor(np.log2(np.abs(x) + 1e-30)) - 7)

    jp, js = ja.step(bf(p), bf(g), {"m": bf(m)}, lr,
                     j_mixer(JTopology.make("ring", 4)))
    tb = {k: {n: t(v).to(torch.bfloat16) for n, v in x.items()}
          for k, x in (("p", p), ("g", g), ("m", m))}
    tp, ts = ta.step(tb["p"], tb["g"], {"m": tb["m"]}, lr,
                     t_mixer(TTopology.make("ring", 4), device="cpu"))
    for k in shapes:
        assert tp[k].dtype == ts["m"][k].dtype == torch.bfloat16
        assert tp[k].data_ptr() == tb["p"][k].data_ptr()
        rp = np.asarray(jp[k].astype(jnp.float32))
        rm = np.asarray(js["m"][k].astype(jnp.float32))
        dp = np.abs(tp[k].float().numpy() - rp)
        dm = np.abs(ts["m"][k].float().numpy() - rm)
        assert (dp <= ulp(rp) + 2.0 ** -24 * np.abs(rp).max()).all(), k
        assert (dm <= ulp(rm) + (1 - beta) / lr * ulp(rp)).all(), k
