"""The "dots" remat policy (``remat_policy="dots"``) against the
reference's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``,
on the CPU: for a reduced dense model (Qwen3-1.7B), Hymba-1.5B and
DeepSeek-V3 (MoE + MLA), one node's loss and gradients under "dots"
equal those under "nothing" and "everything" and the reference's
``jax.value_and_grad`` under "dots"; and the (rows, cols) of the product
outputs one layer saves equal the residuals
``jax.ad_checkpoint.print_saved_residuals`` lists for the reference's
layer, less the layer's inputs (its params and x). Weights come from the
port's ``init`` (moved by numpy noise) and reach the reference through
``convert.to_jax_lm_params``.

The twin of ``examples/llm_idkd_train.py`` (the same ``run_training``
call at ``reduced()``, ROADMAP item 10d's satellite) runs 2 steps here
too.

Tolerances (f32): the port's policies run the same arithmetic, so their
losses and gradients agree to 1e-6 of each leaf's scale; against the
reference, losses to 2e-5 and each gradient to 2e-5 of its leaf's max
|grad| (sums in another order over two or three layers)."""
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import print_saved_residuals
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.convert import to_jax_lm_params
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import sub
from repro_torch.models.transformer import DecoderModel

from test_torch_common import leaves, t

torch.set_num_threads(1)

ARCHS = ["qwen3-1.7b", "hymba-1.5b", "deepseek-v3-671b"]
LOSS_TOL, GRAD_TOL, SAME_TOL = 2e-5, 2e-5, 1e-6
B, S = 2, 16


def _cfgs(arch):
    return (t_get_config(arch).reduced().replace(dtype="float32"),
            j_get_config(arch).reduced().replace(dtype="float32"))


def _one(model, seed):
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor(0.05 * rng.normal(size=v.shape),
                                   dtype=v.dtype)
            for k, v in model.init(seed, "cpu").items()}


def _port(cfg, one, batch, policy):
    model = DecoderModel(cfg.replace(remat=True, remat_policy=policy))
    keys = list(one)
    ps = [one[k][None].clone().requires_grad_(True) for k in keys]
    loss, _ = model.loss(dict(zip(keys, ps)),
                         {k: t(v)[None] for k, v in batch.items()})
    grads = torch.autograd.grad(loss.sum(), ps, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: g[0] for k, g in zip(keys, grads)}


def _reference(jcfg, one, batch):
    jm = j_build(jcfg.replace(remat=True, remat_policy="dots"))
    jp = jax.tree.map(jnp.asarray, to_jax_lm_params(one))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fast = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb)[0]))(jp)
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)
    return float(loss), leaves(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_loss_and_grads_match_other_policies_and_reference(arch):
    """One node's loss (DeepSeek-V3: next token + MTP + aux) and its
    gradient on every leaf under "dots", against "nothing",
    "everything" and the reference's value_and_grad under "dots"."""
    tcfg, jcfg = _cfgs(arch)
    one = _one(DecoderModel(tcfg), 5)
    rng = np.random.default_rng(7)
    seq = rng.integers(0, tcfg.vocab_size, size=(B, S + 1))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    got = {p: _port(tcfg, one, batch, p)
           for p in ("dots", "nothing", "everything")}
    ref_loss, ref_grads = _reference(jcfg, one, batch)
    loss, grads = got["dots"]
    assert loss == pytest.approx(ref_loss, abs=LOSS_TOL)
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        scale = max(float(np.abs(ref_grads[k]).max()), 1e-30)
        if k.endswith("router_bias"):      # it only ranks the experts
            assert not g.any() and not ref_grads[k].any(), k
            continue
        assert float((g - t(ref_grads[k])).abs().max()) <= \
            GRAD_TOL * scale, k
        for pol in ("nothing", "everything"):
            other = got[pol][1][k]
            assert float((g - other).abs().max()) <= SAME_TOL * scale, \
                (pol, k)
    for pol in ("nothing", "everything"):
        assert got[pol][0] == pytest.approx(loss, abs=SAME_TOL)


def _saved_shapes(monkeypatch, p, x, cfg, kind):
    """(rows, cols) of each product output one layer saves under "dots"
    (a forward and backward of the layer on ``x``), in call order: the
    model's own policy (``transformer.dots_policy``), wrapped to record
    what it marks MUST_SAVE outside the recompute. An ``aten.mm`` (a, w)
    or ``aten.addmm`` (bias, a, w) writes (rows of a, cols of w)."""
    from torch.utils.checkpoint import CheckpointPolicy
    tape, real = [], tfm.dots_policy

    def recording(p_, cfg_, memory=None):
        policy = real(p_, cfg_, memory)

        def record(ctx, op, *args, **kwargs):
            out = policy(ctx, op, *args, **kwargs)
            if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                tape.append((args[-2].shape[0], args[-1].shape[1]))
            return out
        return record
    monkeypatch.setattr(tfm, "dots_policy", recording)
    lp = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    y, aux = tfm._checkpointed("dots", lp, x, cfg, kind, 0, None)
    (y.float().sum() + aux).backward()
    return tape


def _reference_residuals(jcfg, one_layer, x, kind):
    """(rows, cols) of every residual the reference's layer saves under
    dots_with_no_batch_dims_saveable, its arguments left out."""
    lp = jax.tree.map(jnp.asarray, one_layer)

    def f(lp_, x_):
        y, aux = jtfm._layer_forward(lp_, x_, jcfg, kind, jnp.int32(0),
                                     None)
        return y.sum() + aux
    g = jax.checkpoint(
        f, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    buf = io.StringIO()
    with redirect_stdout(buf):
        print_saved_residuals(g, lp, jnp.asarray(x))
    out = []
    for line in buf.getvalue().splitlines():
        if "from the argument" in line or not line.strip():
            continue
        dims = [int(d) for d in line.split("[", 1)[1].split("]", 1)[0]
                .split(",")]
        out.append((int(np.prod(dims[:-1])), dims[-1]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saves_what_the_reference_saves(arch, monkeypatch):
    """One layer (the last segment's: DeepSeek-V3's MoE layer) of each
    arch: the product outputs the port's policy saves, in call order,
    equal the reference's saved residuals as a multiset — q, k, v and o
    (MLA's six projections), the SSM's in and out projections, the MLP's
    wg and wi, the router and the shared experts' wg and wi; not the
    FFN's wo, attention's per-head products or the expert bank's."""
    tcfg, jcfg = _cfgs(arch)
    model = DecoderModel(tcfg)
    one = _one(model, 3)
    si = len(model.segments) - 1
    lp = {k: v[0] for k, v in sub(one, f"layers_{si}/").items()}
    x = np.random.default_rng(4).normal(size=(B, S, tcfg.d_model)) \
        .astype(np.float32)
    got = _saved_shapes(monkeypatch, lp, t(x), tcfg,
                        model.segments[si].kind)
    jlayer = to_jax_lm_params(one)[f"layers_{si}"]
    jlayer = jax.tree.map(lambda a: np.asarray(a)[0], jlayer)
    ref = _reference_residuals(jcfg, jlayer, x, model.segments[si].kind)
    assert got and sorted(got) == sorted(ref), (got, ref)


def test_llm_idkd_train_twin_runs_two_steps(capsys):
    """``python -m repro_torch.llm_idkd_train --steps 2 --device cpu``: the
    round fires at step 1 and both evals are finite; the call is
    run_training's with the example's arguments."""
    from repro_torch import llm_idkd_train
    out = llm_idkd_train.main(["--steps", "2", "--device", "cpu"])
    hist = out["loss_history"]
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert out["last_round"] is not None
    assert "loss history" in capsys.readouterr().out
