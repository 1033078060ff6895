"""The MoE family (DeepSeek-V3, Arctic) against the reference on the CPU:
the configs and registry, ``moe_forward`` (the sigmoid router with its
f32 bias and a shared expert, the softmax router with the dense
residual, one and four dispatch groups, forced capacity drops), MLA's
``mla_forward``, flash_attention's MLA mode (qk head dim 48, v head dim
32: ``reduced()``'s) in the plain forward and backward, the decoder's
forward, loss (multi-token prediction and the aux loss) and gradients
for both archs, the convert round trip, one 2-node ``make_train_step``
step and one ``idkd_label_round`` on a reduced DeepSeek-V3.

Weights are made by the port's ``init``, perturbed from numpy seeds so
that unit norm scales and the zero router bias matter, and carried to
the reference with ``convert.to_jax_lm_params``. Tolerances (f32): MoE
and MLA outputs 2e-5 with routing ids equal; the attention forward 2e-5,
its backward 1e-5, and 2^-7 of each gradient's max |value| on bf16
inputs (the repo's own kernel tolerances); logits 5e-5, losses 1e-5,
gradients 2e-4 of each leaf's max |grad| (sums reordered); one step's
params 1e-5 and momentum 1e-4; the round as ``test_torch_lm_round.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import IDKDConfig as JIDKD
from repro.configs.base import TrainConfig as JTrain
from repro.core.topology import Topology as JTopology
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import idkd_label_round as j_round
from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch import lmpath
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import from_jax_lm_params, to_jax_lm_params
from repro_torch.models.layers import sub
from repro_torch.models.transformer import DecoderModel

from test_torch_common import leaves, t
from test_torch_lm_round import THRESH_ATOL, assert_labels_close

torch.set_num_threads(1)

ARCHS = ["deepseek-v3-671b", "arctic-480b"]
MOE_ATOL, FLASH_ATOL, ATTN_GRAD_TOL, BF16_GRAD_TOL = 2e-5, 2e-5, 1e-5, 2 ** -7
FWD_ATOL, LOSS_TOL, GRAD_TOL = 5e-5, 1e-5, 2e-4
STEP_PARAM_ATOL, STEP_MOM_ATOL = 1e-5, 1e-4


def _cfgs(arch, **moe):
    """The reduced config on both sides, the MoE fields in ``moe``
    replaced."""
    out = []
    for get in (tconfigs.get_config, jconfigs.get_config):
        cfg = get(arch).reduced()
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _perturbed(model, seed):
    """One node's params from the port's init, each leaf moved by numpy
    noise of 0.05 (norm scales off one, the router bias off zero)."""
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor(0.05 * rng.normal(size=v.shape),
                                   dtype=v.dtype)
            for k, v in model.init(seed, "cpu").items()}


def _no_opt(fn):
    """fn() with XLA's optimization passes off (compile time; results
    move by f32 rounding only)."""
    fast = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)


def _tree(params):
    return jax.tree.map(jnp.asarray, to_jax_lm_params(params))


# ------------------------------------------------------------------ configs
def test_moe_configs_and_registry_match_reference():
    """Both archs field for field, the registry in the reference's order,
    and what each builds: DeepSeek-V3's dense layer then MoE layer, MLA
    leaves, f32 router bias and MTP leaves; Arctic's all-MoE stack with
    its dense residual."""
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jconfigs.get_config(arch))
        tcfg, jcfg = _cfgs(arch)
        model, jm = DecoderModel(tcfg), j_build(jcfg)
        assert [tuple(s) for s in model.segments] == \
            [tuple(s) for s in jm.segments]
        p = model.init(0, "cpu")
        jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        want = {"/".join(q.key for q in path): (leaf.shape, leaf.dtype.name)
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(jshapes)[0]}
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in p.items()} == want
    full = tconfigs.get_config("deepseek-v3-671b")
    assert (full.mla.qk_nope_head_dim + full.mla.qk_rope_head_dim,
            full.mla.v_head_dim) == (192, 128)


# ---------------------------------------------------------------------- MoE
MOE_CASES = {
    "sigmoid-shared": ("deepseek-v3-671b", {}),
    "sigmoid-G4-drops": ("deepseek-v3-671b",
                         {"dispatch_groups": 4, "capacity_factor": 0.3}),
    "softmax-residual": ("arctic-480b", {}),
    "softmax-G4-drops": ("arctic-480b",
                         {"dispatch_groups": 4, "capacity_factor": 0.3}),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case):
    """One MoE layer on the same tokens: the routing ids equal, the
    output within 2e-5 and the aux loss within 1e-6; under forced drops
    some assignments really are dropped."""
    arch, kw = MOE_CASES[case]
    tcfg, jcfg = _cfgs(arch, **kw)
    model = DecoderModel(tcfg)
    si = len(model.segments) - 1
    p = {k[len(f"layers_{si}/moe/"):]: v[0] for k, v in
         _perturbed(model, 3).items() if k.startswith(f"layers_{si}/moe/")}
    jp = _tree(p)
    x = np.random.default_rng(4).normal(size=(4, 16, tcfg.d_model))
    x = x.astype(np.float32)
    ref_ids = np.asarray(jmoe._route(jp, jnp.asarray(x.reshape(64, -1)),
                                     jcfg)[0])
    ref, ref_aux = jax.jit(lambda a, b: jmoe.moe_forward(a, b, jcfg))(
        jp, jnp.asarray(x))
    ids, _, _ = tmoe.route(p, t(x).reshape(64, -1), tcfg)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    out, aux = tmoe.moe_forward(p, t(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MOE_ATOL)
    assert float(aux) == pytest.approx(float(ref_aux), abs=1e-6)
    G, cap = tmoe.capacity(tcfg, 64)
    assert G == max(1, tcfg.moe.dispatch_groups)
    dest = torch.cat([tmoe.dispatch_slots(g, tcfg.moe.num_experts, cap)
                      for g in ids.reshape(G, 64 // G, -1)])
    dropped = int((dest == tcfg.moe.num_experts * cap).sum())
    assert (dropped > 0) == ("drops" in case)


# ---------------------------------------------------------------------- MLA
def test_mla_forward_matches_reference():
    """MLA (q_lora, kv_lora, nope + rope, v head dim apart) on the same
    inputs, through the flash plain version's MLA mode."""
    tcfg, jcfg = _cfgs("deepseek-v3-671b")
    p = {k[len("layers_0/attn/"):]: v[0] for k, v in
         _perturbed(DecoderModel(tcfg), 5).items()
         if k.startswith("layers_0/attn/")}
    x = np.random.default_rng(6).normal(size=(2, 40, tcfg.d_model))
    x = x.astype(np.float32)
    ref = jax.jit(lambda a, b: jattn.mla_forward(a, b, jcfg))(
        _tree(p), jnp.asarray(x))
    out = tattn.mla_forward(p, t(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MOE_ATOL)


def _lse(q, k):
    H, D, S = q.shape[2], q.shape[3], q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(H // k.shape[2], 2))
    pos = torch.arange(S)
    allow = pos[None, :] <= pos[:, None]
    return torch.logsumexp((s / D ** 0.5).masked_fill(~allow, -1e30), -1)


def test_flash_plain_mla_mode_matches_jax():
    """The plain forward and backward with qk head dim 48 and v head dim
    32, a ragged S (75 over 32-key chunks) and GQA, against the
    reference's chunked_attention and jax.vjp of it: f32, and both
    operand modes of the backward on bf16 inputs."""
    rng = np.random.default_rng(7)
    q, k = (rng.normal(size=(2, 75, n, 48)).astype(np.float32)
            for n in (4, 2))
    v = rng.normal(size=(2, 75, 2, 32)).astype(np.float32)
    do = rng.normal(size=(2, 75, 4, 32)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv, tdo = (t(a).to(dtype) for a in (q, k, v, do))
        f32 = [x.float().numpy() for x in (tq, tk, tv, tdo)]
        ref_o, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
            a, b, c, causal=True, chunk=32), *f32[:3])
        ref = [np.asarray(g) for g in vjp(jnp.asarray(f32[3]))]
        o = flash_attention_plain(tq, tk, tv, chunk=32)
        assert o.dtype == dtype and o.shape == (2, 75, 4, 32)
        np.testing.assert_allclose(
            o.float().numpy(), np.asarray(ref_o),
            atol=FLASH_ATOL if dtype == torch.float32 else 2e-2)
        for operands in ("f32", "bf16"):
            got = flash_attention_bwd_plain(tq, tk, tv, o, _lse(tq, tk), tdo,
                                            chunk=32, operands=operands)
            for name, g, r, x in zip("qkv", got, ref, (tq, tk, tv)):
                assert g.dtype == dtype and g.shape == x.shape
                err = float(np.abs(g.float().numpy() - r).max())
                tol = ATTN_GRAD_TOL if dtype == torch.float32 and \
                    operands == "f32" else BF16_GRAD_TOL * np.abs(r).max()
                assert err <= tol, (dtype, operands, name, err)


# ------------------------------------------------------------------ decoder
@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_forward_loss_and_grads_match_reference(arch):
    """Node-stacked forward (two different nodes: logits and each node's
    aux) and one node's loss (next-token + MTP + router_aux_coef · aux)
    with its gradient on every leaf, against the reference's forward,
    loss and jax.grad; every leaf crosses convert both ways bit for
    bit (layers_0 / layers_1, the expert banks, the f32 router bias, the
    MLA and mtp leaves)."""
    tcfg, jcfg = _cfgs(arch)
    model, jm = DecoderModel(tcfg), j_build(jcfg)
    a, b = _perturbed(model, 1), _perturbed(model, 2)
    params = {k: torch.stack([a[k], b[k]]) for k in a}
    tree = to_jax_lm_params(params)
    back = from_jax_lm_params(tree, device="cpu")
    assert set(back) == set(params)
    assert all(torch.equal(back[k], v) and back[k].dtype == v.dtype
               for k, v in params.items())
    assert params[f"layers_{len(model.segments) - 1}/moe/router_bias"
                  ].dtype == torch.float32
    rng = np.random.default_rng(3)
    S = 24
    seq = rng.integers(0, tcfg.vocab_size, size=(2, 2, S + 1))
    jparams = jax.tree.map(jnp.asarray, tree)

    def reference():
        logits, aux = jax.jit(jax.vmap(lambda p, x: jm.forward(
            p, {"tokens": x})))(jparams, jnp.asarray(seq[..., :-1]))
        one = jax.tree.map(lambda x: x[0], jparams)
        jb = {"tokens": jnp.asarray(seq[0, :, :-1]),
              "labels": jnp.asarray(seq[0, :, 1:])}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb)[0]))(one)
        return (np.asarray(logits), np.asarray(aux), float(loss),
                leaves(jax.tree.map(np.asarray, grads)))
    ref_logits, ref_aux, ref_loss, ref_grads = _no_opt(reference)

    logits, aux = model.forward(params, {"tokens": t(seq[..., :-1])})
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=FWD_ATOL)
    np.testing.assert_allclose(aux.numpy(), ref_aux, atol=1e-6)
    keys = list(a)
    ps = [a[k][None].clone().requires_grad_(True) for k in keys]
    loss, metrics = model.loss(dict(zip(keys, ps)),
                               {"tokens": t(seq[:1, :, :-1]),
                                "labels": t(seq[:1, :, 1:])})
    assert float(loss.detach()) == pytest.approx(ref_loss, abs=LOSS_TOL)
    nll, aux = (float(metrics[k][0].detach()) for k in ("nll", "aux"))
    assert aux > 0.0 and float(loss.detach()) > nll + 0.5 * \
        tcfg.moe.router_aux_coef * aux
    grads = torch.autograd.grad(loss.sum(), ps, allow_unused=True,
                                materialize_grads=True)
    assert set(keys) == set(ref_grads)
    for k, g in zip(keys, grads):
        scale = float(np.abs(ref_grads[k]).max())
        if scale == 0.0:        # the router bias only ranks the experts
            assert k.endswith("router_bias") and not g.any(), k
            continue
        assert float((g[0] - t(ref_grads[k])).abs().max()) <= \
            GRAD_TOL * scale, k


# --------------------------------------- a step and a round on DeepSeek-V3
@pytest.fixture(scope="module")
def deepseek_small():
    """A reduced DeepSeek-V3 (a dense and an MoE layer, MLA 48/32, MTP) on
    2 ring nodes from seeds 0-1, data as lmpath makes it, and the same
    params on the reference's side."""
    icfg = TIDKD(label_topk=4, stream_microbatch=3, label_backend="sparse",
                 temperature=10.0)
    tcfg, jcfg = _cfgs("deepseek-v3-671b")
    r = lmpath.setup(tcfg, num_nodes=2, seq_len=24, n_private=32,
                     n_public=3, icfg=icfg, device="cpu")
    for k, v in r.params.items():          # scales and the bias off 1 and 0
        v += torch.as_tensor(0.05 * np.random.default_rng(5).normal(
            size=v.shape), dtype=v.dtype)
    return r, j_build(jcfg), _tree(r.params)


def test_deepseek_train_step_matches_reference(deepseek_small):
    """make_train_step (QG-DSGDm-N on the ring of 2, the loss with MTP and
    aux) from the same params, zero momentum and batch: the loss, and
    params and momentum after the step."""
    r, jm, jparams = deepseek_small
    tcfg = dict(num_nodes=2, lr=0.1, batch_size=2)
    seq = np.random.default_rng(8).integers(0, 512, size=(2, 2, 25))
    batch = {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
    jstep = j_make_train_step(jm, JTrain(**tcfg), 2)
    ref = _no_opt(lambda: jax.jit(jstep)(
        jparams, jstep.init_opt(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, 0.1))
    step = make_train_step(r.model, TTrain(**tcfg), 2, device="cpu")
    params = {k: v.clone() for k, v in r.params.items()}
    new_p, new_o, metrics = step(params, step.init_opt(params),
                                 {k: t(v) for k, v in batch.items()}, 0.1)
    assert float(metrics["loss"]) == pytest.approx(float(ref[2]["loss"]),
                                                   rel=LOSS_TOL)
    for k, v in leaves(jax.tree.map(np.asarray, ref[0])).items():
        np.testing.assert_allclose(new_p[k].numpy(), v,
                                   atol=STEP_PARAM_ATOL, err_msg=k)
    for k, v in leaves(jax.tree.map(np.asarray, ref[1]["m"])).items():
        np.testing.assert_allclose(new_o["m"][k].numpy(), v,
                                   atol=STEP_MOM_ATOL, err_msg=k)


def test_deepseek_label_round_matches_reference(deepseek_small):
    """The streaming round (MoE and MLA in forward_features, head_select's
    plain version on the untied head, one microbatch of 3) against the
    reference's idkd_label_round."""
    r, jm, jparams = deepseek_small
    ref = _no_opt(lambda: j_round(
        jm, jparams, r.public, r.private,
        JIDKD(**dataclasses.asdict(r.icfg)),
        JTopology.make("ring", 2), backend="sparse"))
    labels, w, mask, thr = r.run()
    np.testing.assert_allclose(thr.numpy(), np.asarray(ref[3]),
                               atol=THRESH_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref[1]))
    assert_labels_close(labels.values, labels.indices, ref[0].values,
                        ref[0].indices)


def test_node_params_fill_the_stack_as_init_makes_it():
    """lmpath.node_params writes model.pieces into the stack (an expert
    bank one expert at a time): the same values as init, node by node."""
    tcfg, _ = _cfgs("deepseek-v3-671b")
    model = DecoderModel(tcfg)
    stacked = lmpath.node_params(model, [3, 4], "cpu")
    for i, seed in enumerate((3, 4)):
        one = model.init(seed, "cpu")
        assert set(one) == set(stacked)
        assert all(torch.equal(stacked[k][i], v) for k, v in one.items())
    assert sub(stacked, "layers_1/moe/experts/")["wi"].shape == \
        (2, 1, tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.moe_d_ff)


def test_node_metrics_and_guard_default_to_the_card():
    """init_node_metrics and init_node_guard run on the card unless the
    caller asks for the CPU, as every other entry point does."""
    from repro_torch.obs.metrics import init_node_metrics
    from repro_torch.resil import init_node_guard
    for fn in (init_node_metrics, init_node_guard):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(3)
        out = fn(3, device="cpu")
        assert all(v.device.type == "cpu" for v in out.values())
