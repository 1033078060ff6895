"""PaliGemma-3B against the reference on the CPU: its config, the
attention plain versions' prefix-LM mask (against the reference's
``chunked_attention`` and ``jax.vjp`` of it; the Pallas kernel has no
prefix mode, so it is the oracle at head_dim 256 without a prefix only),
the reduced model's forward features, forward, loss and gradients with
the patch prefix at the reduced config's ``prefix_lm_prefix`` (256: past
every reduced sequence, so bidirectional everywhere) and at 8 (exactly
the 8 patches, so both mask regions exist), one 4-node
``make_train_step`` step and ``make_prefill_step``'s logits, and the
refusals where the reference has no path (a VLM batch without patches;
``run_training`` and the LM round).

Inputs are made from numpy seeds; weights by the port's ``init``,
perturbed so that zero biases and unit scales matter, and carried to the
reference with ``convert.to_jax_lm_params``. Tolerances are
``test_torch_musicgen.py``'s: the attention forward 2e-5 in f32 (the
reference's kernel tolerance) and 2e-2 in bf16 (one bf16 ulp of the
output), its backward 1e-5 in f32 and 2^-7 of each gradient's max |value|
with bf16 inputs; logits 5e-5 and losses 1e-5 (f32, 2 layers), gradients
2e-4 of each leaf's max |grad| (sums reordered); one step's params 1e-5
and momentum 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import ShapeConfig
from repro.configs.base import TrainConfig as JTrain
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.launch.input_specs import train_specs
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import attention as jattn
from repro.models import build_model as j_build
import repro_torch.configs as tconfigs
from repro_torch import lmpath
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core.topology import Topology as TTopology
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models.convert import to_jax_lm_params
from repro_torch.models.transformer import DecoderModel

from test_torch_common import leaves, t
from test_torch_dense import _no_opt, _perturbed

torch.set_num_threads(1)

ARCH = "paligemma-3b"
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_GRAD_TOL, BF16_GRAD_TOL = 1e-5, 2.0 ** -7
FWD_ATOL, LOSS_TOL, GRAD_TOL = 5e-5, 1e-5, 2e-4
STEP_PARAM_ATOL, STEP_MOM_ATOL = 1e-5, 1e-4
N_NODES = 4


def _small(side, prefix=None):
    cfg = (jconfigs if side == "jax" else tconfigs).get_config(ARCH).reduced()
    return cfg if prefix is None else cfg.replace(prefix_lm_prefix=prefix)


def _attn(seed, B, S, H, KVH, D):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _lse(q, k, prefix_len):
    """The rows' log-sum-exp of the scaled scores under the prefix-LM
    mask."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float(
    ).repeat_interleave(q.shape[2] // k.shape[2], 2)) / q.shape[-1] ** 0.5
    pos = torch.arange(S)
    allow = (pos[None, :] <= pos[:, None]) | (
        (pos[:, None] < prefix_len) & (pos[None, :] < prefix_len))
    return torch.logsumexp(s.masked_fill(~allow, -1e30), -1)


# ------------------------------------------------------------------ config
def test_paligemma_config_matches_reference():
    """The config and its reduced() field for field as the reference's:
    18 layers × 2048, 8/1 heads × 256, GeGLU 16,384, tied embeddings over
    257,216 tokens, 256 patches under a 256-position prefix; reduced()
    cuts the patches to 8 and keeps the prefix at 256, in both
    packages."""
    tcfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert (tcfg.num_layers, tcfg.d_model, tcfg.num_heads,
            tcfg.num_kv_heads, tcfg.resolved_head_dim, tcfg.d_ff,
            tcfg.vocab_size, tcfg.mlp_type, tcfg.tie_embeddings,
            tcfg.num_prefix_tokens, tcfg.prefix_lm_prefix) == \
        (18, 2048, 8, 1, 256, 16384, 257_216, "geglu", True, 256, 256)
    small = tcfg.reduced()
    assert (small.num_prefix_tokens, small.prefix_lm_prefix,
            small.resolved_head_dim, small.num_kv_heads) == (8, 256, 64, 1)


# ------------------------------------------------------ prefix-LM flash
@pytest.mark.parametrize("S,P,chunk,H,KVH,D", [
    (24, 8, 8, 4, 1, 64),        # PaliGemma's reduced layout
    (100, 37, 32, 8, 1, 256),    # MQA at head_dim 256, P ends mid-chunk
    (40, 64, 16, 2, 2, 32)])     # P >= S: every key for every row
def test_prefix_plain_matches_chunked_attention(S, P, chunk, H, KVH, D):
    """flash_attention_plain(prefix_len=P) against the reference's
    chunked_attention(prefix_len=P) on the same inputs (bf16-exact values
    in f32), in f32 and on the same values in bf16 (the output rounded
    to bf16)."""
    q, k, v, _ = _attn(S + P, 2, S, H, KVH, D)
    xs = [t(x).to(torch.bfloat16) for x in (q, k, v)]
    ref = np.asarray(_no_opt(lambda: jattn.chunked_attention(
        *(jnp.asarray(x.float().numpy()) for x in xs), causal=True,
        prefix_len=P, chunk=chunk)))
    for dt in (torch.float32, torch.bfloat16):
        out = flash_attention_plain(*(x.to(dt) for x in xs), prefix_len=P,
                                    chunk=chunk)
        assert out.dtype == dt and out.shape == xs[0].shape
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   atol=FLASH_ATOL[str(dt)[6:]])


def test_causal_plain_matches_pallas_kernel_at_head_dim_256():
    """Without a prefix, the plain version at head_dim 256 against the
    Pallas kernel (causal, interpret mode), MQA 4/1."""
    q, k, v, _ = _attn(5, 1, 128, 4, 1, 256)
    ref = j_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                  block_q=64, block_k=64, interpret=True)
    out = flash_attention_plain(t(q), t(k), t(v), chunk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=FLASH_ATOL["float32"])


@pytest.mark.parametrize("S,P,H,KVH,D", [(40, 64, 4, 2, 16),
                                         (48, 20, 8, 1, 256)])
def test_prefix_plain_bwd_matches_vjp(S, P, H, KVH, D):
    """flash_attention_bwd_plain(prefix_len=P) against jax.vjp of the
    reference's chunked_attention(prefix_len=P), in f32 and, on bf16
    inputs, with both operand modes (operands="bf16" rounds P and dS as
    the tensor-core kernel does); and autograd of flash_attention_plain
    against flash_attention_bwd_plain."""
    q, k, v, do = (t(x) for x in _attn(S * P, 2, S, H, KVH, D))

    @jax.jit
    def vjp(a, b, c, g):
        o, back = jax.vjp(lambda a, b, c: jattn.chunked_attention(
            a, b, c, causal=True, prefix_len=P, chunk=32), a, b, c)
        return o, back(g)

    def reference(xs):
        o, grads = _no_opt(lambda: vjp(*(jnp.asarray(x) for x in xs)))
        return np.asarray(o), [np.asarray(g) for g in grads]
    ref_o, ref = reference([x.numpy() for x in (q, k, v, do)])
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = flash_attention_plain(qr, kr, vr, prefix_len=P, chunk=32)
    np.testing.assert_allclose(o.detach().numpy(), ref_o,
                               atol=FLASH_ATOL["float32"])
    o.backward(do)
    got = flash_attention_bwd_plain(q, k, v, o.detach(), _lse(q, k, P), do,
                                    prefix_len=P, chunk=16)
    for name, g, r, auto in zip("qkv", got, ref, (qr, kr, vr)):
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(auto.grad.numpy(), g.numpy(),
                                   atol=ATTN_GRAD_TOL, err_msg=name)
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    _, ref = reference([x.float().numpy() for x in (qb, kb, vb, dob)])
    ob = flash_attention_plain(qb, kb, vb, prefix_len=P)
    for operands in ("f32", "bf16"):
        got = flash_attention_bwd_plain(qb, kb, vb, ob, _lse(qb, kb, P), dob,
                                        prefix_len=P, operands=operands)
        for name, g, r in zip("qkv", got, ref):
            assert g.dtype == torch.bfloat16
            err = float(np.abs(g.float().numpy() - r).max())
            assert err <= BF16_GRAD_TOL * float(np.abs(r).max()), \
                (operands, name, err)


# ------------------------------------------------------ the reduced model
def _batch(seed, n, B, S, cfg):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, size=(n, B, S + 1))
    patches = rng.normal(size=(n, B, cfg.num_prefix_tokens, cfg.d_model)
                         ).astype(np.float32)
    return {"tokens": seq[:, :, :-1], "labels": seq[:, :, 1:],
            "patch_embeddings": patches}


@pytest.mark.parametrize("prefix", [None, 8])
def test_reduced_paligemma_forward_loss_and_grads_match_reference(prefix):
    """Node-stacked forward features (the patches stripped) and logits of
    two different nodes, through make_prefill_step too, and one node's
    masked loss with its gradient on every leaf, against the reference's
    forward_features, forward, loss and jax.grad, at the reduced
    prefix_lm_prefix (256, past the sequence) and at 8 (the patches
    alone); at 8 the logits differ from the causal model's."""
    cfg, jcfg = _small("torch", prefix), _small("jax", prefix)
    model, jm = DecoderModel(cfg), j_build(jcfg)
    a, b = _perturbed(model, 1), _perturbed(model, 2)
    params = {k: torch.stack([a[k], b[k]]) for k in a}
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    S = 16
    bt = _batch(3, 2, 3, S, cfg)
    inputs = {k: v for k, v in bt.items() if k != "labels"}
    mask = (np.random.default_rng(5).random(size=(2, 3, S)) > 0.2
            ).astype(np.float32)

    def reference():
        fwd = jax.jit(jax.vmap(lambda p, x, e: (
            jm.forward_features(p, {"tokens": x, "patch_embeddings": e})[0],
            jm.forward(p, {"tokens": x, "patch_embeddings": e})[0])))
        one = jax.tree.map(lambda x: x[0], jparams)
        jb = {"tokens": jnp.asarray(bt["tokens"][0]),
              "labels": jnp.asarray(bt["labels"][0]),
              "patch_embeddings": jnp.asarray(bt["patch_embeddings"][0]),
              "loss_mask": jnp.asarray(mask[0])}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb)[0]))(one)
        h, logits = fwd(jparams, jnp.asarray(bt["tokens"]),
                        jnp.asarray(bt["patch_embeddings"]))
        return (np.asarray(h), np.asarray(logits), float(loss),
                leaves(jax.tree.map(np.asarray, grads)))
    ref_h, ref_logits, ref_loss, ref_grads = _no_opt(reference)

    tb = {k: t(v) for k, v in inputs.items()}
    h, _ = model.forward_features(params, tb)
    assert h.shape == (2, 3, S, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), ref_h, atol=FWD_ATOL)
    logits = make_prefill_step(model)(params, tb)
    assert logits.shape == (2, 3, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=FWD_ATOL)
    if prefix:
        causal, _ = DecoderModel(cfg.replace(prefix_lm_prefix=0)).forward(
            params, tb)
        assert float((causal - logits).abs().max()) > 1e-3
    keys = list(a)
    ps = [a[k][None].clone().requires_grad_(True) for k in keys]
    loss, _ = model.loss(dict(zip(keys, ps)),
                         {k: t(v[:1]) for k, v in bt.items()}
                         | {"loss_mask": t(mask[:1])})
    assert float(loss.detach()) == pytest.approx(ref_loss, abs=LOSS_TOL)
    grads = torch.autograd.grad(loss.sum(), ps)
    assert set(keys) == set(ref_grads)
    for k, g in zip(keys, grads):
        scale = float(np.abs(ref_grads[k]).max())
        assert scale > 0, k
        assert float((g[0] - t(ref_grads[k])).abs().max()) <= \
            GRAD_TOL * scale, k


@pytest.mark.parametrize("prefix", [None, 8])
def test_paligemma_train_step_matches_reference(prefix):
    """One make_train_step step (QG-DSGDm-N on a ring of 4, the LM loss,
    the patch embeddings riding along to model.loss) from the same
    params, zero momentum and batch, as tests/test_models_smoke.py runs
    the reference's: the loss, and params and momentum after the step."""
    cfg, jcfg = _small("torch", prefix), _small("jax", prefix)
    model, jm = DecoderModel(cfg), j_build(jcfg)
    nodes = [_perturbed(model, 10 + i) for i in range(N_NODES)]
    params = {k: torch.stack([p[k] for p in nodes]) for k in nodes[0]}
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    tcfg = dict(num_nodes=N_NODES, lr=0.05, batch_size=2)
    batch = _batch(8, N_NODES, 2, 12, cfg)
    jstep = j_make_train_step(jm, JTrain(**tcfg), N_NODES)
    ref = _no_opt(lambda: jax.jit(jstep)(
        jparams, jstep.init_opt(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, 0.05))
    step = make_train_step(model, TTrain(**tcfg), N_NODES, device="cpu")
    params = {k: v.clone() for k, v in params.items()}   # updated in place
    new_p, new_o, metrics = step(params, step.init_opt(params),
                                 {k: t(v) for k, v in batch.items()}, 0.05)
    assert float(metrics["loss"]) == pytest.approx(float(ref[2]["loss"]),
                                                   rel=LOSS_TOL)
    for k, v in leaves(jax.tree.map(np.asarray, ref[0])).items():
        np.testing.assert_allclose(new_p[k].numpy(), v,
                                   atol=STEP_PARAM_ATOL, err_msg=k)
    for k, v in leaves(jax.tree.map(np.asarray, ref[1]["m"])).items():
        np.testing.assert_allclose(new_o["m"][k].numpy(), v,
                                   atol=STEP_MOM_ATOL, err_msg=k)


# ----------------------------------------------------- lmpath and refusals
def test_train_steps_on_train_specs_layout():
    """lmpath.train_batch's batches have train_specs' shapes and dtypes
    (tokens and labels (n, B, S), patch_embeddings (n, B, P, d) in the
    config's dtype); one lmpath.train_steps step on the CPU gives a
    finite loss, moves the params and launches no kernel."""
    cfg, jcfg = _small("torch"), _small("jax")
    tcfg = dataclasses.replace(lmpath.PALIGEMMA_TRAIN, num_nodes=2)
    batch = lmpath.train_batch(cfg, 2, tcfg.batch_size, 12,
                               torch.Generator().manual_seed(0))
    specs = train_specs(jcfg, ShapeConfig("t", 12, 2 * tcfg.batch_size,
                                          "train"), 2)
    assert set(batch) == set(specs)
    for k, spec in specs.items():
        assert tuple(batch[k].shape) == spec.shape, k
        assert batch[k].is_floating_point() == \
            jnp.issubdtype(spec.dtype, jnp.floating), k
    assert batch["patch_embeddings"].dtype == torch.float32
    full = lmpath.train_batch(tconfigs.get_config(ARCH), 1, 1, 4,
                              torch.Generator().manual_seed(0))
    assert full["patch_embeddings"].shape == (1, 1, 256, 2048)
    assert full["patch_embeddings"].dtype == torch.bfloat16
    out = lmpath.train_steps(cfg.replace(num_layers=1), tcfg, seq_len=12,
                             steps=1, device="cpu")
    assert len(out["steps"]) == 1 and out["peak_gib"] is None
    assert np.isfinite(out["steps"][0]["loss"])
    assert 0 < out["moved"] <= out["pairs"]
    assert all(n == 0 for modes in out["steps"][0]["launches"].values()
               for by in modes.values() for n in by.values())


def test_vlm_refusals():
    """A VLM batch without patch_embeddings raises KeyError naming the key
    (the reference's KeyError); run_training and the LM round refuse
    PaliGemma, for which the reference has no data or round path, before
    doing any work."""
    cfg = _small("torch")
    model = DecoderModel(cfg)
    params = {k: v[None] for k, v in model.init(0, "cpu").items()}
    with pytest.raises(KeyError, match="patch_embeddings"):
        model.forward(params, {"tokens": torch.zeros((1, 2, 5),
                                                     dtype=torch.long)})
    with pytest.raises(ValueError, match="VLM"):
        ttrain.run_training(tconfigs.get_config(ARCH),
                            TTrain(num_nodes=2, steps=1), device="cpu")
    with pytest.raises(ValueError, match="VLM"):
        ttrain.idkd_label_round(model, params, np.zeros((2, 8), np.int64),
                                np.zeros((1, 2, 8), np.int64), TIDKD(),
                                TTopology.make("ring", 1))
