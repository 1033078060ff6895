"""MusicGen-medium against the reference on the CPU: its config, the
attention plain versions' non-causal mode (cross-attention over a key set
of another length), the cross-attention block, the reduced model's
forward with and without conditioning, its loss and gradients, one
4-node ``make_train_step`` step, the leaves ``convert`` carries, the
refusals where the reference has no path (a single unembedding head, LM
data and rounds for multi-codebook tokens), and ``lmpath.train_steps``'
batches against ``launch.input_specs.train_specs``.

Inputs are made from numpy seeds; weights by the port's ``init``,
perturbed so that zero biases and unit scales matter, and carried to the
reference with ``convert.to_jax_lm_params``. Tolerances: the attention
forward 2e-5 in f32 (the reference's kernel tolerance), its backward
1e-5 in f32 and 2^-7 of each gradient's max |value| with bf16 operands
(``test_torch_bwd_passes.py``'s rules); the cross block 5e-5, logits 5e-5
and losses 1e-5 (f32, 2 layers), gradients 2e-4 of each leaf's max
|grad| (sums reordered); one step's params 1e-5 and momentum 1e-4 (as
``test_torch_dense.py``)."""
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
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models.convert import from_jax_lm_params, to_jax_lm_params
from repro_torch.models.transformer import DecoderModel

from test_torch_common import leaves, t
from test_torch_dense import _no_opt, _perturbed

torch.set_num_threads(1)

ARCH = "musicgen-medium"
FLASH_ATOL, ATTN_GRAD_TOL, BF16_GRAD_TOL = 2e-5, 1e-5, 2.0 ** -7
FWD_ATOL, LOSS_TOL, GRAD_TOL = 5e-5, 1e-5, 2e-4
STEP_PARAM_ATOL, STEP_MOM_ATOL = 1e-5, 1e-4
N_NODES = 4


def _small(side):
    return (jconfigs if side == "jax" else tconfigs).get_config(ARCH).reduced()


def _attn(seed, B, Sq, Sk, H, KVH, D):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, Sk, KVH, D)).astype(np.float32)
            for _ in range(2))
    return [t(x) for x in (q, k, v, do)]


def _lse(q, k):
    """The rows' log-sum-exp of the scaled scores over every key."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float(
    ).repeat_interleave(q.shape[2] // k.shape[2], 2))
    return torch.logsumexp(s / q.shape[-1] ** 0.5, -1)


# ------------------------------------------------------------------ config
def test_musicgen_config_matches_reference():
    """The config and its reduced() field for field as the reference's:
    48 layers × 1536, 24/24 heads, GELU + LayerNorm, 4 codebooks × 2048,
    cross-attention to 64 vectors; reduced: 2 layers, Sk 8."""
    tcfg, jcfg = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert (tcfg.num_layers, tcfg.d_model, tcfg.num_codebooks,
            tcfg.cross_attn_len) == (48, 1536, 4, 64)
    small = tcfg.reduced()
    assert (small.num_layers, small.num_codebooks, small.cross_attention,
            small.cross_attn_len) == (2, 4, True, 8)


# ------------------------------------------------------- non-causal flash
@pytest.mark.parametrize("Sq,Sk", [(128, 64), (64, 256)])
def test_cross_plain_matches_pallas_kernel(Sq, Sk):
    """flash_attention_plain(causal=False) against the Pallas kernel's
    causal=False in interpret mode (lengths multiples of its blocks),
    GQA 4/2, keys fewer and more than the queries."""
    q, k, v, _ = _attn(Sq + Sk, 1, Sq, Sk, 4, 2, 64)
    ref = j_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                  causal=False, block_q=64, block_k=64, interpret=True)
    out = flash_attention_plain(q, k, v, causal=False, chunk=32)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("Sk", [8, 72])
def test_cross_plain_fwd_and_bwd_match_chunked_attention(Sk):
    """At a ragged Sq (100) and Sk 8 or 72 (over 32-key chunks, the last
    ragged): the plain forward against the reference's
    chunked_attention(causal=False), and the plain backward against
    jax.vjp of it, in f32 and, on bf16 inputs, with both operand modes
    (operands="bf16" rounds P and dS as the tensor-core kernel does)."""
    chunk = min(32, Sk)
    q, k, v, do = _attn(3 + Sk, 2, 100, Sk, 4, 2, 16)

    def reference(xs):
        o, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
            a, b, c, causal=False, chunk=chunk),
            *(jnp.asarray(x) for x in xs[:3]))
        return np.asarray(o), [np.asarray(g) for g in vjp(
            jnp.asarray(xs[3]))]
    ref_o, ref = reference([x.numpy() for x in (q, k, v, do)])
    o = flash_attention_plain(q, k, v, causal=False, chunk=chunk)
    np.testing.assert_allclose(o.numpy(), ref_o, atol=FLASH_ATOL)
    got = flash_attention_bwd_plain(q, k, v, o, _lse(q, k), do,
                                    causal=False, chunk=32)
    for name, g, r in zip("qkv", got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_GRAD_TOL,
                                   err_msg=name)
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    ref_o, ref = reference([x.float().numpy() for x in (qb, kb, vb, dob)])
    ob = flash_attention_plain(qb, kb, vb, causal=False, chunk=chunk)
    for operands in ("f32", "bf16"):
        got = flash_attention_bwd_plain(qb, kb, vb, ob, _lse(qb, kb), dob,
                                        causal=False, chunk=32,
                                        operands=operands)
        for name, g, r in zip("qkv", got, ref):
            assert g.dtype == torch.bfloat16
            err = float(np.abs(g.float().numpy() - r).max())
            assert err <= BF16_GRAD_TOL * float(np.abs(r).max()), \
                (operands, name, err)


def test_chunked_attention_routes_cross_and_names_what_is_left():
    """The port's chunked_attention takes causal=False over another
    length, and the prefix-LM mask (ported with PaliGemma,
    tests/test_torch_paligemma.py) only beside causal attention;
    kv_valid_len (ported with the serving path) masks cross-attention's
    keys past it, and q_offset / kv_valid_len beside the prefix-LM mask
    raise."""
    q, k, v, _ = _attn(1, 1, 10, 6, 4, 2, 16)
    out = tattn.chunked_attention(q, k, v, causal=False, chunk=4)
    torch.testing.assert_close(out, flash_attention_plain(
        q, k, v, causal=False), atol=FLASH_ATOL, rtol=0)
    torch.testing.assert_close(
        tattn.chunked_attention(q, q, q, prefix_len=4),
        flash_attention_plain(q, q, q, prefix_len=4), atol=0, rtol=0)
    with pytest.raises(ValueError, match="prefix"):
        tattn.chunked_attention(q, k, v, causal=False, prefix_len=4)
    torch.testing.assert_close(
        tattn.chunked_attention(q, k, v, causal=False, chunk=4,
                                kv_valid_len=torch.tensor([4])),
        flash_attention_plain(q, k[:, :4], v[:, :4], causal=False),
        atol=FLASH_ATOL, rtol=0)
    for kw in (dict(q_offset=3), dict(kv_valid_len=torch.ones(1))):
        with pytest.raises(ValueError, match="prefix"):
            tattn.chunked_attention(q, q, q, prefix_len=4, **kw)


def test_cross_attention_forward_matches_reference():
    """The cross block (q from x, k and v from memory, no RoPE) on the
    same weights and inputs."""
    cfg, jcfg = _small("torch"), _small("jax")
    rng = np.random.default_rng(4)
    p = {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in tattn.init_cross_attention(
             torch.Generator().manual_seed(0), cfg, torch.float32).items()}
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, cfg.cross_attn_len, cfg.d_model)
                     ).astype(np.float32)
    ref = jattn.cross_attention_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(mem), jcfg)
    out = tattn.cross_attention_forward({k: t(v) for k, v in p.items()},
                                        t(x), t(mem), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL)


# ------------------------------------------------------ the reduced model
def _batch(seed, n, B, S, cfg):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, size=(n, B, S + 1,
                                                 cfg.num_codebooks))
    cond = rng.normal(size=(n, B, cfg.cross_attn_len, cfg.d_model)
                      ).astype(np.float32)
    return {"tokens": seq[:, :, :-1], "labels": seq[:, :, 1:],
            "conditioning": cond}


def test_reduced_musicgen_forward_loss_and_grads_match_reference():
    """Node-stacked forward of two different nodes, (n, B, S, K, V)
    logits, with conditioning and without it (the cross block skipped),
    and one node's masked loss over (B, S, K) with its gradient on every
    leaf, against the reference's forward, loss and jax.grad."""
    cfg, jcfg = _small("torch"), _small("jax")
    model, jm = DecoderModel(cfg), j_build(jcfg)
    a, b = _perturbed(model, 1), _perturbed(model, 2)
    params = {k: torch.stack([a[k], b[k]]) for k in a}
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    S = 24
    bt = _batch(3, 2, 3, S, cfg)
    mask = (np.random.default_rng(5).random(size=(2, 3, S)) > 0.2
            ).astype(np.float32)

    def reference():
        fwd = jax.jit(jax.vmap(lambda p, x, c: jm.forward(
            p, {"tokens": x, "conditioning": c})[0]))
        bare = jax.jit(jax.vmap(lambda p, x: jm.forward(
            p, {"tokens": x})[0]))
        one = jax.tree.map(lambda x: x[0], jparams)
        jb = {"tokens": jnp.asarray(bt["tokens"][0]),
              "labels": jnp.asarray(bt["labels"][0]),
              "conditioning": jnp.asarray(bt["conditioning"][0]),
              "loss_mask": jnp.asarray(mask[0])}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb)[0]))(one)
        return (np.asarray(fwd(jparams, jnp.asarray(bt["tokens"]),
                               jnp.asarray(bt["conditioning"]))),
                np.asarray(bare(jparams, jnp.asarray(bt["tokens"]))),
                float(loss), leaves(jax.tree.map(np.asarray, grads)))
    ref_logits, ref_bare, ref_loss, ref_grads = _no_opt(reference)

    logits, _ = model.forward(params, {k: t(v) for k, v in bt.items()
                                       if k != "labels"})
    assert logits.shape == (2, 3, S, 4, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=FWD_ATOL)
    bare, _ = model.forward(params, {"tokens": t(bt["tokens"])})
    np.testing.assert_allclose(bare.numpy(), ref_bare, atol=FWD_ATOL)
    assert float(np.abs(ref_bare - ref_logits).max()) > 1e-3
    keys = list(a)
    ps = [a[k][None].clone().requires_grad_(True) for k in keys]
    loss, _ = model.loss(dict(zip(keys, ps)),
                         {"tokens": t(bt["tokens"][:1]),
                          "labels": t(bt["labels"][:1]),
                          "conditioning": t(bt["conditioning"][:1]),
                          "loss_mask": t(mask[:1])})
    assert float(loss.detach()) == pytest.approx(ref_loss, abs=LOSS_TOL)
    grads = torch.autograd.grad(loss.sum(), ps)
    assert set(keys) == set(ref_grads)
    for k, g in zip(keys, grads):
        scale = float(np.abs(ref_grads[k]).max())
        assert scale > 0, k
        assert float((g[0] - t(ref_grads[k])).abs().max()) <= \
            GRAD_TOL * scale, k


def test_musicgen_train_step_matches_reference():
    """One make_train_step step (QG-DSGDm-N on a ring of 4, the LM loss
    over 4 codebooks, conditioning riding along to model.loss) from the
    same params, zero momentum and batch, as
    tests/test_models_smoke.py runs the reference's: the loss, and params
    and momentum after the step."""
    cfg, jcfg = _small("torch"), _small("jax")
    model, jm = DecoderModel(cfg), j_build(jcfg)
    nodes = [_perturbed(model, 10 + i) for i in range(N_NODES)]
    params = {k: torch.stack([p[k] for p in nodes]) for k in nodes[0]}
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    tcfg = dict(num_nodes=N_NODES, lr=0.05, batch_size=2)
    batch = _batch(8, N_NODES, 2, 20, cfg)
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


def test_convert_carries_the_musicgen_leaves():
    """init makes the reference's tree (stacked embed_cb (K-1, V, d) and
    head (K, d, V), ln_cross and cross per layer), dtypes kept in bf16,
    and to_jax_lm_params / from_jax_lm_params carry it both ways
    exactly."""
    cfg = _small("torch").replace(dtype="bfloat16")
    jm = j_build(_small("jax").replace(dtype="bfloat16"))
    p = DecoderModel(cfg).init(0, "cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {"/".join(q.key for q in path): (leaf.shape, leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in p.items()} == want
    assert want["embed_cb"][0] == (3, cfg.vocab_size, cfg.d_model)
    assert want["head"][0] == (4, cfg.d_model, cfg.vocab_size)
    assert "layers_0/cross/wq" in want and "layers_0/ln_cross/bias" in want
    tree = to_jax_lm_params(p)
    assert tree["layers_0"]["cross"]["wk"].dtype.name == "bfloat16"
    back = from_jax_lm_params(tree, device="cpu")
    assert set(back) == set(p)
    assert all(back[k].dtype == v.dtype and torch.equal(back[k], v)
               for k, v in p.items())


# ------------------------------------------------------------- refusals
def test_no_single_head_and_no_lm_round_or_run_training():
    """head_params refuses codebook heads (the reference's reason); the
    LM round and run_training refuse multi-codebook models, for which
    the reference has no data or round path, before doing any work."""
    cfg = _small("torch")
    model = DecoderModel(cfg)
    params = {k: v[None] for k, v in model.init(0, "cpu").items()}
    with pytest.raises(ValueError, match="single unembedding head"):
        model.head_params(params)
    with pytest.raises(ValueError, match="codebook"):
        ttrain.run_training(cfg, TTrain(num_nodes=2, steps=1),
                            device="cpu")
    with pytest.raises(ValueError, match="codebook"):
        ttrain.idkd_label_round(model, params, np.zeros((2, 8), np.int64),
                                np.zeros((1, 2, 8), np.int64), TIDKD(),
                                TTopology.make("ring", 1))


def test_train_steps_on_train_specs_layout():
    """lmpath.train_steps' batches have train_specs' shapes and dtypes
    (tokens and labels (n, B, S, K), conditioning (n, B, Sk, d) in the
    config's dtype); two steps on the CPU give finite losses, move the
    params and launch no kernel."""
    cfg, jcfg = _small("torch"), _small("jax")
    tcfg = dataclasses.replace(lmpath.MUSICGEN_TRAIN, num_nodes=2)
    batch = lmpath.train_batch(cfg, 2, tcfg.batch_size, 12,
                               torch.Generator().manual_seed(0))
    specs = train_specs(jcfg, ShapeConfig("t", 12, 2 * tcfg.batch_size,
                                          "train"), 2)
    assert set(batch) == set(specs)
    for k, spec in specs.items():
        assert tuple(batch[k].shape) == spec.shape, k
        assert batch[k].is_floating_point() == \
            jnp.issubdtype(spec.dtype, jnp.floating), k
    assert batch["conditioning"].dtype == torch.float32
    assert torch.equal(batch["tokens"][:, :, 1:], batch["labels"][:, :, :-1])
    out = lmpath.train_steps(cfg.replace(num_layers=1), tcfg, seq_len=12,
                             steps=2, device="cpu")
    assert len(out["steps"]) == 2 and out["peak_gib"] is None
    assert all(np.isfinite(s["loss"]) for s in out["steps"])
    assert 0 < out["moved"] <= out["pairs"]
    assert all(n == 0 for s in out["steps"] for modes in
               s["launches"].values() for by in modes.values()
               for n in by.values())
