"""The decoder stack against the reference on the CPU: configs, the LM
corpus, the layers (norms, RoPE, MLP, attention, the SSD mixer), the
param tree and its conversion, and ``DecoderModel.forward`` on a reduced
Hymba. Weights are made by the port's ``init`` and carried to the
reference with ``convert.to_jax_lm_params``; inputs come from numpy
seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.synthetic import make_lm_data as j_make_lm_data
from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.data.synthetic import make_lm_data as t_make_lm_data
from repro_torch.launch.steps import (consensus_params, make_prefill_step,
                                      stack_params)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import from_jax_lm_params, to_jax_lm_params
from repro_torch.models.model import build_model as t_build
from repro_torch.models.transformer import DecoderModel

from test_torch_common import hymba_small, leaves, t

torch.set_num_threads(1)

FWD_ATOL = 5e-5           # f32 logits (|logit| ~ 5) after 3 layers
LAYER_ATOL = 1e-5         # one f32 layer, sums reordered
BF16_ULPS = 4             # bf16 logits: bf16 ulps of max|logit|
BF16_NOISE = (0.5, 2.0)   # the port's bf16-vs-f32 gap over the reference's
BF16_CORR = 0.3           # least correlation of the two bf16 rounding fields

ARCHS = ["hymba-1.5b", "mamba2-780m", "qwen3-1.7b", "phi3-mini-3.8b",
         "qwen1.5-0.5b", "mistral-nemo-12b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_reduced_match_reference(arch):
    jc, tc = j_get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jc.reduced()) == dataclasses.asdict(tc.reduced())
    other = JModelConfig(num_heads=8, num_kv_heads=8, d_model=1024,
                         sliding_window=4096)
    mine = TModelConfig(num_heads=8, num_kv_heads=8, d_model=1024,
                        sliding_window=4096)
    assert dataclasses.asdict(other.reduced()) == \
        dataclasses.asdict(mine.reduced())


def test_make_lm_data_bitwise_equal():
    for kw in ({"vocab": 512, "seq_len": 33, "n_seqs": 20, "seed": 4},
               {"vocab": 32001, "seq_len": 16, "n_seqs": 7,
                "num_topics": 10, "seed": 103}):
        for a, b in zip(j_make_lm_data(**kw), t_make_lm_data(**kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(norm_type, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    jcfg = JModelConfig(norm_type=norm_type)
    tcfg = TModelConfig(norm_type=norm_type)
    jx, tx = jnp.asarray(x, dtype), t(x).to(getattr(torch, dtype))
    ref = jlayers.apply_norm({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jx, jcfg)
    out = tlayers.apply_norm({"scale": t(scale), "bias": t(bias)}, tx, tcfg)
    assert out.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2     # one bf16 ulp at |y| ~ 2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)
    ref = jlayers.rms_head_norm(jx, jnp.asarray(scale))
    out = tlayers.rms_head_norm(tx, t(scale))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


def test_rope_and_mlp_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7)[None].repeat(2, 0)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = tlayers.apply_rope(t(x), t(pos), 10_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    h = rng.normal(size=(2, 5, 12)).astype(np.float32)
    p = {k: (rng.normal(size=s) / 4).astype(np.float32)
         for k, s in (("wi", (12, 20)), ("wg", (12, 20)), ("wo", (20, 12)))}
    for mlp in ("swiglu", "geglu", "gelu"):
        ref = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(h), JModelConfig(mlp_type=mlp))
        out = tlayers.apply_mlp({k: t(v) for k, v in p.items()}, t(h),
                                TModelConfig(mlp_type=mlp))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=LAYER_ATOL, err_msg=mlp)


def _layer_params(model, seed, prefix):
    """One layer's params under ``prefix`` from the port's init, perturbed
    so that zero biases and unit scales matter."""
    rng = np.random.default_rng(seed)
    lp = {k[len("layers_0/" + prefix):]: v[1]
          for k, v in model.init(seed, "cpu").items()
          if k.startswith("layers_0/" + prefix)}
    return {k: v + torch.as_tensor(0.05 * rng.normal(size=v.shape),
                                   dtype=v.dtype) for k, v in lp.items()}


@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, False), (True, True)])
def test_attention_forward_matches_reference(qkv_bias, qk_norm):
    jcfg = hymba_small("jax").replace(qkv_bias=qkv_bias, qk_norm=qk_norm)
    tcfg = hymba_small("torch").replace(qkv_bias=qkv_bias, qk_norm=qk_norm)
    p = _layer_params(DecoderModel(tcfg), 3, "attn/")
    x = np.random.default_rng(2).normal(size=(2, 70, tcfg.d_model)
                                        ).astype(np.float32)
    for window in (0, tcfg.sliding_window):
        ref = jattn.attention_forward(
            {k: jnp.asarray(v.numpy()) for k, v in p.items()},
            jnp.asarray(x), jcfg, layer_window=window)
        out = tattn.attention_forward(p, t(x), tcfg, layer_window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=LAYER_ATOL)


@pytest.mark.parametrize("split_proj", [False, True])
def test_ssm_forward_matches_reference(split_proj):
    jcfg = hymba_small("jax")
    tcfg = hymba_small("torch")
    jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, split_proj=split_proj,
                                                ngroups=2))
    tcfg = tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, split_proj=split_proj,
                                                ngroups=2))
    p = _layer_params(DecoderModel(tcfg), 4, "ssm/")
    x = np.random.default_rng(5).normal(size=(2, 45, tcfg.d_model)
                                        ).astype(np.float32)
    ref = jssm.ssm_forward({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                           jnp.asarray(x), jcfg)
    out = tssm.ssm_forward(p, t(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """The init's paths, shapes and dtypes against the reference's tree
    (the reduced config)."""
    tcfg, jcfg = t_get_config(arch), j_get_config(arch)
    jshapes = jax.eval_shape(j_build(jcfg.reduced()).init,
                             jax.random.PRNGKey(0))
    want = {"/".join(q.key for q in path): (leaf.shape, leaf.dtype.name)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    params = DecoderModel(tcfg.reduced()).init(0, "cpu")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in params.items()}
    assert got == want


def test_lm_params_round_trip_keeps_dtypes():
    """A node-stacked bf16 Hymba tree with its f32 SSM leaves crosses to
    the port and back bitwise, every leaf in its own dtype, nothing
    transposed."""
    cfg = t_get_config("hymba-1.5b").reduced().replace(dtype="bfloat16")
    one = DecoderModel(cfg).init(1, "cpu")
    tree = to_jax_lm_params(stack_params(one, 2))
    dtypes = {k: v.dtype for k, v in leaves(tree).items()}
    assert dtypes["layers_0/ssm/a_log"] == np.float32
    assert dtypes["layers_0/ssm/conv_w"] == ml_dtypes.bfloat16
    assert leaves(tree)["layers_0/ssm/conv_w"].shape == \
        (2,) + tuple(one["layers_0/ssm/conv_w"].shape)
    back = from_jax_lm_params(tree, device="cpu")
    for k, v in stack_params(one, 2).items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k
    again = leaves(to_jax_lm_params(back))
    for k, v in leaves(tree).items():
        assert again[k].dtype == v.dtype
        np.testing.assert_array_equal(again[k], v)


def _families(side):
    """The hybrid (Hymba: attention ∥ SSM, meta tokens), SSM-only
    (Mamba-2: tied embeddings, no MLP) and attention-only stacks."""
    get = j_get_config if side == "jax" else t_get_config
    hymba = hymba_small(side)
    dense = hymba.replace(arch_type="dense", hybrid_parallel=False,
                          ssm=dataclasses.replace(hymba.ssm, state_size=0),
                          num_prefix_tokens=0)
    return {"hymba": hymba, "mamba2": get("mamba2-780m").reduced(),
            "dense": dense, "hymba-bf16": hymba.replace(dtype="bfloat16")}


@pytest.mark.parametrize("family", ["hymba", "mamba2", "dense",
                                    "hymba-bf16"])
def test_decoder_forward_matches_reference(family):
    """Node-stacked forward against the reference, vmapped over the same
    two nodes. The reduced Hymba has 3 layers, GQA 4:2, window 64 on
    layer 1 and 8 meta tokens; S + 8 > 64, so the window bites."""
    tcfg, jcfg = _families("torch")[family], _families("jax")[family]
    tm, jm = DecoderModel(tcfg), j_build(jcfg)
    assert tm.layer_windows() == list(np.asarray(jm.layer_windows()))
    if family == "hymba":
        assert tm.layer_windows() == [0, 64, 0]
    params = consensus_and_stack(tm)
    S = 70
    toks = np.random.default_rng(6).integers(0, 512, size=(2, 3, S))
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    ref = jax.vmap(lambda p, x: jm.forward(p, {"tokens": x})[0])(
        jparams, jnp.asarray(toks, jnp.int32))
    logits, aux = t_build(tcfg).forward(params, {"tokens": t(toks)})
    assert logits.shape == (2, 3, S, tcfg.vocab_size) and float(aux) == 0.0
    if tcfg.dtype == "bfloat16":
        _check_bf16_logits(logits, ref, tcfg, jcfg, params, toks)
    else:
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref),
                                   atol=FWD_ATOL)
    prefill = make_prefill_step(tm)(params, {"tokens": t(toks)})
    torch.testing.assert_close(prefill, logits, atol=0.0, rtol=0.0)


def _check_bf16_logits(logits, ref, tcfg, jcfg, params, toks):
    """The bf16 model against the reference's bf16 forward. The two round
    to bf16 at the same points (residual adds, branch outputs after the
    f32 norms, the SSM and attention outputs, the logits), but XLA's and
    PyTorch's silu, softplus and exp differ by an ulp here and there, and
    three layers amplify that to a few ulps of the logits: as much as an
    f32 model's distance from the bf16 reference (the reference's own
    jit and op-by-op runs differ by as much). So besides the logits
    within BF16_ULPS ulps of max|logit| and their dtype, the test holds
    the port's rounding to the reference's: with both models also run in
    f32 on the same (upcast) params, the port's bf16-vs-f32 gap must be
    BF16_NOISE times the reference's and the two rounding fields must
    correlate by BF16_CORR. The port's ratio is 0.95 and its correlation
    0.41; a model run in f32 and cast to bf16 at the end fails the ratio
    (0.16), layer norms in bf16 (0.10) or a mixer run in f32 (0.17) fail
    the correlation."""
    ref = np.asarray(ref.astype(jnp.float32))
    assert logits.dtype == torch.bfloat16
    scale = np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(logits.float().numpy(), ref,
                               atol=BF16_ULPS * ulp, rtol=0)
    f32 = {k: v.float() for k, v in params.items()}
    jm = j_build(jcfg.replace(dtype="float32"))
    ref32 = jax.vmap(lambda p, x: jm.forward(p, {"tokens": x})[0])(
        jax.tree.map(jnp.asarray, to_jax_lm_params(f32)),
        jnp.asarray(toks, jnp.int32))
    out32, _ = DecoderModel(tcfg.replace(dtype="float32")).forward(
        f32, {"tokens": t(toks)})
    e_port = (logits.float() - out32).numpy().ravel()
    e_ref = (ref - np.asarray(ref32)).ravel()
    ratio = np.abs(e_port).mean() / np.abs(e_ref).mean()
    assert BF16_NOISE[0] <= ratio <= BF16_NOISE[1], ratio
    assert np.corrcoef(e_port, e_ref)[0, 1] >= BF16_CORR


def consensus_and_stack(model):
    """Two different nodes; their consensus is the f32 mean."""
    a, b = model.init(0, "cpu"), model.init(1, "cpu")
    params = {k: torch.stack([a[k], b[k]]) for k in a}
    mean = consensus_params(params)
    torch.testing.assert_close(mean["embed"], (a["embed"] + b["embed"]) / 2)
    return params


def test_unported_decoder_features_raise():
    """MoE, MLA and multi-token prediction (and decode) raise, naming
    ROADMAP.md; codebooks and cross-attention, ported with MusicGen, and
    VLM patches, ported with PaliGemma, build
    (tests/test_torch_musicgen.py and tests/test_torch_paligemma.py hold
    them to the reference)."""
    base = t_get_config("hymba-1.5b").reduced()
    for kw in ({"moe": dataclasses.replace(base.moe, num_experts=4)},
               {"mla": dataclasses.replace(base.mla, kv_lora_rank=8)},
               {"mtp_depth": 1}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DecoderModel(base.replace(**kw))
    for kw in ({"num_codebooks": 2}, {"cross_attention": True,
                                      "cross_attn_len": 4},
               {"arch_type": "vlm"}):
        assert DecoderModel(base.replace(**kw)).cfg == base.replace(**kw)
    model = DecoderModel(base)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_decode_state(1, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.decode_step({}, None, None)
