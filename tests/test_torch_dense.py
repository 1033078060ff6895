"""The dense decoder family against the reference on the CPU: the four
dense configs (Qwen3-1.7B, Phi-3-mini, Qwen1.5-0.5B, Mistral-Nemo-12B)
and their long-context variant, the dense stacks' features (qkv-bias,
qk-norm, tied heads, rope_theta, all-global layers), forward, loss and
gradients at ``reduced()`` (Phi-3 also at its own head_dim 96), the
attention kernels' plain versions at head_dim 96, one train step and
one homogenization round on a reduced Qwen3 (tied head, so the round's
``head_select`` reads the embedding), and the ring of 2 that Phi-3's
full-width run trains on.

Weights are made by the port's ``init``, perturbed from numpy seeds so
that zero biases and unit scales matter, and carried to the reference
with ``convert.to_jax_lm_params``. Tolerances: logits 5e-5 and losses
1e-5 (f32, 2 layers), gradients 2e-4 of each leaf's max |grad| (sums
reordered), the attention forward 2e-5 in f32 and 2e-2 in bf16, its
backward 1e-5 in f32 and 2^-7 of each gradient's max |value| with bf16
operands (the repo's own kernel tolerances); one step's params 1e-5 and
momentum 1e-4; round confidences, thresholds and labels as
``test_torch_lm_round.py``."""
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
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import idkd_label_round as j_round
from repro.models import attention as jattn
from repro.models import build_model as j_build
import repro_torch.configs as tconfigs
from repro_torch import lmpath
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core.mixing import make_mixer
from repro_torch.core.topology import Topology as TTopology
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import from_jax_lm_params, to_jax_lm_params
from repro_torch.models.transformer import DecoderModel

from test_torch_common import leaves, t
from test_torch_lm_round import THRESH_ATOL, assert_labels_close

torch.set_num_threads(1)

DENSE = ["qwen3-1.7b", "phi3-mini-3.8b", "qwen1.5-0.5b", "mistral-nemo-12b"]
CASES = DENSE + ["phi3-mini-3.8b@96"]
FWD_ATOL, LOSS_TOL, GRAD_TOL = 5e-5, 1e-5, 2e-4
FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_GRAD_TOL, BF16_GRAD_TOL = 1e-5, 2.0 ** -7
STEP_PARAM_ATOL, STEP_MOM_ATOL = 1e-5, 1e-4


def _small(case, side):
    """The reduced config of a case; "phi3-mini-3.8b@96" keeps Phi-3's
    own head_dim (3072 / 32), which ``reduced()`` cuts to 64."""
    get = jconfigs.get_config if side == "jax" else tconfigs.get_config
    arch, _, hd = case.partition("@")
    cfg = get(arch).reduced()
    return cfg.replace(head_dim=int(hd)) if hd else cfg


def _perturbed(model, seed):
    """One node's params from the port's init, each leaf moved by numpy
    noise of 0.05 (biases off zero, norm scales off one)."""
    rng = np.random.default_rng(seed)
    return {k: v + torch.as_tensor(0.05 * rng.normal(size=v.shape),
                                   dtype=v.dtype)
            for k, v in model.init(seed, "cpu").items()}


def _no_opt(fn):
    """fn() with XLA's optimization passes off: they take most of the
    reference's compile time on the CPU and change no result here beyond
    f32 rounding."""
    fast = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)


# ------------------------------------------------------------------ configs
def test_dense_registry_and_long_context_variants_match_reference():
    """get_config resolves the four dense archs field for field as the
    reference's, and the long-context variants are the reference's."""
    for arch in DENSE:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jconfigs.get_config(arch))
    assert set(tconfigs.LONG_CONTEXT_VARIANTS) == \
        set(jconfigs.LONG_CONTEXT_VARIANTS)
    for k, v in tconfigs.LONG_CONTEXT_VARIANTS.items():
        assert dataclasses.asdict(v) == \
            dataclasses.asdict(jconfigs.LONG_CONTEXT_VARIANTS[k])
        assert dataclasses.asdict(v) == dataclasses.asdict(
            jconfigs.get_config(k, "long_500k"))
    assert tconfigs.LONG_CONTEXT_VARIANTS["mistral-nemo-12b"
                                          ].sliding_window == 4096


def test_cli_defaults_to_the_references_arch(monkeypatch):
    """python -m repro_torch.launch.train with no --arch trains the
    reference CLI's default, qwen3-1.7b."""
    import repro_torch.launch.train as ttrain
    seen = {}

    def fake_run(cfg, tcfg, **kw):
        seen["cfg"] = cfg
        return {"loss_history": [0.0], "ledger": {
            "gossip_bytes": 0, "label_bytes": 0, "per_round": []}}

    monkeypatch.setattr(ttrain, "run_training", fake_run)
    monkeypatch.setattr("sys.argv", ["train", "--device", "cpu"])
    ttrain.main()
    assert seen["cfg"] == tconfigs.get_config("qwen3-1.7b").reduced()


@pytest.mark.parametrize("case", CASES)
def test_dense_stack_features(case):
    """What each dense config builds, against the reference's tree and
    windows: qkv-bias (Qwen1.5), qk-norm and rope_theta 1e6 (Qwen3;
    Mistral's theta), tied heads (both Qwens: no "head" leaf, the round
    reads the embedding), an untied head and MHA (Phi-3), and every layer
    global when sliding_window is 0."""
    tcfg, jcfg = _small(case, "torch"), _small(case, "jax")
    model, jm = DecoderModel(tcfg), j_build(jcfg)
    assert tcfg.sliding_window == 0
    assert model.layer_windows() == [0] * tcfg.num_layers == \
        list(np.asarray(jm.layer_windows()))
    p = model.init(0, "cpu")
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {"/".join(q.key for q in path): (leaf.shape, leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in p.items()} == want
    arch = case.split("@")[0]
    assert ("layers_0/attn/bq" in p) == (arch == "qwen1.5-0.5b")
    assert ("layers_0/attn/q_norm" in p) == (arch == "qwen3-1.7b")
    assert ("head" in p) == (arch not in ("qwen3-1.7b", "qwen1.5-0.5b"))
    w, bias = model.head_params({k: v[None] for k, v in p.items()})
    assert bias is None and w.shape == (1, tcfg.d_model, tcfg.vocab_size)
    full = tconfigs.get_config(arch)
    assert full.rope_theta == (1e6 if arch in ("qwen3-1.7b",
                                               "mistral-nemo-12b") else 1e4)
    if arch == "phi3-mini-3.8b":
        assert (full.num_heads, full.num_kv_heads,
                full.resolved_head_dim) == (32, 32, 96)


@pytest.mark.parametrize("case", CASES)
def test_dense_forward_loss_and_grads_match_reference(case):
    """Node-stacked forward (two different nodes) and one node's masked
    next-token loss with its gradient on every leaf, against the
    reference's forward, loss and jax.grad; the dense leaves (bq, bk, bv,
    q_norm, k_norm, a missing head) cross both ways through convert."""
    tcfg, jcfg = _small(case, "torch"), _small(case, "jax")
    model, jm = DecoderModel(tcfg), j_build(jcfg)
    a, b = _perturbed(model, 1), _perturbed(model, 2)
    params = {k: torch.stack([a[k], b[k]]) for k in a}
    tree = to_jax_lm_params(params)
    back = from_jax_lm_params(tree, device="cpu")
    assert set(back) == set(params)
    assert all(torch.equal(back[k], v) for k, v in params.items())
    rng = np.random.default_rng(3)
    S = 40
    seq = rng.integers(0, tcfg.vocab_size, size=(2, 3, S + 1))
    mask = (rng.random(size=(2, 3, S)) > 0.2).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)

    def reference():
        logits = jax.jit(jax.vmap(lambda p, x: jm.forward(
            p, {"tokens": x})[0]))(jparams, jnp.asarray(seq[..., :-1]))
        one = jax.tree.map(lambda x: x[0], jparams)
        jb = {"tokens": jnp.asarray(seq[0, :, :-1]),
              "labels": jnp.asarray(seq[0, :, 1:]),
              "loss_mask": jnp.asarray(mask[0])}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb)[0]))(one)
        return np.asarray(logits), float(loss), leaves(
            jax.tree.map(np.asarray, grads))
    ref_logits, ref_loss, ref_grads = _no_opt(reference)

    logits, _ = model.forward(params, {"tokens": t(seq[..., :-1])})
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=FWD_ATOL)
    keys = list(a)
    ps = [a[k][None].clone().requires_grad_(True) for k in keys]
    loss, _ = model.loss(dict(zip(keys, ps)),
                         {"tokens": t(seq[:1, :, :-1]),
                          "labels": t(seq[:1, :, 1:]),
                          "loss_mask": t(mask[:1])})
    assert float(loss.detach()) == pytest.approx(ref_loss, abs=LOSS_TOL)
    grads = torch.autograd.grad(loss.sum(), ps)
    assert set(keys) == set(ref_grads)
    for k, g in zip(keys, grads):
        scale = float(np.abs(ref_grads[k]).max())
        assert scale > 0, k
        assert float((g[0] - t(ref_grads[k])).abs().max()) <= \
            GRAD_TOL * scale, k


# -------------------------------------------------------- attention at 96
def _attn(seed, B, S, H, KVH, D, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, KVH, D)).astype(np.float32)
            for _ in range(2))
    return [t(x).to(dtype) for x in (q, k, v, do)]


def _lse(q, k, window):
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(H // k.shape[2], 2))
    pos = torch.arange(S)
    allow = pos[None, :] <= pos[:, None]
    if window:
        allow &= pos[:, None] - pos[None, :] < window
    return torch.logsumexp((s / D ** 0.5).masked_fill(~allow, -1e30), -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_head_dim_96_matches_pallas_kernel(dtype):
    """The plain version at Phi-3's head_dim against the Pallas kernel in
    interpret mode (S a multiple of its block, causal, no window), MHA
    and GQA."""
    dt = getattr(torch, dtype)
    for H, KVH in ((4, 4), (4, 2)):
        q, k, v, _ = _attn(7 + KVH, 1, 128, H, KVH, 96, dt)
        jx = [jnp.asarray(x.float().numpy(), getattr(jnp, dtype))
              for x in (q, k, v)]
        ref = j_flash(*jx, block_q=64, block_k=64, interpret=True)
        out = flash_attention_plain(q, k, v, chunk=32)
        assert out.dtype == dt
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=FLASH[dtype])


@pytest.mark.parametrize("window", [0, 24])
def test_flash_fwd_and_bwd_plain_at_head_dim_96_match_jax(window):
    """The plain forward and backward at head_dim 96, a ragged S (75 over
    32-key chunks) and a window that bites, against the reference's
    chunked_attention and jax.vjp of it: f32, and both operand modes of
    the backward on bf16 inputs (f32 sums; operands="bf16" rounds P and
    dS as the tensor-core kernel does)."""
    q, k, v, do = _attn(11 + window, 2, 75, 4, 2, 96)
    ref_o, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, causal=True, window=window, chunk=32),
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    o = flash_attention_plain(q, k, v, window=window, chunk=32)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o),
                               atol=FLASH["float32"])
    got = flash_attention_bwd_plain(q, k, v, o, _lse(q, k, window), do,
                                    window=window, chunk=32)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_GRAD_TOL,
                                   err_msg=name)
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    f32 = [x.float().numpy() for x in (qb, kb, vb, dob)]
    ref_o, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, causal=True, window=window, chunk=32), *f32[:3])
    ref = [np.asarray(g) for g in vjp(jnp.asarray(f32[3]))]
    ob = flash_attention_plain(qb, kb, vb, window=window, chunk=32)
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(ob.float().numpy(), np.asarray(ref_o),
                               atol=FLASH["bfloat16"])
    for operands in ("f32", "bf16"):
        got = flash_attention_bwd_plain(qb, kb, vb, ob, _lse(qb, kb, window),
                                        dob, window=window, chunk=32,
                                        operands=operands)
        for name, g, r in zip("qkv", got, ref):
            assert g.dtype == torch.bfloat16
            err = float(np.abs(g.float().numpy() - r).max())
            assert err <= BF16_GRAD_TOL * float(np.abs(r).max()), \
                (operands, name, err)


# --------------------------------------------- a step and a round on Qwen3
N_NODES = 4


@pytest.fixture(scope="module")
def qwen3_small():
    """A reduced Qwen3 (2 layers, 4/4 heads × 64, qk-norm, tied head over
    512 tokens) on 4 ring nodes from seeds 0-3, data as lmpath makes it,
    and the same params on the reference's side."""
    icfg = TIDKD(label_topk=4, stream_microbatch=3, label_backend="sparse",
                 temperature=10.0)
    r = lmpath.setup(_small("qwen3-1.7b", "torch"), num_nodes=N_NODES,
                     seq_len=30, n_private=64, n_public=7, icfg=icfg,
                     device="cpu")
    for k, v in r.params.items():          # biases and scales off 0 and 1
        v += torch.as_tensor(0.05 * np.random.default_rng(5).normal(
            size=v.shape), dtype=v.dtype)
    jm = j_build(_small("qwen3-1.7b", "jax"))
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(r.params))
    return r, jm, jparams


def test_qwen3_train_step_matches_reference(qwen3_small):
    """make_train_step (QG-DSGDm-N on the ring, the LM loss) from the same
    params, zero momentum and batch: the loss, and params and momentum
    after the step."""
    r, jm, jparams = qwen3_small
    tcfg = dict(num_nodes=N_NODES, lr=0.1, batch_size=2)
    rng = np.random.default_rng(8)
    seq = rng.integers(0, 512, size=(N_NODES, 2, 31))
    batch = {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
    jstep = j_make_train_step(jm, JTrain(**tcfg), N_NODES)
    jopt = jstep.init_opt(jparams)
    ref = _no_opt(lambda: jax.jit(jstep)(
        jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()}, 0.1))
    step = make_train_step(r.model, TTrain(**tcfg), N_NODES, device="cpu")
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


def test_qwen3_label_round_matches_reference(qwen3_small):
    """The streaming round on the tied head (head_select's plain version
    reads the embedding's transpose, microbatches of 3 with a ragged
    last one) against the reference's idkd_label_round."""
    r, jm, jparams = qwen3_small
    ref = _no_opt(lambda: j_round(
        jm, jparams, r.public, r.private,
        JIDKD(**dataclasses.asdict(r.icfg)),
        JTopology.make("ring", N_NODES), backend="sparse"))
    labels, w, mask, thr = r.run()
    assert labels.values.shape == (N_NODES, 7, 30, 3 * 4)
    np.testing.assert_allclose(thr.numpy(), np.asarray(ref[3]),
                               atol=THRESH_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref[1]))
    assert_labels_close(labels.values, labels.indices, ref[0].values,
                        ref[0].indices)
    assert 0.0 < float(mask.float().mean()) < 1.0


def test_kd_public_batch_defaults_to_the_references(monkeypatch):
    """run_training's KD steps draw min(4, n_public) public sequences per
    node, as the reference's, unless ``pub_batch`` asks for fewer (the
    full-width Qwen3 run's QWEN3_PUB_BATCH), and it returns the number
    it drew."""
    import repro_torch.core.driver as tdriver
    seen = []
    draw = tdriver.draw_public

    def recording(gen, n, pub_batch, n_public, device):
        seen.append(pub_batch)
        return draw(gen, n, pub_batch, n_public, device)

    monkeypatch.setattr(tdriver, "draw_public", recording)
    cfg = _small("qwen3-1.7b", "torch").replace(num_layers=1)
    tcfg = dataclasses.replace(lmpath.QWEN3_TRAIN, steps=2,
                               idkd=dataclasses.replace(
                                   lmpath.QWEN3_TRAIN.idkd, start_step=1))
    for pub_batch, want in ((None, 4), (lmpath.QWEN3_PUB_BATCH, 2)):
        seen.clear()
        out = lmpath.train(cfg, tcfg, seq_len=16, n_private=32, n_public=6,
                           pub_batch=pub_batch, device="cpu")
        assert seen == [want] and out["pub_batch"] == want
        assert len(out["loss_history"]) == 2


def test_ring_of_two_matches_reference():
    """Phi-3's full-width run trains 2 nodes on a ring, whose edge list
    names the one edge twice: the port's topology, mixing matrix and
    mixer make of it what the reference's make."""
    jt, tt = JTopology.make("ring", 2), TTopology.make("ring", 2)
    assert tt.name == jt.name
    np.testing.assert_array_equal(tt.mixing_matrix(), jt.mixing_matrix())
    assert [list(tt.neighbors(i)) for i in range(2)] == \
        [list(jt.neighbors(i)) for i in range(2)]
    x = np.random.default_rng(9).normal(size=(2, 5)).astype(np.float32)
    mixed = make_mixer(tt, device="cpu")({"x": t(x)})["x"]
    np.testing.assert_allclose(mixed.numpy(), jt.mixing_matrix() @ x,
                               atol=1e-6)
    assert lmpath.PHI3_TRAIN.num_nodes == 2 and \
        lmpath.PHI3_TRAIN.topology == "ring"
