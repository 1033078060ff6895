"""The port's core modules against the reference on identical inputs:
mixing, algorithms, OoD calibration, distillation, the label exchange
and the one-shot label round (dense, sparse and fused backends)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import IDKDConfig as JIDKD
from repro.core import distill as jdistill
from repro.core import idkd as jidkd
from repro.core import labeling as jlab
from repro.core import ood as jood
from repro.core.algorithms import make_algorithm as j_make_algorithm
from repro.core.mixing import consensus_distance as j_consensus
from repro.core.mixing import make_mixer as j_make_mixer
from repro.core.topology import Topology as JTopology
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.core import distill as tdistill
from repro_torch.core import idkd as tidkd
from repro_torch.core import labeling as tlab
from repro_torch.core import ood as tood
from repro_torch.core.algorithms import make_algorithm as t_make_algorithm
from repro_torch.core.mixing import consensus_distance as t_consensus
from repro_torch.core.mixing import make_mixer as t_make_mixer
from repro_torch.core.topology import Topology as TTopology

from test_torch_common import t

torch.set_num_threads(1)


def _tree(rng, n):
    return {"conv": rng.normal(size=(n, 3, 3, 2, 4)).astype(np.float32),
            "s0b0/norm": rng.normal(size=(n, 4)).astype(np.float32),
            "fc_w": rng.normal(size=(n, 4, 10)).astype(np.float32)}


def _ulps(got, want):
    """|got − want| in units of the bf16 ulp at ``want``."""
    want = want.astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got.astype(np.float32) - want) / ulp


def _flat_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# (algo, topology, dtype, slices): bf16 bands in bf16 ulps — 1 where the
# reference computes in f32 and casts once (D²'s combine), 2 where it
# sums in the leaf's dtype (centralized's and RelaySGD's momentum, the
# tracker); on the CPU every case is bitwise equal. "sliced" sets CHUNK
# small so every leaf is cut into slices
_ALGO_CASES = [
    ("qg-dsgdm-n", "ring", "float32", False),
    ("qg-dsgdm-n", "full", "float32", False),
    ("dsgdm", "ring", "float32", False), ("dsgd", "full", "float32", False),
    ("centralized", "full", "float32", False),
    ("d2", "ring", "float32", False),
    ("gradient-tracking", "ring", "float32", False),
    ("relaysgd", "chain", "float32", False),
    ("centralized", "full", "bfloat16", False),
    ("d2", "ring", "bfloat16", False),
    ("gradient-tracking", "ring", "bfloat16", False),
    ("relaysgd", "chain", "bfloat16", False),
    ("d2", "ring", "float32", True),
    ("centralized", "full", "float32", True),
    ("gradient-tracking", "ring", "float32", True),
]
_BF16_ULPS = {"d2": 1, "centralized": 2, "gradient-tracking": 2,
              "relaysgd": 2}


@pytest.mark.parametrize(
    "algo,topo,dtype,sliced", _ALGO_CASES,
    ids=[f"{a}-{t}" + ("-bf16" if d == "bfloat16" else "")
         + ("-sliced" if s else "") for a, t, d, s in _ALGO_CASES])
def test_algorithm_step_with_dense_mixer_matches_reference(
        algo, topo, dtype, sliced, monkeypatch):
    """Three steps from identical params, state and per-step grads
    (random momentum where the state has one): params and every state
    leaf after each step, so that D²'s and gradient tracking's first-step
    branch and D²'s reuse of its previous params' buffers show."""
    from repro_torch.core import algorithms as talgos
    if sliced:
        monkeypatch.setattr(talgos, "CHUNK", 16)
    n = 5
    rng = np.random.default_rng(0)
    p, m = _tree(rng, n), _tree(rng, n)
    lr = 0.3
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)
    jt, tt = JTopology.make(topo, n), TTopology.make(topo, n)
    ja = j_make_algorithm(algo, topology=jt, momentum=0.9,
                          weight_decay=1e-4)
    ta = t_make_algorithm(algo, topology=tt, momentum=0.9,
                          weight_decay=1e-4)
    jmix = j_make_mixer(jt, "dense", wire_dtype="float32")
    tmix = t_make_mixer(tt, "dense", wire_dtype="float32", device="cpu")

    def jtree(x):
        return {k: jnp.asarray(v).astype(jd) for k, v in x.items()}

    def ttree(x):
        return {k: t(v).to(td) for k, v in x.items()}

    jp, tp = jtree(p), ttree(p)
    jstate, tstate = ja.init(jp), ta.init(tp)
    if set(jstate) == {"m"}:
        jstate, tstate = {"m": jtree(m)}, {"m": ttree(m)}

    def close(got, want, what):
        got = got.float().numpy()
        want = np.asarray(want).astype(np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=what)
        else:
            worst = float(_ulps(got, want).max())
            assert worst <= _BF16_ULPS[algo], f"{what}: {worst} bf16 ulps"

    for s in range(3):
        g = _tree(rng, n)
        jp, jstate = ja.step(jp, jtree(g), jstate, lr, jmix)
        tp, tstate = ta.step(tp, ttree(g), tstate, lr, tmix)
        for k in p:
            close(tp[k], jp[k], f"step {s} params {k}")
        jflat, tflat = _flat_state(jstate), _flat_state(tstate)
        assert set(jflat) == set(tflat)
        for k, want in jflat.items():
            if k == "t":
                assert tflat[k] == int(want) == s + 1
            else:
                close(tflat[k], want, f"step {s} state {k}")
    np.testing.assert_allclose(
        float(t_consensus({k: t(v) for k, v in p.items()})),
        float(j_consensus(jax.tree.map(jnp.asarray, p))), rtol=1e-5)


@pytest.mark.parametrize("helper", ["make_dense_mixer", "make_mixer",
                                    "pad_partitions", "homogenized_ctx",
                                    "from_jax_params"])
def test_public_helpers_default_to_cuda(helper):
    """A helper called without a device puts its tensors on the card, and
    raises where there is none: nothing lands on the CPU unless
    ``device="cpu"`` is passed."""
    from repro_torch.core import driver as tdriver
    from repro_torch.core.mixing import make_dense_mixer
    from repro_torch.models.convert import from_jax_params
    tt = TTopology.make("ring", 4)
    call = {
        "make_dense_mixer": lambda **kw: make_dense_mixer(
            tt.mixing_matrix(), **kw)(
                {"x": torch.ones(4, 2, device=kw.get("device", "cuda"))})["x"],
        "make_mixer": lambda **kw: t_make_mixer(tt, **kw)(
            {"x": torch.ones(4, 2, device=kw.get("device", "cuda"))})["x"],
        "pad_partitions": lambda **kw: tdriver.pad_partitions(
            [np.arange(3), np.arange(2)], **kw).idx,
        "homogenized_ctx": lambda **kw: tdriver.homogenized_ctx(
            np.ones((2, 3), np.float32), np.ones((2, 3, 10), np.float32), 3,
            **kw)["labels"],
        "from_jax_params": lambda **kw: from_jax_params(
            {"fc_w": np.ones((4, 10), np.float32)}, **kw)["fc_w"],
    }[helper]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_unported_pieces_raise():
    """What the slice leaves out raises, naming the queue that holds it,
    instead of being silently ignored."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.sched import ChurnEvent, compile_schedule
    tt = TTopology.make("ring", 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_make_mixer(tt, "gather")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        compile_schedule(10, 5, events=(
            ChurnEvent(2, down=(1,), mode="stale"),))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        compile_schedule(10, 5, gossip="delayed")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        t_make_mixer(tt, device="cpu", compression=("topk", 0.1))
    data = make_classification_data(image_size=8, n_train=32, n_val=8,
                                    n_test=8)
    for kw, item in (({"driver_mode": "shard"}, "item 13"),
                     ({"model_parallel": 2}, "item 13")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            DecentralizedSimulator(SMALL_CONFIG, TrainConfig(num_nodes=4),
                                   data, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecentralizedSimulator(SMALL_CONFIG,
                               TrainConfig(num_nodes=4, compression="topk"),
                               data, device="cpu")


@pytest.mark.parametrize("det", ["msp", "energy"])
def test_ood_confidence_and_calibration_match_reference(det):
    rng = np.random.default_rng(1)
    val = (rng.normal(size=(4, 40, 10)) * 3).astype(np.float32)
    pub = (rng.normal(size=(4, 90, 10)) * 1.5).astype(np.float32)
    cv, cp = jood.confidence(val, det), jood.confidence(pub, det)
    tv, tp = tood.confidence(t(val), det), tood.confidence(t(pub), det)
    np.testing.assert_allclose(tv.numpy(), np.asarray(cv), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(cp), atol=1e-6,
                               rtol=1e-6)
    ref = jax.vmap(jood.calibrate_threshold)(cv, cp)
    np.testing.assert_allclose(tood.calibrate_threshold(t(cv), t(cp)).numpy(),
                               np.asarray(ref), atol=1e-6)
    ts, tpr, fpr = jood.roc_curve(cv[0], cp[0])
    ts2, tpr2, fpr2 = tood.roc_curve(t(cv[0]), t(cp[0]))
    np.testing.assert_allclose(ts2.numpy(), np.asarray(ts), atol=1e-6)
    np.testing.assert_allclose(tpr2.numpy(), np.asarray(tpr), atol=1e-6)
    np.testing.assert_allclose(fpr2.numpy(), np.asarray(fpr), atol=1e-6)


def test_distill_matches_reference():
    """Soft labels, the T²-scaled KD losses (dense and sparse), the top-k
    codec and the byte accounting."""
    rng = np.random.default_rng(2)
    z = (rng.normal(size=(6, 12)) * 3).astype(np.float32)
    tz = (rng.normal(size=(6, 12)) * 3).astype(np.float32)
    T = 10.0
    probs = jdistill.soft_labels(tz, T)
    np.testing.assert_allclose(tdistill.soft_labels(t(tz), T).numpy(),
                               np.asarray(probs), atol=1e-7)
    np.testing.assert_allclose(
        tdistill.kd_loss(t(z), t(probs), T).numpy(),
        np.asarray(jdistill.kd_loss(z, probs, T)), rtol=1e-5)
    # the T² convention: kd_loss == T² · soft-CE
    ce = -(t(probs) * torch.log_softmax(t(z) / T, -1)).sum(-1)
    np.testing.assert_allclose(tdistill.kd_loss(t(z), t(probs), T).numpy(),
                               (T ** 2 * ce).numpy(), rtol=1e-6)
    js = jdistill.sparsify_labels(probs, 4)
    ts = tdistill.sparsify_labels(t(probs), 4)
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               atol=1e-6)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_allclose(tdistill.densify_labels(ts, 12).numpy(),
                               np.asarray(jdistill.densify_labels(js, 12)),
                               atol=1e-6)
    np.testing.assert_allclose(
        tdistill.sparse_kd_loss(t(z), ts, T).numpy(),
        np.asarray(jdistill.sparse_kd_loss(z, js, T)), rtol=1e-5)
    assert tdistill.label_bytes(7, 10, 4) == jdistill.label_bytes(7, 10, 4)
    assert tdistill.label_bytes(7, 10) == jdistill.label_bytes(7, 10)


def test_class_histogram_and_skew_match_reference():
    rng = np.random.default_rng(3)
    hard = rng.integers(0, 10, size=30)
    vals = rng.dirichlet(np.ones(4), size=20).astype(np.float32)
    idx = rng.integers(0, 10, size=(20, 4)).astype(np.int32)
    w = (rng.random(20) > 0.3).astype(np.float32)
    ref = jidkd.class_histogram(jnp.asarray(hard),
                                jdistill.SparseLabels(vals, idx), w, 10)
    out = tidkd.class_histogram(t(hard), tdistill.SparseLabels(t(vals),
                                                               t(idx)),
                                t(w), 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    dense = rng.dirichlet(np.ones(10), size=20).astype(np.float32)
    ref = jidkd.class_histogram(jnp.asarray(hard), dense, w, 10)
    out = tidkd.class_histogram(t(hard), t(dense), t(w), 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    hists = rng.dirichlet(np.ones(10), size=4)
    assert tidkd.skew_metric(hists) == pytest.approx(
        float(jidkd.skew_metric(jnp.asarray(hists))), rel=1e-6)


@pytest.mark.parametrize("topo,n", [("ring", 5), ("full", 4), ("chain", 3)])
def test_exchange_sparse_matches_reference(topo, n):
    rng = np.random.default_rng(n)
    vals = rng.dirichlet(np.ones(3), size=(n, 9)).astype(np.float32)
    idx = rng.integers(0, 10, size=(n, 9, 3)).astype(np.int32)
    mask = rng.random((n, 9)) > 0.4
    jl, jw = jlab.exchange_sparse(JTopology.make(topo, n), jnp.asarray(mask),
                                  jdistill.SparseLabels(vals, idx))
    tl, tw = tlab.exchange_sparse(TTopology.make(topo, n), t(mask),
                                  tdistill.SparseLabels(t(vals), t(idx)))
    np.testing.assert_allclose(tl.values.numpy(), np.asarray(jl.values),
                               atol=1e-6)
    np.testing.assert_array_equal(tl.indices.numpy(), np.asarray(jl.indices))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def _masks_equal_away_from_threshold(out, ref, conf):
    """D_ID masks agree except where conf is within 1e-5 of t_opt."""
    differ = np.asarray(out.id_masks) != np.asarray(ref.id_masks)
    near = np.abs(conf - np.asarray(ref.thresholds)[:, None]) <= 1e-5
    assert not (differ & ~near).any()


@pytest.mark.parametrize("backend,det,filter_ood,active", [
    ("dense", "msp", True, None), ("dense", "energy", True, (1, 1, 0, 1, 1)),
    ("sparse", "msp", True, None), ("sparse", "msp", False, None),
    ("fused", "msp", True, (1, 1, 0, 1, 1)), ("fused", "energy", True, None)])
def test_label_round_matches_reference(backend, det, filter_ood, active):
    n, P, V, C = 5, 60, 24, 10
    rng = np.random.default_rng(7)
    pub = (rng.normal(size=(n, P, C)) * 2.5).astype(np.float32)
    val = (rng.normal(size=(n, V, C)) * 4).astype(np.float32)
    jcfg = JIDKD(temperature=10.0, detector=det, label_topk=4)
    tcfg = TIDKD(temperature=10.0, detector=det, label_topk=4)
    act = None if active is None else np.asarray(active, bool)
    ref = jlab.label_round(jnp.asarray(pub), jnp.asarray(val), None,
                           JTopology.make("ring", n), jcfg, backend=backend,
                           filter_ood=filter_ood, active=act)
    out = tlab.label_round(t(pub), t(val), None, TTopology.make("ring", n),
                           tcfg, backend=backend, filter_ood=filter_ood,
                           active=act)
    np.testing.assert_allclose(out.thresholds.numpy(),
                               np.asarray(ref.thresholds), atol=1e-5)
    _masks_equal_away_from_threshold(
        out, ref, np.asarray(jood.confidence(pub, det)))
    np.testing.assert_array_equal(out.weights.numpy(),
                                  np.asarray(ref.weights))
    if backend == "dense":
        np.testing.assert_allclose(out.labels.numpy(),
                                   np.asarray(ref.labels), atol=1e-5)
    else:
        np.testing.assert_allclose(out.labels.values.numpy(),
                                   np.asarray(ref.labels.values), atol=1e-5)
        np.testing.assert_array_equal(out.labels.indices.numpy(),
                                      np.asarray(ref.labels.indices))
        np.testing.assert_allclose(out.densify(C).numpy(),
                                   np.asarray(ref.densify(C)), atol=1e-5)
