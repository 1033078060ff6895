"""The paper's baselines and the small leftovers ported beside them,
against the reference on the CPU.

- The optimizers on heterogeneous quadratics (node i minimizes
  ||x − c_i||²/2, the optimum is mean(c_i)): the reference's property
  tests (``tests/test_algorithms.py``) on the port, with fewer
  iterations.
- Topology: ``edge_key``, ``is_tree``, ``is_connected``,
  ``spectral_gap``, ``hierarchical_ring_edges`` and
  ``TimeVaryingTopology``, exactly equal.
- ``ood.sequence_confidence`` / ``auroc`` / ``select_id_subset``,
  ``distill.average_labels``, ``idkd.homogenization_round`` and the
  plain ``optim.sgd`` optimizers on numpy-seeded inputs, to 1e-6.
- The simulator's wiring: ``centralized`` gossips on the complete graph
  over the reference's IID partition (bit for bit); ``relaysgd`` on a
  ring raises in both packages; tiny runs of each new method end with
  finite losses.
- The LM launch path: ``run_training`` and ``make_train_step`` refuse
  ``relaysgd`` as the reference does (no topology reaches the
  algorithm); one D² ``make_train_step`` step on a reduced Qwen3 against
  the reference's (1e-5); ``driver_mode="scan"`` and ``"host"`` give the
  same run.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import IDKDConfig as JIDKD
from repro.configs.base import TrainConfig as JTrain
from repro.configs.resnet20_cifar import SMALL_CONFIG as J_SMALL
from repro.core import distill as jdistill
from repro.core import idkd as jidkd
from repro.core import ood as jood
from repro.core import topology as jtopo
from repro.core.simulator import DecentralizedSimulator as JSim
from repro.data.synthetic import make_classification_data as j_data
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import run_training as j_run_training
from repro.models import build_model as j_build
from repro.optim import sgd as jsgd
import repro_torch.configs as tconfigs
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG as T_SMALL
from repro_torch.core import distill as tdistill
from repro_torch.core import idkd as tidkd
from repro_torch.core import ood as tood
from repro_torch.core import topology as ttopo
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.mixing import make_dense_mixer
from repro_torch.core.simulator import DecentralizedSimulator as TSim
from repro_torch.data.synthetic import make_classification_data as t_data
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import run_training
from repro_torch.models.convert import to_jax_lm_params
from repro_torch.models.transformer import DecoderModel
from repro_torch.optim import sgd as tsgd

from test_torch_common import leaves, t

torch.set_num_threads(1)

ATOL = 1e-6

# ------------------------------------------------- quadratics (port only)
N, DIM = 8, 4


def _targets(seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(N, DIM)) * 2,
                           dtype=torch.float32)


def _ring_mix():
    return make_dense_mixer(ttopo.Topology.make("ring", N).mixing_matrix(),
                            device="cpu")


def _run(name, mix, targets, lr, steps=1500, topology=None):
    algo = make_algorithm(name, topology=topology, momentum=0.9,
                          weight_decay=0.0)
    params = {"x": torch.zeros(N, DIM)}
    state = algo.init(params)
    for _ in range(steps):
        grads = {"x": params["x"] - targets}
        params, state = algo.step(params, grads, state, lr, mix)
    return params["x"].numpy().copy()


def _mix_for(name):
    return (make_dense_mixer(np.full((N, N), 1.0 / N), device="cpu")
            if name == "centralized" else _ring_mix())


@pytest.mark.parametrize("name,lr", [("dsgd", 0.05), ("dsgdm", 0.05),
                                     ("qg-dsgdm-n", 0.02), ("d2", 0.05),
                                     ("centralized", 0.05),
                                     ("gradient-tracking", 0.05)])
def test_mean_iterate_reaches_global_optimum(name, lr):
    """Every method's node average reaches the global optimum."""
    targets = _targets()
    x = _run(name, _mix_for(name), targets, lr)
    opt = targets.numpy().mean(0)
    assert np.abs(x.mean(0) - opt).max() < 0.15, f"{name} biased mean"


@pytest.mark.parametrize("name", ["qg-dsgdm-n", "d2", "centralized",
                                  "gradient-tracking"])
def test_bias_corrected_methods_reach_consensus(name):
    """The bias-corrected methods remove the heterogeneity spread that
    plain DSGD keeps at a constant lr."""
    lr = 0.02 if name == "qg-dsgdm-n" else 0.05
    x = _run(name, _mix_for(name), _targets(), lr)
    assert np.abs(x - x.mean(0)).max() < 0.15, f"{name} no consensus"


def test_dsgd_heterogeneity_spread_shrinks_with_lr():
    """DSGD's consensus spread is O(lr): a fifth of the lr shrinks it by
    more than half."""
    targets, mix = _targets(), _ring_mix()
    hi = _run("dsgd", mix, targets, 0.05)
    lo = _run("dsgd", mix, targets, 0.01, steps=3000)
    assert np.abs(lo - lo.mean(0)).max() < 0.5 * np.abs(
        hi - hi.mean(0)).max()


def test_qgm_beats_dsgd_on_consensus():
    targets, mix = _targets(seed=7), _ring_mix()
    x_dsgd = _run("dsgd", mix, targets, 0.05)
    x_qgm = _run("qg-dsgdm-n", mix, targets, 0.02)
    assert np.abs(x_qgm - x_qgm.mean(0)).max() < \
        np.abs(x_dsgd - x_dsgd.mean(0)).max()


def test_relaysgd_on_chain():
    """RelaySGD on a chain reaches consensus at the global optimum, with
    no mixer (its messages are the gossip)."""
    targets = _targets()
    x = _run("relaysgd", None, targets, 0.05,
             topology=ttopo.Topology.make("chain", N))
    opt = targets.numpy().mean(0)
    assert np.abs(x - x.mean(0)).max() < 0.2
    assert np.abs(x.mean(0) - opt).max() < 0.2


def test_registry_names_and_errors_match_reference():
    """Every name of the reference's registry resolves to the same
    algorithm; relaysgd raises the reference's errors without a topology
    and on a graph that is not a tree."""
    from repro.core.algorithms import make_algorithm as j_make
    chain = ttopo.Topology.make("chain", 4)
    jchain = jtopo.Topology.make("chain", 4)
    for name in ("centralized", "dsgd", "dsgdm", "qg-dsgdm-n", "qgm", "d2",
                 "gradient-tracking", "gt", "relaysgd"):
        got = make_algorithm(name, topology=chain)
        want = j_make(name, topology=jchain)
        assert (got.name, got.needs_topology) == (want.name,
                                                  want.needs_topology)
    for kw in ({}, {"topology": ttopo.Topology.make("ring", 4)}):
        jkw = {k: jtopo.Topology.make("ring", 4) for k in kw}
        with pytest.raises(ValueError) as want:
            j_make("relaysgd", **jkw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            make_algorithm("relaysgd", **kw)
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_algorithm("adam")


# ----------------------------------------------------------------- topology
@pytest.mark.parametrize("kind,n", [("ring", 8), ("chain", 6), ("full", 5),
                                    ("torus", 9), ("exponential", 16),
                                    ("social", 15)])
def test_topology_leftovers_equal_reference(kind, n):
    got, want = ttopo.Topology.make(kind, n), jtopo.Topology.make(kind, n)
    assert got.edge_key() == want.edge_key()
    assert got.edge_key() is got.edge_key()          # cached
    assert got.is_tree() == want.is_tree()
    assert got.is_connected() == want.is_connected()
    assert got.spectral_gap() == want.spectral_gap()


def test_disconnected_and_hierarchical_topologies_equal_reference():
    edges = [(0, 1), (2, 3)]
    got, want = ttopo.Topology(4, edges), jtopo.Topology(4, edges)
    assert (got.is_connected(), got.is_tree()) == (
        want.is_connected(), want.is_tree()) == (False, False)
    for pods, per in ((2, 4), (3, 5), (4, 2), (1, 6)):
        assert ttopo.hierarchical_ring_edges(pods, per) == \
            jtopo.hierarchical_ring_edges(pods, per)
        edges = ttopo.hierarchical_ring_edges(pods, per)
        g = ttopo.Topology(pods * per, edges)
        w = jtopo.Topology(pods * per, edges)
        np.testing.assert_array_equal(g.mixing_matrix(), w.mixing_matrix())
        assert g.spectral_gap() == w.spectral_gap()


@pytest.mark.parametrize("n", [5, 8, 16])
def test_time_varying_topology_equals_reference(n):
    got, want = ttopo.TimeVaryingTopology(n), jtopo.TimeVaryingTopology(n)
    assert got.num_rounds == want.num_rounds
    for step in range(7):
        assert got.round_topology(step).name == \
            want.round_topology(step).name
        assert got.round_topology(step).edge_key() == \
            want.round_topology(step).edge_key()
        np.testing.assert_array_equal(got.mixing_matrix(step),
                                      want.mixing_matrix(step))


# ------------------------------------------------- OoD, distill, idkd, optim
def test_ood_leftovers_match_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(6, 12, 40)) * 2).astype(np.float32)
    for temp in (1.0, 2.5):
        np.testing.assert_allclose(
            tood.sequence_confidence(t(logits), temp).numpy(),
            np.asarray(jood.sequence_confidence(logits, temp)), atol=ATOL)
    idc = rng.normal(1.0, 1.0, size=300).astype(np.float32)
    oodc = rng.normal(0.0, 1.0, size=200).astype(np.float32)
    for nt in (64, 512):
        assert float(tood.auroc(t(idc), t(oodc), nt)) == pytest.approx(
            float(jood.auroc(idc, oodc, nt)), abs=ATOL)
    conf = rng.uniform(size=(4, 50)).astype(np.float32)
    thr = rng.uniform(size=(4, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        tood.select_id_subset(t(conf), t(thr)).numpy(),
        np.asarray(jood.select_id_subset(conf, thr)))


def test_average_labels_matches_reference():
    rng = np.random.default_rng(4)
    stack = rng.dirichlet(np.ones(10), size=(5, 30)).astype(np.float32)
    mask = rng.uniform(size=(5, 30)) < 0.4
    mask[:, 0] = False                          # a sample nobody kept
    avg, anym = tdistill.average_labels(t(stack), t(mask))
    javg, jany = jdistill.average_labels(stack, mask)
    np.testing.assert_allclose(avg.numpy(), np.asarray(javg), atol=ATOL)
    np.testing.assert_array_equal(anym.numpy(), np.asarray(jany))


@pytest.mark.parametrize("cal", [False, True])
def test_homogenization_round_matches_reference(cal):
    """The paper-named round on the dense backend, D_C = D_P or its own
    calibration logits."""
    rng = np.random.default_rng(5)
    n, P, V, K, C = 4, 40, 16, 24, 10
    pub = (rng.normal(size=(n, P, C)) * 2).astype(np.float32)
    val = (rng.normal(size=(n, V, C)) * 3).astype(np.float32)
    cal_logits = ((rng.normal(size=(n, K, C))).astype(np.float32)
                  if cal else None)
    kw = dict(temperature=4.0)
    got = tidkd.homogenization_round(
        t(pub), t(val), None if cal_logits is None else t(cal_logits),
        ttopo.Topology.make("ring", n), TIDKD(**kw))
    want = jidkd.homogenization_round(
        pub, val, cal_logits, jtopo.Topology.make("ring", n), JIDKD(**kw))
    for name in ("labels", "weights", "thresholds"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.id_masks.numpy(),
                                  np.asarray(want.id_masks))


@pytest.mark.parametrize("nesterov,wd", [(False, 0.0), (True, 1e-3)])
def test_sgd_matches_reference(nesterov, wd):
    rng = np.random.default_rng(6)
    shapes = {"w": (4, 5), "b": (5,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tp, jp = {k: t(v) for k, v in p.items()}, dict(p)
    ts, js = tsgd.sgd_init(tp), jsgd.sgd_init(jp)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        tp, ts = tsgd.sgd_update(tp, {k: t(v) for k, v in g.items()}, ts,
                                 0.1, weight_decay=wd, nesterov=nesterov)
        jp, js = jsgd.sgd_update(jp, g, js, 0.1, weight_decay=wd,
                                 nesterov=nesterov)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL)
        np.testing.assert_allclose(ts.momentum[k].numpy(),
                                   np.asarray(js.momentum[k]), atol=ATOL)


def test_adamw_matches_reference():
    rng = np.random.default_rng(7)
    shapes = {"w": (4, 5), "b": (5,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tp, jp = {k: t(v) for k, v in p.items()}, dict(p)
    ts, js = tsgd.adamw_init(tp), jsgd.adamw_init(jp)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        tp, ts = tsgd.adamw_update(tp, {k: t(v) for k, v in g.items()}, ts,
                                   1e-2)
        jp, js = jsgd.adamw_update(jp, g, js, 1e-2)
    assert ts.t == int(js.t) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   atol=ATOL)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   atol=ATOL)


# ---------------------------------------------------------------- simulator
def _data(pkg):
    make = j_data if pkg == "jax" else t_data
    return make(image_size=8, n_train=96, n_val=16, n_test=32, seed=0)


def test_centralized_simulator_takes_the_references_iid_split():
    """centralized gossips on the complete graph and trains on the
    reference's IID partition, bit for bit; the other algorithms keep
    the Dirichlet partition and the run topology."""
    for algo in ("centralized", "d2"):
        kw = dict(algorithm=algo, num_nodes=4, topology="ring", seed=3)
        got = TSim(T_SMALL.replace(image_size=8), TTrain(**kw), _data("torch"),
                   device="cpu")
        want = JSim(J_SMALL.replace(image_size=8), JTrain(**kw),
                    _data("jax"))
        assert len(got.parts) == len(want.parts) == 4
        for a, b in zip(got.parts, want.parts):
            np.testing.assert_array_equal(a, b)
        assert got.gossip_topo.name == want.gossip_topo.name == (
            "full4" if algo == "centralized" else "ring4")
        assert got.topology.name == "ring4"
        np.testing.assert_array_equal(
            got.gossip_topo.mixing_matrix(), want.gossip_topo.mixing_matrix())


def test_relaysgd_simulator_on_a_ring_raises_as_the_reference():
    kw = dict(algorithm="relaysgd", num_nodes=4, topology="ring")
    with pytest.raises(ValueError) as want:
        JSim(J_SMALL.replace(image_size=8), JTrain(**kw), _data("jax"))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        TSim(T_SMALL.replace(image_size=8), TTrain(**kw), _data("torch"),
             device="cpu")


@pytest.mark.parametrize("algo,topo", [("centralized", "ring"),
                                       ("d2", "ring"),
                                       ("gradient-tracking", "ring"),
                                       ("relaysgd", "chain")])
def test_new_methods_run_the_simulator(algo, topo):
    """Six steps of each new method (ResNet-8 at 8 × 8, 4 nodes), every
    eval finite; centralized keeps its identical nodes together."""
    tcfg = TTrain(algorithm=algo, topology=topo, num_nodes=4, steps=6,
                  batch_size=4, lr=0.1, weight_decay=5e-4)
    sim = TSim(T_SMALL.replace(image_size=8), tcfg, _data("torch"),
               eval_every=3, eval_batches=1, device="cpu")
    r = sim.run()
    assert len(r.loss_history) == 3
    assert np.all(np.isfinite(r.loss_history))
    assert all(bool(torch.isfinite(v).all()) for v in r.params.values())
    if algo == "centralized":
        assert max(r.consensus_history) <= 1e-5


# ----------------------------------------------------------- LM launch path
def _qwen3(side):
    get = jconfigs.get_config if side == "jax" else tconfigs.get_config
    return get("qwen3-1.7b").reduced().replace(num_layers=1)


def test_lm_path_refuses_relaysgd_as_the_reference():
    """No topology reaches the LM path's algorithm, so relaysgd raises
    there in both packages."""
    kw = dict(algorithm="relaysgd", num_nodes=2, steps=2)
    with pytest.raises(ValueError) as want:
        j_run_training(_qwen3("jax"), JTrain(**kw), verbose=False)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        run_training(_qwen3("torch"), TTrain(**kw), verbose=False,
                     device="cpu")
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        make_train_step(DecoderModel(_qwen3("torch")), TTrain(**kw), 2,
                        device="cpu")


def test_d2_train_step_matches_reference():
    """Two D² make_train_step steps (the first-step branch, then
    2x − x_prev) on a one-layer reduced Qwen3, 2 ring nodes, from the
    same perturbed params and batches: losses, params and state."""
    n = 2
    model = DecoderModel(_qwen3("torch"))
    rng = np.random.default_rng(11)
    params = {k: torch.stack([v + torch.as_tensor(
        0.05 * rng.normal(size=v.shape), dtype=v.dtype) for _ in range(n)])
        for k, v in model.init(0, "cpu").items()}
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(params))
    kw = dict(algorithm="d2", num_nodes=n, lr=0.1, batch_size=2)
    jmake = j_make_train_step(j_build(_qwen3("jax")), JTrain(**kw), n)
    jstep = jax.jit(jmake)
    step = make_train_step(model, TTrain(**kw), n, device="cpu")
    jopt, opt = jmake.init_opt(jparams), step.init_opt(params)
    fast = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for s in range(2):
            seq = rng.integers(0, model.cfg.vocab_size, size=(n, 2, 17))
            batch = {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
            jparams, jopt, jm = jstep(
                jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
                0.1)
            params, opt, m = step(params, opt,
                                  {k: t(v) for k, v in batch.items()}, 0.1)
            assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                     rel=1e-5)
            for name, got, want in (("params", params, jparams),
                                    ("prev_x", opt["prev_x"], jopt["prev_x"]),
                                    ("prev_g", opt["prev_g"],
                                     jopt["prev_g"])):
                for k, v in leaves(jax.tree.map(np.asarray, want)).items():
                    np.testing.assert_allclose(
                        got[k].numpy(), v, atol=1e-5,
                        err_msg=f"step {s} {name} {k}")
            assert opt["t"] == int(jopt["t"]) == s + 1
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)


def test_scan_and_host_drivers_give_the_same_run():
    """driver_mode "scan" (the default, as the reference's) and "host"
    run the same loop: the same losses and params, exactly."""
    cfg = _qwen3("torch")
    tcfg = TTrain(algorithm="gradient-tracking", num_nodes=2, steps=3,
                  batch_size=2, lr=0.1,
                  idkd=TIDKD(label_topk=4, start_step=1, num_rounds=1,
                             label_backend="sparse", stream_microbatch=3))
    runs = [run_training(cfg, tcfg, seq_len=16, n_seqs=32, n_public=6,
                         log_every=1, use_idkd=True, verbose=False,
                         device="cpu", **kw)
            for kw in ({}, {"driver_mode": "host"})]
    assert runs[0]["loss_history"] == runs[1]["loss_history"]
    assert len(runs[0]["loss_history"]) == 3
    for k, v in runs[0]["params"].items():
        assert torch.equal(v, runs[1]["params"][k]), k
    # the sharded driver runs (tests/test_torch_shard.py) but refuses an
    # f32 wire before any training, as the reference does
    with pytest.raises(ValueError, match="storage dtype"):
        run_training(cfg, tcfg, driver_mode="shard", wire_dtype="float32",
                     device="cpu")
    with pytest.raises(ValueError, match="unknown driver mode"):
        run_training(cfg, tcfg, driver_mode="graph", device="cpu")


def test_scan_driver_runs_the_simulator_as_host():
    tcfg = TTrain(algorithm="d2", num_nodes=4, steps=4, batch_size=4,
                  lr=0.1)
    runs = [TSim(T_SMALL.replace(image_size=8), tcfg, _data("torch"),
                 eval_every=2, eval_batches=1, device="cpu",
                 driver_mode=mode).run() for mode in ("scan", "host")]
    assert runs[0].loss_history == runs[1].loss_history
    for k, v in runs[0].params.items():
        assert torch.equal(v, runs[1].params[k]), k

