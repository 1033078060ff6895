"""The sharded driver (``driver_mode="shard"``) on gloo ranks of the CPU,
and ``head_select``'s ``raw_stats`` mode.

One spawn of two ranks (``tests/torch_shard_ranks.py``, through
``launch.dist.spawn`` with a ``file://`` store under ``tmp_path``) runs
every sharded case; this process holds the results to the port's
node-stacked runs on the same params and draws, and the rounds also to
the reference's ``shard_label_round`` on its one-device mesh. Tolerances:
the sharded mix and the global sums add in another order than the
node-stacked ones, so f32 values agree to 1e-5 (the rounds' exchanges
only concatenate and scale: 1e-6), indices, masks, thresholds and
payload widths exactly."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import IDKDConfig as JIDKD
from repro.core import labeling as jlab
from repro.core.topology import Topology as JTopology
from repro.kernels.head_select.kernel import head_select_pallas
from repro.kernels.head_select.ref import (head_select_ref,
                                           head_select_stats_ref,
                                           merge_head_stats)
from repro.launch.mesh import make_node_mesh as j_node_mesh
from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.core import driver, labeling
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.mixing import make_mixer
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.core.topology import Topology
from repro_torch.data.synthetic import make_classification_data
from repro_torch.kernels.head_select import (head_select,
                                             merge_head_stats_plain)
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_node_mesh
from repro_torch.launch.train import run_training
from repro_torch.models.resnet import build_model
from repro_torch.obs.metrics import init_node_metrics
from repro_torch.resil.guards import init_node_guard
from repro_torch.sched import (ChurnEvent, FaultEvent, RewireEvent,
                               compile_schedule, validate_shard_schedule)

import torch_shard_ranks as R

torch.set_num_threads(1)
NEG = -1e30


# ------------------------------------------------- raw_stats (no spawn)
@pytest.mark.parametrize("C,S,k", [(9, 4, 4)])   # the last slice all padding
def test_head_select_raw_stats_matches_pallas_and_stats_ref(C, S, k):
    """Each vocabulary slice's raw carry, cut as the vocab-sharded round
    cuts it (C padded to S slices, padded columns NEG-biased), against
    the Pallas kernel's raw_stats mode (interpret) and
    head_select_stats_ref: m, z and the top-k logits to 1e-5, indices
    equal wherever the slot holds a real logit (padding slots are
    unspecified and never win the merge). The port's merge against
    merge_head_stats and the unsharded head_select_ref."""
    rng = np.random.default_rng(C * 7 + S)
    h = rng.normal(size=(12, 16)).astype(np.float32)
    w = (rng.normal(size=(16, C)) * 0.5).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    w_sh = -(-C // S)
    wp = np.pad(w, ((0, 0), (0, w_sh * S - C)))
    bp = np.pad(b, (0, w_sh * S - C), constant_values=NEG)
    k_loc = min(k, w_sh)                           # 3 < k
    mine, refs = [], []
    for j in range(S):
        wl, bl = wp[:, j * w_sh:(j + 1) * w_sh], bp[j * w_sh:(j + 1) * w_sh]
        m, z, tv, ti = head_select(torch.as_tensor(h)[None],
                                   torch.as_tensor(wl)[None],
                                   torch.as_tensor(bl)[None], k=k_loc,
                                   raw_stats=True)
        got = [x[0].numpy() for x in (m, z, tv, ti)]
        pal = head_select_pallas(jnp.asarray(h), jnp.asarray(wl),
                                 jnp.asarray(bl), temperature=5.0, k=k_loc,
                                 block_rows=4, block_c=4, interpret=True,
                                 raw_stats=True)
        ref = head_select_stats_ref(jnp.asarray(h), jnp.asarray(wl),
                                    jnp.asarray(bl), k=k_loc)
        for other in (pal, ref):
            o = [np.asarray(x) for x in other]
            np.testing.assert_allclose(got[0], o[0], atol=1e-5)
            np.testing.assert_allclose(got[1], o[1], rtol=1e-5)
            np.testing.assert_allclose(got[2], o[2], atol=1e-5)
            real = o[2] > NEG / 2
            np.testing.assert_array_equal(got[3][real], o[3][real])
        if j * w_sh >= C:                      # the all-padding slice
            np.testing.assert_array_equal(got[0], np.float32(NEG))
            np.testing.assert_array_equal(got[1], w_sh)
        got[3] = got[3] + j * w_sh
        mine.append(got)
        refs.append([np.asarray(x) for x in ref[:3]]
                    + [np.asarray(ref[3]) + j * w_sh])
    conf, vals, idx = merge_head_stats_plain(
        *[[torch.as_tensor(g[i]) for g in mine] for i in range(4)],
        temperature=5.0, k=k, detector="msp")
    rc, rv, ri = merge_head_stats(*[jnp.stack([r[i] for r in refs])
                                    for i in range(4)],
                                  temperature=5.0, k=k)
    uc, uv, ui = head_select_ref(jnp.asarray(h), jnp.asarray(w),
                                 jnp.asarray(b), temperature=5.0, k=k)
    for c, v, i in ((rc, rv, ri), (uc, uv, ui)):
        np.testing.assert_allclose(conf.numpy(), np.asarray(c), atol=1e-5)
        np.testing.assert_allclose(vals.numpy(), np.asarray(v), atol=1e-5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i))


# ------------------------------------------------ refusals (no spawn)
def test_shard_refusals_before_the_run():
    """validate_shard_schedule, the simulator, make_shard_step and
    run_training refuse what the sharded driver has no path for, before
    any training, as the reference does."""
    n = 4
    for events, msg in (((ChurnEvent(2, down=(1,)),), "churn"),
                        ((FaultEvent(2, "drop", (1,)),), "wire fault"),
                        ((RewireEvent(2, "torus"),), "ring/complete")):
        with pytest.raises(ValueError, match=msg):
            validate_shard_schedule(compile_schedule(8, 4, events=events),
                                    n)
    validate_shard_schedule(compile_schedule(8, 4, events=(
        FaultEvent(3, "crash"), RewireEvent(2, "full"))), n)
    with pytest.raises(ValueError, match="2-D"):
        validate_shard_schedule(compile_schedule(8, 4, events=(
            RewireEvent(2, "full"),)), n, model_parallel=2)
    data = make_classification_data(image_size=8, n_train=32, n_val=8,
                                    n_test=8)
    cfg = R.CFG
    for kw, tk, msg in (
            ({}, dict(topology="torus"), "ring/complete"),
            ({"kd_mode": "idkd", "public_x": data.test_x},
             dict(idkd=IDKDConfig(label_backend="dense")), "top-k"),
            # a chain of two is a ring (and a tree)
            ({}, dict(algorithm="relaysgd", topology="chain", num_nodes=2),
             "per-edge state")):
        with pytest.raises(ValueError, match=msg):
            DecentralizedSimulator(cfg, TrainConfig(**{"num_nodes": n, **tk}),
                                   data, driver_mode="shard", device="cpu",
                                   **kw)
    with pytest.raises(ValueError, match="needs driver_mode='shard'"):
        DecentralizedSimulator(cfg, TrainConfig(num_nodes=n), data,
                               model_parallel=2, device="cpu")
    mesh = make_node_mesh(n)
    model, topo = build_model(cfg), Topology.make("ring", n)
    with pytest.raises(ValueError, match="per-edge state"):
        driver.make_shard_step(model, make_algorithm(
            "relaysgd", topology=Topology.make("chain", n)),
            driver.classification_adapter, mesh=mesh, topology=topo)
    with pytest.raises(ValueError, match="ring gossip"):
        driver.make_shard_step(model, make_algorithm("dsgd"),
                               driver.classification_adapter, mesh=mesh,
                               topology=Topology.make("torus", n))
    # stragglers have no sharded path (a churn event, refused before the
    # run), nor do compressed wires on other graphs, as in the reference
    with pytest.raises(ValueError, match="churn"):
        validate_shard_schedule(compile_schedule(8, 4, events=(
            ChurnEvent(2, down=(1,), mode="stale"),), gossip="delayed"), n)
    with pytest.raises(ValueError, match="ring or complete"):
        driver.make_shard_step(model, make_algorithm("dsgd"),
                               driver.classification_adapter, mesh=mesh,
                               topology=Topology.make("torus", n),
                               compression="topk")
    assert driver.make_shard_step(model, make_algorithm("dsgd"),
                                  driver.classification_adapter, mesh=mesh,
                                  topology=topo, gossip="delayed").comm
    hcfg, tcfg, kw = R.train_args()
    with pytest.raises(ValueError, match="storage dtype"):
        run_training(hcfg, tcfg, driver_mode="shard", wire_dtype="float32",
                     **kw)


# ------------------------------------------- the spawn and its checks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("shard_store")
    snaps = tmp_path_factory.mktemp("shard_snapshots")
    out = dist.spawn(R.rank_main, 2, str(snaps), device="cpu",
                     store_dir=str(store))
    out[0]["snapshot_steps"] = [{name: o["snapshots"][name]["steps"]
                                 for name, _ in R.SNAP_CASES} for o in out]
    return out[0]


def _stacked_steps(algo_name, topo_name, comp=None, gossip="sync"):
    model = build_model(R.CFG)
    topo = Topology.make(topo_name, R.N)
    algo = make_algorithm(algo_name, weight_decay=1e-4)
    mixer = make_mixer(topo, "dense", device="cpu", compression=comp,
                       gossip=gossip)
    steps = [driver.make_step(model, algo, mixer, a, telemetry=True,
                              guard=R.GUARD) for a in R.adapters()]
    p = R.params()
    opt = algo.init(p)
    carries = [init_node_metrics(R.N, "cpu"), init_node_guard(R.N, "cpu")]
    if steps[0].comm:
        carries.insert(0, steps[0].init_comm(p))
    losses = []
    for s, batch in enumerate(R.batches()):
        step = steps[0 if s < R.PLAIN_STEPS else 1]
        p, opt, loss, *carries = step(p, opt, batch, R.LR, *carries)
        losses.append(float(loss))
    return p, losses, carries[-2:]


@pytest.mark.parametrize("case", R.STEP_CASES, ids=[c[0] for c in R.STEP_CASES])
def test_shard_step_matches_node_stacked(ranks, case):
    """make_shard_step on 2 node ranks, and on 1 node x 2 model ranks
    (model-sharded convs and head, replicated norms): plain and sparse-KD
    steps, with the metrics and guard carries — and with compressed and
    delayed gossip, whose comm state the ranks cut from the global
    params' (on 1 x 2 compressed through the model-sharded adapter,
    whose EF residual reads 0 as the reference's) — against make_step
    on the
    node-stacked params with the same batches."""
    name, mp, algo_name, topo_name, comp, gossip = case
    got = ranks["steps"][name]
    p, losses, carries = _stacked_steps(algo_name, topo_name, comp, gossip)
    if mp > 1 and comp is not None:
        assert not got["carries"][0]["ef_sq"].any()
        got["carries"][0]["ef_sq"] = carries[0]["ef_sq"]
    elif comp is not None or gossip != "sync":
        assert carries[0]["ef_sq"].any()
    for k, v in p.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    for mine, ref in zip(got["carries"], carries):
        for k, v in mine.items():
            if v.dtype == torch.int32:
                np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), k)
            else:
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(),
                                           rtol=1e-5, atol=1e-7, err_msg=k)


def _hom_arrays(hom, C):
    labels, w, mask, thr = hom
    return (labeling.SparseHomogenizedSet(labels, w, mask, thr)
            .densify(C).numpy(), w.numpy(), mask.numpy(), thr.numpy(),
            labels.values.shape[-1])


@pytest.mark.parametrize("topo_name", ["ring", "full"])
def test_shard_label_round_matches_reference_and_stacked(ranks, topo_name):
    """shard_label_round on 2 ranks against the port's node-stacked
    sparse round and, on the ring, the reference's on its one-device
    mesh: masks, thresholds and payload widths equal, payloads equal
    once densified."""
    inp = R.round_inputs()
    C = R.CFG.num_classes
    got = _hom_arrays(ranks["rounds"][f"oneshot-{topo_name}"], C)
    stacked = labeling.label_round(inp["pub_logits"], inp["val_logits"],
                                   None, Topology.make(topo_name, R.N),
                                   R.ROUND_CFG, backend="sparse")
    others = [_hom_arrays(tuple(stacked), C)]
    if topo_name == "ring":          # one shard_map compile of the reference
        ref = jlab.shard_label_round(
            jnp.asarray(inp["pub_logits"].numpy()),
            jnp.asarray(inp["val_logits"].numpy()),
            JTopology.make(topo_name, R.N),
            JIDKD(temperature=10.0, label_backend="sparse", label_topk=8),
            mesh=j_node_mesh(R.N))
        others.append((np.asarray(jlab.SparseHomogenizedSet(*ref)
                                  .densify(C)),
                       np.asarray(ref.weights), np.asarray(ref.id_masks),
                       np.asarray(ref.thresholds),
                       ref.labels.values.shape[-1]))
    for other in others:
        np.testing.assert_allclose(got[0], other[0], atol=1e-6)
        np.testing.assert_array_equal(got[1], other[1])
        np.testing.assert_array_equal(got[2], other[2])
        np.testing.assert_allclose(got[3], other[3], atol=1e-6)
        assert got[4] == other[4]


@pytest.mark.parametrize("mp", [1, 2])
def test_shard_streaming_round_matches_stacked(ranks, mp):
    """shard_streaming_label_round on 2 node ranks and, vocab-sharded
    (head_select raw_stats, C = 9 in two 5-wide slices), on 1 node x 2
    model ranks, against the node-stacked streaming round."""
    inp = R.round_inputs()
    C = R.CFG.num_classes
    got = _hom_arrays(ranks["rounds"][f"stream-{mp}d"], C)
    ref = labeling.streaming_label_round(
        build_model(R.CFG), R.params(), inp["pub_x"], inp["val_x"],
        Topology.make("ring", R.N), R.ROUND_CFG)
    ref = _hom_arrays(tuple(ref), C)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[3], ref[3], atol=1e-6)
    assert got[4] == ref[4]


def test_shard_run_training_matches_node_stacked(ranks):
    """run_training(driver_mode="shard", model_parallel=2) on a reduced
    f32 Hymba (4 steps, a round at step 2 through the vocab-sharded
    head pass) against the node-stacked run_training."""
    cfg, tcfg, kw = R.train_args()
    ref = run_training(cfg, tcfg, **kw)
    got = ranks["train"]
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"],
                               rtol=1e-5)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
    for k in ("thresholds", "selected"):
        np.testing.assert_allclose(got["last_round"][k],
                                   ref["last_round"][k], atol=1e-6)


def _mixer_steps(topo_name, comp, gossip):
    """The node-stacked stateful mixer's MIXER_STEPS steps (the dense
    backend) on the trees the ranks mix."""
    mix = make_mixer(Topology.make(topo_name, R.N), "dense", device="cpu",
                     compression=comp, gossip=gossip)
    comm = mix.init_state(R.gossip_tree(1))
    ys = []
    for x in R.gossip_inputs():
        bound = mix.bind(comm)
        ys.append(bound(x))
        comm = bound.finalize()
    return ys, comm["prev" if comp is None else "hat"]


def _jax_shard_twin(topo_name, comp, gossip):
    """The reference's make_compressed_ppermute_mixer under shard_map on
    its one-device mesh, MIXER_STEPS steps."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh

    from repro.core import mixing as jm
    from repro.launch.sharding import node_stacked_specs
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("node",))
    mp = jm.make_mixer(JTopology.make(topo_name, R.N), "ppermute",
                       compression=comp, gossip=gossip, stateful=True,
                       axis_names=("node",), axis_sizes=(1,),
                       local_nodes=R.N)
    tree = {k: jnp.asarray(v.numpy()) for k, v in R.gossip_tree(1).items()}
    comm = mp.init_state(tree)

    def body(x, c):
        b = mp.bind(c)
        return b(x), b.finalize()

    sx = node_stacked_specs(tree, R.N, "node")
    sc = node_stacked_specs(comm, R.N, "node")
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(sx, sc),
                          out_specs=(sx, sc), check_rep=False))
    ys = []
    for x in R.gossip_inputs():
        y, comm = f({k: jnp.asarray(v.numpy()) for k, v in x.items()},
                    comm)
        ys.append(y)
    return ys, comm["prev" if comp is None else "hat"]


# the reference's shard_map twin compiles once a case: two of them
_JAX_TWIN = {"ring-topk-delayed", "full-topk-sync"}


@pytest.mark.parametrize("case", R.MIXER_CASES,
                         ids=[c[0] for c in R.MIXER_CASES])
def test_shard_compressed_mixer_matches_stacked_and_reference(ranks, case):
    """The stateful sharded mixer on 2 node ranks — top-k and random-k,
    sync and delayed, on the ring (boundary payload rows into the
    neighbours' replicas) and the complete graph (the payloads gathered
    into the replicated sum), and uncompressed delayed — against the
    port's node-stacked stateful mixer over MIXER_STEPS steps (random-k
    from the same generator state: the ranks draw every node's uniforms
    and keep their rows) and, for two cases, the reference's
    make_compressed_ppermute_mixer on its one-device mesh: every step's
    mixed tree and the final estimates within 1e-5."""
    name, topo_name, comp, gossip = case
    got = ranks["mixers"][name]
    others = [_mixer_steps(topo_name, comp, gossip)]
    if name in _JAX_TWIN:
        others.append(_jax_shard_twin(topo_name, comp, gossip))
    for ys, state in others:
        for s, (gy, wy) in enumerate(zip(got["ys"], ys)):
            for k in gy:
                np.testing.assert_allclose(gy[k].numpy(), np.asarray(wy[k]),
                                           atol=1e-5, err_msg=f"{s} {k}")
        for k in state:
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       np.asarray(state[k]), atol=1e-5,
                                       err_msg=k)


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _close(a, b, atol=1e-5):
    for k, v in b.items():
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", [c[0] for c in R.SNAP_CASES])
def test_shard_snapshot_resume_matches_uninterrupted(ranks, name, tmp_path):
    """Durable snapshots under the sharded driver (2 gloo ranks, the
    ResNet simulator, a crash after the snapshot at step 7): resumed, the
    run is the uninterrupted sharded run bit for bit (with top-k gossip
    too: x̂ rides the snapshot, the ring replicas are rebuilt from it);
    rank 0 picks the step past a cut-short newer file and every rank
    resumes from it; one file serves both drivers — the sharded run's
    snapshot resumes a node-stacked run, a node-stacked run's snapshot
    resumes the sharded run, within the drivers' 1e-5 (uncompressed;
    top-k runs that differ by rounding may part at a near-tie, so that
    case checks the resume step and finite params)."""
    got = ranks["snapshots"][name]
    comp = dict(R.SNAP_CASES)[name]
    assert got["crashed"]
    last = R.SNAP_CRASH - 1
    for steps in ranks["snapshot_steps"]:
        assert steps[name] == (last, last, last)
    assert _same(got["resumed"], got["base"])
    assert _same(got["from_cut"], got["base"])
    # the sharded run's snapshot resumes a node-stacked run
    stacked = R.snapshot_sim("scan", comp)
    shutil.copytree(got["dir"], tmp_path / "mid")
    res, step = R._resumed_from(stacked, tmp_path / "mid")
    assert step == last
    if comp is None:
        _close(res.params, got["base"])
        _close(got["from_stacked"], got["base"])
        ref = stacked.run(R.snapshot_schedule(False))
        _close(res.params, ref.params)
    else:
        assert all(torch.isfinite(v).all() for v in res.params.values())
        assert all(torch.isfinite(v).all()
                   for v in got["from_stacked"].values())
