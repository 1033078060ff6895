"""The port's train step against the reference's, replayed: both sides
start from the same converted weights and take the same batches, built
from index draws made with numpy (JAX's threefry and torch's Philox
draw different numbers, so the samplers are not compared, the steps
are). Plain classification and sparse-KD adapters, QG-DSGDm-N over the
dense ring mixer, 5 steps each, on a two-block ResNet and at ResNet-20's
depth (stages (3, 3, 3), nine blocks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet20_cifar import CONFIG as J_RESNET20
from repro.configs.resnet20_cifar import SMALL_CONFIG as J_SMALL
from repro.core import driver as jdriver
from repro.core.algorithms import make_algorithm as j_make_algorithm
from repro.core.mixing import make_mixer as j_make_mixer
from repro.core.topology import Topology as JTopology
from repro.models import build_model as j_build
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG as T_SMALL
from repro_torch.core import driver as tdriver
from repro_torch.core.algorithms import make_algorithm as t_make_algorithm
from repro_torch.core.mixing import make_mixer as t_make_mixer
from repro_torch.core.topology import Topology as TTopology
from repro_torch.data.synthetic import make_classification_data
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.models.resnet import build_model as t_build

from test_torch_common import assert_trees_close, resnet_tree, t

torch.set_num_threads(1)

# two residual blocks (one plain, one stride-2 with a projection) cover
# every layer kind of the ResNet at a third less JAX compile time
TWO_BLOCKS = (1, 1)

N_NODES, BATCH, STEPS, K = 4, 8, 5, 4


def _batch(kind, rng, data):
    idx = rng.integers(0, len(data.train_y), size=(N_NODES, BATCH))
    b = {"images": data.train_x[idx],
         "weights": (rng.random((N_NODES, BATCH)) > 0.2).astype(np.float32)}
    if kind == "plain":
        b["labels"] = np.eye(10, dtype=np.float32)[data.train_y[idx]]
        return b
    b["values"] = rng.dirichlet(np.ones(K), size=(N_NODES, BATCH)
                                ).astype(np.float32)
    b["indices"] = rng.integers(0, 10, size=(N_NODES, BATCH, K)
                                ).astype(np.int32)
    b["is_pub"] = rng.random((N_NODES, BATCH)) < 0.5
    return b


@pytest.mark.parametrize(
    "kind,stages",
    [("plain", TWO_BLOCKS), ("sparse_kd", TWO_BLOCKS),
     ("plain", J_RESNET20.cnn_stages), ("sparse_kd", J_RESNET20.cnn_stages)],
    ids=["plain", "sparse_kd", "plain-resnet20", "sparse_kd-resnet20"])
def test_replayed_steps_match_reference(kind, stages):
    """Step 1 to 1e-5 (losses and params); after 5 steps the params stay
    within 1e-4: the normalized updates amplify float rounding, and the
    two sides sum convolutions in another order. The resnet20 cases run
    all nine blocks of the paper's ResNet-20 (width 16, image 8 here) at
    the same tolerances."""
    jcfg = J_SMALL.replace(image_size=8, cnn_stages=stages)
    tcfg = T_SMALL.replace(image_size=8, cnn_stages=stages)
    data = make_classification_data(image_size=8, n_train=128, n_val=8,
                                    n_test=8, noise=1.6, seed=0)
    tree = resnet_tree(jcfg, seed=3, n=N_NODES)
    jt, tt = JTopology.make("ring", N_NODES), TTopology.make("ring", N_NODES)
    adapters = {"plain": (jdriver.classification_adapter,
                          tdriver.classification_adapter),
                "sparse_kd": (jdriver.sparse_kd_adapter(10.0, 0.7),
                              tdriver.sparse_kd_adapter(10.0, 0.7))}[kind]
    ja = j_make_algorithm("qg-dsgdm-n", topology=jt)
    ta = t_make_algorithm("qg-dsgdm-n", topology=tt)
    jstep = jax.jit(jdriver.make_step(
        j_build(jcfg), ja,
        j_make_mixer(jt, "dense", wire_dtype="float32"), adapters[0]))
    tstep = tdriver.make_step(
        t_build(tcfg), ta,
        t_make_mixer(tt, "dense", wire_dtype="float32", device="cpu"),
        adapters[1])

    jp = jax.tree.map(jnp.asarray, tree)
    jo = ja.init(jp)
    tp = from_jax_params(tree, device="cpu")
    to = ta.init(tp)
    rng = np.random.default_rng(11)
    for s in range(STEPS):
        b = _batch(kind, rng, data)
        lr = 0.5 if s < 3 else 0.05
        jp, jo, jl = jstep(jp, jo, jax.tree.map(jnp.asarray, b), lr)
        tp, to, tl = tstep(tp, to, {k: t(v) for k, v in b.items()}, lr)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5, abs=1e-6)
        if s == 0:
            assert_trees_close(to_jax_params(tp), jax.tree.map(np.asarray, jp),
                               atol=1e-5, rtol=1e-5)
    assert_trees_close(to_jax_params(tp), jax.tree.map(np.asarray, jp),
                       atol=1e-4, rtol=1e-4)
    assert_trees_close(to_jax_params(to["m"]),
                       jax.tree.map(np.asarray, jo["m"]), atol=1e-3,
                       rtol=1e-3)


def test_samplers_draw_from_partitions():
    """The port's on-device samplers: private draws stay inside each
    node's partition; KD batches merge private one-hots (k=1 sparse
    labels) with public top-k payloads at the D_ID rate."""
    data = make_classification_data(image_size=8, n_train=64, n_val=8,
                                    n_test=8, seed=1)
    parts = [np.arange(i * 16, i * 16 + 16) for i in range(4)]
    padded = tdriver.pad_partitions(parts, device="cpu")
    gen = torch.Generator().manual_seed(0)
    idx = tdriver.sample_partition(padded, gen, 32)
    for i in range(4):
        assert set(idx[i].tolist()) <= set(parts[i].tolist())
    tx, ty = t(data.train_x), t(data.train_y)
    plain = tdriver.make_classification_sampler(padded, tx, ty, 10, 8)(gen, 0)
    assert plain["images"].shape == (4, 8, 8, 8, 3)
    assert torch.equal(plain["labels"].sum(-1), torch.ones(4, 8))
    pub_x = torch.randn(20, 8, 8, 3)
    w = np.zeros((4, 20), np.float32)
    w[0, :10] = 1.0                      # node 0 holds 10 public rows
    vals = torch.full((4, 20, 3), 1 / 3)
    inds = torch.randint(0, 10, (4, 20, 3), dtype=torch.int32)
    ctx = tdriver.homogenized_ctx(w, (vals, inds), 20, device="cpu")
    assert ctx["pub_size"].tolist() == [10, 0, 0, 0]
    kd = tdriver.make_homogenized_sampler(padded, tx, ty, pub_x, 10, 64)
    b = kd(gen, 0, ctx)
    assert not b["is_pub"][1:].any() and b["is_pub"][0].any()
    priv = ~b["is_pub"]
    assert torch.equal(b["values"][priv][:, 0], torch.ones(int(priv.sum())))
    assert (b["values"][b["is_pub"]] == 1 / 3).all()
