"""Shared helpers of the port's parity tests, and the parity of the
port's numpy-only copies (configs, data, topology) with the reference.

Both sides get the same inputs, made from numpy seeds; arrays cross
between the frameworks as numpy.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import resnet20_cifar as jresnet_cfg
from repro.core.topology import Topology as JTopology
from repro.data import dirichlet as jdir
from repro.data import synthetic as jsyn
from repro_torch.configs import base as tbase
from repro_torch.configs import resnet20_cifar as tresnet_cfg
from repro_torch.core.topology import Topology as TTopology
from repro_torch.data import dirichlet as tdir
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)


# ------------------------------------------------------------------ helpers
def resnet_tree(cfg, seed: int, n: int = 0):
    """Random ResNet params in the reference's pytree layout (HWIO convs),
    made with numpy; EvoNorm and bias leaves are perturbed from their
    init so that every leaf matters. ``n`` > 0 adds a node axis with
    per-node differences."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, ci, co):
        return (rng.normal(size=(kh, kw, ci, co)) * np.sqrt(2.0 / (kh * kw * ci))
                ).astype(np.float32)

    def norm(c):
        return {"gamma": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
                "beta": (0.1 * rng.normal(size=c)).astype(np.float32),
                "v": (1 + 0.1 * rng.normal(size=c)).astype(np.float32)}

    w = cfg.cnn_width
    p = {"stem": conv(3, 3, cfg.image_channels, w), "stem_norm": norm(w)}
    cin = w
    for si, blocks in enumerate(cfg.cnn_stages):
        cout = w * 2 ** si
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"conv1": conv(3, 3, cin, cout), "norm1": norm(cout),
                   "conv2": conv(3, 3, cout, cout), "norm2": norm(cout)}
            if stride != 1 or cin != cout:
                blk["proj"] = conv(1, 1, cin, cout)
            p[f"s{si}b{bi}"] = blk
            cin = cout
    p["fc_w"] = (rng.normal(size=(cin, cfg.num_classes)) / np.sqrt(cin)
                 ).astype(np.float32)
    p["fc_b"] = (0.1 * rng.normal(size=cfg.num_classes)).astype(np.float32)
    if n:
        p = _map(lambda a: (a[None] * (1 + 0.05 * rng.normal(
            size=(n,) + (1,) * a.ndim))).astype(np.float32), p)
    return p


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def leaves(tree, prefix=""):
    """{path: array} of a nested tree, paths joined with '/'."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_trees_close(a, b, atol, rtol=0.0):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_allclose(la[k], lb[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def t(x, dtype=None):
    """numpy (or jax) array -> CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def hymba_small(side):
    """The reduced Hymba ("jax" or "torch" side) with what the stock
    ``reduced()`` drops: three layers, so layer 1 is windowed (layers 0
    and L-1 are global), and 2 KV heads for 4 query heads (GQA)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config as t_get_config
    get = j_get_config if side == "jax" else t_get_config
    return get("hymba-1.5b").reduced().replace(num_layers=3, num_kv_heads=2)


# ------------------------------------------------------- numpy-only copies
@pytest.mark.parametrize("cls", ["ModelConfig", "IDKDConfig", "TrainConfig",
                                 "MoEConfig", "MLAConfig", "SSMConfig"])
def test_config_fields_match_reference(cls):
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jbase, cls))]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tbase, cls))]
    assert jf == tf


def test_resnet_configs_match_reference():
    assert dataclasses.asdict(jresnet_cfg.CONFIG) == \
        dataclasses.asdict(tresnet_cfg.CONFIG)
    assert dataclasses.asdict(jresnet_cfg.SMALL_CONFIG) == \
        dataclasses.asdict(tresnet_cfg.SMALL_CONFIG)


@pytest.mark.parametrize("kind", ["aligned", "shifted", "noise"])
def test_data_copies_bitwise_equal(kind):
    kw = dict(image_size=8, n_train=128, n_val=16, n_test=32, noise=1.6,
              seed=3)
    jd, td = jsyn.make_classification_data(**kw), \
        tsyn.make_classification_data(**kw)
    for f in dataclasses.fields(jd):
        np.testing.assert_array_equal(getattr(jd, f.name),
                                      getattr(td, f.name))
    np.testing.assert_array_equal(
        jsyn.make_public_data(jd, n_public=64, kind=kind, seed=1),
        tsyn.make_public_data(td, n_public=64, kind=kind, seed=1))
    jp = jdir.dirichlet_partition(jd.train_y, 4, 0.1,
                                  np.random.default_rng(4))
    tp = tdir.dirichlet_partition(td.train_y, 4, 0.1,
                                  np.random.default_rng(4))
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jdir.partition_stats(jd.train_y, jp, 10),
                                  tdir.partition_stats(td.train_y, tp, 10))


@pytest.mark.parametrize("kind,n", [("ring", 16), ("ring", 2), ("chain", 5),
                                    ("full", 4), ("social", 15),
                                    ("torus", 9), ("exponential", 8)])
def test_topology_copy_exact(kind, n):
    jt, tt = JTopology.make(kind, n), TTopology.make(kind, n)
    assert jt.name == tt.name and jt.adj == tt.adj
    for include_self in (True, False):
        for a, b in zip(jt.neighbor_arrays(include_self),
                        tt.neighbor_arrays(include_self)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jt.mixing_matrix(), tt.mixing_matrix())
    active = np.arange(n) % 3 != 1
    np.testing.assert_array_equal(jt.mixing_matrix(active),
                                  tt.mixing_matrix(active))
