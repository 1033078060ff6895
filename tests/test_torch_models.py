"""The port's ResNet-EvoNorm against the reference on converted weights:
EvoNorm-S0, XLA's SAME padding at stride 2, logits, features and the
weight converter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet20_cifar import SMALL_CONFIG as J_SMALL
from repro.models import build_model as j_build
from repro.models.layers import evonorm_b0 as j_evonorm
from repro.models.resnet import _conv as j_conv
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG as T_SMALL
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.models.layers import evonorm_b0 as t_evonorm
from repro_torch.models.resnet import build_model as t_build
from repro_torch.models.resnet import conv_nodes

from test_torch_common import assert_trees_close, resnet_tree, t

torch.set_num_threads(1)


@pytest.mark.parametrize("c", [4, 16, 24])
def test_evonorm_s0_matches_reference(c):
    """Group std over (H, W, channels-in-group), population variance,
    groups = max(1, C // 8)."""
    rng = np.random.default_rng(c)
    x = rng.normal(size=(3, 5, 6, c)).astype(np.float32) * 2 + 0.5
    p = {"gamma": rng.normal(size=c).astype(np.float32),
         "beta": rng.normal(size=c).astype(np.float32),
         "v": rng.normal(size=c).astype(np.float32)}
    ref = j_evonorm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    out = t_evonorm(t(x), {k: t(v) for k, v in p.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (8, 3, 2), (7, 3, 2),
                                           (8, 1, 2), (8, 3, 1)])
def test_same_padding_matches_xla(size, k, stride):
    """XLA pads low = total // 2: a 3×3 stride-2 conv on 32×32 pads
    (0, 1), where PyTorch's symmetric padding=1 would shift every output
    by a pixel."""
    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    ref = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(w), stride))
    xt = t(x).permute(0, 3, 1, 2)                         # L = 1 node
    wt = t(w).permute(3, 2, 0, 1)[None]
    out = conv_nodes(xt, wt, stride).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_resnet_logits_match_reference():
    """Node-stacked logits and pre-head features from converted weights,
    every node with its own weights and images (1e-5)."""
    cfg_j, cfg_t = J_SMALL.replace(image_size=8), T_SMALL.replace(image_size=8)
    n = 3
    tree = resnet_tree(cfg_j, seed=0, n=n)
    x = np.random.default_rng(1).normal(size=(n, 5, 8, 8, 3)
                                        ).astype(np.float32)
    jm = j_build(cfg_j)
    fwd = jax.jit(jax.vmap(lambda p, xb: (
        jm.forward(p, {"images": xb})[0],
        jm.forward_features(p, {"images": xb})[0])))
    ref_logits, ref_feats = fwd(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x))
    tm = t_build(cfg_t)
    params = from_jax_params(tree, device="cpu")
    logits, _ = tm.forward(params, {"images": t(x)})
    feats, _ = tm.forward_features(params, {"images": t(x)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats),
                               atol=1e-5, rtol=1e-5)
    w, b = tm.head_params(params)
    assert w.shape == (n, cfg_t.cnn_width * 4, 10) and b.shape == (n, 10)


@pytest.mark.parametrize("n", [0, 2])
def test_convert_round_trip(n):
    """HWIO <-> OIHW, with and without the node axis."""
    tree = resnet_tree(J_SMALL, seed=2, n=n)
    params = from_jax_params(tree, device="cpu")
    assert params["s1b0/proj"].shape[-4:] == (32, 16, 1, 1)
    assert params["stem"].shape[-4:] == (16, 3, 3, 3)
    assert_trees_close(to_jax_params(params), tree, atol=0.0)


def test_port_init_has_reference_structure():
    """The port's own init draws other numbers but the same leaves and
    shapes as the reference's tree."""
    tm = t_build(T_SMALL)
    mine = to_jax_params(tm.init(torch.Generator().manual_seed(0)))
    ref = resnet_tree(J_SMALL, seed=0)
    from test_torch_common import leaves
    lm, lr = leaves(mine), leaves(ref)
    assert lm.keys() == lr.keys()
    assert all(lm[k].shape == lr[k].shape for k in lm)
