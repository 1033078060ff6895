"""The streaming label round (the ``head_select`` path) against the
reference's on converted node-stacked weights, with a public set that
is not a multiple of the microbatch; and the port's streaming round
against its own one-shot rounds (``msp_select`` on the fused backend,
and the sparse backend)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import IDKDConfig as JIDKD
from repro.configs.resnet20_cifar import SMALL_CONFIG as J_SMALL
from repro.core import labeling as jlab
from repro.core import ood as jood
from repro.core.topology import Topology as JTopology
from repro.models import build_model as j_build
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG as T_SMALL
from repro_torch.core import labeling as tlab
from repro_torch.core import ood as tood
from repro_torch.core.topology import Topology as TTopology
from repro_torch.models.convert import from_jax_params
from repro_torch.models.resnet import build_model as t_build

from test_torch_common import resnet_tree, t

torch.set_num_threads(1)

# two residual blocks (one plain, one stride-2 with a projection) cover
# every layer kind of the ResNet at a third less JAX compile time
J_CFG = J_SMALL.replace(image_size=8, cnn_stages=(1, 1))
T_CFG = T_SMALL.replace(image_size=8, cnn_stages=(1, 1))

N_NODES, P, V, MB = 4, 70, 12, 32


def _inputs():
    rng = np.random.default_rng(5)
    tree = resnet_tree(J_CFG, seed=4, n=N_NODES)
    pub = rng.normal(size=(P, 8, 8, 3)).astype(np.float32) * 1.5
    val = rng.normal(size=(N_NODES, V, 8, 8, 3)).astype(np.float32)
    return tree, pub, val


def _near_threshold(conf, thresholds):
    return np.abs(conf - np.asarray(thresholds)[:, None]) <= 1e-5


def test_streaming_round_matches_reference():
    tree, pub, val = _inputs()
    jcfg = JIDKD(temperature=10.0, label_backend="sparse",
                 stream_microbatch=MB)
    tcfg = TIDKD(temperature=10.0, label_backend="sparse",
                 stream_microbatch=MB)
    jm = j_build(J_CFG)
    jparams = jax.tree.map(jnp.asarray, tree)
    ref = jlab.streaming_label_round(jm, jparams, jnp.asarray(pub),
                                     jnp.asarray(val),
                                     JTopology.make("ring", N_NODES), jcfg)
    out = tlab.streaming_label_round(t_build(T_CFG),
                                     from_jax_params(tree, device="cpu"),
                                     t(pub), t(val),
                                     TTopology.make("ring", N_NODES), tcfg)
    np.testing.assert_allclose(out.thresholds.numpy(),
                               np.asarray(ref.thresholds), atol=1e-5)
    logits = jax.vmap(lambda p: jm.forward(p, {"images": jnp.asarray(pub)}
                                           )[0])(jparams)
    conf = np.asarray(jood.confidence(logits, "msp"))
    differ = out.id_masks.numpy() != np.asarray(ref.id_masks)
    assert not (differ & ~_near_threshold(conf, ref.thresholds)).any()
    if not differ.any():
        np.testing.assert_array_equal(out.weights.numpy(),
                                      np.asarray(ref.weights))
        np.testing.assert_allclose(out.labels.values.numpy(),
                                   np.asarray(ref.labels.values), atol=1e-5)
        np.testing.assert_array_equal(out.labels.indices.numpy(),
                                      np.asarray(ref.labels.indices))
    assert out.labels.values.shape == (N_NODES, P, 3 * 8)


@pytest.mark.parametrize("det", ["msp", "energy"])
def test_streaming_round_matches_one_shot_rounds(det):
    """Streaming (head_select over microbatches) == the one-shot fused
    round (msp_select on the logit stack) == the sparse round."""
    tree, pub, val = _inputs()
    model = t_build(T_CFG)
    params = from_jax_params(tree, device="cpu")
    topo = TTopology.make("ring", N_NODES)
    cfg = TIDKD(temperature=10.0, label_backend="sparse", detector=det,
                stream_microbatch=MB)
    stream = tlab.streaming_label_round(model, params, t(pub), t(val), topo,
                                        cfg)
    with torch.no_grad():
        logits = model.forward(
            params, {"images": t(pub)[None].expand(N_NODES, *pub.shape)})[0]
        val_logits = model.forward(params, {"images": t(val)})[0]
    conf = tood.confidence(logits, det).numpy()
    for backend in ("fused", "sparse"):
        one = tlab.label_round(logits, val_logits, None, topo, cfg,
                               backend=backend)
        np.testing.assert_allclose(one.thresholds.numpy(),
                                   stream.thresholds.numpy(), atol=1e-5)
        differ = one.id_masks.numpy() != stream.id_masks.numpy()
        assert not (differ & ~_near_threshold(conf, one.thresholds)).any()
        np.testing.assert_allclose(one.densify(10).numpy()[~differ],
                                   stream.densify(10).numpy()[~differ],
                                   atol=1e-5)


def test_streaming_round_without_filter_and_chunking():
    """filter_ood=False keeps every sample; the ragged tail is padded by
    repeating row 0 and sliced off."""
    tree, pub, val = _inputs()
    chunks, n, mb = tlab._chunk_public(t(pub), MB)
    assert chunks.shape == (3, MB, 8, 8, 3) and (n, mb) == (P, MB)
    assert torch.equal(chunks.reshape(-1, 8, 8, 3)[P:],
                       t(pub)[:1].expand(3 * MB - P, 8, 8, 3))
    out = tlab.streaming_label_round(
        t_build(T_CFG), from_jax_params(tree, device="cpu"),
        t(pub), t(val), TTopology.make("ring", N_NODES),
        TIDKD(label_backend="sparse", stream_microbatch=MB),
        filter_ood=False)
    assert out.id_masks.all() and (out.thresholds == 0).all()
    assert (out.weights == 1).all()


def _shapes_produced(fn):
    """Every tensor shape any aten op produces while ``fn`` runs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen.extend(tuple(t.shape) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            return out

    with Record():
        fn()
    return seen


def test_streaming_round_never_forms_the_public_logit_stack():
    """No op of the streaming round produces a tensor whose last two dims
    are (P, C): the (n, P, C) public logit stack never exists, only
    microbatch logits (mb, C) and the (P, k)-wide payloads. The audit is
    validated on the one-shot round, where the stack does exist."""
    tree, pub, val = _inputs()
    model = t_build(T_CFG)
    params = from_jax_params(tree, device="cpu")
    topo = TTopology.make("ring", N_NODES)
    cfg = TIDKD(label_backend="sparse", stream_microbatch=MB)
    C = 10
    assert C not in (MB, V, P, cfg.label_topk or tlab.DEFAULT_TOPK)

    def stack(shape):
        return len(shape) >= 2 and shape[-2:] == (P, C)

    seen = _shapes_produced(lambda: tlab.streaming_label_round(
        model, params, t(pub), t(val), topo, cfg))
    assert seen and not any(map(stack, seen))
    pub_n = t(pub)[None].expand(N_NODES, *pub.shape)
    seen = _shapes_produced(lambda: tlab.label_round(
        model.forward(params, {"images": pub_n})[0],
        model.forward(params, {"images": t(val)})[0], None, topo, cfg,
        backend="sparse"))
    assert any(map(stack, seen))
