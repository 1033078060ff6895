"""The LM homogenization round against the reference on the CPU: the
labeling engine on token shapes — the sparse exchange with a token axis,
the head pass on (mb, S, D) features, the one-shot round on (n, P, S, V)
logits — and ``launch.train.idkd_label_round`` on a reduced Hymba,
streaming and one-shot, driven through ``repro_torch.lmpath``.

Tolerances: confidences 1e-4, thresholds 1e-5, merged labels 1e-4; D_ID
masks equal; top-k indices equal except at near-ties (two labels within
1e-6, where the summation order may swap them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import IDKDConfig as JIDKD
from repro.core import distill as jdistill
from repro.core import labeling as jlab
from repro.core.topology import Topology as JTopology
from repro.launch.train import idkd_label_round as j_round
from repro.models import build_model as j_build
from repro_torch import lmpath
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.core import distill as tdistill
from repro_torch.core import labeling as tlab
from repro_torch.core.topology import Topology as TTopology
from repro_torch.launch.train import idkd_label_round, private_sequences
from repro_torch.models.convert import to_jax_lm_params

from test_torch_common import hymba_small, t

torch.set_num_threads(1)

CONF_ATOL, THRESH_ATOL, LABEL_ATOL, TIE = 1e-4, 1e-5, 1e-4, 1e-6
N_NODES = 4


def assert_labels_close(vals, idx, ref_vals, ref_idx):
    vals, idx = np.asarray(vals), np.asarray(idx)
    ref_vals, ref_idx = np.asarray(ref_vals), np.asarray(ref_idx)
    np.testing.assert_allclose(vals, ref_vals, atol=LABEL_ATOL)
    differ = idx != ref_idx
    if differ.any():                 # a swap inside a near-tie only
        near = np.abs(vals - np.roll(vals, 1, -1)) <= TIE
        near |= np.abs(vals - np.roll(vals, -1, -1)) <= TIE
        assert (near | ~differ).all()


def _sparse(rng, n, P, S, k, V):
    v = rng.random(size=(n, P, S, k)).astype(np.float32)
    v /= v.sum(-1, keepdims=True)
    i = rng.integers(0, V, size=(n, P, S, k)).astype(np.int32)
    return v, i


def test_exchange_sparse_keeps_the_token_axis():
    """(n, P, S, k) token payloads merge to (n, P, S, (deg + 1)·k), as the
    reference's broadcast over trailing axes does."""
    rng = np.random.default_rng(0)
    n, P, S, k = 5, 6, 7, 3
    v, i = _sparse(rng, n, P, S, k, 50)
    mask = rng.random(size=(n, P)) < 0.6
    for kind in ("ring", "chain"):
        ref, ref_w = jlab.exchange_sparse(
            JTopology.make(kind, n), jnp.asarray(mask),
            jdistill.SparseLabels(jnp.asarray(v), jnp.asarray(i)))
        out, w = tlab.exchange_sparse(
            TTopology.make(kind, n), t(mask),
            tdistill.SparseLabels(t(v), t(i)))
        assert out.values.shape == ref.values.shape == (n, P, S, 3 * k)
        np.testing.assert_allclose(out.values.numpy(),
                                   np.asarray(ref.values), atol=1e-7)
        np.testing.assert_array_equal(out.indices.numpy(),
                                      np.asarray(ref.indices))
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))


def test_exchange_dense_keeps_the_token_axis():
    rng = np.random.default_rng(1)
    n, P, S, V = 4, 5, 3, 9
    labels = rng.random(size=(n, P, S, V)).astype(np.float32)
    mask = rng.random(size=(n, P)) < 0.5
    ref, ref_w = jlab.exchange_dense(JTopology.make("ring", n),
                                     jnp.asarray(mask), jnp.asarray(labels))
    out, w = tlab.exchange_dense(TTopology.make("ring", n), t(mask),
                                 t(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))


@pytest.fixture(scope="module")
def small_round():
    """The LM path at a reduced Hymba (3 layers, GQA 4:2, window 64 on
    layer 1, S = 60 + 8 meta tokens): four nodes from the port's init
    (seeds 0-3), data as lmpath makes it, the same params on the
    reference's side."""
    icfg = TIDKD(label_topk=4, stream_microbatch=3, label_backend="sparse",
                 temperature=10.0)
    r = lmpath.setup(hymba_small("torch"), num_nodes=N_NODES, seq_len=60,
                     n_private=64, n_public=7, icfg=icfg, device="cpu")
    jm = j_build(hymba_small("jax"))
    jparams = jax.tree.map(jnp.asarray, to_jax_lm_params(r.params))
    return r, jm, jparams


def _jcfg(tcfg):
    return JIDKD(**dataclasses.asdict(tcfg))


def test_head_pass_on_token_features(small_round):
    """One head_select pass over (L, mb·S, D) rows: conf is the mean over
    S of the token confidences, labels keep (L, mb, S, k)."""
    r, jm, jparams = small_round
    x = np.asarray(r.public[:3])
    xs = t(x[None].repeat(N_NODES, 0)).long()
    conf, vals, idx = tlab._head_pass(r.model, r.params, xs, r.icfg, 4)
    ref = jax.vmap(lambda p, xx: jlab._head_pass(
        jm, p, xx, _jcfg(r.icfg), 4))(jparams, jnp.asarray(x[None].repeat(
            N_NODES, 0)))
    assert conf.shape == (N_NODES, 3) and vals.shape == (N_NODES, 3, 60, 4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref[0]),
                               atol=CONF_ATOL)
    assert_labels_close(vals, idx, ref[1], ref[2])


@pytest.mark.parametrize("backend", ["fused", "sparse", "dense"])
def test_label_round_on_token_logits(small_round, backend):
    """The one-shot round takes (n, P, S, V) logits: sequence scores are
    the mean token confidence, every token is labelled."""
    r, _, _ = small_round
    rng = np.random.default_rng(2)
    pub = (rng.normal(size=(N_NODES, 6, 5, 40)) * 3).astype(np.float32)
    val = (rng.normal(size=(N_NODES, 4, 5, 40)) * 3).astype(np.float32)
    icfg = dataclasses.replace(r.icfg, label_backend=backend)
    ref = jlab.label_round(jnp.asarray(pub), jnp.asarray(val), None,
                           JTopology.make("ring", N_NODES), _jcfg(icfg),
                           backend=backend)
    out = tlab.label_round(t(pub), t(val), None,
                           TTopology.make("ring", N_NODES), icfg,
                           backend=backend)
    np.testing.assert_allclose(out.thresholds.numpy(),
                               np.asarray(ref.thresholds), atol=THRESH_ATOL)
    np.testing.assert_array_equal(out.id_masks.numpy(),
                                  np.asarray(ref.id_masks))
    np.testing.assert_array_equal(out.weights.numpy(), np.asarray(ref.weights))
    if backend == "dense":
        np.testing.assert_allclose(out.labels.numpy(), np.asarray(ref.labels),
                                   atol=LABEL_ATOL)
    else:
        assert out.labels.values.shape == (N_NODES, 6, 5, 12)
        assert_labels_close(out.labels.values, out.labels.indices,
                            ref.labels.values, ref.labels.indices)


@pytest.mark.parametrize("stream,backend", [(True, "sparse"),
                                            (False, "fused")])
def test_idkd_label_round_matches_reference(small_round, stream, backend):
    """The whole round, streaming (head_select per microbatch of 3
    sequences, a ragged last one) and one-shot (msp_select on the logit
    stack), against the reference's idkd_label_round."""
    r, jm, jparams = small_round
    icfg = dataclasses.replace(r.icfg, stream_labels=stream,
                               label_backend=backend)
    ref = j_round(jm, jparams, r.public, r.private, _jcfg(icfg),
                  JTopology.make("ring", N_NODES), backend=backend)
    labels, w, mask, thr = r.run(icfg)
    assert labels.values.shape == (N_NODES, 7, 60, 3 * 4)
    np.testing.assert_allclose(thr.numpy(), np.asarray(ref[3]),
                               atol=THRESH_ATOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref[1]))
    assert_labels_close(labels.values, labels.indices, ref[0].values,
                        ref[0].indices)
    assert 0.0 < float(mask.float().mean()) < 1.0


def test_private_sequences_take_the_smallest_partition():
    tokens = np.arange(40 * 9).reshape(40, 9)
    parts = [np.arange(0, 20), np.arange(20, 23), np.arange(23, 40)]
    priv = private_sequences(tokens, parts, 8)
    assert priv.shape == (3, 3, 8)
    np.testing.assert_array_equal(priv[1], tokens[20:23, :8])
    parts = [np.arange(0, 20), np.arange(20, 40)]
    assert private_sequences(tokens, parts, 8).shape == (2, 16, 8)


def test_idkd_label_round_mesh_raises(small_round):
    # the sharded round runs (tests/test_torch_shard.py) but has no churn
    # path, as in the reference
    r, _, _ = small_round
    with pytest.raises(ValueError, match="no churn path"):
        idkd_label_round(r.model, r.params, r.public, r.private, r.icfg,
                         r.topology, mesh=object(),
                         active=np.array([True, False, True, True]))
