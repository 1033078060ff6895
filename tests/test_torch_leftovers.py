"""The smaller leftovers of the port against the reference: the config
registry's parameter counts, shape table and shape rules, the lr
schedules, the ``optim`` and ``data`` exports, and the host samplers of
``data/pipeline.py``. numpy and scalar checks only."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.optim as joptim
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.optim import schedules as jsched
import repro_torch.data as tdata
import repro_torch.optim as toptim
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import schedules as tsched


def _port_config(cfg):
    """A reference ModelConfig as the port's (the field lists match)."""
    kw = dataclasses.asdict(cfg)
    for sub, cls in (("moe", tbase.MoEConfig), ("mla", tbase.MLAConfig),
                     ("ssm", tbase.SSMConfig)):
        kw[sub] = cls(**kw[sub])
    kw["cnn_stages"] = tuple(kw["cnn_stages"])
    return tbase.ModelConfig(**kw)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_param_counts_match_reference(arch):
    """Every arch of the port's registry, and the reference's MoE and MLA
    archs carried over field for field (their terms of the formula), at
    full width and at ``reduced()``."""
    jc = jconfigs.get_config(arch)
    tc = (tconfigs.get_config(arch) if arch in tconfigs.ARCHS
          else _port_config(jc))
    for j, t in ((jc, tc), (jc.reduced(), tc.reduced())):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    if arch in ("arctic-480b", "deepseek-v3-671b"):
        assert tc.active_param_count() < tc.param_count()


def test_shapes_and_registry_match_reference():
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    for k, s in jbase.SHAPES.items():
        assert dataclasses.asdict(tbase.SHAPES[k]) == dataclasses.asdict(s)
    assert [(f.name, f.default) for f in dataclasses.fields(
        tbase.ShapeConfig)] == [(f.name, f.default) for f in
                                dataclasses.fields(jbase.ShapeConfig)]
    assert tconfigs.ASSIGNED_ARCHS == [a for a in jconfigs.ASSIGNED_ARCHS
                                       if a in tconfigs.ARCHS]
    assert list(tconfigs.ARCHS) == [a for a in jconfigs.ARCHS
                                    if a in tconfigs.ARCHS]
    for arch in tconfigs.ARCHS:
        assert dataclasses.asdict(tconfigs.get_config(arch, None)) == \
            dataclasses.asdict(jconfigs.get_config(arch))
        for name, shape in jbase.SHAPES.items():
            tc = tconfigs.get_config(arch, name)
            jc = jconfigs.get_config(arch, name)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert tconfigs.shape_supported(tc, tbase.SHAPES[name]) == \
                jconfigs.shape_supported(jc, shape)
            assert tc.supports_long_context == jc.supports_long_context
    long = tconfigs.get_config("mistral-nemo-12b", "long_500k")
    assert long is tconfigs.LONG_CONTEXT_VARIANTS["mistral-nemo-12b"]
    assert long != tconfigs.get_config("mistral-nemo-12b")
    assert tconfigs.shape_supported(long, tbase.SHAPES["long_500k"])
    with pytest.raises(KeyError):
        tconfigs.get_config("deepseek-v3-671b")


# ------------------------------------------------------------------ optim
@pytest.mark.parametrize("kind, args", [
    ("cosine", (0.5, 100)), ("cosine", (0.3, 100, 10)),
    ("cosine", (0.1, 50, 60, 0.0)), ("constant", (0.25,)),
    ("step_decay", (0.5, 100))])
def test_schedules_match_reference(kind, args):
    """Every step of a range past the end: the reference computes in
    float32, the port on the host in float64, so the values agree within
    the reference's own rounding, 1e-6 relative (8 float32 ulp over its
    chain of ~6 operations)."""
    j, t = getattr(jsched, kind)(*args), getattr(tsched, kind)(*args)
    for step in range(0, 130):
        got = t(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(j(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"step {step}")


def test_optim_and_data_export_the_reference_names():
    for jmod, tmod in ((joptim, toptim), (jdata, tdata)):
        names = [n for n in vars(jmod) if not n.startswith("_")
                 and callable(getattr(jmod, n))]
        assert names
        for n in names:
            assert callable(getattr(tmod, n)), n


# ------------------------------------------------------------- samplers
def _parts(seed=0, n=4):
    rng = np.random.default_rng(seed)
    sizes = [3, 40, 17, 9][:n]
    return [np.sort(rng.choice(500, size=s, replace=False)) for s in sizes]


def test_node_sampler_draws_the_reference_indices():
    parts = _parts()
    j, t = jpipe.NodeSampler(parts, 8, seed=5), tpipe.NodeSampler(parts, 8,
                                                                    seed=5)
    for _ in range(6):
        np.testing.assert_array_equal(t.sample(), j.sample())


def test_homogenized_sampler_draws_the_reference_indices():
    """Dense labels, then a refresh to sparse top-k labels (numpy on the
    reference's side, torch tensors on the port's): the same draws and
    the same gathered payloads and weights."""
    rng = np.random.default_rng(3)
    parts, n, P, C, k = _parts(), 4, 30, 10, 3
    w = (rng.random((n, P)) < 0.4).astype(np.float32)
    w[0] = 0.0                                  # a node with no D_ID
    dense = rng.random((n, P, C)).astype(np.float32)
    j = jpipe.HomogenizedSampler(parts, w, 6, seed=2, public_labels=dense)
    t = tpipe.HomogenizedSampler(parts, torch.as_tensor(w), 6, seed=2,
                                 public_labels=torch.as_tensor(dense))
    assert not t.sparse and not j.sparse
    for _ in range(4):
        js, ts = j.sample(), t.sample()
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(t.gather_public(ts[1]),
                                      j.gather_public(js[1]))
        np.testing.assert_array_equal(t.gather_weights(ts[1]),
                                      j.gather_weights(js[1]))
    w2 = (rng.random((n, P)) < 0.7).astype(np.float32)
    vals = rng.random((n, P, k)).astype(np.float32)
    idx = rng.integers(0, C, (n, P, k)).astype(np.int32)
    j.refresh(w2, (vals, idx))
    t.refresh(w2, (torch.as_tensor(vals), torch.as_tensor(idx)))
    assert t.sparse and j.sparse
    for _ in range(4):
        js, ts = j.sample(), t.sample()
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b, a)
        for a, b in zip(j.gather_public(js[1]), t.gather_public(ts[1])):
            np.testing.assert_array_equal(b, a)
    bare = tpipe.HomogenizedSampler(parts, w, 6, seed=2)
    with pytest.raises(ValueError):
        bare.gather_public(np.zeros((n, 6), np.int64))
