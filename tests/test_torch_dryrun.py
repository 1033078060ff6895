"""The port's dry run (``launch.dryrun``, ``launch.input_specs``, the
sharding rules of ``launch.sharding``, ``launch.mesh``'s production and
host meshes) and the two-axis hierarchical ppermute mixer, against the
reference.

The reference side runs in a subprocess that forces 512 host devices
before it imports JAX (``tests/torch_dryrun_ref.py``, as
``tests/test_dryrun_small.py`` does): for every assigned arch at full
width on both production meshes, its PartitionSpecs and
``NamedSharding.shard_shape`` of every leaf, the input specs' shapes and
dtypes, ``model_flops_total``, and its two-axis ``make_ppermute_mixer``
under ``shard_map`` at (pod 2, data 3). The port must match leaf by
leaf: equal specs, shapes and shard shapes, its ``argument_bytes`` the
sum of the reference's shard shapes times the port's dtype sizes — the
port's token ids and labels, and its decode caches' positions and
lengths, are int64 where the reference's are int32, and no other dtype
differs — and equal model FLOPs. One spawn of 6 gloo ranks
(``tests/torch_dryrun_ranks.py``) runs the port's two-axis mixer, held
within 1e-6 of the reference's, and one ``make_shard_step`` step on a
3 node x 2 model ``make_host_mesh`` whose ``launch.dist`` byte counters
must equal the dry run's per-kind collective bytes."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dist, dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import AxisMesh, make_production_mesh

import torch_dryrun_ranks as R

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
# (port dtype, reference dtype) where the two differ, by leaf name
WIDER = {"tokens": ("int64", "int32"), "labels": ("int64", "int32"),
         "pos": ("int64", "int32"), "length": ("int64", "int32")}
MIX_ATOL = 1e-6


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    run = subprocess.run([sys.executable, str(HERE / "torch_dryrun_ref.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("dryrun_store")
    return dist.spawn(R.rank_main, math.prod(R.MIX_SIZES), device="cpu",
                      store_dir=str(store))


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _leaves(tree, specs, mesh):
    """{path: [spec, shard shape, shape, dtype]}, the reference's form."""
    return {path: [[_entry(e) for e in spec],
                   list(shd.shard_shape(tuple(leaf.shape), spec, mesh)),
                   list(leaf.shape), str(leaf.dtype).replace("torch.", "")]
            for path, leaf, spec in shd.spec_leaves(tree, specs)}


def _expected_bytes(ref_leaves):
    """Σ the reference's shard shapes times the port's dtype sizes."""
    total = 0
    for path, (_, shard, _, dtype) in ref_leaves.items():
        name = path.rsplit("/", 1)[-1]
        port = WIDER[name][0] if name in WIDER else dtype
        total += math.prod(shard) * torch.empty((), dtype=getattr(
            torch, port)).element_size()
    return total


def _same_leaves(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for path, (spec, shard, shape, dtype) in want.items():
        g = got[path]
        assert g[:3] == [spec, shard, shape], (what, path, g, want[path])
        name = path.rsplit("/", 1)[-1]
        if name in WIDER:
            assert (g[3], dtype) == WIDER[name], (what, path)
        else:
            assert g[3] == dtype, (what, path, g[3], dtype)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_shards_bytes_and_flops_match_reference(ref, arch):
    """Every shape on both production meshes: each input's specs, shard
    shapes, shapes and dtypes leaf by leaf, the argument bytes, and the
    model FLOPs; "skipped" exactly where the reference skips."""
    for mesh_name in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=mesh_name == "multi")
        for shape_name, shape in SHAPES.items():
            want = ref["archs"][arch][mesh_name][shape_name]
            if want is None:
                rec = dryrun.run_one(arch, shape_name,
                                     mesh_name == "multi", verbose=False)
                assert rec["status"] == "skipped"
                continue
            cfg = get_config(arch, shape=shape_name)
            su = dryrun.setup(cfg, shape, mesh)
            expected = 0
            for part, leaves in want.items():
                _same_leaves(_leaves(su.inputs[part], su.specs[part], mesh),
                             leaves,
                             (arch, mesh_name, shape_name, part))
                expected += _expected_bytes(leaves)
            if shape.mode == "train":
                expected += dryrun.LR_BYTES
            assert su.argument_bytes == expected, (arch, shape_name)
            assert dryrun.model_flops_total(cfg, shape) == \
                ref["flops"][arch][shape_name]


def test_sharded_out_is_refused():
    """The reference's sharded_out pins GSPMD's layouts; the port has no
    partitioner, so its dry run raises rather than record a variant."""
    with pytest.raises(ValueError, match="partitioner"):
        dryrun.run_one("qwen3-1.7b", "train_4k", False, sharded_out=True)


def test_experts_over_data_and_model(ref, monkeypatch):
    """REPRO_SHARD_EXPERTS=both on the multi-pod mesh (pod scope):
    DeepSeek-V3's expert banks over ("data", "model"), as the
    reference's."""
    monkeypatch.setenv("REPRO_SHARD_EXPERTS", "both")
    mesh = make_production_mesh(multi_pod=True)
    su = dryrun.setup(get_config("deepseek-v3-671b"), SHAPES["train_4k"],
                      mesh)
    got = _leaves(su.inputs["params"], su.specs["params"], mesh)
    _same_leaves(got, ref["both"]["params"], "both")
    assert any(v[0][2] == ["data", "model"] for k, v in got.items()
               if "experts" in k)


def _hand_flops(cfg, shape, nodes):
    """A reduced dense step's products, counted by hand: each projection
    and the head 2·T·din·dout forward and twice that backward (the input
    and the weight gradients); the plain attention's two products a key
    chunk, 2·b·S·H·hd·chunk each, every chunk of every row, and twice
    that backward; per node, over the nodes."""
    b = shape.global_batch // nodes
    S, T = shape.seq_len, shape.global_batch // nodes * shape.seq_len
    d, H, KVH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, f, V = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    proj = [(d, H * hd), (d, KVH * hd), (d, KVH * hd), (H * hd, d),
            (d, f), (d, f), (f, d)]
    layer = sum(2 * T * i * o for i, o in proj) + 2 * 2 * b * S * H * hd * S
    return nodes * 3 * (cfg.num_layers * layer + 2 * T * d * V)


def test_flops_equal_a_hand_count():
    """On a reduced dense config (Qwen3-1.7B, two layers, no recompute),
    hlo_flops_per_device x n_chips is the hand count of the step's
    products, exactly."""
    cfg = get_config("qwen3-1.7b").reduced().replace(dtype="float32")
    assert cfg.mlp_type == "swiglu" and not cfg.remat
    mesh = AxisMesh(("data", "model"), (2, 2))
    shape = ShapeConfig("tiny", 40, 4, "train")   # one key chunk, cut to 40
    rec = dryrun.analyze(cfg, shape, mesh)
    assert rec["hlo_flops_per_device"] * mesh.size == \
        _hand_flops(cfg, shape, 2)


def test_hierarchical_mixer_matches_reference(ref, ranks):
    """The two-axis mixer on a (pod 2, data 3) grid of 6 gloo ranks, each
    holding one node: every node within 1e-6 of the reference's
    shard_map output, with and without self_weight."""
    for name, _ in R.SELF_WEIGHTS:
        for r, got in enumerate(ranks):
            for k, v in got["mixers"][name].items():
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(ref["mixer"][name][k])[r],
                    atol=MIX_ATOL, err_msg=f"{name} node {r} {k}")


def test_hierarchical_mixer_refusals():
    from repro_torch.core.mixing import make_ppermute_mixer
    one = dist.Group((0,), 0)
    with pytest.raises(ValueError, match="single-axis only"):
        make_ppermute_mixer((one, one), local_nodes=2)
    with pytest.raises(ValueError, match="hierarchical"):
        make_ppermute_mixer(one, self_weight=0.5)


def test_collective_bytes_equal_the_counter(ranks):
    """A reduced Qwen3-1.7B on a 3 node x 2 model host mesh: the dry
    run's bytes of each collective kind equal what launch.dist counted
    over one make_shard_step step, on every rank."""
    mesh = AxisMesh(("data", "model"), R.HOST)
    rec = dryrun.analyze(R.step_config(), R.STEP_SHAPE, mesh,
                         scope="replica", wire_dtype="native",
                         tcfg=R.step_train_config())
    want = rec["collectives"]
    assert want["collective-permute"] and want["all-gather"] \
        and want["all-reduce"]
    for got in ranks:
        for k in dist.KINDS:
            assert got["sent"][k] == want[k], (k, got["sent"][k], want[k])
