"""The reference side of ``tests/test_torch_dryrun.py``, run in a
subprocess of its own (``python tests/torch_dryrun_ref.py OUT``): it
forces 512 host devices before it imports JAX, as
``src/repro/launch/dryrun.py`` does, and writes to OUT (JSON) what the
port is held to — for every assigned arch at full width on both
production meshes, every leaf's PartitionSpec and
``NamedSharding.shard_shape`` under ``param_shardings`` (params and the
optimizer state), ``batch_shardings``, ``serve_param_shardings``,
``serve_batch_shardings`` and ``serve_state_shardings``, with the input
specs' shapes and dtypes; ``model_flops_total`` of every shape; the
experts rule with ``REPRO_SHARD_EXPERTS=both``; and the two-axis
``make_ppermute_mixer`` under ``shard_map`` at (pod 2, data 3) on a
numpy tree."""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json                                              # noqa: E402

import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402
import numpy as np                                       # noqa: E402
from jax.sharding import NamedSharding                   # noqa: E402

from repro.configs import (ASSIGNED_ARCHS, SHAPES, get_config,  # noqa: E402
                           shape_supported)
from repro.configs.base import TrainConfig               # noqa: E402
from repro.launch import input_specs as ispec            # noqa: E402
from repro.launch import sharding as shd                 # noqa: E402
from repro.launch.mesh import (make_production_mesh,     # noqa: E402
                               num_nodes)
from repro.launch.steps import make_train_step           # noqa: E402
from repro.models import build_model                     # noqa: E402

from torch_dryrun_ranks import MIX_SIZES, SELF_WEIGHTS, mixer_tree  # noqa


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _leaves(tree, sh):
    """{path: [spec, shard shape, shape, dtype]} of a spec'd tree."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    shs = jax.tree.leaves(sh, is_leaf=lambda s: isinstance(s,
                                                           NamedSharding))
    for (path, leaf), s in zip(flat, shs):
        out[shd._path_str(path)] = [
            [_entry(e) for e in s.spec], list(s.shard_shape(leaf.shape)),
            list(leaf.shape), str(leaf.dtype)]
    return out


def specs_of(arch, multi):
    mesh = make_production_mesh(multi_pod=multi)
    res = {}
    for shape_name, shape in SHAPES.items():
        cfg = get_config(arch, shape=shape_name)
        if not shape_supported(cfg, shape):
            res[shape_name] = None
            continue
        model = build_model(cfg)
        if shape.mode == "train":
            nodes = num_nodes(mesh, cfg.node_scope)
            step = make_train_step(model, TrainConfig(num_nodes=nodes),
                                   nodes)
            p = ispec.stacked_params_specs(model, nodes)
            opt = jax.eval_shape(step.init_opt, p)
            b = ispec.train_specs(cfg, shape, nodes)
            sc = cfg.node_scope
            res[shape_name] = {
                "params": _leaves(p, shd.param_shardings(p, mesh, sc)),
                "opt_state": _leaves(opt, shd.param_shardings(opt, mesh, sc)),
                "batch": _leaves(b, shd.batch_shardings(b, mesh, sc))}
            continue
        p = ispec.params_specs(model)
        out = {"params": _leaves(p, shd.serve_param_shardings(p, mesh))}
        if shape.mode == "prefill":
            b = ispec.prefill_specs(cfg, shape)
            out["batch"] = _leaves(b, shd.serve_batch_shardings(b, mesh))
        else:
            tok, state, extras = ispec.decode_specs(cfg, shape, model)
            ins = {"tokens": tok, **{f"extra{i}": e
                                     for i, e in enumerate(extras)}}
            out["batch"] = _leaves(ins, shd.serve_batch_shardings(ins, mesh))
            out["state"] = _leaves(state,
                                   shd.serve_state_shardings(state, mesh))
        res[shape_name] = out
    return res


def mixer_out():
    """The reference's two-axis mixer on a (pod 2, data 3) mesh, one node
    a device."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core.mixing import make_ppermute_mixer
    mesh = Mesh(np.asarray(jax.devices()[:6]).reshape(MIX_SIZES),
                ("pod", "data"))
    out = {}
    for name, sw in SELF_WEIGHTS:
        mix = make_ppermute_mixer(("pod", "data"), MIX_SIZES, self_weight=sw)
        spec = {k: P(("pod", "data")) for k in mixer_tree()}
        f = jax.jit(shard_map(mix, mesh=mesh, in_specs=(spec,),
                              out_specs=spec, check_rep=False))
        y = f({k: jnp.asarray(v) for k, v in mixer_tree().items()})
        out[name] = {k: np.asarray(v).tolist() for k, v in y.items()}
    return out


def main(path):
    out = {"archs": {}, "flops": {}, "both": {}}
    for arch in ASSIGNED_ARCHS:
        out["archs"][arch] = {m: specs_of(arch, m == "multi")
                              for m in ("single", "multi")}
        out["flops"][arch] = {}
        for shape_name, shape in SHAPES.items():
            cfg = get_config(arch, shape=shape_name)
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.mode != "decode" else 1)
            factor = 6 if shape.mode == "train" else 2
            out["flops"][arch][shape_name] = \
                factor * cfg.active_param_count() * tokens
    # the experts rule's variant: the expert dim over (data, model)
    os.environ["REPRO_SHARD_EXPERTS"] = "both"
    out["both"] = specs_of("deepseek-v3-671b", True)["train_4k"]
    del os.environ["REPRO_SHARD_EXPERTS"]
    out["mixer"] = mixer_out()
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
