"""The rank side of ``tests/test_torch_dryrun.py``'s spawn of 6 gloo
ranks, and the inputs both sides share (numpy seeds). It imports
neither JAX nor the reference, so that a spawned rank starts in the time
torch takes.

Each rank mixes its row of :func:`mixer_tree` with the two-axis
hierarchical mixer over a (pod 2, data 3) grid, and takes one
``make_shard_step`` step of a reduced dense model on a 3 node x 2 model
``make_host_mesh`` with ``launch.dist``'s byte counters zeroed before
and read after."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import driver
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.mixing import make_ppermute_mixer
from repro_torch.core.topology import Topology
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_grid, make_host_mesh
from repro_torch.launch.sharding import federation_specs, local_block
from repro_torch.launch.steps import stack_params
from repro_torch.models.model import build_model

MIX_SIZES = (2, 3)              # (pod, data)
HOST = (3, 2)                   # (data, model): 3 nodes, 2 model shards
SELF_WEIGHTS = (("plain", None), ("self_weight", 0.5))
# the counted step: a reduced Qwen3-1.7B (f32; every weight dim even, so
# each 2-D leaf cuts over "model"), 3 ring nodes, 2 sequences of 16 each
STEP_SHAPE = ShapeConfig("host", 16, 6, "train")


def mixer_tree(seed=0):
    """One row a node of the (pod 2, data 3) grid's 6."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(6, 7)).astype(np.float32),
            "b": rng.normal(size=(6, 2, 3)).astype(np.float32)}


def step_config():
    return get_config("qwen3-1.7b").reduced().replace(dtype="float32")


def step_train_config():
    return TrainConfig(num_nodes=HOST[0], topology="ring")


def _mixers(rank):
    grid = make_grid(("pod", "data"), MIX_SIZES)
    tree = {k: torch.as_tensor(v[rank:rank + 1])
            for k, v in mixer_tree().items()}
    out = {}
    for name, sw in SELF_WEIGHTS:
        mix = make_ppermute_mixer((grid.group("pod"), grid.group("data")),
                                  self_weight=sw)
        out[name] = {k: v[0] for k, v in mix(tree).items()}
    return out


def _counted_step():
    cfg, tcfg = step_config(), step_train_config()
    mesh = make_host_mesh(*HOST).federation()
    model = build_model(cfg)
    n = HOST[0]
    glob = stack_params(model.init(0, "cpu"), n)
    specs = federation_specs(glob, n, mesh)
    params = local_block(glob, specs, mesh)
    algo = make_algorithm(tcfg.algorithm, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay)
    step = driver.make_shard_step(model, algo, driver.lm_adapter,
                                  mesh=mesh,
                                  topology=Topology.make("ring", n),
                                  specs=specs)
    rng = np.random.default_rng(1)
    per = STEP_SHAPE.global_batch // n
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        n, per, STEP_SHAPE.seq_len + 1)))
    batch = {"tokens": seq[..., :-1], "labels": seq[..., 1:]}
    opt = step.init_opt(params)
    dist.zero_sent()
    step(params, opt, batch, tcfg.lr)
    return dist.sent()


def rank_main(rank, world):
    torch.set_num_threads(1)
    return {"mixers": _mixers(rank), "sent": _counted_step()}
