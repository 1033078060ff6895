"""The rank side of ``tests/test_torch_shard.py``: what each gloo rank of
the sharded driver runs, and the inputs both sides share (made from
numpy and ``torch.Generator`` seeds). It imports neither JAX nor the
reference, so that a spawned rank starts in the time torch takes."""
import numpy as np
import torch

import shutil
from pathlib import Path

from repro_torch import sched
from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
from repro_torch.core import driver, labeling
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.core.topology import Topology
from repro_torch.data.synthetic import (make_classification_data,
                                        make_public_data)
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_federation_mesh
from repro_torch.core.mixing import make_shard_mixer
from repro_torch.launch.sharding import (comm_block, federation_specs,
                                         gather_nodes, global_stack,
                                         local_block)
from repro_torch.models.resnet import build_model, stack_params
from repro_torch.obs.metrics import init_node_metrics
from repro_torch.resil import Resilience, SimulatedCrash
from repro_torch.resil.guards import GuardSpec, init_node_guard
from repro_torch.resil.snapshot import SnapshotManager

# C = 9: at model size 2 the vocab slices are 5 wide, the last with one
# padded column
CFG = SMALL_CONFIG.replace(image_size=8, cnn_stages=(1, 1), num_classes=9)
N, B, K = 4, 3, 3
P, V, MB = 11, 5, 4
ROUND_CFG = IDKDConfig(temperature=10.0, label_backend="sparse",
                       stream_microbatch=MB, label_topk=8)
# (name, model_parallel, algorithm, topology, compression, gossip):
# QG-DSGDm-N and DSGD, ring and complete graph, on 2 node ranks and on
# 1 node x 2 model ranks; compressed and delayed gossip through the
# stateful sharded mixer (on 1 x 2 through the model-sharded adapter).
# The compressed steps take random-k, whose selection depends on the
# shared draws only: a top-k of deltas that differ by float rounding
# between the two runs may take another of two near-equal coordinates
# (the mixer cases hold top-k on identical inputs)
STEP_CASES = (("qg-ring-1d", 1, "qg-dsgdm-n", "ring", None, "sync"),
              ("dsgd-full-1d", 1, "dsgd", "full", None, "sync"),
              ("qg-ring-2d", 2, "qg-dsgdm-n", "ring", None, "sync"),
              ("dsgd-full-2d", 2, "dsgd", "full", None, "sync"),
              ("qg-ring-1d-randk", 1, "qg-dsgdm-n", "ring", ("randk", 0.2),
               "sync"),
              ("qg-full-1d-randk-delayed", 1, "qg-dsgdm-n", "full",
               ("randk", 0.2), "delayed"),
              ("qg-ring-2d-randk", 2, "qg-dsgdm-n", "ring", ("randk", 0.2),
               "sync"),
              ("qg-ring-2d-delayed", 2, "qg-dsgdm-n", "ring", None,
               "delayed"))
# (name, topology, compression, gossip) of the sharded mixer alone
MIXER_CASES = (("ring-topk-sync", "ring", ("topk", 0.2), "sync"),
               ("ring-topk-delayed", "ring", ("topk", 0.2), "delayed"),
               ("ring-randk-sync", "ring", ("randk", 0.3), "sync"),
               ("ring-randk-delayed", "ring", ("randk", 0.3), "delayed"),
               ("ring-none-delayed", "ring", None, "delayed"),
               ("full-topk-sync", "full", ("topk", 0.2), "sync"),
               ("full-topk-delayed", "full", ("topk", 0.2), "delayed"),
               ("full-none-delayed", "full", None, "delayed"))
MIXER_STEPS = 3
PLAIN_STEPS, KD_STEPS, LR = 2, 2, 0.1
GUARD = GuardSpec(loss_spike_factor=1.5, warmup_steps=1, consensus_max=0.5)


def params():
    """Node-stacked f32 ResNet params, every node a little different."""
    model = build_model(CFG)
    base = stack_params(model.init(torch.Generator().manual_seed(0)), N)
    rng = np.random.default_rng(1)
    return {k: v * torch.as_tensor(1 + 0.05 * rng.normal(
        size=(N,) + (1,) * (v.dim() - 1)), dtype=torch.float32)
        for k, v in base.items()}


def batches():
    """PLAIN_STEPS plain batches, then KD_STEPS sparse-KD batches."""
    rng = np.random.default_rng(2)
    out = []
    for s in range(PLAIN_STEPS + KD_STEPS):
        imgs = torch.as_tensor(rng.normal(size=(N, B, 8, 8, 3)),
                               dtype=torch.float32)
        y = torch.as_tensor(rng.integers(0, CFG.num_classes, size=(N, B)))
        w = torch.as_tensor(rng.uniform(0.5, 1.0, size=(N, B)),
                            dtype=torch.float32)
        if s < PLAIN_STEPS:
            out.append({"images": imgs, "weights": w,
                        "labels": torch.nn.functional.one_hot(
                            y, CFG.num_classes).float()})
            continue
        vals = torch.as_tensor(rng.dirichlet(np.ones(K), size=(N, B)),
                               dtype=torch.float32)
        idx = torch.as_tensor(rng.integers(0, CFG.num_classes,
                                           size=(N, B, K)), dtype=torch.int32)
        out.append({"images": imgs, "weights": w, "values": vals,
                    "indices": idx,
                    "is_pub": torch.as_tensor(rng.uniform(size=(N, B)) < 0.5)})
    return out


def gossip_tree(seed, scale=1.0):
    """A node-stacked tree of three leaves, sorted keys."""
    rng = np.random.default_rng(seed)
    return {"b": torch.as_tensor(rng.normal(size=(N, 5)) * scale,
                                 dtype=torch.float32),
            "c": torch.as_tensor(rng.normal(size=(N, 3, 4)) * scale,
                                 dtype=torch.float32),
            "w": torch.as_tensor(rng.normal(size=(N, 29)) * scale,
                                 dtype=torch.float32)}


def gossip_inputs():
    """The MIXER_STEPS trees the sharded mixer cases mix."""
    base = gossip_tree(1)
    return [{k: v + (s + 1) * gossip_tree(10 + s, 0.3)[k]
             for k, v in base.items()} for s in range(MIXER_STEPS)]


def adapters():
    return (driver.classification_adapter,
            driver.sparse_kd_adapter(ROUND_CFG.temperature, 0.7))


def round_inputs():
    """Logits for the one-shot round and images for the streaming one."""
    rng = np.random.default_rng(3)
    return {"pub_logits": torch.as_tensor(
                rng.normal(size=(N, P, CFG.num_classes)) * 2,
                dtype=torch.float32),
            "val_logits": torch.as_tensor(
                rng.normal(size=(N, V, CFG.num_classes)) * 3,
                dtype=torch.float32),
            "pub_x": torch.as_tensor(rng.normal(size=(P, 8, 8, 3)) * 1.5,
                                     dtype=torch.float32),
            "val_x": torch.as_tensor(rng.normal(size=(N, V, 8, 8, 3)),
                                     dtype=torch.float32)}


def train_args():
    """run_training's arguments for the reduced Hymba, f32."""
    from repro_torch.configs import get_config
    cfg = get_config("hymba-1.5b").reduced().replace(dtype="float32")
    tcfg = TrainConfig(num_nodes=N, steps=4, lr=0.1, batch_size=2,
                       idkd=IDKDConfig(start_step=2, label_topk=4,
                                       num_rounds=1, label_backend="sparse",
                                       stream_microbatch=3))
    return cfg, tcfg, dict(seq_len=12, n_seqs=32, n_public=5, log_every=1,
                           use_idkd=True, verbose=False, device="cpu")


# durable snapshots under the sharded driver: a 12-step run, the round at
# 6, an eval every 3 steps, a snapshot at boundaries 3 or more steps
# apart (1, 4 and 7), a crash at 8
SNAP_STEPS, SNAP_ROUND, SNAP_CRASH, SNAP_EVERY = 12, 6, 8, 3
# (name, compression): uncompressed sync gossip, and top-k, whose comm
# state (x̂ and the ring replicas) rides the snapshot
SNAP_CASES = (("plain", None), ("topk", ("topk", 0.2)))


def snapshot_sim(driver_mode, compression=None):
    """The ResNet simulator of the snapshot checks, on 4 ring nodes."""
    data = make_classification_data(num_classes=CFG.num_classes,
                                    image_size=8, n_train=96, n_val=8,
                                    n_test=16, seed=0)
    pub = make_public_data(data, n_public=12, kind="aligned", seed=1)
    kind, frac = compression or ("none", 0.0)
    tcfg = TrainConfig(num_nodes=N, steps=SNAP_STEPS, batch_size=3, lr=0.1,
                       compression=kind, compression_frac=frac,
                       idkd=IDKDConfig(start_step=SNAP_ROUND,
                                       label_backend="sparse",
                                       label_topk=4, stream_microbatch=4))
    return DecentralizedSimulator(CFG, tcfg, data, pub, kd_mode="idkd",
                                  eval_every=SNAP_EVERY,
                                  driver_mode=driver_mode,
                                  wire_dtype="native", device="cpu")


def snapshot_schedule(crash: bool):
    events = (sched.FaultEvent(SNAP_CRASH, "crash"),) if crash else ()
    return sched.compile_schedule(SNAP_STEPS, SNAP_EVERY,
                                  round_steps=(SNAP_ROUND,), events=events)


def _resumed_from(sim, directory):
    """Run the crash schedule on ``directory``'s snapshots; returns the
    result and the step this process resumed from."""
    loaded = []
    load = SnapshotManager.load

    def record(self, step, like):
        out = load(self, step, like)
        loaded.append(out["step"])
        return out
    SnapshotManager.load = record
    try:
        res = sim.run(snapshot_schedule(True), resil=Resilience(
            snapshot_dir=str(directory), snapshot_every=SNAP_EVERY))
    finally:
        SnapshotManager.load = load
    return res, loaded[-1] if loaded else None


def _snapshots(snap_dir):
    """Each case: the sharded run uninterrupted; snapshotted, crashed at
    SNAP_CRASH and resumed; its directory as the crash left it (copied
    for the parent's node-stacked resume); a node-stacked run's snapshot
    resuming the sharded run; and a snapshot beside a cut-short newer
    file resuming every rank from the same step."""
    rank = dist.world()[0]
    root = Path(snap_dir)
    out = {}
    for name, comp in SNAP_CASES:
        sim = snapshot_sim("shard", comp)
        base = sim.run(snapshot_schedule(False))
        d = root / name
        crashed = False
        try:
            sim.run(snapshot_schedule(True), resil=Resilience(
                snapshot_dir=str(d / "shard"), snapshot_every=SNAP_EVERY))
        except SimulatedCrash:
            crashed = True
        dist.barrier()
        if rank == 0:
            shutil.copytree(d / "shard", d / "mid")
            stacked = snapshot_sim("scan", comp)
            try:
                stacked.run(snapshot_schedule(True), resil=Resilience(
                    snapshot_dir=str(d / "stacked"),
                    snapshot_every=SNAP_EVERY))
            except SimulatedCrash:
                pass
            # a newer snapshot cut short by a crash beside the newest
            shutil.copytree(d / "shard", d / "cut")
            last = SnapshotManager(d / "cut").steps()[-1]
            for suffix in (".npz", ".meta.json"):
                shutil.copy(d / "cut" / f"snap-{last:08d}{suffix}",
                            d / "cut" / f"snap-{last + 1:08d}{suffix}")
            npz = d / "cut" / f"snap-{last + 1:08d}.npz"
            raw = npz.read_bytes()
            npz.write_bytes(raw[:len(raw) // 2])
        dist.barrier()
        resumed, step = _resumed_from(sim, d / "shard")
        from_stacked, step_stacked = _resumed_from(sim, d / "stacked")
        from_cut, step_cut = _resumed_from(sim, d / "cut")
        glob = sim.global_params
        out[name] = {"crashed": crashed,
                     "steps": (step, step_stacked, step_cut),
                     "base": glob(base.params),
                     "resumed": glob(resumed.params),
                     "from_stacked": glob(from_stacked.params),
                     "from_cut": glob(from_cut.params),
                     "dir": str(d / "mid")}
    return out


def _steps():
    model = build_model(CFG)
    out = {}
    for name, mp, algo_name, topo_name, comp, gossip in STEP_CASES:
        mesh = make_federation_mesh(N, mp)
        topo = Topology.make(topo_name, N)
        algo = make_algorithm(algo_name, weight_decay=1e-4)
        glob = params()
        specs = federation_specs(glob, N, mesh)
        p = local_block(glob, specs, mesh)
        opt = algo.init(p)
        steps = [driver.make_shard_step(model, algo, a, mesh=mesh,
                                        topology=topo, specs=specs,
                                        compression=comp, gossip=gossip,
                                        telemetry=True, guard=GUARD)
                 for a in adapters()]
        L = N // mesh.node.size
        carries = [init_node_metrics(L, "cpu"), init_node_guard(L, "cpu")]
        if steps[0].comm:
            carries.insert(0, comm_block(steps[0].init_comm(glob), specs,
                                         mesh))
        losses = []
        for s, batch in enumerate(batches()):
            step = steps[0 if s < PLAIN_STEPS else 1]
            p, opt, loss, *carries = step(p, opt, batch, LR, *carries)
            losses.append(float(loss))
        out[name] = {"params": global_stack(p, specs, mesh),
                     "losses": losses,
                     "carries": [gather_nodes({k: v for k, v in c.items()
                                               if k != "steps"}, mesh)
                                 for c in carries[-2:]]}
    return out


def _mixers():
    """The sharded mixer alone on 2 node ranks, MIXER_STEPS steps from
    the global trees' comm state: each step's mixed trees and the final
    estimates (or previous trees), gathered."""
    out = {}
    xs = gossip_inputs()
    for name, topo_name, comp, gossip in MIXER_CASES:
        mesh = make_federation_mesh(N, 1)
        topo = Topology.make(topo_name, N)
        specs = federation_specs(xs[0], N, mesh)
        L = N // mesh.node.size
        mix = make_shard_mixer(topo, mesh.node, local_nodes=L,
                               compression=comp, gossip=gossip)
        comm = comm_block(mix.init_state(gossip_tree(1)), specs, mesh)
        ys = []
        for x in xs:
            bound = mix.bind(comm)
            ys.append(global_stack(bound(local_block(x, specs, mesh)),
                                   specs, mesh))
            comm = bound.finalize()
        state = "prev" if comp is None else "hat"
        out[name] = {"ys": ys, "state": gather_nodes(comm[state], mesh)}
    return out


def _rounds():
    model = build_model(CFG)
    inp = round_inputs()
    out = {}
    for topo_name in ("ring", "full"):
        mesh = make_federation_mesh(N, 1)
        topo = Topology.make(topo_name, N)
        hom = labeling.shard_label_round(inp["pub_logits"],
                                         inp["val_logits"], topo, ROUND_CFG,
                                         mesh=mesh)
        out[f"oneshot-{topo_name}"] = gather_nodes(tuple(hom), mesh)
    for mp in (1, 2):
        mesh = make_federation_mesh(N, mp)
        glob = params()
        specs = federation_specs(glob, N, mesh)
        hom = labeling.shard_streaming_label_round(
            model, local_block(glob, specs, mesh), inp["pub_x"],
            inp["val_x"], Topology.make("ring", N), ROUND_CFG, mesh=mesh,
            specs=specs)
        out[f"stream-{mp}d"] = gather_nodes(tuple(hom), mesh)
    return out


def _train():
    from repro_torch.launch.train import run_training
    cfg, tcfg, kw = train_args()
    res = run_training(cfg, tcfg, driver_mode="shard", model_parallel=2,
                       **kw)
    return {k: res[k] for k in ("params", "loss_history", "last_round")}


def rank_main(rank, world, snap_dir):
    torch.set_num_threads(1)
    return {"steps": _steps(), "rounds": _rounds(), "train": _train(),
            "mixers": _mixers(), "snapshots": _snapshots(snap_dir)}
