"""The paper's experiment harness on the port: ``run_cell`` runs one
(method × α × topology × n) cell of the simulator, with JSON result
caching, for the table modules beside it. A copy of the reference's
``benchmarks/common.py`` that keeps its module name, under two settings:

* ``"reference"`` — the reference harness exactly: ResNet-8
  (``SMALL_CONFIG``) at 8 × 8 images, 768 training and 768 public
  samples at noise 2.0, batch 16, the ``IDKDConfig`` defaults (the dense
  label backend) with KD from 0.65 of the run at T = 4, lr 0.5 for the
  QG methods and centralized SGD (else 0.1), weight decay 1e-4 for the
  QG methods (else 5e-4), an eval every ``steps // 4`` over 2 batches;
* ``"full"`` — the main path's width (``repro_torch.mainpath``):
  ResNet-20 at 32 × 32, 8192 / 512 / 1024 images at noise 1.6, 2048
  public samples of the requested kind, batch 32, the main path's round
  (streaming, sparse, T = 10), the same nodes, topologies, α, seeds and
  KD start fraction, an eval every ``steps // 4`` over the whole test
  set, and each method's lr from :data:`FULL_WIDTH_LR`.

RelaySGD runs on a chain in both. Results are cached under
``experiments/bench_torch/`` (``REPRO_BENCH_CACHE``), tagged with the
setting and the device so that a result is served only to a run of the
same kind; ``REPRO_BENCH_STEPS`` sets the default depth, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import IDKDConfig, ModelConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import CONFIG, SMALL_CONFIG
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.data.synthetic import (ClassificationData,
                                        make_classification_data,
                                        make_public_data)

CACHE_DIR = os.environ.get("REPRO_BENCH_CACHE", "experiments/bench_torch")

# the reference's quick-mode defaults: small images, short runs, noise
# set so that accuracy saturates well below 100%
IMAGE_SIZE = 8
N_TRAIN = 768
N_PUBLIC = 768
NOISE = 2.0
STEPS = int(os.environ.get("REPRO_BENCH_STEPS", "300"))
BATCH = 16
KD_START_FRAC = 0.65          # label exchange after the plateau (paper: 240/300)
KD_TEMPERATURE = 4.0          # tuned on validation, as the paper tunes T

_METHODS = {
    # name -> (algorithm, kd_mode)
    "dsgd": ("dsgd", None),
    "relay-sgd": ("relaysgd", None),
    "qg-dsgdm-n": ("qg-dsgdm-n", None),
    "qg-dsgdm-n+kd": ("qg-dsgdm-n", "vanilla"),
    "qg-idkd": ("qg-dsgdm-n", "idkd"),
    "sgd-centralized": ("centralized", None),
}


def harness_rule(algorithm: str) -> Tuple[float, float]:
    """The reference harness's (lr, weight decay) for an algorithm: lr
    0.5 for the QG methods and centralized SGD, else 0.1; weight decay
    1e-4 for the QG methods, else 5e-4."""
    qg = "qg" in algorithm
    return (0.5 if qg or algorithm == "centralized" else 0.1,
            1e-4 if qg else 5e-4)


# The "full" setting's lr per method; weight decay stays the harness's.
# The harness's rule, unless another lr of {0.5, 0.2, 0.1, 0.05, 0.02}
# ended the sweep (``python -m repro_torch.paper.lr_sweep --steps 300``:
# α 0.1, the 8-ring, the PAPER phase's depth) with an eval NLL lower by
# more than 0.05; then the lowest-NLL lr. PERF.md §5, "lr sweep" (final
# eval NLL, H100): DSGD 0.5631 at 0.2 against 0.7566 at its rule's 0.1;
# centralized SGD 0.0365 at 0.05 against 2.3053 at 0.5 (a constant
# predictor); RelaySGD and the QG methods keep their rule.
FULL_WIDTH_LR = {"dsgd": 0.2, "relay-sgd": 0.1, "qg-dsgdm-n": 0.5,
                 "qg-dsgdm-n+kd": 0.5, "qg-idkd": 0.5,
                 "sgd-centralized": 0.05}


@dataclass(frozen=True)
class Setting:
    """What a setting fixes of a cell: the model, the data, the batch,
    the round (every IDKDConfig field but ``start_step``) and the eval."""
    model: ModelConfig
    n_train: int
    n_val: int
    n_test: int
    noise: float
    n_public: int
    batch: int
    idkd: IDKDConfig
    eval_batches: int


SETTINGS = {
    "reference": Setting(SMALL_CONFIG.replace(image_size=IMAGE_SIZE),
                         N_TRAIN, 256, 512, NOISE, N_PUBLIC, BATCH,
                         IDKDConfig(temperature=KD_TEMPERATURE), 2),
    "full": Setting(CONFIG, 8192, 512, 1024, 1.6, 2048, 32,
                    IDKDConfig(temperature=10.0, label_backend="sparse",
                               stream_labels=True), 4),
}

_data_cache: Dict[Any, Any] = {}


def get_data(seed: int = 0, setting: str = "reference") -> ClassificationData:
    key = ("data", seed, setting)
    if key not in _data_cache:
        s = SETTINGS[setting]
        _data_cache[key] = make_classification_data(
            image_size=s.model.image_size, n_train=s.n_train,
            n_val=s.n_val, n_test=s.n_test, noise=s.noise, seed=seed)
    return _data_cache[key]


def get_public(kind: str = "aligned", seed: int = 0,
               setting: str = "reference") -> np.ndarray:
    key = ("pub", kind, seed, setting)
    if key not in _data_cache:
        _data_cache[key] = make_public_data(
            get_data(seed, setting), n_public=SETTINGS[setting].n_public,
            kind=kind, seed=seed + 1)
    return _data_cache[key]


def cell_lr(method: str, setting: str) -> Tuple[float, float]:
    """(lr, weight decay) of ``method`` under ``setting``."""
    lr, wd = harness_rule(_METHODS[method][0])
    return (FULL_WIDTH_LR[method] if setting == "full" else lr), wd


def run_cell(method: str, alpha: float, nodes: int = 8,
             topology: str = "ring", public_kind: str = "aligned",
             seed: int = 4, steps: Optional[int] = None,
             use_cache: bool = True, *, setting: str = "reference",
             device="cuda", lr: Optional[float] = None) -> Dict[str, Any]:
    """One simulator run; returns a JSON-able result dict (the
    reference's keys). ``lr`` overrides the setting's rule (the lr
    sweep)."""
    steps = steps or STEPS
    s = SETTINGS[setting]
    tag = (f"{method}_a{alpha}_n{nodes}_{topology}_{public_kind}_s{seed}"
           f"_t{steps}_{setting}_{torch.device(device).type}"
           + ("" if lr is None else f"_lr{lr}"))
    path = os.path.join(CACHE_DIR, tag + ".json")
    if use_cache and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    algorithm, kd_mode = _METHODS[method]
    topo = "chain" if algorithm == "relaysgd" else topology
    rule_lr, wd = cell_lr(method, setting)
    tcfg = TrainConfig(
        algorithm=algorithm, topology=topo, num_nodes=nodes, alpha=alpha,
        steps=steps, batch_size=s.batch, seed=seed,
        lr=rule_lr if lr is None else lr, weight_decay=wd,
        idkd=dataclasses.replace(s.idkd,
                                 start_step=int(steps * KD_START_FRAC)))
    data = get_data(seed=0, setting=setting)
    pub = get_public(public_kind, setting=setting) if kd_mode else None
    sim = DecentralizedSimulator(s.model, tcfg, data, pub, kd_mode=kd_mode,
                                 eval_every=max(steps // 4, 1),
                                 eval_batches=s.eval_batches, device=device)
    r = sim.run()
    out = {
        "method": method, "alpha": alpha, "nodes": nodes,
        "topology": topo, "public_kind": public_kind, "seed": seed,
        "steps": steps,
        "final_acc": r.final_acc,
        "acc_history": r.acc_history,
        "loss_history": r.loss_history,
        "consensus_history": r.consensus_history,
        "id_fraction": r.id_fraction,
        "comm_bytes_per_iter": r.comm_bytes_per_iter,
        "label_bytes_total": r.label_bytes_total,
        "pre_hist": np.asarray(r.pre_hist).tolist()
        if r.pre_hist is not None else None,
        "post_hist": np.asarray(r.post_hist).tolist()
        if r.post_hist is not None else None,
        "wall_seconds": r.wall_seconds,
    }
    os.makedirs(CACHE_DIR, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    return out


def mean_std(cells) -> str:
    accs = [c["final_acc"] * 100 for c in cells]
    return f"{np.mean(accs):.2f} ± {np.std(accs):.2f}"
