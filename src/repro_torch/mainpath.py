"""The slice's main path at full width, shared by ``chip_smoke.py`` and
:mod:`repro_torch.trace_main_path`: the paper's ResNet-20 (stages
(3, 3, 3), width 16, 32×32×3, 10 classes) on 16 ring nodes with
QG-DSGDm-N at the reference's default lr 0.5, Dirichlet α = 0.1, batch
32, synthetic CIFAR-sized data with 2048 aligned public samples, and one
streaming IDKD round on the sparse label backend halfway through.

The run is long enough that the consensus model learns before the round:
the round's labels come from nodes that are past chance, and the KD
phase lowers the eval NLL further.

:func:`grid_sim` runs the paper's method grid in the same setting: the
methods are the paper harness's (:mod:`repro_torch.paper.common`), with
each method's lr from its ``FULL_WIDTH_LR`` and the harness's weight
decay and chain for RelaySGD, and D² and gradient tracking under the
harness's rules of the other non-QG methods. The KD methods take the
main path's round (streaming, sparse, T = 10); ``qg-dsgdm-n+kd`` is that
round with the OoD filter off (``kd_mode="vanilla"``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.data.synthetic import (make_classification_data,
                                        make_public_data)
from repro_torch.paper.common import _METHODS, FULL_WIDTH_LR, harness_rule

STEPS = 240
ROUND_STEP = 120
EVAL_EVERY = 60

# method -> (algorithm, kd_mode)
METHODS = {**_METHODS, "d2": ("d2", None),
           "gradient-tracking": ("gradient-tracking", None)}


def grid_config(method: str, steps: int = STEPS,
                round_step: Optional[int] = None
                ) -> Tuple[TrainConfig, Optional[str]]:
    """``method``'s TrainConfig at the main path's width and its
    kd_mode: RelaySGD on a chain, the rest on the ring; the lr of
    ``FULL_WIDTH_LR`` (D² and gradient tracking: the harness's rule,
    0.1) and the harness's weight decay (1e-4 for the QG methods, else
    5e-4); the round at ``round_step`` (half the run when None)."""
    algorithm, kd_mode = METHODS[method]
    lr, wd = harness_rule(algorithm)
    icfg = IDKDConfig(start_step=steps // 2 if round_step is None
                      else round_step, temperature=10.0,
                      label_backend="sparse", stream_labels=True)
    tcfg = TrainConfig(
        algorithm=algorithm,
        topology="chain" if algorithm == "relaysgd" else "ring",
        num_nodes=16, alpha=0.1, steps=steps, batch_size=32,
        lr=FULL_WIDTH_LR.get(method, lr), weight_decay=wd, idkd=icfg)
    return tcfg, kd_mode


@functools.lru_cache(maxsize=1)
def grid_data():
    """The grid's data (made once a process; the simulators copy it):
    8192 training images and 2048 aligned public samples."""
    data = make_classification_data(image_size=32, n_train=8192, n_val=512,
                                    n_test=1024, noise=1.6, seed=0)
    return data, make_public_data(data, n_public=2048, kind="aligned",
                                  seed=1)


def grid_sim(method: str, steps: int = STEPS,
             round_step: Optional[int] = None, eval_every: int = EVAL_EVERY,
             device="cuda", *, topology: Optional[str] = None,
             driver_mode: str = "auto", model_parallel: int = 1,
             compression: Optional[Tuple[str, float]] = None,
             gossip: str = "sync") -> DecentralizedSimulator:
    """One method of the grid (a key of :data:`METHODS`) at full width:
    8192 training images, and 2048 aligned public samples for the KD
    methods. ``topology`` replaces the method's graph; ``driver_mode``
    and ``model_parallel`` pass to the simulator (``"shard"``: call this
    on every rank of a ``launch.dist`` run); ``compression`` (a (kind,
    frac) pair) and ``gossip`` set the run's gossip wire."""
    tcfg, kd_mode = grid_config(method, steps, round_step)
    if topology is not None:
        tcfg = dataclasses.replace(tcfg, topology=topology)
    if compression is not None:
        tcfg = dataclasses.replace(tcfg, compression=compression[0],
                                   compression_frac=compression[1])
    tcfg = dataclasses.replace(tcfg, gossip=gossip)
    data, public = grid_data()
    public = public if kd_mode else None
    return DecentralizedSimulator(CONFIG, tcfg, data, public,
                                  kd_mode=kd_mode, eval_every=eval_every,
                                  driver_mode=driver_mode,
                                  model_parallel=model_parallel,
                                  device=device)


def full_width_sim(device="cuda") -> DecentralizedSimulator:
    """The main path: ``qg-idkd`` for :data:`STEPS` steps, the round at
    :data:`ROUND_STEP`."""
    return grid_sim("qg-idkd", STEPS, ROUND_STEP, EVAL_EVERY, device)
