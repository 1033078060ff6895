"""The slice's main path at full width, shared by ``chip_smoke.py`` and
:mod:`repro_torch.trace_main_path`: the paper's ResNet-20 (stages
(3, 3, 3), width 16, 32×32×3, 10 classes) on 16 ring nodes with
QG-DSGDm-N at the reference's default lr 0.5, Dirichlet α = 0.1, batch
32, synthetic CIFAR-sized data with 2048 aligned public samples, and one
streaming IDKD round on the sparse label backend halfway through.

The run is long enough that the consensus model learns before the round:
the round's labels come from nodes that are past chance, and the KD
phase lowers the eval NLL further.
"""
from __future__ import annotations

from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import CONFIG
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.data.synthetic import (make_classification_data,
                                        make_public_data)

STEPS = 240
ROUND_STEP = 120
EVAL_EVERY = 60


def full_width_sim(device="cuda") -> DecentralizedSimulator:
    data = make_classification_data(image_size=32, n_train=8192, n_val=512,
                                    n_test=1024, noise=1.6, seed=0)
    public = make_public_data(data, n_public=2048, kind="aligned", seed=1)
    icfg = IDKDConfig(start_step=ROUND_STEP, temperature=10.0,
                      label_backend="sparse", stream_labels=True)
    tcfg = TrainConfig(algorithm="qg-dsgdm-n", topology="ring",
                       num_nodes=16, alpha=0.1, steps=STEPS, batch_size=32,
                       lr=0.5, idkd=icfg)
    return DecentralizedSimulator(CONFIG, tcfg, data, public,
                                  kd_mode="idkd", eval_every=EVAL_EVERY,
                                  device=device)
