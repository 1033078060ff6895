"""Quickstart: the IDKD framework on the port, twin of the reference's
``examples/quickstart.py``.

Builds a 4-node ring, trains the paper's ResNet-EvoNorm on synthetic
non-IID data with QG-DSGDm-N, runs one IDKD homogenization round on the
sparse label backend (the streaming round through the ``head_select``
kernel) and prints the effect on the class distribution and accuracy.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
from repro_torch.core.idkd import skew_metric
from repro_torch.core.simulator import DecentralizedSimulator, SimResult
from repro_torch.data.synthetic import (make_classification_data,
                                        make_public_data)


def run(device="cuda") -> SimResult:
    """The quickstart's run: data, a 4-node ring with Dirichlet α=0.05
    shards, and IDKD at step 80 of 120."""
    data = make_classification_data(image_size=8, n_train=1024, n_test=512,
                                    noise=1.6, seed=0)
    public = make_public_data(data, n_public=512, kind="aligned", seed=1)
    tcfg = TrainConfig(algorithm="qg-dsgdm-n", topology="ring", num_nodes=4,
                       alpha=0.05, steps=120, batch_size=16, lr=0.5,
                       idkd=IDKDConfig(start_step=80,
                                       temperature=10.0,
                                       label_backend="sparse"))
    mcfg = SMALL_CONFIG.replace(image_size=8)
    sim = DecentralizedSimulator(mcfg, tcfg, data, public, kd_mode="idkd",
                                 eval_every=40, device=device)
    return sim.run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    pre = skew_metric(result.pre_hist)
    post = skew_metric(result.post_hist)
    print(f"accuracy history : {[round(a, 3) for a in result.acc_history]}")
    print(f"final consensus accuracy: {result.final_acc:.3f}")
    print(f"class-skew (TV from uniform): {pre:.3f} -> {post:.3f}")
    print(f"public samples kept by MSP detector: {result.id_fraction:.2f}")
    print(f"per-node MSP thresholds: {np.round(result.thresholds, 3)}")


if __name__ == "__main__":
    main()
