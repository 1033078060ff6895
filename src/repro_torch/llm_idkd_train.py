"""IDKD on a language model, twin of the reference's
``examples/llm_idkd_train.py``: decentralized next-token training over a
non-IID topic-partitioned corpus with top-k sparse label exchange, the
same ``run_training`` call at ``reduced()``, on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.llm_idkd_train --arch qwen3-1.7b \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.launch.train import run_training


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="any assigned architecture id")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    tcfg = TrainConfig(num_nodes=args.nodes, steps=args.steps, lr=0.1,
                       alpha=0.1, batch_size=8,
                       idkd=IDKDConfig(start_step=args.steps // 2,
                                       label_topk=8, kd_weight=0.3))
    out = run_training(cfg, tcfg, seq_len=48, n_seqs=256, n_public=32,
                       use_idkd=True, log_every=5, device=args.device)
    print(f"loss history: {[round(x, 3) for x in out['loss_history']]}")
    return out


if __name__ == "__main__":
    main()
