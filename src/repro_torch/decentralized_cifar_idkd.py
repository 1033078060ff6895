"""End-to-end run on the port, twin of the reference's
``examples/decentralized_cifar_idkd.py``: the paper's model for a few
hundred decentralized steps on an 8-node ring with α=0.05 non-IID data,
comparing QG-DSGDm-N, vanilla KD and QG-IDKD (the paper's Table 2 row
at reduced scale), then saving the best method's consensus checkpoint.

``--rounds K`` re-homogenizes K times, ``--churn`` drops nodes mid-run
(``node@down-up``, e.g. ``7@120-200``: masked Metropolis gossip keeps
the survivors doubly stochastic), and ``--telemetry DIR`` writes the
QG-IDKD run's ``run.jsonl`` and ``trace.json``. The per-round
communication ledger is printed for the IDKD run. The checkpoint is the
node average of the best run's params in the reference's layout
(``models.convert.to_jax_params``), so either package's
``load_checkpoint`` reads it.

    PYTHONPATH=src python -m repro_torch.decentralized_cifar_idkd \\
        [--steps 300] [--rounds 3] [--churn 7@120-200] \\
        [--checkpoint PATH] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import sched
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
from repro_torch.core.idkd import skew_metric
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.data.synthetic import (make_classification_data,
                                        make_public_data)
from repro_torch.launch.steps import consensus_params
from repro_torch.models.convert import to_jax_params

METHODS = {
    "QG-DSGDm-N": ("qg-dsgdm-n", None),
    "QG-DSGDm-N + KD": ("qg-dsgdm-n", "vanilla"),
    "QG-IDKD (ours)": ("qg-dsgdm-n", "idkd"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=4)   # paper seeds: 4, 34, 5
    ap.add_argument("--rounds", type=int, default=1,
                    help="IDKD homogenization rounds (re-labeled each time)")
    ap.add_argument("--every-k", type=int, default=0,
                    help="steps between rounds (default: fit evenly)")
    ap.add_argument("--churn", default="",
                    help="churn spec node@down-up[,...], e.g. 7@120-200")
    ap.add_argument("--telemetry", default="", metavar="DIR",
                    help="write the QG-IDKD run's telemetry (run.jsonl + "
                         "trace.json) under DIR")
    ap.add_argument("--checkpoint", default="experiments/e2e_consensus",
                    metavar="PATH",
                    help="where the consensus checkpoint goes "
                         "(PATH.npz and PATH.meta.json)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = make_classification_data(image_size=8, n_train=1024, n_val=256,
                                    n_test=512, noise=2.2, seed=0)
    public = make_public_data(data, n_public=768, kind="aligned", seed=1)
    mcfg = SMALL_CONFIG.replace(image_size=8)
    start = int(args.steps * 0.6)
    every_k = args.every_k or sched.fit_every_k(args.steps, start,
                                                args.rounds)
    churn = (sched.parse_churn(args.churn, args.nodes, args.steps)
             if args.churn else ())

    results = {}
    for name, (algo, kd) in METHODS.items():
        tcfg = TrainConfig(algorithm=algo, num_nodes=args.nodes,
                           alpha=args.alpha, steps=args.steps, batch_size=16,
                           lr=0.5, seed=args.seed,
                           idkd=IDKDConfig(start_step=start,
                                           temperature=10.0,
                                           every_k_steps=every_k,
                                           num_rounds=args.rounds))
        sim = DecentralizedSimulator(mcfg, tcfg, data, public, kd_mode=kd,
                                     eval_every=max(args.steps // 6, 1),
                                     device=args.device)
        schedule = sched.compile_schedule(
            tcfg.steps, sim.eval_every,
            round_steps=sim.default_schedule().round_steps, events=churn)
        telemetry = None
        if args.telemetry and kd == "idkd":
            from repro_torch.obs import Telemetry
            telemetry = Telemetry(args.telemetry, trace=True,
                                  meta={"method": name, "steps": args.steps,
                                        "nodes": args.nodes,
                                        "alpha": args.alpha})
        try:
            r = sim.run(schedule=schedule, telemetry=telemetry)
        finally:
            if telemetry is not None:
                telemetry.close()
        results[name] = r
        extra = ""
        if r.post_hist is not None:
            extra = (f"  skew {skew_metric(r.pre_hist):.3f}"
                     f"->{skew_metric(r.post_hist):.3f}"
                     f"  id_frac {r.id_fraction:.2f}"
                     f"  rounds {len(r.rounds)}")
        print(f"{name:18s} acc={r.final_acc*100:6.2f}%  "
              f"curve={[round(a, 2) for a in r.acc_history]}{extra}",
              flush=True)

    idkd_run = results["QG-IDKD (ours)"]
    print("\nper-round communication ledger (QG-IDKD):")
    for row in idkd_run.ledger["per_round"]:
        print(f"  round {row['round']}: {row['gossip_bytes']/1e6:8.2f} MB "
              f"gossip over {row['steps']} steps, "
              f"{row['labels_bytes']/1e3:8.2f} kB labels")

    best = max(results.items(), key=lambda kv: kv[1].final_acc)
    print(f"\nbest method: {best[0]} ({best[1].final_acc*100:.2f}%)")
    save_checkpoint(args.checkpoint,
                    to_jax_params(consensus_params(best[1].params)),
                    step=args.steps,
                    extra={"method": best[0],
                           "final_acc": best[1].final_acc})
    print(f"checkpoint written to {args.checkpoint}.npz")
    return results


if __name__ == "__main__":
    main()
