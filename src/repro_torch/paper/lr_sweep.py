"""The "full" setting's lr sweep: each method of the harness at
lr ∈ {0.5, 0.2, 0.1, 0.05, 0.02}, α 0.1, the 8-ring, and the picks of
the rule that fixes :data:`repro_torch.paper.common.FULL_WIDTH_LR`: the
harness's lr unless another ends with an eval NLL lower by more than
0.05, then the lowest-NLL lr.

    PYTHONPATH=src python -m repro_torch.paper.lr_sweep --steps 300

Prints one line per (method, lr) and, last, one JSON object of the
picks. Cells are cached as ``run_cell`` caches them, so with the cache
of a card run (``REPRO_BENCH_CACHE``) the picks are printed again
without a card.
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch.paper.common import _METHODS, harness_rule, run_cell

LRS = (0.5, 0.2, 0.1, 0.05, 0.02)
NLL_MARGIN = 0.05


def pick(method: str, final_nll: dict) -> float:
    """The rule: ``final_nll`` maps each lr to the run's last eval NLL (a
    diverged run's NaN counts as infinite)."""
    rule = harness_rule(_METHODS[method][0])[0]
    nll = {lr: v if math.isfinite(v) else math.inf
           for lr, v in final_nll.items()}
    best = min(nll, key=nll.get)
    return best if nll[best] < nll[rule] - NLL_MARGIN else rule


def run(steps=None, device="cuda"):
    picks = {}
    for method in _METHODS:
        nll = {}
        for lr in LRS:
            c = run_cell(method, 0.1, steps=steps, setting="full",
                         device=device, lr=lr)
            nll[lr] = c["loss_history"][-1]
            print(f"lr_sweep {method} lr {lr}: final accuracy "
                  f"{c['final_acc']:.4f}, eval NLL "
                  f"{[round(x, 4) for x in c['loss_history']]}, "
                  f"{c['wall_seconds']:.1f} s", flush=True)
        picks[method] = pick(method, nll)
    return picks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.device)))


if __name__ == "__main__":
    main()
