"""Paper Table 2/5: accuracy vs Dirichlet α for the method grid on a ring.

Methods: DSGD, QG-DSGDm-N, QG-DSGDm-N+KD (vanilla), QG-IDKD (ours),
SGD-Centralized (IID upper bound), on the synthetic CIFAR stand-in;
validation is directional against the paper's ordering:
    IDKD > vanilla KD ≥ QG-DSGDm-N > DSGD at high skew (α = 0.05),
    gaps shrinking as α grows.
"""
from __future__ import annotations

import time

from repro_torch.paper.common import mean_std, run_cell

METHODS = ["dsgd", "qg-dsgdm-n", "qg-dsgdm-n+kd", "qg-idkd",
           "sgd-centralized"]
ALPHAS = [1.0, 0.1, 0.05]


def run(nodes: int = 8, seeds=(4,), quick: bool = True, *,
        setting: str = "reference", device="cuda"):
    rows = []
    csv = []
    for method in METHODS:
        row = {"method": method}
        for alpha in ALPHAS:
            t0 = time.time()
            cells = [run_cell(method, alpha, nodes=nodes, seed=s,
                              setting=setting, device=device)
                     for s in seeds]
            row[f"alpha={alpha}"] = mean_std(cells)
            csv.append((f"table2/{method}/alpha{alpha}",
                        (time.time() - t0) * 1e6 / max(cells[0]['steps'], 1),
                        f"acc={cells[0]['final_acc']*100:.2f}"))
        rows.append(row)
    return rows, csv


def render(rows) -> str:
    cols = ["method"] + [f"alpha={a}" for a in ALPHAS]
    lines = [" | ".join(cols), " | ".join(["---"] * len(cols))]
    for r in rows:
        lines.append(" | ".join(str(r[c]) for c in cols))
    return "\n".join(lines)
