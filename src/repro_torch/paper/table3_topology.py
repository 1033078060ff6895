"""Paper Table 3: ring vs social (Florentine-families) topologies."""
from __future__ import annotations

import time

from repro_torch.paper.common import mean_std, run_cell

GRID = [("ring", 8), ("social", 15)]
METHODS = ["qg-dsgdm-n", "qg-idkd"]
ALPHAS = [0.1, 0.05]


def run(seeds=(4,), *, setting: str = "reference", device="cuda"):
    rows, csv = [], []
    for method in METHODS:
        row = {"method": method}
        for topo, n in GRID:
            for alpha in ALPHAS:
                t0 = time.time()
                cells = [run_cell(method, alpha, nodes=n, topology=topo,
                                  seed=s, setting=setting, device=device)
                         for s in seeds]
                row[f"{topo}{n}/α={alpha}"] = mean_std(cells)
                csv.append((f"table3/{method}/{topo}{n}/a{alpha}",
                            (time.time() - t0) * 1e6,
                            f"acc={cells[0]['final_acc']*100:.2f}"))
        rows.append(row)
    return rows, csv


def render(rows) -> str:
    cols = list(rows[0].keys())
    lines = [" | ".join(cols), " | ".join(["---"] * len(cols))]
    for r in rows:
        lines.append(" | ".join(str(r[c]) for c in cols))
    return "\n".join(lines)
