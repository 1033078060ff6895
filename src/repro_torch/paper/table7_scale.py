"""Paper Table 7: scalability in the number of nodes (ring)."""
from __future__ import annotations

import time

from repro_torch.paper.common import mean_std, run_cell

NODES = [8, 16]
METHODS = ["qg-dsgdm-n", "qg-idkd"]


def run(alpha: float = 0.05, seeds=(4,), *, setting: str = "reference",
        device="cuda"):
    rows, csv = [], []
    for method in METHODS:
        row = {"method": method}
        for n in NODES:
            t0 = time.time()
            cells = [run_cell(method, alpha, nodes=n, seed=s,
                              setting=setting, device=device)
                     for s in seeds]
            row[f"ring{n}"] = mean_std(cells)
            csv.append((f"table7/{method}/n{n}", (time.time() - t0) * 1e6,
                        f"acc={cells[0]['final_acc']*100:.2f}"))
        rows.append(row)
    return rows, csv


def render(rows) -> str:
    cols = list(rows[0].keys())
    lines = [" | ".join(cols), " | ".join(["---"] * len(cols))]
    for r in rows:
        lines.append(" | ".join(str(r[c]) for c in cols))
    return "\n".join(lines)
