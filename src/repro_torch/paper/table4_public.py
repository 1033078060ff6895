"""Paper Table 4: public-dataset choice (TinyImageNet/LSUN/Uniform-Noise →
our aligned/shifted/noise) — IDKD must stay ahead of vanilla KD on every
public set because the OoD detector selects the aligned subset."""
from __future__ import annotations

import time

from repro_torch.paper.common import mean_std, run_cell

KINDS = ["aligned", "shifted", "noise"]
METHODS = ["qg-dsgdm-n+kd", "qg-idkd"]


def run(alpha: float = 0.05, nodes: int = 8, seeds=(4,), *,
        setting: str = "reference", device="cuda"):
    rows, csv = [], []
    for method in METHODS:
        row = {"method": method}
        for kind in KINDS:
            t0 = time.time()
            cells = [run_cell(method, alpha, nodes=nodes, public_kind=kind,
                              seed=s, setting=setting, device=device)
                     for s in seeds]
            row[kind] = mean_std(cells)
            row[f"{kind}/id_frac"] = f"{cells[0]['id_fraction']:.2f}"
            csv.append((f"table4/{method}/{kind}", (time.time() - t0) * 1e6,
                        f"acc={cells[0]['final_acc']*100:.2f}"))
        rows.append(row)
    return rows, csv


def render(rows) -> str:
    cols = list(rows[0].keys())
    lines = [" | ".join(cols), " | ".join(["---"] * len(cols))]
    for r in rows:
        lines.append(" | ".join(str(r[c]) for c in cols))
    return "\n".join(lines)
