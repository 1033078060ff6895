"""Paper Figure 3: (a) class-distribution homogenization pre/post IDKD,
(b) convergence curves IDKD vs QG-DSGDm-N."""
from __future__ import annotations

import numpy as np

from repro_torch.core.idkd import skew_metric
from repro_torch.paper.common import run_cell


def run(alpha: float = 0.1, nodes: int = 8, seed: int = 4, *,
        setting: str = "reference", device="cuda"):
    cell = run_cell("qg-idkd", alpha, nodes=nodes, seed=seed,
                    setting=setting, device=device)
    base = run_cell("qg-dsgdm-n", alpha, nodes=nodes, seed=seed,
                    setting=setting, device=device)
    pre = np.asarray(cell["pre_hist"])
    post = np.asarray(cell["post_hist"])
    pre_skew = skew_metric(pre)
    post_skew = skew_metric(post)
    rows = [{
        "metric": "mean TV-from-uniform (skew)",
        "pre-IDKD": f"{pre_skew:.3f}", "post-IDKD": f"{post_skew:.3f}",
        "node0 empty classes pre": int((pre[0] == 0).sum()),
        "node0 empty classes post": int((post[0] < 1e-6).sum()),
    }]
    csv = [("fig3a/skew_pre", 0.0, f"{pre_skew:.4f}"),
           ("fig3a/skew_post", 0.0, f"{post_skew:.4f}"),
           ("fig3b/final_acc_idkd", 0.0, f"{cell['final_acc']*100:.2f}"),
           ("fig3b/final_acc_qgm", 0.0, f"{base['final_acc']*100:.2f}")]
    return rows, csv, {"idkd_curve": cell["acc_history"],
                       "qgm_curve": base["acc_history"]}
