"""Per-round communication ledger: gossip and label bytes, per node.

* **gossip** — every training step each active node ships its
  parameters to each active neighbour, at the wire dtype's width;
* **labels** — at each homogenization round each node serializes its
  D_ID label payload once (``distill.label_bytes``).

Round r spans from the r-th homogenization step to the next one (round
0 is everything before the first round).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.topology import Topology


def wire_elem_bytes(wire_dtype: str, param_dtype: str) -> int:
    """Bytes per parameter element on the gossip wire."""
    if wire_dtype == "float32":
        return 4
    if param_dtype == "bfloat16":
        return 2
    return int(np.dtype(param_dtype).itemsize)


def gossip_bytes_per_step(topology: Topology, active: Optional[np.ndarray],
                          param_count: int, elem_bytes: int) -> np.ndarray:
    """(n,) bytes each node sends per step: active degree · params ·
    bytes per element. Down nodes (and links to them) carry nothing."""
    n = topology.n
    act = np.ones(n, bool) if active is None else np.asarray(active, bool)
    deg = np.array([sum(act[j] for j in topology.neighbors(i))
                    if act[i] else 0 for i in range(n)], np.int64)
    return deg * int(param_count) * int(elem_bytes)


@dataclass
class LedgerEntry:
    round_index: int
    kind: str                 # "gossip" | "labels"
    start: int
    stop: int
    per_node: np.ndarray      # (n,) bytes

    @property
    def total(self) -> float:
        return float(self.per_node.sum())


@dataclass
class CommLedger:
    """Append-only per-(node, round) byte ledger for one run."""
    num_nodes: int
    meta: Dict = field(default_factory=dict)
    entries: List[LedgerEntry] = field(default_factory=list)

    def log_gossip(self, round_index: int, start: int, stop: int,
                   per_node_bytes_per_step: np.ndarray) -> None:
        per_node = np.asarray(per_node_bytes_per_step,
                              np.float64) * (stop - start)
        self.entries.append(LedgerEntry(round_index, "gossip", start, stop,
                                        per_node))

    def log_labels(self, round_index: int, step: int,
                   per_node_bytes: np.ndarray) -> None:
        self.entries.append(LedgerEntry(
            round_index, "labels", step, step,
            np.asarray(per_node_bytes, np.float64)))

    def _sum(self, kind: str) -> float:
        return float(sum(e.total for e in self.entries if e.kind == kind))

    @property
    def gossip_bytes(self) -> float:
        return self._sum("gossip")

    @property
    def label_bytes(self) -> float:
        return self._sum("labels")

    @property
    def total_bytes(self) -> float:
        return self.gossip_bytes + self.label_bytes

    def gossip_steps(self) -> int:
        return sum(e.stop - e.start for e in self.entries
                   if e.kind == "gossip")

    def per_round(self) -> List[Dict]:
        """One row per round bucket: gossip + label bytes, totals and
        per-node breakdowns, and the steps the bucket spans."""
        out = []
        for r in sorted({e.round_index for e in self.entries}):
            row = {"round": r}
            for kind in ("gossip", "labels"):
                sel = [e for e in self.entries
                       if e.round_index == r and e.kind == kind]
                per_node = (np.sum([e.per_node for e in sel], axis=0)
                            if sel else np.zeros(self.num_nodes))
                row[f"{kind}_bytes"] = float(np.sum(per_node))
                row[f"{kind}_per_node"] = np.asarray(
                    per_node, np.float64).tolist()
            row["steps"] = sum(e.stop - e.start for e in self.entries
                               if e.round_index == r and e.kind == "gossip")
            out.append(row)
        return out

    def as_dict(self) -> Dict:
        return {"meta": dict(self.meta),
                "num_nodes": self.num_nodes,
                "gossip_bytes": self.gossip_bytes,
                "label_bytes": self.label_bytes,
                "total_bytes": self.total_bytes,
                "per_round": self.per_round()}
