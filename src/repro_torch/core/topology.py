"""Graph topologies + Metropolis–Hastings gossip mixing matrices (paper
§4.1), a numpy copy of the JAX package's ``core/topology.py``.

Parity with the reference is exact: same edges, same padded neighbour
arrays, same mixing matrices.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Florentine families marriage network (Breiger & Pattison 1986), 15 nodes.
FLORENTINE_FAMILIES = [
    "Acciaiuoli", "Albizzi", "Barbadori", "Bischeri", "Castellani",
    "Ginori", "Guadagni", "Lamberteschi", "Medici", "Pazzi", "Peruzzi",
    "Ridolfi", "Salviati", "Strozzi", "Tornabuoni",
]
_FLORENTINE_EDGES = [
    ("Acciaiuoli", "Medici"), ("Albizzi", "Ginori"), ("Albizzi", "Guadagni"),
    ("Albizzi", "Medici"), ("Barbadori", "Castellani"), ("Barbadori", "Medici"),
    ("Bischeri", "Guadagni"), ("Bischeri", "Peruzzi"), ("Bischeri", "Strozzi"),
    ("Castellani", "Peruzzi"), ("Castellani", "Strozzi"),
    ("Guadagni", "Lamberteschi"), ("Guadagni", "Tornabuoni"),
    ("Medici", "Ridolfi"), ("Medici", "Salviati"), ("Medici", "Tornabuoni"),
    ("Pazzi", "Salviati"), ("Peruzzi", "Strozzi"), ("Ridolfi", "Strozzi"),
    ("Ridolfi", "Tornabuoni"),
]


def ring_edges(n: int) -> List[Tuple[int, int]]:
    return [(i, (i + 1) % n) for i in range(n)]


def chain_edges(n: int) -> List[Tuple[int, int]]:
    return [(i, i + 1) for i in range(n - 1)]


def torus_edges(rows: int, cols: int) -> List[Tuple[int, int]]:
    e = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            e.append((i, r * cols + (c + 1) % cols))
            e.append((i, ((r + 1) % rows) * cols + c))
    return [(a, b) for a, b in e if a != b]


def full_edges(n: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def social_edges() -> List[Tuple[int, int]]:
    idx = {f: i for i, f in enumerate(FLORENTINE_FAMILIES)}
    return [(idx[a], idx[b]) for a, b in _FLORENTINE_EDGES]


def exponential_edges(n: int) -> List[Tuple[int, int]]:
    """Static exponential graph: i ~ i ± 2^k."""
    e = set()
    k = 1
    while k < n:
        for i in range(n):
            e.add(tuple(sorted((i, (i + k) % n))))
        k *= 2
    return [t for t in e if t[0] != t[1]]


def hierarchical_ring_edges(num_pods: int, nodes_per_pod: int
                            ) -> List[Tuple[int, int]]:
    """Ring of rings: a ring inside each pod, and node 0 of each pod on
    an outer ring."""
    e = []
    for p in range(num_pods):
        base = p * nodes_per_pod
        e += [(base + i, base + (i + 1) % nodes_per_pod)
              for i in range(nodes_per_pod)]
    for p in range(num_pods):
        e.append((p * nodes_per_pod, ((p + 1) % num_pods) * nodes_per_pod))
    return [(a, b) for a, b in set(tuple(sorted(t)) for t in e) if a != b]


class Topology:
    """Undirected gossip graph with Metropolis–Hastings mixing weights."""

    def __init__(self, n: int, edges: List[Tuple[int, int]], name: str = ""):
        self.n = n
        self.name = name
        self._cache: Dict = {}
        self.adj: Dict[int, List[int]] = {i: [] for i in range(n)}
        for a, b in edges:
            if b not in self.adj[a]:
                self.adj[a].append(b)
            if a not in self.adj[b]:
                self.adj[b].append(a)
        for v in self.adj.values():
            v.sort()

    @staticmethod
    def make(kind: str, n: int) -> "Topology":
        topo = Topology._make(kind, n)
        import logging

        from repro_torch.obs import log
        if log.enabled(logging.DEBUG):
            # spectral_gap is an eigendecomposition: paid only when the
            # debug line is shown
            log.debug("topology.make", kind=kind, n=n, name=topo.name,
                      edges=sum(len(v) for v in topo.adj.values()) // 2,
                      spectral_gap=round(topo.spectral_gap(), 4))
        return topo

    @staticmethod
    def _make(kind: str, n: int) -> "Topology":
        if kind == "ring":
            return Topology(n, ring_edges(n), f"ring{n}")
        if kind == "chain":
            return Topology(n, chain_edges(n), f"chain{n}")
        if kind == "full":
            return Topology(n, full_edges(n), f"full{n}")
        if kind == "social":
            if n != 15:
                raise ValueError("social (Florentine) topology has n=15")
            return Topology(15, social_edges(), "florentine15")
        if kind == "torus":
            r = int(np.sqrt(n))
            if r * r != n:
                raise ValueError("torus needs square n")
            return Topology(n, torus_edges(r, r), f"torus{n}")
        if kind == "exponential":
            return Topology(n, exponential_edges(n), f"exp{n}")
        raise ValueError(f"unknown topology {kind!r}")

    def neighbors(self, i: int) -> List[int]:
        return self.adj[i]

    def edge_key(self) -> Tuple:
        """Canonical hashable identity: (n, sorted undirected edges), so
        two graphs with the same wiring share one key."""
        cached = self._cache.get("edge_key")
        if cached is None:
            cached = (self.n, tuple(sorted(
                (i, j) for i, nbrs in self.adj.items()
                for j in nbrs if i < j)))
            self._cache["edge_key"] = cached
        return cached

    def degree(self, i: int) -> int:
        return len(self.adj[i])

    def max_degree(self) -> int:
        return max(self.degree(i) for i in range(self.n))

    def neighbor_arrays(self, include_self: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded neighbour lists ``(nbr (n, D) int32, valid (n, D) f32)``
        with D = max_degree (+1 with ``include_self``); slot d of row i is
        the d-th contributor to node i (self first). Padding slots point
        at node 0 with valid = 0 so gathers stay in bounds."""
        key = ("nbr_arrays", include_self)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        D = self.max_degree() + (1 if include_self else 0)
        nbr = np.zeros((self.n, max(D, 1)), np.int32)
        valid = np.zeros((self.n, max(D, 1)), np.float32)
        for i in range(self.n):
            row = ([i] if include_self else []) + self.adj[i]
            nbr[i, :len(row)] = row
            valid[i, :len(row)] = 1.0
        self._cache[key] = (nbr, valid)
        return nbr, valid

    def mixing_matrix(self, active=None) -> np.ndarray:
        """Metropolis–Hastings: W_ij = 1/(1+max(d_i,d_j)) on edges, rows
        sum to 1. ``active`` restricts the exchange to the induced
        subgraph of available nodes (down nodes get identity rows)."""
        n = self.n
        if active is None:
            act = np.ones(n, bool)
        else:
            act = np.asarray(active, bool)
            if act.shape != (n,):
                raise ValueError(f"active mask shape {act.shape} != ({n},)")
        deg = np.array([sum(act[j] for j in self.adj[i]) if act[i] else 0
                        for i in range(n)])
        W = np.zeros((n, n))
        for i in range(n):
            if not act[i]:
                continue
            for j in self.adj[i]:
                if act[j]:
                    W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        for i in range(n):
            W[i, i] = 1.0 - W[i].sum()
        return W

    def spectral_gap(self) -> float:
        """1 − |λ₂| of the mixing matrix: how fast gossip converges."""
        ev = np.linalg.eigvalsh(self.mixing_matrix())
        return float(1.0 - np.abs(ev)[::-1][1])

    def is_connected(self) -> bool:
        seen = {0}
        stack = [0]
        while stack:
            for j in self.adj[stack.pop()]:
                if j not in seen:
                    seen.add(j)
                    stack.append(j)
        return len(seen) == self.n

    def is_tree(self) -> bool:
        """Connected with n − 1 edges: the graphs RelaySGD runs on."""
        m = sum(len(v) for v in self.adj.values()) // 2
        return self.is_connected() and m == self.n - 1


class TimeVaryingTopology:
    """One-peer time-varying exponential graph: at step t every node
    talks to its ±2^(t mod ⌈log₂ n⌉) neighbour only."""

    def __init__(self, n: int):
        self.n = n
        self.num_rounds = max(1, int(np.ceil(np.log2(n))))

    def round_topology(self, t: int) -> Topology:
        k = 2 ** (t % self.num_rounds)
        edges = [(i, (i + k) % self.n) for i in range(self.n)]
        edges = [e for e in set(tuple(sorted(p)) for p in edges)
                 if e[0] != e[1]]
        return Topology(self.n, edges, f"onepeer{self.n}@{t}")

    def mixing_matrix(self, t: int) -> np.ndarray:
        return self.round_topology(t).mixing_matrix()
