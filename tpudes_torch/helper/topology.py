"""The BRITE analog's Barabási–Albert graph, as plain arrays.

Counterpart of ``tpudes/helper/topology.py`` (``:32-110``, ``:151-211``)
for ``model="BA"``: :func:`component_labels`, :func:`barabasi_albert`,
:class:`BriteGraph` and :class:`BriteTopologyHelper`'s ``Generate``, pure
numpy, the same draws in the same order from the same generator, so the
same arguments give the same arrays.  The Waxman model and
``BuildTopology`` (the host object graph) are not ported.
"""

from __future__ import annotations

import numpy as np

from tpudes_torch.core.rng import seeded_bulk_generator


def component_labels(n: int, edges) -> np.ndarray:
    """``(n,)`` connected-component root label per vertex (path-halving
    union-find; ``topology.py:32-50``)."""
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[ru] = rv
    return np.asarray([find(i) for i in range(n)])


class BriteGraph:
    """Plain arrays: ``edges`` (E, 2) int32, ``delay_s`` (E,) float64,
    ``rate_bps`` (E,) float64, ``pos`` (N, 2) float64."""

    def __init__(self, n, edges, delay_s, rate_bps, pos):
        self.n = int(n)
        self.edges = np.asarray(edges, np.int32)
        self.delay_s = np.asarray(delay_s, np.float64)
        self.rate_bps = np.asarray(rate_bps, np.float64)
        self.pos = pos

    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    def is_connected(self) -> bool:
        labels = component_labels(self.n, self.edges)
        return bool((labels == labels[0]).all())


def barabasi_albert(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """``(E, 2)`` edge list: preferential attachment, ``m`` edges per new
    node, from an ``(m + 1)``-clique; a uniform draw from the flat
    endpoint array picks a node with probability proportional to its
    degree (``topology.py:73-106``)."""
    if n <= m:
        raise ValueError(f"need n > m (got n={n}, m={m})")
    seed_edges = [(i, j) for i in range(m + 1) for j in range(i + 1, m + 1)]
    n_edges = len(seed_edges) + m * (n - m - 1)
    edges = np.empty((n_edges, 2), np.int32)
    edges[: len(seed_edges)] = seed_edges
    endpoints = np.empty(2 * n_edges, np.int32)
    endpoints[: 2 * len(seed_edges)] = edges[: len(seed_edges)].ravel()
    e_cnt, ep_cnt = len(seed_edges), 2 * len(seed_edges)
    targets = np.empty(m, np.int32)
    for v in range(m + 1, n):
        seen = 0
        while seen < m:
            draw = endpoints[rng.integers(0, ep_cnt, size=2 * (m - seen))]
            for t in draw:
                if seen < m and t not in targets[:seen]:
                    targets[seen] = t
                    seen += 1
        edges[e_cnt: e_cnt + m, 0] = v
        edges[e_cnt: e_cnt + m, 1] = targets
        endpoints[ep_cnt: ep_cnt + m] = v
        endpoints[ep_cnt + m: ep_cnt + 2 * m] = targets
        e_cnt += m
        ep_cnt += 2 * m
    return edges


class BriteTopologyHelper:
    """``BriteTopologyHelper`` (``topology.py:151-211``) for the BA model:
    link delays are the plane distance over 2e8 m/s, rates uniform in
    ``[bw_min_bps, bw_max_bps]``.  ``rng_seed`` and ``rng_run`` are the
    reference's global ``RngSeed`` and ``RngRun``."""

    def __init__(self, model: str = "BA", n: int = 100, m: int = 2,
                 bw_min_bps: float = 10e6, bw_max_bps: float = 100e6,
                 plane: float = 4000e3, seed: int = 1, rng_seed: int = 1,
                 rng_run: int = 1):
        if model.upper() != "BA":
            raise NotImplementedError(
                f"BRITE model {model!r}: the port generates BA graphs only")
        self.model = model
        self.n = int(n)
        self.m_links = int(m)
        self.bw_min = bw_min_bps
        self.bw_max = bw_max_bps
        self.plane = plane
        self.seed = seed
        self.rng_seed = rng_seed
        self.rng_run = rng_run
        self.graph: BriteGraph | None = None

    def Generate(self) -> BriteGraph:  # noqa: N802 — the reference's name
        rng = seeded_bulk_generator(self.seed, self.rng_seed, self.rng_run)
        edges = barabasi_albert(self.n, self.m_links, rng)
        pos = rng.uniform(0.0, self.plane, size=(self.n, 2))
        dist = np.sqrt(((pos[edges[:, 0]] - pos[edges[:, 1]]) ** 2).sum(-1))
        delay_s = dist / 2e8
        rate = rng.uniform(self.bw_min, self.bw_max, size=len(edges))
        self.graph = BriteGraph(self.n, edges, delay_s, rate, pos)
        return self.graph
