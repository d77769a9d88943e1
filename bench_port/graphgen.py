"""The gene graph every configuration runs on, made from its fixed seed.

Hetionet v1.0 (Himmelstein et al., eLife 2017;6:e26726) is not shipped
with the repository, so its gene-gene part is drawn at its published counts:
each relation is a Chung-Lu graph whose expected degrees follow a power law
(``weights_i = i ** (-1 / (gamma - 1))`` over a permutation of the genes of
its own), drawn edge by edge with both ends in proportion to the weights,
self-loops and repeated pairs dropped, until exactly the relation's count
is reached.  Undirected relations are stored in both directions.  Pathways
("communities") have log-normal sizes, rescaled to the published number of
memberships, and draw their members in proportion to the same weights
(the first relation's).  Features are standard normal.

Everything is plain numpy on the host, so the program, the reference and
the CPU tests see the same graph from the same ``graph_seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class GeneGraph:
    """A generated graph: ``n`` genes, features ``x [n, F]``, the edges of
    each relation as ``[2, E_r]`` int64 (row 0 senders, row 1 receivers),
    in the configuration's relation order, and the pathways as sorted gene
    index arrays."""

    n: int
    x: np.ndarray
    relations: List[str]
    edges: Dict[str, np.ndarray]
    pathways: List[np.ndarray]

    def merged_edges(self) -> np.ndarray:
        """Every relation's edges, one after another (a multigraph: a pair
        in two relations is two edges)."""
        return np.concatenate([self.edges[r] for r in self.relations], axis=1)

    def names(self) -> List[str]:
        """One name a gene."""
        return [f"gene{i}" for i in range(self.n)]


def _degree_weights(rng: np.random.Generator, n: int, gamma: float) -> np.ndarray:
    """Power-law expected-degree weights over a random permutation of the
    genes, summing to 1."""
    w = np.empty(n, np.float64)
    w[rng.permutation(n)] = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (gamma - 1.0))
    return w / w.sum()


def _draw_pairs(rng, cdf: np.ndarray, n: int, m: int, directed: bool) -> np.ndarray:
    """Exactly ``m`` distinct pairs ``[2, m]`` (no self-loops; for an
    undirected relation the pair with the smaller index first), in the
    order first drawn."""
    codes = np.zeros(0, np.int64)
    while True:
        need = m - codes.size
        k = int(need * 1.3) + 1024
        u = np.minimum(np.searchsorted(cdf, rng.random(k), side="right"), n - 1)
        v = np.minimum(np.searchsorted(cdf, rng.random(k), side="right"), n - 1)
        keep = u != v
        u, v = u[keep], v[keep]
        if not directed:
            u, v = np.minimum(u, v), np.maximum(u, v)
        codes = np.concatenate([codes, u.astype(np.int64) * n + v])
        _, first = np.unique(codes, return_index=True)
        if first.size >= m:
            codes = codes[np.sort(first)[:m]]
            return np.stack([codes // n, codes % n])
        codes = codes[np.sort(first)]


def _pathway_sizes(rng, count: int, memberships: int, mean: float, sigma: float,
                   n: int) -> np.ndarray:
    """Log-normal sizes with the given mean, at least 1 and at most ``n``,
    then moved one member at a time until they sum to ``memberships``."""
    mu = np.log(mean) - 0.5 * sigma * sigma
    sizes = np.clip(np.rint(rng.lognormal(mu, sigma, count)), 1, n).astype(np.int64)
    while (diff := memberships - int(sizes.sum())) != 0:
        step = 1 if diff > 0 else -1
        pick = rng.choice(count, min(abs(diff), count), replace=False)
        pick = pick[(sizes[pick] + step >= 1) & (sizes[pick] + step <= n)]
        sizes[pick] += step
    return sizes


def _pathway_members(rng, cdf: np.ndarray, n: int, size: int) -> np.ndarray:
    """``size`` distinct genes drawn in proportion to the weights."""
    got = np.zeros(0, np.int64)
    while got.size < size:
        k = 2 * (size - got.size) + 16
        draw = np.minimum(np.searchsorted(cdf, rng.random(k), side="right"), n - 1)
        both = np.concatenate([got, draw])
        _, first = np.unique(both, return_index=True)
        got = both[np.sort(first)][:size]
    return np.sort(got)


def generate(graph_cfg: dict) -> GeneGraph:
    """The graph of one configuration's ``graph`` block: ``seed``, ``genes``,
    ``features``, ``gamma``, ``relations`` (a list of ``{"name", "edges",
    "directed"}``) and ``pathways`` (``count``, ``memberships``,
    ``size_mean``, ``size_sigma``)."""
    rng = np.random.default_rng(int(graph_cfg["seed"]))
    n = int(graph_cfg["genes"])
    gamma = float(graph_cfg["gamma"])
    x = rng.standard_normal((n, int(graph_cfg["features"])), dtype=np.float32)
    rels, edges, first_w = [], {}, None
    for rel in graph_cfg["relations"]:
        w = _degree_weights(rng, n, gamma)
        first_w = w if first_w is None else first_w
        pairs = _draw_pairs(rng, np.cumsum(w), n, int(rel["edges"]), bool(rel["directed"]))
        if not rel["directed"]:
            pairs = np.concatenate([pairs, pairs[::-1]], axis=1)
        rels.append(rel["name"])
        edges[rel["name"]] = pairs
    pw = graph_cfg["pathways"]
    sizes = _pathway_sizes(rng, int(pw["count"]), int(pw["memberships"]),
                           float(pw["size_mean"]), float(pw["size_sigma"]), n)
    cdf = np.cumsum(first_w)
    pathways = [_pathway_members(rng, cdf, n, int(s)) for s in sizes]
    return GeneGraph(n=n, x=x, relations=rels, edges=edges, pathways=pathways)


def in_neighbour_csr(n: int, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of senders by receiver: ``(ptr [n+1], senders)``."""
    order = np.argsort(edges[1], kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(edges[1], minlength=n), out=ptr[1:])
    return ptr, edges[0][order]


def khop_nodes(ptr: np.ndarray, col: np.ndarray, query: int, hops: int) -> np.ndarray:
    """Sorted nodes that reach ``query`` along at most ``hops`` edges (the
    query included): PyG ``k_hop_subgraph``'s node set under its default
    flow."""
    seen = np.zeros(ptr.size - 1, bool)
    seen[query] = True
    frontier = np.array([query], np.int64)
    for _ in range(hops):
        if frontier.size == 0:
            break
        starts, lens = ptr[frontier], ptr[frontier + 1] - ptr[frontier]
        idx = np.repeat(starts - (np.cumsum(lens) - lens), lens) + np.arange(lens.sum())
        nxt = np.unique(col[idx])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return np.nonzero(seen)[0]
