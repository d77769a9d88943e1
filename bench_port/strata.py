"""Which queries a run sends: every gene's subgraph class, and a schedule
that gives every call (or every cycle of requests) the same mix of classes.

A query's work is set by its computational subgraph, the genes that reach
it within two hops: the program pads it to a power of two of nodes and of
edges, and ``explain_many`` stacks queries of one (nodes, edges) class
together.  On a heavy-tailed graph two genes of one degree can have
subgraphs 16 times apart, so a schedule by degree would still change the
work from call to call.  The classes are counted here for every gene at
once, on the run's device, by exact products of 0/1 reach matrices; the
schedule takes each class's share of the genes as its share of a call.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Class = Tuple[int, int]


def _pow2(n: np.ndarray, minimum: int = 8) -> np.ndarray:
    """Each count rounded up to a power of two, at least ``minimum``."""
    n = np.maximum(np.asarray(n, np.int64), 1)
    p = np.left_shift(1, np.ceil(np.log2(n)).astype(np.int64))
    return np.maximum(p, minimum)


@torch.no_grad()
def subgraph_sizes(n: int, edges: np.ndarray, hops: int, device, block: int = 4096):
    """``(nodes [n], edges [n])``: the size of every gene's subgraph, the
    genes that reach it along at most ``hops`` edges and the edges among
    them (a self-loop-free multigraph, so a repeated pair counts twice).
    Products of 0/1 and small-count matrices accumulate exactly in float32
    (and in TF32, whose inputs they fit), so the counts are exact."""
    dev = torch.device(device)
    snd = torch.as_tensor(edges[0], device=dev)
    rcv = torch.as_tensor(edges[1], device=dev)
    # adj[v, u]: edges u -> v
    adj = torch.zeros(n, n, dtype=torch.float32, device=dev)
    adj.index_put_((rcv, snd), torch.ones_like(rcv, dtype=torch.float32), accumulate=True)
    step = (adj > 0).to(torch.float32)
    step.diagonal().fill_(1.0)
    nodes = np.empty(n, np.int64)
    inner = np.empty(n, np.int64)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for r0 in range(0, n, block):
            reach = step[r0 : r0 + block]
            for _ in range(hops - 1):
                reach = ((reach @ step) > 0).to(torch.float32)
            nodes[r0 : r0 + block] = reach.sum(1).to(torch.int64).cpu().numpy()
            inner[r0 : r0 + block] = ((reach @ adj.T) * reach).sum(1).to(torch.int64).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return nodes, inner


def cached_sizes(graph_cfg: dict, n: int, edges: np.ndarray, hops: int, device,
                 cache_dir: str):
    """:func:`subgraph_sizes`, kept in ``cache_dir`` under a key of the
    graph's configuration, ``hops`` and the sources of the generator and
    of this module: the configuration's graph seed fixes the counts, so
    only a checkout's first run counts them."""
    here = os.path.dirname(os.path.abspath(__file__))
    key = hashlib.sha256(json.dumps([graph_cfg, hops], sort_keys=True).encode())
    for src in ("graphgen.py", "strata.py"):
        with open(os.path.join(here, src), "rb") as f:
            key.update(f.read())
    path = os.path.join(cache_dir, f"sizes-{key.hexdigest()[:24]}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["nodes"], z["edges"]
    nodes, inner = subgraph_sizes(n, edges, hops, device)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, nodes=nodes, edges=inner)
    os.replace(tmp, path)
    return nodes, inner


def classes_of(nodes: np.ndarray, edges: np.ndarray) -> List[Class]:
    """The padded (nodes, edges) class of each subgraph: an empty edge set
    counts as the one self-loop the program gives it."""
    return list(zip(_pow2(nodes).tolist(), _pow2(np.maximum(edges, 1)).tolist()))


def quota(classes: Sequence[Class], per_round: int) -> Dict[Class, int]:
    """Queries of each class in one call (or one cycle) of ``per_round``:
    the classes' shares of all genes, rounded by largest remainder."""
    counts = Counter(classes)
    total = sum(counts.values())
    keys = sorted(counts)
    exact = np.array([counts[k] * per_round / total for k in keys])
    got = np.floor(exact).astype(np.int64)
    for i in np.argsort(-(exact - got), kind="stable")[: per_round - int(got.sum())]:
        got[i] += 1
    return {k: int(c) for k, c in zip(keys, got) if c}


class Schedule:
    """Rounds of queries, each with :func:`quota`'s mix.  A class's genes
    are taken in an order drawn from ``genes_seed``, the traffic's own, and
    never twice in one run; each round's list is shuffled by ``seed``, the
    run's.  So every run sends the same genes round by round, in another
    order: a run's seed changes its inputs (the order, the weights) and not
    its work."""

    def __init__(self, classes: Sequence[Class], mix: Dict[Class, int], genes_seed: int,
                 seed: int):
        pick = np.random.default_rng(genes_seed)
        self.rng = np.random.default_rng(seed)
        self.mix = mix
        by_class: Dict[Class, List[int]] = {}
        for g, c in enumerate(classes):
            by_class.setdefault(c, []).append(g)
        self.pools = {c: pick.permutation(np.asarray(by_class[c])).tolist() for c in mix}

    def next_round(self) -> List[int]:
        """The next round's genes, in the order they are sent."""
        out: List[int] = []
        for c, k in self.mix.items():
            if len(self.pools[c]) < k:
                raise RuntimeError(f"class {c} has no unused gene left; lengthen the pool")
            out += self.pools[c][:k]
            del self.pools[c][:k]
        return [out[i] for i in self.rng.permutation(len(out))]

    def one_of_each(self) -> List[int]:
        """One unused gene of every class of the mix (to warm up each)."""
        out = []
        for c in self.mix:
            out.append(self.pools[c].pop(0))
        return out
