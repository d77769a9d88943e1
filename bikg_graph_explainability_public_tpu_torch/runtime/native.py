"""Host-side graph builders in numpy: receiver-CSR, padded neighbour
tables, maximum in-degree and BFS levels.

The JAX package compiles a C++ builder and keeps these as its fallbacks;
the port uses the numpy versions only (their host time at 100k nodes / 1M
edges is printed by ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _c32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.int32))


def build_csr(n: int, src, dst) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR by receiver: (row_ptr [n+1] i64, col [e] i32 senders, eid [e] i32).
    Edges keep their input order within each row."""
    src, dst = _c32(src), _c32(dst)
    row_ptr = np.zeros(n + 1, np.int64)
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=n)
    row_ptr[1:] = np.cumsum(counts)
    return row_ptr, src[order], order.astype(np.int32)


def max_degree(n: int, dst) -> int:
    """Maximum in-degree over receivers."""
    dst = _c32(dst)
    return int(np.bincount(dst, minlength=n).max()) if dst.size else 0


def build_ell(
    n: int, src, dst, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Padded neighbour tables: (nbr [n,k] i32, eid [n,k] i32,
    valid [n,k] bool, dropped).

    A stable sort by receiver keeps edge order within each row, so
    ``position - group_start`` is the slot of each edge; slots >= k are the
    dropped tail."""
    src, dst = _c32(src), _c32(dst)
    e = src.shape[0]
    nbr = np.zeros((n, k), np.int32)
    eid = np.zeros((n, k), np.int32)
    valid = np.zeros((n, k), bool)
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=n)
    group_start = np.zeros(n, np.int64)
    np.cumsum(counts[:-1], out=group_start[1:])
    slot = np.arange(e, dtype=np.int64) - np.repeat(group_start, counts)
    keep = slot < k
    rows = dst[order][keep]
    cols = slot[keep]
    nbr[rows, cols] = src[order][keep]
    eid[rows, cols] = order[keep].astype(np.int32)
    valid[rows, cols] = True
    dropped = int(e - keep.sum())
    return nbr, eid, valid, dropped


def khop_reachable(n: int, src, dst, query: int, hops: int) -> np.ndarray:
    """Directed BFS towards the query (PyG source_to_target semantics)."""
    src, dst = _c32(src), _c32(dst)
    reach = np.zeros(n, bool)
    reach[query] = True
    for _ in range(hops):
        new = reach | np.bincount(src[reach[dst]], minlength=n).astype(bool)
        if (new == reach).all():
            break
        reach = new
    return reach


def bfs_levels_csr(
    n: int, row_ptr: np.ndarray, col: np.ndarray, query: int, max_hops: int
) -> np.ndarray:
    """In-distance (BFS level) per node from ``query`` over a receiver-CSR;
    unreached nodes get ``max_hops + 1``.  Each level expands the whole
    frontier at once."""
    out = np.full(n, max_hops + 1, np.int32)
    out[query] = 0
    frontier = np.array([query], np.int64)
    for h in range(1, max_hops + 1):
        starts, ends = row_ptr[frontier], row_ptr[frontier + 1]
        lens = ends - starts
        if not lens.sum():
            break
        pos = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
        nbrs = np.unique(col[pos])
        frontier = nbrs[out[nbrs] > h].astype(np.int64)
        out[frontier] = h
    return out
