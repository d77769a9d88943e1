"""k-hop computational-subgraph extraction.

Semantics match PyG ``k_hop_subgraph(ind, k, edge_index, relabel_nodes=True)``
with the default ``flow="source_to_target"``: a node is kept iff it can reach
the query along <=k directed edges; the edge set is the subgraph induced on
kept nodes; kept nodes are relabelled in ascending original order.  The
BFS and the gathers run on the host; the padded result is uploaded once,
or not at all where the caller reads it on the host only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..graph import Graph, graph_from_numpy, host_view
from ..runtime import native
from ..utils.padding import pad_budget


class Subgraph(NamedTuple):
    """Padded k-hop subgraph plus its mapping back into the parent graph."""
    graph: Graph
    # position of each kept node in the parent graph, padded with parent n_pad
    parent_nodes: np.ndarray
    # new index of the query node
    query: int
    # [E_parent] bool: which parent edges were kept
    parent_edge_mask: np.ndarray


def extract_khop_subgraph(
    graph: Graph,
    query: int,
    n_hops: int,
    *,
    pad_mode: str = "multiple",
    host_only: bool = False,
) -> Subgraph:
    """Extract the padded k-hop computational subgraph around ``query``, on
    the parent graph's device.  If the subgraph has no edges the query gets
    a single self-loop, mirroring the reference fallback
    (``data.py:337-339``).

    ``host_only=True`` skips the upload: the subgraph's fields are the
    numpy arrays its host view holds, for callers that read the subgraph on
    the host only (the multi-query stacker of :mod:`..explain.batch`)."""
    hv = host_view(graph)
    row_ptr, col, _eid = hv.csr()
    reach = (
        native.bfs_levels_csr(graph.n_pad, row_ptr, col, int(query), n_hops)
        <= n_hops
    )
    reach &= hv.node_mask
    snd = hv.senders
    rcv = hv.receivers
    keep_edge = reach[snd] & reach[rcv] & hv.edge_mask

    kept_nodes = np.nonzero(reach)[0]  # ascending -> matches PyG relabel order
    n_sub = int(kept_nodes.shape[0])
    kept_edges = np.nonzero(keep_edge)[0]
    e_sub = int(kept_edges.shape[0])

    relabel = np.full((graph.n_pad,), -1, np.int64)
    relabel[kept_nodes] = np.arange(n_sub)
    new_query = int(relabel[query])

    n_pad = pad_budget(n_sub, pad_mode, 8)
    self_loop_fallback = e_sub == 0
    e_pad = pad_budget(max(e_sub, 1), pad_mode, 8)

    x = np.zeros((n_pad, graph.num_features), np.float32)
    x[:n_sub] = hv.x[kept_nodes]
    new_snd = np.zeros((e_pad,), np.int32)
    new_rcv = np.zeros((e_pad,), np.int32)
    new_et = np.zeros((e_pad,), np.int32)
    if self_loop_fallback:
        new_snd[0] = new_query
        new_rcv[0] = new_query
        e_sub = 1
    else:
        new_snd[:e_sub] = relabel[snd[kept_edges]]
        new_rcv[:e_sub] = relabel[rcv[kept_edges]]
        new_et[:e_sub] = hv.edge_type[kept_edges]
    nmask = np.zeros((n_pad,), bool)
    nmask[:n_sub] = True
    emask = np.zeros((e_pad,), bool)
    emask[:e_sub] = True
    nt = np.zeros((n_pad,), np.int32)
    nt[:n_sub] = hv.node_type[kept_nodes]

    parent_nodes = np.full((n_pad,), graph.n_pad, np.int64)
    parent_nodes[:n_sub] = kept_nodes
    arrays = dict(
        x=x, senders=new_snd, receivers=new_rcv, node_mask=nmask,
        edge_mask=emask, node_type=nt, edge_type=new_et,
    )
    if host_only:
        sub = Graph(**arrays, num_nodes=n_sub, num_edges=e_sub)
        sub.host._cache.update(arrays)
    else:
        sub = graph_from_numpy(graph.device, **arrays, num_nodes=n_sub, num_edges=e_sub)
    return Subgraph(
        graph=sub,
        parent_nodes=parent_nodes,
        query=new_query,
        parent_edge_mask=keep_edge,
    )
