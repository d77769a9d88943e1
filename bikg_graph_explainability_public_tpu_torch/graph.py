"""Padded graph container (homogeneous half of the JAX package's ``graph.py``).

A graph holds device tensors padded to a capacity, plus boolean validity
masks: removing an edge means weighting it 0, never rebuilding the edge
list.  Host-side planning (k-hop extraction, query plans, neighbour tables)
reads numpy copies of the same arrays through :func:`host_view`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.padding import pad_budget


def _as_np(a) -> np.ndarray:
    """Convert tensors / lists to numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class HostView:
    """Numpy copies of a graph's arrays, fetched from the device at most
    once per array (graphs built by :func:`from_arrays` start seeded)."""

    __slots__ = ("_graph", "_cache")

    def __init__(self, graph: "Graph", arrays: Optional[Dict[str, np.ndarray]] = None):
        self._graph = graph
        self._cache: Dict[str, np.ndarray] = dict(arrays or {})

    def __getattr__(self, name: str) -> np.ndarray:
        cache = object.__getattribute__(self, "_cache")
        if name not in cache:
            cache[name] = _as_np(getattr(self._graph, name))
        return cache[name]

    def csr(self):
        """Receiver-CSR over valid edges, built once per graph:
        (row_ptr [n+1] i64, col [e] i32 senders, eid [e] i32)."""
        if "csr" not in self._cache:
            from .runtime import native

            g = self._graph
            self._cache["csr"] = native.build_csr(
                g.n_pad,
                self.senders[: g.num_edges],
                self.receivers[: g.num_edges],
            )
        return self._cache["csr"]


@dataclass(frozen=True, eq=False)
class Graph:
    """A padded graph on one device.

      x:          [N_pad, F] float32 node features (zero for padding rows)
      senders:    [E_pad] int64 — edge source node index (edge_index[0])
      receivers:  [E_pad] int64 — edge target node index (edge_index[1])
      node_mask:  [N_pad] bool — True for real nodes
      edge_mask:  [E_pad] bool — True for real edges
      node_type:  [N_pad] int32 — node type id (0 for homogeneous)
      edge_type:  [E_pad] int32 — edge type id (0 for homogeneous)
      num_nodes / num_edges: actual (unpadded) counts.
    """

    x: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    node_type: torch.Tensor
    edge_type: torch.Tensor
    num_nodes: int
    num_edges: int
    host: HostView = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.host is None:
            object.__setattr__(self, "host", HostView(self))

    @property
    def device(self) -> torch.device:
        """Device holding the graph's tensors."""
        return self.x.device

    @property
    def n_pad(self) -> int:
        """Padded node count."""
        return self.x.shape[0]

    @property
    def e_pad(self) -> int:
        """Padded edge count."""
        return self.senders.shape[0]

    @property
    def num_features(self) -> int:
        """Feature width F."""
        return self.x.shape[1]


def host_view(graph: Graph) -> HostView:
    """The :class:`HostView` of ``graph``."""
    return graph.host


def graph_from_numpy(
    device: torch.device,
    *,
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    node_mask: np.ndarray,
    edge_mask: np.ndarray,
    node_type: np.ndarray,
    edge_type: np.ndarray,
    num_nodes: int,
    num_edges: int,
) -> Graph:
    """Upload padded numpy arrays and keep them as the graph's host view."""
    arrays = dict(
        x=x, senders=senders, receivers=receivers, node_mask=node_mask,
        edge_mask=edge_mask, node_type=node_type, edge_type=edge_type,
    )
    t = {
        k: torch.from_numpy(v).to(device)
        for k, v in arrays.items()
    }
    t["senders"] = t["senders"].long()
    t["receivers"] = t["receivers"].long()
    g = Graph(**t, num_nodes=int(num_nodes), num_edges=int(num_edges))
    g.host._cache.update(arrays)
    return g


def from_arrays(
    feat,
    edge_index,
    node_type=None,
    edge_type=None,
    *,
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    pad_mode: str = "multiple",
    device=None,
) -> Graph:
    """Build a padded :class:`Graph` from dense arrays.

    ``feat``: [N, F]; ``edge_index``: [2, E] (row 0 = senders, row 1 =
    receivers).  ``device=None`` means the CUDA card.
    """
    dev = resolve_device(device)
    feat = _as_np(feat).astype(np.float32)
    edge_index = _as_np(edge_index).astype(np.int64)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edge_index.shape}")
    n, f = feat.shape
    e = edge_index.shape[1]
    n_pad = node_budget if node_budget is not None else pad_budget(n, pad_mode, 8)
    e_pad = edge_budget if edge_budget is not None else pad_budget(max(e, 1), pad_mode, 8)
    if n_pad < n or e_pad < e:
        raise ValueError("budget smaller than actual size")

    x = np.zeros((n_pad, f), np.float32)
    x[:n] = feat
    snd = np.zeros((e_pad,), np.int32)
    rcv = np.zeros((e_pad,), np.int32)
    snd[:e] = edge_index[0]
    rcv[:e] = edge_index[1]
    nmask = np.zeros((n_pad,), bool)
    nmask[:n] = True
    emask = np.zeros((e_pad,), bool)
    emask[:e] = True

    nt = np.zeros((n_pad,), np.int32)
    et = np.zeros((e_pad,), np.int32)
    if node_type is not None:
        nt[:n] = _as_np(node_type).astype(np.int32)
    if edge_type is not None:
        et[:e] = _as_np(edge_type).astype(np.int32)
    return graph_from_numpy(
        dev, x=x, senders=snd, receivers=rcv, node_mask=nmask, edge_mask=emask,
        node_type=nt, edge_type=et, num_nodes=n, num_edges=e,
    )


def element_size(graph: Graph, problem: str) -> int:
    """Number of elements to explain: edges for edge problems, else nodes."""
    if "edge" in problem:
        return graph.num_edges
    return graph.num_nodes
