"""Padded graph container (the JAX package's ``graph.py``).

A graph holds device tensors padded to a capacity, plus boolean validity
masks: removing an edge means weighting it 0, never rebuilding the edge
list.  Host-side planning (k-hop extraction, query plans, neighbour tables)
reads numpy copies of the same arrays through :func:`host_view`.

A heterogeneous graph is a *typed homogeneous* graph: :func:`hetero_to_homo`
concatenates the node types' feature blocks (one contiguous block per
type) and the relations' edge lists, and records how in a
:class:`HeteroInfo`; node and edge type ids are block positions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
      typed:      whether the type vectors are meaningful (heterogeneous
                  origin).
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
    typed: bool = False
    host: HostView = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
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

    def edge_index(self) -> torch.Tensor:
        """[2, E_pad] COO edge index (reference layout, ``data.py:29``)."""
        return torch.stack([self.senders, self.receivers], dim=0)

    def with_features(self, x: torch.Tensor) -> "Graph":
        """Copy of this graph with a replaced [N_pad, F] feature matrix; its
        host view keeps every cached array but the features."""
        g = dataclasses.replace(self, x=x)
        g.host._cache.update({k: v for k, v in self.host._cache.items() if k != "x"})
        return g


def host_view(graph: Graph) -> HostView:
    """The :class:`HostView` of ``graph``."""
    return graph.host


def seed_host_view(graph: Graph, **arrays: np.ndarray) -> Graph:
    """Pre-populate ``graph``'s :class:`HostView` with the numpy arrays it
    was just built from, so later host-side planning never copies them back
    from the device.  Returns ``graph`` for chaining."""
    graph.host._cache.update(arrays)
    return graph


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
    typed: bool = False,
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
    g = Graph(**t, num_nodes=int(num_nodes), num_edges=int(num_edges), typed=bool(typed))
    return seed_host_view(g, **arrays)


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
        typed=node_type is not None or edge_type is not None,
    )


def element_size(graph: Graph, problem: str) -> int:
    """Number of elements to explain: edges for edge problems, else nodes."""
    if "edge" in problem:
        return graph.num_edges
    return graph.num_nodes


@dataclass(frozen=True)
class HeteroInfo:
    """How a heterogeneous graph was homogenised: type names in block
    order, the start pointer and size of each node type's block and of each
    relation's edge block, and each type's feature padding (the reference's
    ``preprocess_hetero_graph`` side outputs, ``data.py:39-93``)."""

    node_type_names: List[str]
    edge_type_names: List[Tuple[str, ...]]
    node_pointers: List[int]
    edge_pointers: List[int]
    padded_dims: List[int]
    node_counts: List[int]
    edge_counts: List[int]

    @property
    def num_relations(self) -> int:
        """Number of edge types."""
        return len(self.edge_type_names)

    @property
    def num_node_types(self) -> int:
        """Number of node types."""
        return len(self.node_type_names)


def pad_feature_blocks(
    feat_blocks: Sequence[np.ndarray],
) -> Tuple[List[np.ndarray], List[int], List[int]]:
    """Zero-pad per-type feature matrices to a common width (reference
    ``pad_feat_tensors``, ``data.py:825-878``): the padded blocks, how much
    each was padded, and each block's start pointer in the concatenation."""
    max_w = max(b.shape[1] for b in feat_blocks)
    padded, padded_dims, pointers = [], [], []
    ptr = 0
    for b in feat_blocks:
        diff = max_w - b.shape[1]
        padded_dims.append(diff)
        pointers.append(ptr)
        ptr += b.shape[0]
        padded.append(np.pad(b, ((0, 0), (0, diff))) if diff > 0 else b)
    return padded, padded_dims, pointers


def hetero_to_homo(
    feat: Dict[str, Any],
    edge_index: Dict[Tuple[str, ...], Any],
    *,
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    pad_mode: str = "multiple",
    device=None,
) -> Tuple[Graph, HeteroInfo]:
    """Homogenise a heterogeneous graph into a typed :class:`Graph` on
    ``device`` (``None`` means the CUDA card).

    As the reference's ``hetero2homo`` (``data.py:95-147``): feature blocks
    are concatenated in ``feat``'s order, zero-padded to a common width;
    node type ``i`` is block ``i``; relation ``i`` is ``edge_index``'s
    ``i``-th key, whose indices are shifted by the start pointers of its
    source and target types' blocks.
    """
    node_type_names = list(feat.keys())
    blocks = [_as_np(v).astype(np.float32) for v in feat.values()]
    padded, padded_dims, node_pointers = pad_feature_blocks(blocks)
    node_counts = [b.shape[0] for b in padded]
    node_types = np.concatenate(
        [np.full((c,), i, np.int32) for i, c in enumerate(node_counts)]
    )
    edge_blocks, edge_types, edge_pointers, edge_counts = [], [], [], []
    ptr = 0
    for i, (rel, ei) in enumerate(edge_index.items()):
        ei = _as_np(ei).astype(np.int64)
        shift = [
            [node_pointers[node_type_names.index(rel[0])]],
            [node_pointers[node_type_names.index(rel[-1])]],
        ]
        edge_blocks.append(ei + np.array(shift, np.int64))
        edge_types.append(np.full((ei.shape[1],), i, np.int32))
        edge_pointers.append(ptr)
        edge_counts.append(ei.shape[1])
        ptr += ei.shape[1]
    homo_ei = np.hstack(edge_blocks) if edge_blocks else np.zeros((2, 0), np.int64)
    homo_et = np.concatenate(edge_types) if edge_types else np.zeros((0,), np.int32)
    g = from_arrays(
        np.vstack(padded), homo_ei, node_type=node_types, edge_type=homo_et,
        node_budget=node_budget, edge_budget=edge_budget, pad_mode=pad_mode,
        device=device,
    )
    info = HeteroInfo(
        node_type_names=node_type_names,
        edge_type_names=[tuple(t) for t in edge_index.keys()],
        node_pointers=node_pointers,
        edge_pointers=edge_pointers,
        padded_dims=padded_dims,
        node_counts=node_counts,
        edge_counts=edge_counts,
    )
    return g, info


def homo_to_hetero_edge_indices(
    senders, receivers, edge_type, info: HeteroInfo, num_edges: Optional[int] = None
) -> Dict[Tuple[str, ...], np.ndarray]:
    """Per-relation local ``[2, E_r]`` edge indices from the homogenised
    arrays (the edge half of the reference's ``homo2hetero``,
    ``data.py:149-232``)."""
    snd, rcv, et = _as_np(senders), _as_np(receivers), _as_np(edge_type)
    if num_edges is not None:
        snd, rcv, et = snd[:num_edges], rcv[:num_edges], et[:num_edges]
    names = info.node_type_names
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for ri, rel in enumerate(info.edge_type_names):
        sel = et == ri
        s_off = info.node_pointers[names.index(rel[0])]
        d_off = info.node_pointers[names.index(rel[-1])]
        out[tuple(rel)] = np.stack([snd[sel] - s_off, rcv[sel] - d_off])
    return out


def homo_to_hetero_features(x, node_type, info: HeteroInfo) -> Dict[str, np.ndarray]:
    """Split a homogenised feature matrix back into per-type blocks, without
    their zero padding (reference ``homo2hetero``)."""
    x, node_type = _as_np(x), _as_np(node_type)
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(info.node_type_names):
        block = x[node_type == i]
        if info.padded_dims[i] > 0:
            block = block[:, : -info.padded_dims[i]]
        out[name] = block
    return out


def hetero_names_to_homo(names) -> Tuple[List[str], Optional[np.ndarray]]:
    """Flatten a dict of per-type name lists into one list plus a type
    vector (reference ``hetero2homo_names``, ``data.py:234-279``); a list
    passes through with no types."""
    if not isinstance(names, dict):
        return names, None
    homo: List[str] = []
    types: List[np.ndarray] = []
    for i, lst in enumerate(names.values()):
        homo.extend(lst)
        types.append(np.full((len(lst),), i, np.int32))
    return homo, (np.concatenate(types) if types else np.zeros((0,), np.int32))
