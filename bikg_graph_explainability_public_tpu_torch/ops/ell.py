"""ELL (padded neighbour-table) aggregation.

A node-masked batch of GCN layers gathers the transformed features once per
batch of perturbations and contracts ``[B,N,K] x [N,K,F] -> [B,N,F]``.
Tables are built on the host (:mod:`..runtime.native`).  Self-loop data
edges are excluded at build time because PyG ``gcn_norm`` replaces them
with unit self-loops anyway (see :mod:`.norm`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph import host_view
from ..runtime import native
from ..utils.padding import round_up


@dataclass(frozen=True, eq=False)
class NeighborTable:
    """Static padded in-neighbour lists of a padded graph.

    nbr:   [N_pad, K] int32 — sender of each slot (0 when invalid)
    valid: [N_pad, K] float32 — 1 for real slots
    eid:   [N_pad, K] int32 — original edge id of each slot
    """

    nbr: torch.Tensor
    valid: torch.Tensor
    eid: torch.Tensor

    @property
    def k(self) -> int:
        """Padded neighbours per row (ELL width)."""
        return self.nbr.shape[1]

    @functools.cached_property
    def _prefix(self) -> tuple[torch.Tensor, int]:
        v01 = self.valid.detach().cpu().numpy() > 0
        if v01.shape[1] > 1 and np.any(v01[:, 1:] & ~v01[:, :-1]):
            raise ValueError(
                "NeighborTable validity is not in prefix form (a valid slot "
                "follows an invalid one); the static gather-sum requires "
                "the builder's source-sorted layout"
            )
        nbr = self.nbr.detach().cpu().numpy()
        n_src = int(nbr[v01].max()) + 1 if v01.any() else 0
        deg = torch.from_numpy(v01.sum(axis=1).astype(np.int32))
        return deg.to(self.nbr.device), n_src

    @property
    def deg(self) -> torch.Tensor:
        """[N_pad] int32 valid-prefix length of each row, checked on the host
        once per table.  The static gather-sum reads slot ``k`` of row ``v``
        only when ``k < deg[v]``, so valid slots MUST form a per-row prefix
        (the builder's source sort guarantees it); a hand-built table with
        interior holes fails here instead of summing silently wrong."""
        return self._prefix[0]

    @property
    def n_src(self) -> int:
        """One past the largest source row a valid slot names."""
        return self._prefix[1]


def build_neighbor_table(
    graph, *, k: Optional[int] = None, drop_self_loops: bool = True
) -> NeighborTable:
    """Build the table host-side from a :class:`..graph.Graph` (valid edges
    only), on the graph's device.  ``k`` defaults to the max in-degree
    rounded up to a multiple of 8."""
    hv = host_view(graph)
    snd = hv.senders[: graph.num_edges]
    rcv = hv.receivers[: graph.num_edges]
    eids = np.arange(graph.num_edges, dtype=np.int32)
    if drop_self_loops:
        keep = snd != rcv
        snd, rcv, eids = snd[keep], rcv[keep], eids[keep]
    return build_neighbor_table_edges(
        graph.n_pad, snd, rcv, eids, k=k, device=graph.device
    )


def build_neighbor_table_edges(
    n: int,
    snd: np.ndarray,
    rcv: np.ndarray,
    eids: np.ndarray,
    *,
    k: Optional[int] = None,
    device=None,
) -> NeighborTable:
    """Build a table from explicit (already filtered) edge arrays; ``eids``
    are the edges' ids in the parent graph."""
    if k is None:
        k = max(native.max_degree(n, rcv), 1)
        k = round_up(k, 8)
    nbr, slot_eid, valid, dropped = native.build_ell(n, snd, rcv, k)
    if dropped:
        raise ValueError(
            f"neighbor table overflow: {dropped} edges dropped at K={k}; "
            "pass a larger k"
        )
    eid_full = np.zeros_like(slot_eid)
    eid_full[valid] = eids[slot_eid[valid]]
    # valid slots of each row sorted by source id, invalid slots last: this
    # is the prefix form that NeighborTable.deg requires
    key = np.where(valid, nbr.astype(np.int64), np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind="stable")
    rows = np.arange(n)[:, None]

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[rows, order], dtype)).to(device)

    return NeighborTable(
        nbr=put(nbr, np.int32), valid=put(valid, np.float32), eid=put(eid_full, np.int32)
    )


def gcn_coeffs_from_node_mask(
    table: NeighborTable, node_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot GCN coefficients and self-loop weights for a batch of node
    masks ``[B, N]`` (1 = node active).

    Edge weight of slot (v,k) = m[v] * m[nbr] (the reference's node
    perturbation semantics); degree and normalisation as in :mod:`.norm`.
    Returns (coeff [B,N,K], self_w [B,N]).
    """
    m = node_mask
    w = table.valid * m[:, table.nbr] * m[:, :, None]  # [B, N, K]
    deg = 1.0 + w.sum(dim=2)
    dis = torch.rsqrt(deg)
    coeff = w * dis[:, :, None] * dis[:, table.nbr]
    return coeff, dis * dis


def gcn_coeffs_from_edge_mask(
    table: NeighborTable, edge_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same for a batch of edge masks ``[B, E]`` indexed by original
    edge id: the weight of slot (v,k) is the mask bit of its edge."""
    w = table.valid * edge_mask[:, table.eid]  # [B, N, K]
    deg = 1.0 + w.sum(dim=2)
    dis = torch.rsqrt(deg)
    coeff = w * dis[:, :, None] * dis[:, table.nbr]
    return coeff, dis * dis


def ell_aggregate_shared(coeff_b: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """Batched aggregation with a batch-shared gathered table.

    coeff_b:  [B, N, K] per-perturbation slot coefficients
    gathered: [N, K, F] XW[nbr], gathered once for the whole batch
    returns   [B, N, F] (float32)
    """
    out = torch.bmm(coeff_b.transpose(0, 1).float(), gathered.float())  # [N, B, F]
    return out.transpose(0, 1)
