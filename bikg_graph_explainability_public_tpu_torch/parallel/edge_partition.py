"""Edge-partitioned graph aggregation across a device mesh.

Edges are split into contiguous blocks, one a rank; node features are
replicated.  Every rank aggregates its block's messages into a full node
accumulator, and an ``all_reduce`` sums the partials (the ``O(N)``
exchange that :mod:`.halo` narrows to the boundary rows).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.layers import refuse_row_sharded
from .mesh import axis_size


def partition_edges(edge_arrays, mesh, axis: str = "data") -> tuple:
    """This rank's contiguous block of each per-edge array (rank r of D
    takes ``[r * E / D, (r + 1) * E / D)``).  The edge count must divide
    by the axis size: pad with weight-0 edges otherwise."""
    d, me = axis_size(mesh, axis), mesh.get_local_rank(axis)
    out = []
    for a in edge_arrays:
        if a.shape[0] % d:
            raise ValueError(
                f"{a.shape[0]} edges do not split over {d} ranks; pad with weight-0 edges"
            )
        blk = a.shape[0] // d
        out.append(a[me * blk : (me + 1) * blk])
    return tuple(out)


def partitioned_gather_sum(
    edge_weight: torch.Tensor,
    feats: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mesh,
    axis: str = "data",
) -> torch.Tensor:
    """out[v] = sum_e w_e * feats[senders_e] over edges with receiver v.
    The edge arrays and ``feats`` are replicated (each rank reads its own
    edge block); the result is the same on every rank."""
    ew, snd, rcv = partition_edges((edge_weight, senders, receivers), mesh, axis)
    part = feats.new_zeros(feats.shape).index_add_(0, rcv.long(), ew[:, None] * feats[snd.long()])
    dist.all_reduce(part, group=mesh.get_group(axis))
    return part


@torch.no_grad()
def partitioned_gcn_forward(
    model,
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_weight: torch.Tensor,
    mesh,
    axis: str = "data",
) -> torch.Tensor:
    """Full forward of a :class:`..models.gnn.GCNNodeModel` (``model``, a
    :class:`..models.adapter.Model`) with the edge set split across the
    mesh: the degrees and every conv layer's aggregation run
    edge-partitioned with an ``all_reduce``; linear layers and activations
    run replicated.  Returns the per-node output on every rank."""
    mdef = model.model_def
    refuse_row_sharded(mdef, "partitioned_gcn_forward")
    num_nodes = x.shape[0]
    snd, rcv = senders.long(), receivers.long()
    w = edge_weight * (snd != rcv).to(edge_weight.dtype)
    w_loc, rcv_loc = partition_edges((w, rcv), mesh, axis)
    deg = w.new_zeros(num_nodes).index_add_(0, rcv_loc, w_loc)
    dist.all_reduce(deg, group=mesh.get_group(axis))
    dis = torch.rsqrt(deg + 1.0)
    norm_e = dis[snd] * w * dis[rcv]
    self_w = dis * dis

    h = x
    for conv in mdef.conv:
        hw = h[:, : conv.in_features] @ conv.weight.T
        h = partitioned_gather_sum(norm_e, hw, snd, rcv, mesh, axis) + self_w[:, None] * hw
        if conv.bias is not None:
            h = h + conv.bias
        h = torch.relu(h)
    return mdef.head(h)
