"""Sparse aggregation entries (the torch-scatter/torch-sparse role).

* :func:`weighted_gather_sum` — per-edge scalar weights over ``[..., N, F]``
  features (the generic layer path): a gather plus ``index_add``, or, given
  the graph's neighbour table and ``[N, F]`` features, kernel 2.4 at
  ``b = 1`` plus the self-loop term.
* :func:`weighted_gather_sum_batched` — per-edge, per-sample weights over
  batch-contiguous ``[N, B*F]`` features (the edge-mask layers >= 2),
  through :func:`.spmm_cuda.batched_gather_sum` (kernel 2.4).
* :func:`gather_sum_batched_separable` — rank-1 separable weights over
  batch-contiguous ``[N, B*F]`` features (the node-mask layers >= 2).  It
  scales the rows before and the outputs after, and aggregates with the
  table's static validity only, through :func:`.spmm_cuda.gather_sum_static`
  (kernel 2.3).

The table routes run the hand-written CUDA kernel on the card and its
plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .spmm_cuda import batched_gather_sum, gather_sum_static


def weighted_gather_sum(
    edge_weight: torch.Tensor,
    feats: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    *,
    table=None,
) -> torch.Tensor:
    """out[..., v, :] = sum over edges e with receivers[e]==v of
    edge_weight[..., e] * feats[..., senders[e], :].

    Masked/padded edges must carry weight 0 (they then contribute nothing,
    wherever their indices point).  With the graph's ``table``
    (:class:`.ell.NeighborTable`, whose ``eid`` index ``edge_weight``) and
    ``[N, F]`` features, the aggregation runs through
    :func:`.spmm_cuda.batched_gather_sum` at ``b = 1`` (kernel 2.4) and the
    self-loop edges, which the table leaves out, are added as a separate
    ``[E]`` pass, as the JAX entry's Pallas branch does; the output is then
    float32.  There is no width crossover: a table means the kernel."""
    if table is not None and feats.dim() == 2 and edge_weight.dim() == 1:
        out = batched_gather_sum(table, edge_weight[:, None], feats, 1)
        loop_w = torch.where(senders == receivers, edge_weight, edge_weight.new_zeros(()))
        self_w = loop_w.new_zeros(num_nodes).index_add_(0, receivers, loop_w)
        return out + self_w[:, None] * feats
    msg = edge_weight[..., None] * feats[..., senders, :]
    lead = msg.shape[:-2]
    out = msg.new_zeros(lead + (num_nodes, msg.shape[-1]))
    return out.index_add_(out.dim() - 2, receivers, msg)


def weighted_gather_sum_batched(
    edge_weight_eb: Optional[torch.Tensor],  # [E, B] per-edge per-sample weights
    feats_bc: torch.Tensor,     # [N, B*F] batch-contiguous features
    b: int,
    *,
    table,
    w_slot: Optional[torch.Tensor] = None,    # [N, K, B] slot-layout weights
    w_sample: Optional[torch.Tensor] = None,  # [B, N, K] sample-major weights
) -> torch.Tensor:              # [N, B*F] float32
    """Batched aggregation: ``out[v] = sum over the table's in-edges e of
    w[e, :] * feats[snd_e]``, the per-sample weight broadcast over each
    sample's F block.

    ``edge_weight_eb`` rows are indexed by the table's ``eid`` (original
    edge ids).  Callers that already hold the weights per slot pass them
    instead, and ``edge_weight_eb`` may then be None: the engine's
    coefficient tensor as it is made, sample-major, as ``w_sample`` (the
    kernel reads it without a copy), or ``w_slot`` in the JAX entry's
    layout.  The table carries no self-loops (``build_neighbor_table`` drops
    them).
    """
    return batched_gather_sum(table, edge_weight_eb, feats_bc, b, w_slot=w_slot, w_sample=w_sample)


def gather_sum_batched_separable(
    a_bn: torch.Tensor,         # [B, N_src] per-node per-sample factors
    feats_bc: torch.Tensor,     # [N_src, B*F] batch-contiguous features
    b: int,
    *,
    table,
    post_a_bn: Optional[torch.Tensor] = None,  # [B, N_out] dest-side factors
) -> torch.Tensor:              # [N_out, B*F] float32
    """Batched aggregation with rank-1 separable weights.

    ``out[v, s] = a[s,v] * sum over in-edges (u -> v) of the table of
    a[s,u] * feats[u, s]`` — the GCN node-mask case, where the per-edge
    weight ``mask[u]*mask[v]*deg^-1/2[u]*deg^-1/2[v]`` factors as
    ``a[u]*a[v]`` with ``a = mask * deg^-1/2``.  The table carries no
    self-loops (``build_neighbor_table`` drops them).  The destination-side
    scale rides the kernel; the source-side scale is applied here.
    """
    f = feats_bc.shape[-1] // b
    a_t = a_bn.t().to(feats_bc.dtype)  # [N_src, B]
    a_out = a_t if post_a_bn is None else post_a_bn.t().to(feats_bc.dtype)
    scaled = (feats_bc.view(-1, b, f) * a_t[:, :, None]).view(-1, b * f)
    return gather_sum_static(
        table, scaled, b, post_scale=a_out.float().contiguous()
    )
