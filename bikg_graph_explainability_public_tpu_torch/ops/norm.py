"""GCN symmetric normalisation with mask-aware self-loop handling.

PyG ``gcn_norm`` semantics: data self-loop edges are replaced by one
unit-weight self-loop per node, the degree is the weighted in-degree over
A+I, and ``norm_e = deg(src)^-1/2 * w_e * deg(dst)^-1/2``.  The self-loop
term is computed in closed form (``self_w = fill / deg``), and a perturbed
edge simply has ``w_e = 0``.

Edge weights may carry leading batch dimensions (``[..., E]``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gcn_norm_weights(
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_weight: torch.Tensor,
    num_nodes: int,
    *,
    improved: bool = False,
    add_self_loops: bool = True,
    self_loop_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return ``(norm_e [..., E], self_w [..., N])``."""
    fill = 2.0 if improved else 1.0
    w = edge_weight
    if add_self_loops:
        w = w * (senders != receivers).to(w.dtype)
    lead = w.shape[:-1]
    deg = torch.zeros(lead + (num_nodes,), dtype=w.dtype, device=w.device)
    deg = deg.index_add(-1, receivers, w)
    if add_self_loops:
        if self_loop_mask is not None:
            loop_fill = fill * self_loop_mask.to(w.dtype)
        else:
            loop_fill = torch.full((num_nodes,), fill, dtype=w.dtype, device=w.device)
        deg = deg + loop_fill
    deg_inv_sqrt = torch.where(
        deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg)
    )
    norm_e = deg_inv_sqrt[..., senders] * w * deg_inv_sqrt[..., receivers]
    if add_self_loops:
        self_w = loop_fill * deg_inv_sqrt * deg_inv_sqrt
    else:
        self_w = torch.zeros_like(deg)
    return norm_e, self_w
