"""GNN layers with PyG-exact numerics, for masked batched execution.

Each layer's ``forward`` is the JAX package's ``apply(params, ...)`` with
the parameters held by the module.  ``edge_weight`` carries both graph
validity and perturbation masks (0 = edge absent), and may have leading
batch dimensions (``[..., E]``, with features ``[..., N, F]``): a batch of
perturbed graphs is one call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.norm import gcn_norm_weights
from ..ops.spmm import weighted_gather_sum


def relu(x: torch.Tensor) -> torch.Tensor:
    """Rectified linear unit."""
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid."""
    return torch.sigmoid(x)


class Linear(nn.Module):
    """Dense layer, torch layout: weight [out, in], y = x W^T + b."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        limit = math.sqrt(1.0 / in_features)
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-limit, limit)
        )
        self.bias = (
            nn.Parameter(torch.empty(out_features).uniform_(-limit, limit))
            if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x @ W.T + b."""
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        return y


class GCNConv(nn.Module):
    """PyG-exact GCN convolution: ``out = D^-1/2 (A+I) D^-1/2 X W^T + b``.

    Parameter layout matches PyG's ``lin.weight`` [out, in] and ``bias``.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        improved: bool = False,
        add_self_loops: bool = True,
        normalize: bool = True,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.improved = improved
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        limit = math.sqrt(6.0 / (in_features + out_features))  # glorot
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-limit, limit)
        )
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_weight: torch.Tensor,
        *,
        dst_scope: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Symmetric-normalised masked graph convolution."""
        num_nodes = x.shape[-2]
        xw = x[..., : self.in_features] @ self.weight.T
        if self.normalize:
            norm_e, self_w = gcn_norm_weights(
                senders,
                receivers,
                edge_weight.to(xw.dtype),
                num_nodes,
                improved=self.improved,
                add_self_loops=self.add_self_loops,
                self_loop_mask=dst_scope,
            )
        else:
            norm_e = edge_weight.to(xw.dtype)
            self_w = xw.new_zeros(norm_e.shape[:-1] + (num_nodes,))
        out = weighted_gather_sum(norm_e, xw, senders, receivers, num_nodes)
        out = out + self_w[..., None] * xw
        if self.bias is not None:
            if dst_scope is not None:
                out = out + self.bias * dst_scope.to(out.dtype)[:, None]
            else:
                out = out + self.bias
        return out
