"""Homogeneous GCN node model: a GCN conv stack plus a fully-connected head.

Structure-compatible with the reference homo test model ``GCN_homo``
(``tests/test_utils.py:10-83``).  The module's parameter names are those of
the JAX package's checkpoints (``conv.0.weight``, ``fc.0.bias``, ...), so a
JAX parameter tree loads with :func:`.checkpoint.params_from_numpy`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from .layers import GCNConv, Linear, relu, sigmoid


class GCNNodeModel(nn.Module):
    """``conv_channels`` GCNConv+ReLU layers, then ``fc_channels``
    Linear+ReLU layers and a final Linear+``final_activation``.

    ``forward`` is the JAX ``apply``: the full per-node output [..., N, out].
    """

    def __init__(
        self,
        in_features: int,
        conv_channels: Sequence[int] = (16,),
        fc_channels: Sequence[int] = (16, 16, 32),
        out_features: int = 1,
        final_activation: Callable = sigmoid,
    ):
        super().__init__()
        self.in_features = in_features
        self.conv_channels = tuple(conv_channels)
        self.fc_channels = tuple(fc_channels)
        self.out_features = out_features
        self.final_activation = final_activation
        if self.fc_channels[0] != self.conv_channels[-1]:
            raise ValueError("fc_channels[0] must equal conv_channels[-1]")
        dims = (in_features,) + self.conv_channels
        self.conv = nn.ModuleList(
            GCNConv(a, b) for a, b in zip(dims[:-1], dims[1:])
        )
        fdims = self.fc_channels + (out_features,)
        self.fc = nn.ModuleList(Linear(a, b) for a, b in zip(fdims[:-1], fdims[1:]))

    @property
    def num_hops(self) -> int:
        """Receptive-field depth = number of conv layers."""
        return len(self.conv)

    def backbone(self, x, senders, receivers, edge_weight) -> torch.Tensor:
        """Conv stack only: per-node hidden representations."""
        for conv in self.conv:
            x = relu(conv(x, senders, receivers, edge_weight))
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """FC head + final activation on [..., C] representations."""
        n = len(self.fc)
        for i, fc in enumerate(self.fc):
            x = fc(x)
            x = self.final_activation(x) if i == n - 1 else relu(x)
        return x

    def forward(self, x, senders, receivers, edge_weight) -> torch.Tensor:
        """Full per-node output (black-box semantics)."""
        return self.head(self.backbone(x, senders, receivers, edge_weight))
