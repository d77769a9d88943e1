"""Homogeneous node models: a conv stack plus a fully-connected head.

:class:`ConvStackNodeModel` is the generic model (any layers with a
``(x, senders, receivers, edge_weight)`` forward); :class:`GCNNodeModel` is
the GCN stack of the reference homo test model ``GCN_homo``
(``tests/test_utils.py:10-83``), which the fused engine serves; the
factories build the GAT, GATv2, SAGE, GraphConv and GIN stacks.  Parameter
names are those of the JAX package's parameter trees (``conv.0.weight``,
``conv.0.lin_src.weight``, ``fc.0.bias``, ...), so a JAX tree loads with
:func:`.checkpoint.params_from_numpy`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .layers import (
    GATConv,
    GATv2Conv,
    GCNConv,
    GINConv,
    GraphConv,
    Linear,
    SAGEConv,
    relu,
    sigmoid,
)


class ConvStackNodeModel(nn.Module):
    """Any conv stack + FC head: each conv is followed by a ReLU, then
    ``fc_channels`` Linear+ReLU layers and a final Linear+``final_activation``.

    ``forward`` is the JAX ``apply``: the full per-node output [..., N, out].
    The ``backbone`` / ``head`` split lets the adapter run the head on the
    query row only.
    """

    def __init__(
        self,
        convs: Sequence[nn.Module],
        fc_channels: Sequence[int] = (16, 16, 32),
        out_features: int = 1,
        final_activation: Callable = sigmoid,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.fc_channels = tuple(fc_channels)
        self.out_features = out_features
        self.final_activation = final_activation
        self.conv = nn.ModuleList(convs)
        fdims = self.fc_channels + (out_features,)
        self.fc = nn.ModuleList(
            Linear(a, b, generator=generator) for a, b in zip(fdims[:-1], fdims[1:])
        )

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


class GCNNodeModel(ConvStackNodeModel):
    """``conv_channels`` GCNConv+ReLU layers, then ``fc_channels``
    Linear+ReLU layers and a final Linear+``final_activation``; the model
    that :class:`.fast_gcn.FastBatchedGCN` serves."""

    def __init__(
        self,
        in_features: int,
        conv_channels: Sequence[int] = (16,),
        fc_channels: Sequence[int] = (16, 16, 32),
        out_features: int = 1,
        final_activation: Callable = sigmoid,
        generator: Optional[torch.Generator] = None,
    ):
        conv_channels = tuple(conv_channels)
        if tuple(fc_channels)[0] != conv_channels[-1]:
            raise ValueError("fc_channels[0] must equal conv_channels[-1]")
        dims = (in_features,) + conv_channels
        super().__init__(
            [GCNConv(a, b, generator=generator) for a, b in zip(dims[:-1], dims[1:])],
            fc_channels, out_features, final_activation, generator,
        )
        self.in_features = in_features
        self.conv_channels = conv_channels


def _stack(in_features, conv_channels, make, fc_channels, out_features, generator):
    """A :class:`ConvStackNodeModel` of ``make(prev, c)`` layers; ``make``
    returns (layer, output width)."""
    convs, prev = [], in_features
    for c in conv_channels:
        conv, prev = make(prev, c)
        convs.append(conv)
    return ConvStackNodeModel(convs, fc_channels, out_features, generator=generator)


def gat_node_model(
    in_features: int,
    conv_channels: Sequence[int] = (16,),
    heads: int = 1,
    fc_channels: Sequence[int] = (16, 16, 32),
    out_features: int = 1,
    add_self_loops: bool = True,
    concat: bool = True,
    generator: Optional[torch.Generator] = None,
) -> ConvStackNodeModel:
    """Homogeneous GAT stack + FC head (PyG ``GATConv`` defaults: unit
    self-loops in the softmax).  Concatenated heads widen a layer's output
    to ``heads * channels``; ``concat=False`` averages them."""
    def make(prev, c):
        conv = GATConv((prev, prev), c, heads=heads, add_self_loops=add_self_loops,
                       concat=concat, generator=generator)
        return conv, c * heads if concat else c
    return _stack(in_features, conv_channels, make, fc_channels, out_features, generator)


def gatv2_node_model(
    in_features: int,
    conv_channels: Sequence[int] = (16,),
    heads: int = 1,
    fc_channels: Sequence[int] = (16, 16, 32),
    out_features: int = 1,
    add_self_loops: bool = True,
    concat: bool = True,
    share_weights: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ConvStackNodeModel:
    """Homogeneous GATv2 stack + FC head (PyG ``GATv2Conv`` semantics)."""
    def make(prev, c):
        conv = GATv2Conv((prev, prev), c, heads=heads, add_self_loops=add_self_loops,
                         concat=concat, share_weights=share_weights, generator=generator)
        return conv, c * heads if concat else c
    return _stack(in_features, conv_channels, make, fc_channels, out_features, generator)


def sage_node_model(
    in_features: int,
    conv_channels: Sequence[int] = (16,),
    fc_channels: Sequence[int] = (16, 16, 32),
    out_features: int = 1,
    generator: Optional[torch.Generator] = None,
) -> ConvStackNodeModel:
    """GraphSAGE stack + FC head (PyG ``SAGEConv`` mean aggregation)."""
    return _stack(in_features, conv_channels,
                  lambda prev, c: (SAGEConv(prev, c, generator=generator), c),
                  fc_channels, out_features, generator)


def graph_conv_node_model(
    in_features: int,
    conv_channels: Sequence[int] = (16,),
    fc_channels: Sequence[int] = (16, 16, 32),
    out_features: int = 1,
    generator: Optional[torch.Generator] = None,
) -> ConvStackNodeModel:
    """GraphConv stack + FC head (PyG ``GraphConv`` sum aggregation)."""
    return _stack(in_features, conv_channels,
                  lambda prev, c: (GraphConv(prev, c, generator=generator), c),
                  fc_channels, out_features, generator)


def gin_node_model(
    in_features: int,
    conv_channels: Sequence[int] = (16,),
    mlp_hidden: int = 16,
    fc_channels: Sequence[int] = (16, 16, 32),
    out_features: int = 1,
    generator: Optional[torch.Generator] = None,
) -> ConvStackNodeModel:
    """GIN stack + FC head (PyG ``GINConv`` with a 2-layer MLP)."""
    return _stack(
        in_features, conv_channels,
        lambda prev, c: (GINConv(prev, c, mlp_channels=(mlp_hidden,), generator=generator), c),
        fc_channels, out_features, generator,
    )
