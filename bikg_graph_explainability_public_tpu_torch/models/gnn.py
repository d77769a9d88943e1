"""Homogeneous node models: a conv stack plus a fully-connected head.

:class:`ConvStackNodeModel` is the generic model (any layers with a
``(x, senders, receivers, edge_weight)`` forward); :class:`GCNNodeModel` is
the GCN stack of the reference homo test model ``GCN_homo``
(``tests/test_utils.py:10-83``), which the fused engine serves; the
factories build the GAT, GATv2, SAGE, GraphConv and GIN stacks.
:class:`HeteroGNN` is the per-relation stack of PyG's ``HeteroConv`` over a
typed homogeneous graph.  Parameter names are those of the JAX package's
parameter trees (``conv.0.weight``, ``conv.0.lin_src.weight``,
``conv.0.a__r1__b.weight``, ``fc.0.bias``, ...), so a JAX tree loads with
:func:`.checkpoint.params_from_numpy`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


Relation = Tuple[str, str, str]


def takes_types(model_def) -> bool:
    """Whether a model's forward also takes ``(node_type, edge_type)``:
    a :class:`HeteroGNN`, or a model declaring ``typed = True``."""
    return isinstance(model_def, HeteroGNN) or getattr(model_def, "typed", False)


class HeteroGNN(nn.Module):
    """Per-relation convs over a typed homogeneous graph, summed per node
    (PyG ``HeteroConv`` with ``aggr='sum'``), then the FC head.

    ``conv_layers``: one dict ``{(src_type, rel, dst_type): conv}`` a layer;
    relation ``ri`` of a layer is its dict's ``ri``-th key, and edges of
    type ``ri`` feed it.  Node type ``i`` is ``node_type_names[i]``: a
    relation's conv puts its self-loops and bias only on its destination
    type's nodes (``dst_scope``).  The modules live in ``conv``, an
    ``nn.ModuleList`` of ``nn.ModuleDict``s keyed ``"src__rel__dst"``, so
    the JAX tree ``{"conv": [{"a__r1__b": {...}}], "fc": [...]}`` loads as
    it is.  ``head_node_type`` is kept for the reference's signature; the
    head runs on whatever rows it is given.
    """

    def __init__(
        self,
        node_type_names: Sequence[str],
        conv_layers: Sequence[Dict[Relation, nn.Module]],
        fc_channels: Sequence[int] = (16, 16, 32),
        out_features: int = 1,
        head_node_type: int = 0,
        final_activation: Callable = sigmoid,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.node_type_names = list(node_type_names)
        self.layer_relations: List[List[Relation]] = [
            [tuple(r) for r in layer] for layer in conv_layers
        ]
        self.conv = nn.ModuleList(
            nn.ModuleDict({"__".join(r): c for r, c in layer.items()}) for layer in conv_layers
        )
        self.fc_channels = tuple(fc_channels)
        self.out_features = out_features
        self.head_node_type = head_node_type
        self.final_activation = final_activation
        fdims = self.fc_channels + (out_features,)
        self.fc = nn.ModuleList(
            Linear(a, b, generator=generator) for a, b in zip(fdims[:-1], fdims[1:])
        )

    @property
    def conv_layers(self) -> List[Dict[Relation, nn.Module]]:
        """Each layer's ``{relation: conv}``, in relation order."""
        return [
            {r: layer["__".join(r)] for r in rels}
            for rels, layer in zip(self.layer_relations, self.conv)
        ]

    @property
    def num_hops(self) -> int:
        """Receptive-field depth = number of conv layers."""
        return len(self.conv)

    @property
    def relations(self) -> List[Relation]:
        """Relation keys in layer order."""
        return list(self.layer_relations[0])

    def backbone(self, x, senders, receivers, edge_weight, node_type, edge_type) -> torch.Tensor:
        """The per-relation convs, summed per node, each layer followed by
        a ReLU.  ``edge_weight`` may carry leading batch axes."""
        scopes = {name: node_type == i for i, name in enumerate(self.node_type_names)}
        for layer in self.conv_layers:
            out = None
            for ri, (rel, conv) in enumerate(layer.items()):
                rel_w = edge_weight * (edge_type == ri).to(edge_weight.dtype)
                contrib = conv(x, senders, receivers, rel_w, dst_scope=scopes[rel[-1]])
                out = contrib if out is None else out + contrib
            x = relu(out)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """FC head + final activation on [..., C] representations."""
        n = len(self.fc)
        for i, fc in enumerate(self.fc):
            x = fc(x)
            x = self.final_activation(x) if i == n - 1 else relu(x)
        return x

    def forward(self, x, senders, receivers, edge_weight, node_type, edge_type) -> torch.Tensor:
        """Full per-node output on the homogenised graph."""
        return self.head(self.backbone(x, senders, receivers, edge_weight, node_type, edge_type))


def hetero_gcn_for_relations(
    node_type_names: Sequence[str],
    relations: Sequence[Relation],
    in_features: int,
    conv_channels: Sequence[int] = (16,),
    fc_channels: Sequence[int] = (16, 16, 32),
    out_features: int = 1,
    generator: Optional[torch.Generator] = None,
) -> HeteroGNN:
    """A :class:`HeteroGNN` of per-relation GCNConvs: the architecture of
    the reference's trained hetero checkpoint (``conv.{2i}.convs.<rel>.
    lin.weight``), which :class:`.fast_hetero.FastBatchedHeteroGCN` serves."""
    layers, prev = [], in_features
    for c in conv_channels:
        layers.append({tuple(r): GCNConv(prev, c, generator=generator) for r in relations})
        prev = c
    return HeteroGNN(node_type_names, layers, fc_channels, out_features, generator=generator)
