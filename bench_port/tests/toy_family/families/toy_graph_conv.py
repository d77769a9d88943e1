"""The ``toy_graph_conv`` family in the program, a family that is not GCN,
for the test that adds a family by files alone: PyG ``GraphConv`` layers
(``lin_rel`` of the summed neighbours plus ``lin_root``) with ReLU, then
the ``gcn`` family's head, on the relations merged."""

from __future__ import annotations

import math
from typing import List

from bench_port.families import gcn
from bench_port.families.gcn import edge_types, explainer_args, program_graph  # noqa: F401


def param_specs(model: dict) -> List[gcn.Spec]:
    """``(name, shape, limit)`` of every parameter, each ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))``."""
    dims = [model["in_features"]] + list(model["conv_channels"])
    specs = []
    for li, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lim = 1.0 / math.sqrt(a)
        specs += [(f"conv.{li}.lin_rel.weight", (b, a), lim), (f"conv.{li}.lin_rel.bias", (b,), lim),
                  (f"conv.{li}.lin_root.weight", (b, a), lim)]
    return specs + gcn.head_specs(model)


def program_model(model: dict, params: dict, device):
    """The program's model with ``params`` loaded."""
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.gnn import graph_conv_node_model

    mdef = graph_conv_node_model(model["in_features"], tuple(model["conv_channels"]),
                                 tuple(model["fc_channels"]), model["out_features"])
    return Model(mdef, params, device=device)
