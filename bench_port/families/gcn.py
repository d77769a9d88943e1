"""The ``gcn`` family in the program: a ``GCNNodeModel`` (``GCNConv``
layers and the fully connected head) on the relations merged into one
homogeneous graph."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


Spec = Tuple[str, Tuple[int, ...], float]


def conv_specs(model: dict, prefix: str, layer: int) -> List[Spec]:
    """``(name, shape, limit)`` of conv layer ``layer``'s weight (Glorot)
    and bias (``1 / sqrt(fan_in)``), named ``<prefix>.weight`` / ``.bias``."""
    dims = [model["in_features"]] + list(model["conv_channels"])
    a, b = dims[layer], dims[layer + 1]
    return [(f"{prefix}.weight", (b, a), math.sqrt(6.0 / (a + b))),
            (f"{prefix}.bias", (b,), 1.0 / math.sqrt(a))]


def head_specs(model: dict) -> List[Spec]:
    """The fully connected head's parameters, ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))``."""
    fc = list(model["fc_channels"]) + [model["out_features"]]
    specs = []
    for i, (a, b) in enumerate(zip(fc[:-1], fc[1:])):
        specs += [(f"fc.{i}.weight", (b, a), 1.0 / math.sqrt(a)),
                  (f"fc.{i}.bias", (b,), 1.0 / math.sqrt(a))]
    return specs


def param_specs(model: dict) -> List[Spec]:
    """``(name, shape, limit)`` of every parameter, drawn ``U(-limit,
    limit)``."""
    convs = [s for li in range(len(model["conv_channels"]))
             for s in conv_specs(model, f"conv.{li}", li)]
    return convs + head_specs(model)


def edge_types(gg, model: dict) -> np.ndarray:
    """The relation index of every edge of ``gg.merged_edges()``."""
    return np.concatenate([np.full(gg.edges[r].shape[1], i, np.int64)
                           for i, r in enumerate(gg.relations)])


def program_model(model: dict, params: dict, device):
    """The program's model with ``params`` loaded."""
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel

    mdef = GCNNodeModel(model["in_features"], tuple(model["conv_channels"]),
                        tuple(model["fc_channels"]), model["out_features"])
    return Model(mdef, params, device=device)


def program_graph(gg, model: dict, device):
    """The whole graph as the program's ``Graph`` (for ``explain_many``)."""
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays

    return from_arrays(gg.x, gg.merged_edges(), device=device)


def explainer_args(gg, model: dict, names: list) -> dict:
    """The program's ``Explainer`` arguments for this graph."""
    return dict(feat=gg.x, edge_index=gg.merged_edges(), names=names)
