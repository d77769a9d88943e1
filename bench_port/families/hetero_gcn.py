"""The ``hetero_gcn`` family in the program: a ``HeteroGNN`` of one
``GCNConv`` a relation, summed per node, and the fully connected head, on
the graph's relations mapped in order onto the model's (``model.relations``
beside ``model.graph_relations``)."""

from __future__ import annotations

from typing import List

import numpy as np

from bench_port.families import gcn


def param_specs(model: dict) -> List[gcn.Spec]:
    """``(name, shape, limit)`` of every parameter, drawn ``U(-limit,
    limit)``: each layer's conv a relation, then the head."""
    convs = [s for li in range(len(model["conv_channels"])) for rel in model["relations"]
             for s in gcn.conv_specs(model, f"conv.{li}.{'__'.join(rel)}", li)]
    return convs + gcn.head_specs(model)


def edge_types(gg, model: dict) -> np.ndarray:
    """The model's relation index of every edge of ``gg.merged_edges()``
    (``graph_relations`` maps the graph's relations, in order, onto the
    model's)."""
    if list(model["graph_relations"]) != list(gg.relations):
        raise ValueError("graph_relations must list the graph's relations in order")
    return gcn.edge_types(gg, model)


def _dicts(gg, model: dict):
    rels = [tuple(r) for r in model["relations"]]
    ntype = rels[0][0]
    feat = {ntype: gg.x}
    ei = {rel: gg.edges[g] for rel, g in zip(rels, model["graph_relations"])}
    return ntype, rels, feat, ei


def program_model(model: dict, params: dict, device):
    """The program's model with ``params`` loaded."""
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.gnn import hetero_gcn_for_relations

    rels = [tuple(r) for r in model["relations"]]
    mdef = hetero_gcn_for_relations([rels[0][0]], rels, model["in_features"],
                                    tuple(model["conv_channels"]), tuple(model["fc_channels"]),
                                    model["out_features"])
    return Model(mdef, params, device=device)


def program_graph(gg, model: dict, device):
    """The whole graph as the program's typed ``Graph`` (for
    ``explain_many``), its types in the model's order."""
    from bikg_graph_explainability_public_tpu_torch.graph import hetero_to_homo

    _, _, feat, ei = _dicts(gg, model)
    return hetero_to_homo(feat, ei, device=device)[0]


def explainer_args(gg, model: dict, names: list) -> dict:
    """The program's ``Explainer`` arguments for this graph: dicts by node
    type and relation, the query type."""
    ntype, _, feat, ei = _dicts(gg, model)
    return dict(feat=feat, edge_index=ei, names={ntype: names}, element_type=ntype)
