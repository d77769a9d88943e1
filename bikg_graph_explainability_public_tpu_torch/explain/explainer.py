"""Explainer orchestrator (reference L6, ``src/pathway_explanations/explainer.py``).

Construct with (feat, edge_index, model, params, names, pathways,
pathway_names, problem), call ``run(element, times)``, receive two sorted
pandas DataFrames.  Its private step ``Explainer._explain`` is the same run
returning numpy arrays; it needs no pandas.

Every random draw derives from ``params['seed']``: the repeat index is
folded into a counter-based key (:mod:`..utils.prng`), so runs reproduce and
repeats differ, and the same seed gives the JAX package's masks and
surrogate initialisation bit for bit.

Ported: homogeneous and heterogeneous graphs (dicts of per-type features,
edge indices, names and communities, homogenised by
:func:`..graph.hetero_to_homo`), ``node_prediction``, ``edge_prediction``
and ``graph_prediction``.  A heterogeneous graph's type ids are matched to
the model's type and relation names (:func:`align_types`), where the JAX
package takes them by position.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import check_spmm_backend
from ..graph import (
    Graph,
    HeteroInfo,
    element_size,
    from_arrays,
    graph_from_numpy,
    hetero_names_to_homo,
    hetero_to_homo,
    host_view,
)
from ..models.adapter import Model
from ..ops.khop import extract_khop_subgraph
from ..utils.device import resolve_device
from ..utils.profiling import PhaseTimer
from ..utils.prng import repeat_split_key_data
from .masks import MaskSampler
from .pathways import Pathways, pathway_dataframe
from .wlm import train_model, train_model_repeats


def extract_index(element, names=None) -> int:
    """Index of the element of interest in ``names`` (reference
    ``explainer.py:191-226``)."""
    if names is None:
        if not isinstance(element, (int, float, np.integer, np.floating)):
            raise AssertionError(
                "No element names have been given and the node name given is not numeric"
            )
        return int(element)
    names_array = np.array(names, dtype=str)
    hits = np.where(names_array == str(element))[0]
    if hits.size == 0:
        raise AssertionError(f"Element name '{element}' is not present in the graph")
    return int(hits[0])


def weight_stacking(weights: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std across repeats (reference ``explainer.py:288-314``; std is
    population std, ``unbiased=False``)."""
    stack = np.stack([np.asarray(w) for w in weights], axis=0)
    return stack.mean(axis=0), stack.std(axis=0)


def config_val_dataframe(mean, std, names):
    """Element-score DataFrame (reference ``data.py:650-693``)."""
    import pandas as pd

    df = pd.DataFrame(
        {
            "name": list(names),
            "config_value_mean": np.asarray(mean, np.float64),
            "config_value_std": np.asarray(std, np.float64),
        }
    )
    return df.set_index("name").sort_values(by=["config_value_mean"], ascending=False)


def align_types(graph: Graph, info: HeteroInfo, model_def) -> Graph:
    """``graph`` with its node and edge type ids renumbered from
    ``info``'s block order into ``model_def``'s ``node_type_names`` and
    ``relations`` order, matched by name (blocks stay where they are;
    padding keeps type 0).  Raises ``ValueError`` where the two name sets
    differ.  A model that declares no type names takes the graph as it is.
    """
    names = getattr(model_def, "node_type_names", None)
    rels = getattr(model_def, "relations", None)
    if names is None or rels is None:
        return graph
    rels = [tuple(r) for r in rels]
    if sorted(names) != sorted(info.node_type_names):
        raise ValueError(
            f"the graph's node types {info.node_type_names} are not the model's {names}"
        )
    if sorted(rels) != sorted(info.edge_type_names):
        raise ValueError(
            f"the graph's relations {info.edge_type_names} are not the model's {rels}"
        )
    node_perm = np.array([names.index(t) for t in info.node_type_names], np.int32)
    edge_perm = np.array([rels.index(r) for r in info.edge_type_names], np.int32)
    if (node_perm == np.arange(len(names))).all() and (edge_perm == np.arange(len(rels))).all():
        return graph
    hv = host_view(graph)
    arrays = {k: getattr(hv, k) for k in ("x", "senders", "receivers", "node_mask", "edge_mask")}
    n, e = graph.num_nodes, graph.num_edges
    nt, et = hv.node_type.copy(), hv.edge_type.copy()
    nt[:n], et[:e] = node_perm[nt[:n]], edge_perm[et[:e]]
    return graph_from_numpy(
        graph.device, **arrays, node_type=nt, edge_type=et, num_nodes=n, num_edges=e,
    )


class Explanation(NamedTuple):
    """One explanation as arrays.

    ``names``, ``mean`` and ``std`` are the element scores in the order of
    the computational graph's elements.  ``pathway_names`` /
    ``pathway_scores`` are the community scores, sorted descending (None in
    Shapley mode).
    """

    names: List[str]
    mean: np.ndarray
    std: np.ndarray
    pathway_names: Optional[np.ndarray]
    pathway_scores: Optional[np.ndarray]


class Explainer:
    """Community-aware GNN explainer.

    feat / edge_index : arrays ([N,F] / [2,E]) or, for a heterogeneous
        graph, dicts of them keyed by node type / relation tuple
    model : a :class:`..models.adapter.Model`, the black box being explained
    params : hyperparameter dict (seed, interpret_samples, epochs, lr,
        l1_lambda, ... — reference ``config/configs.json``)
    names : list of element names: one per node, or one per edge for
        ``edge_prediction``; a dict of such lists for a heterogeneous graph
    pathways / pathway_names : community structure (None → Shapley mode),
        lists or dicts keyed by type
    problem : "node_prediction" | "edge_prediction" | "graph_prediction"
    element_type : the query's node type (str) or relation (tuple) in a
        heterogeneous graph; names are then looked up in its block only
    node_types / edge_types : type vectors of a homogeneous-array graph
    device : where the graph lives; ``None`` means the CUDA card.  It must
        be the model's device.
    """

    def __init__(
        self,
        feat,
        edge_index,
        model: Model,
        params: Dict[str, Any],
        names,
        pathways=None,
        pathway_names=None,
        problem: str = "node_prediction",
        device=None,
        element_type=None,
        node_types=None,
        edge_types=None,
    ):
        self.initial_assertions(
            feat, edge_index, model, params, names, pathways, pathway_names, element_type, problem
        )
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, explainer on {self.device}")
        self.feat = feat
        self.edge_index = edge_index
        self.model = model
        self.params = params
        self.names = names
        self.pathways = pathways
        self.pathway_names = pathway_names
        self.problem = problem.lower().strip()
        self.element_type = element_type
        self.node_types = node_types
        self.edge_types = edge_types

    @staticmethod
    def initial_assertions(
        feat, edge_index, model, params, names, pathways, pathway_names, element_type, problem
    ) -> None:
        """Input validation (reference ``explainer.py:106-189``)."""
        if pathways is not None:
            assert isinstance(pathways, (list, dict)), "Pathways is not list or dict"
        if pathway_names is not None:
            assert isinstance(pathway_names, (list, dict)), "Pathway names is not list or dict"
            assert len(pathway_names) == len(pathways), (
                "Length of list with pathway names and list with pathway indexes "
                "do not match"
            )
        assert isinstance(params, dict) or (
            hasattr(params, "get") and hasattr(params, "__getitem__")
        ), "Hyperparameters given is not dictionary"
        assert isinstance(problem, str), "Problem type given is not string"
        canonical = ("node_prediction", "edge_prediction", "graph_prediction")
        assert problem.lower().strip() in canonical, (
            f"Unknown problem type {problem!r}; expected one of {canonical}"
        )
        assert isinstance(names, (list, dict)), "Element names is not list or dict"
        assert isinstance(model, Model), "model must be a Model adapter"
        if element_type is not None:
            assert isinstance(
                element_type, (str, tuple)
            ), "Element type is not string (node) nor tuple (edge)"
            if "node" in problem:
                assert isinstance(feat, dict), "Feature given is not a dict of node types"
                assert element_type in feat, (
                    f"Node type '{element_type}' is not among input node types "
                    "in heterogeneous graph"
                )
            elif "edge" in problem:
                assert isinstance(edge_index, dict), (
                    "Edge index given is not a dict of edge index types"
                )
                assert element_type in edge_index, (
                    f"Edge type '{element_type}' is not among input edge types "
                    "in heterogeneous graph"
                )

    def _query_index(self, element, names, info: Optional[HeteroInfo]) -> int:
        """Index of the query element in the homogenised graph.  A
        heterogeneous query with an ``element_type`` is looked up in that
        type's block only (names may repeat across types) and offset by the
        block's pointer (the reference's ``filter_hetero_names``,
        ``explainer.py:228-286``)."""
        if info is not None and isinstance(self.element_type, str) and "node" in self.problem:
            t = info.node_type_names.index(self.element_type)
            start, count = info.node_pointers[t], info.node_counts[t]
            return start + extract_index(element, names[start : start + count])
        if info is not None and isinstance(self.element_type, tuple) and "edge" in self.problem:
            t = info.edge_type_names.index(self.element_type)
            start, count = info.edge_pointers[t], info.edge_counts[t]
            return start + extract_index(element, names[start : start + count])
        return extract_index(element, names)

    def _prepare_graph(self) -> Tuple[Graph, Optional[HeteroInfo], list]:
        """The padded graph on the device (homogenised and its type ids
        aligned to the model's where the inputs are dicts), its
        :class:`..graph.HeteroInfo` (None for arrays) and the flat names.
        Dict names are flattened in the graph's block order, matched by key
        where their keys are the node types (or, for edge problems, the
        relations)."""
        if isinstance(self.feat, dict) and isinstance(self.edge_index, dict):
            graph, info = hetero_to_homo(self.feat, self.edge_index, device=self.device)
            graph = align_types(graph, info, self.model.model_def)
            names = self.names
            if isinstance(names, dict):
                order = info.edge_type_names if "edge" in self.problem else info.node_type_names
                if set(names) == set(order):
                    names = {k: names[k] for k in order}
            return graph, info, hetero_names_to_homo(names)[0]
        graph = from_arrays(
            self.feat, self.edge_index, node_type=self.node_types, edge_type=self.edge_types,
            device=self.device,
        )
        return graph, None, self.names

    def _explain(self, element, times: int = 1, return_diagnostics: bool = False):
        """Explain one node, edge or graph prediction; the arrays behind
        :meth:`run`.  Returns an :class:`Explanation`, and with
        ``return_diagnostics=True`` the pair (Explanation, diagnostics dict
        of :meth:`run`)."""
        if "spmm_backend" in self.params:
            check_spmm_backend(self.params["spmm_backend"])
        graph, info, names = self._prepare_graph()
        pathways, pathway_names = self.pathways, self.pathway_names
        if pathways is not None:
            pointers = {}
            if info is not None:
                pointers = dict(
                    node_pointers=dict(zip(info.node_type_names, info.node_pointers)),
                    edge_pointers=dict(zip(info.edge_type_names, info.edge_pointers)),
                )
            pathways, pathway_names, _ = Pathways(pathways, pathway_names).hetero2homo(
                self.problem, **pointers
            )

        if "graph" not in self.problem:
            n_hops = self.model.get_hops(info.num_relations if info is not None else 0)
            ind = self._query_index(element, names, info)
            is_edge = "edge" in self.problem
            # edge queries seed the BFS at the query edge's receiver node,
            # whose prediction the masked forwards read
            seed = int(graph.host.receivers[ind]) if is_edge else ind
            # one extra hop, mirroring the reference (data.py:328)
            sub = extract_khop_subgraph(
                graph, seed, n_hops + 1,
                pad_mode=self.params.get("pad_mode", "pow2") or "pow2",
            )
            sub_graph = sub.graph
            query = int(sub.query)
            names_array = np.array(names, dtype=str)
            if is_edge:
                if len(names_array) < graph.num_edges:
                    raise AssertionError(
                        "edge_prediction requires one name per EDGE "
                        f"(got {len(names_array)} names for "
                        f"{graph.num_edges} edges); node-length name "
                        "lists only fit node/graph problems"
                    )
                kept_edges = np.nonzero(sub.parent_edge_mask)[0]
                sub_names = names_array[kept_edges].tolist()
            else:
                kept = sub.parent_nodes[: sub_graph.num_nodes]
                sub_names = names_array[kept].tolist()
            if pathways is not None:
                pathways, pathway_names = Pathways(pathways, pathway_names).comp_graph(
                    sub_names
                )
        else:
            # graph problems explain the pooled prediction: no query element
            sub_graph = graph
            sub_names = list(names)
            query = None

        sub_pathway_inds = None
        if pathways is not None:
            sub_pclass = Pathways(pathways, pathway_names)
            sub_pathway_inds = sub_pclass.names2inds(sub_names)

        elements = element_size(sub_graph, self.problem)
        width = sub_graph.e_pad if "edge" in self.problem else sub_graph.n_pad
        sampler = MaskSampler(elements, width, self.params, sub_pathway_inds)
        kd = repeat_split_key_data(int(self.params.get("seed", 0)), times)  # [T, 2, 2]
        timer = PhaseTimer()
        with timer.phase("mask_sampling"):
            sampled = [sampler.sample(kd[i, 0]) for i in range(times)]
        batch_size = sampled[0][2]
        chunk = self.params.get("forward_chunk", None)
        stackable = all(
            s[0].shape == sampled[0][0].shape and s[2] == batch_size for s in sampled
        )
        # all repeats in one pass unless the [T, M, S] float32 mask stack
        # would exceed 1 GiB; then one repeat at a time
        losses: List[np.ndarray] = []
        best_epoch: List[int] = []
        if stackable and times * sampled[0][0].size * 4 <= (1 << 30):
            with timer.phase("surrogate_training", sync=self.device):
                result = train_model_repeats(
                    np.stack([s[0] for s in sampled]), self.model, sub_graph,
                    self.params, self.problem, query, elements, batch_size, kd,
                    chunk_size=chunk,
                )
                config_vals = list(result.weights.cpu().numpy()[:, :elements])
            if return_diagnostics:
                losses = list(result.losses.cpu().numpy())
                best_epoch = [int(b) for b in result.best_epoch.cpu().numpy()]
        else:
            config_vals = []
            for i, (mask, _tags, bsz) in enumerate(sampled):
                with timer.phase("surrogate_training", sync=self.device):
                    result = train_model(
                        mask, self.model, sub_graph, self.params, self.problem,
                        query, elements, bsz, kd[i, 1], chunk_size=chunk,
                    )
                    config_vals.append(result.weights.cpu().numpy()[:elements])
                if return_diagnostics:
                    losses.append(result.losses.cpu().numpy())
                    best_epoch.append(int(result.best_epoch))

        mean_cv, std_cv = weight_stacking(config_vals)
        pw_names = pw_scores = None
        if pathways is not None:
            pw_names, pw_scores = sub_pclass.aggregate_arrays(mean_cv, sub_pathway_inds)
        ex = Explanation(
            names=sub_names,
            mean=mean_cv,
            std=std_cv,
            pathway_names=pw_names,
            pathway_scores=pw_scores,
        )
        if not return_diagnostics:
            return ex
        return ex, {
            "losses": losses,
            "best_epoch": best_epoch,
            "phase_seconds": dict(timer.totals),
            "num_elements": elements,
            "subgraph_nodes": sub_graph.num_nodes,
            "subgraph_edges": sub_graph.num_edges,
        }

    def run(self, element, times: int = 1, return_diagnostics: bool = False):
        """Explain one node, edge or graph prediction.

        Returns (config_val_df, pathway_df): element scores and
        community-aggregated scores (None in Shapley mode), both sorted
        descending (reference ``explainer.py:316-546``).  With
        ``return_diagnostics=True`` a third dict is returned: per-repeat
        ``losses`` ([epochs] arrays) and ``best_epoch``, ``phase_seconds``
        (``mask_sampling``, ``surrogate_training``), ``num_elements``,
        ``subgraph_nodes`` and ``subgraph_edges`` (the reference computes
        the losses but discards them, ``explainer.py:502``).
        """
        out = self._explain(element, times, return_diagnostics)
        ex, diag = out if return_diagnostics else (out, None)
        pathway_df = None
        if ex.pathway_names is not None:
            pathway_df = pathway_dataframe(ex.pathway_names, ex.pathway_scores)
        frames = (config_val_dataframe(ex.mean, ex.std, ex.names), pathway_df)
        return frames + (diag,) if return_diagnostics else frames
