"""Explainer orchestrator (reference L6, ``src/pathway_explanations/explainer.py``).

Construct with (feat, edge_index, model, params, names, pathways,
pathway_names, problem), call ``run(element, times)``, receive two sorted
pandas DataFrames.  Its private step ``Explainer._explain`` is the same run
returning numpy arrays; it needs no pandas.

Every random draw derives from ``params['seed']``: the repeat index is
folded into a counter-based key (:mod:`..utils.prng`), so runs reproduce and
repeats differ, and the same seed gives the JAX package's masks and
surrogate initialisation bit for bit.

Ported: homogeneous graphs, ``node_prediction``, ``edge_prediction`` and
``graph_prediction``.  Heterogeneous inputs are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import check_spmm_backend
from ..graph import element_size, from_arrays
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

    feat / edge_index : arrays ([N,F] / [2,E])
    model : a :class:`..models.adapter.Model`, the black box being explained
    params : hyperparameter dict (seed, interpret_samples, epochs, lr,
        l1_lambda, ... — reference ``config/configs.json``)
    names : list of element names: one per node, or one per edge for
        ``edge_prediction``
    pathways / pathway_names : community structure (None → Shapley mode)
    problem : "node_prediction" | "edge_prediction" | "graph_prediction"
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
    ):
        self.initial_assertions(model, params, names, pathways, pathway_names, problem)
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

    @staticmethod
    def initial_assertions(model, params, names, pathways, pathway_names, problem) -> None:
        """Input validation (reference ``explainer.py:106-189``)."""
        if pathways is not None:
            assert isinstance(pathways, list), "Pathways is not list"
        if pathway_names is not None:
            assert isinstance(pathway_names, list), "Pathway names is not list"
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
        assert isinstance(names, list), "Element names is not list"
        assert isinstance(model, Model), "model must be a Model adapter"

    def _explain(self, element, times: int = 1, return_diagnostics: bool = False):
        """Explain one node, edge or graph prediction; the arrays behind
        :meth:`run`.  Returns an :class:`Explanation`, and with
        ``return_diagnostics=True`` the pair (Explanation, diagnostics dict
        of :meth:`run`)."""
        if "spmm_backend" in self.params:
            check_spmm_backend(self.params["spmm_backend"])
        graph = from_arrays(self.feat, self.edge_index, device=self.device)
        pathways, pathway_names = self.pathways, self.pathway_names

        if "graph" not in self.problem:
            n_hops = self.model.get_hops()
            ind = extract_index(element, self.names)
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
            names_array = np.array(self.names, dtype=str)
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
            sub_names = list(self.names)
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
