"""Black-box model adapter (reference ``src/pathway_explanations/model.py``).

Wraps a model module behind a uniform calling convention and provides the
batched masked forward: a batch of B node-mask or edge-mask perturbations
is one chunked forward with per-edge weight multipliers (the reference builds a
block-diagonal mega-graph instead, ``model.py:62-116``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..graph import Graph
from ..utils.device import resolve_device
from .gnn import GCNNodeModel, HeteroGNN, takes_types


class Model:
    """Adapter around a model module and its trained parameters.

    ``params``: an optional state dict loaded into ``model_def`` (see
    :mod:`.checkpoint`).  The module is moved to ``device`` (``None`` means
    the CUDA card).  :class:`.gnn.GCNNodeModel` forwards run on the fused
    engine (:class:`.fast_gcn.FastBatchedGCN`) when ``fast``; other
    homogeneous modules with a ``(x, senders, receivers, edge_weight)``
    forward run the generic batched forward, the head on the query row only
    where they expose ``backbone`` / ``head``
    (:class:`.gnn.ConvStackNodeModel`: the GAT, GATv2, SAGE, GraphConv and
    GIN stacks, which have no fast engine in the JAX package either).
    A :class:`.gnn.HeteroGNN` of GCNConvs runs on
    :class:`.fast_hetero.FastBatchedHeteroGCN` when ``fast``, one of
    GATConvs without self-loops (its node problems) on
    :class:`.fast_hetero.FastBatchedHeteroGAT`; what the engine declines
    (it returns None), any other HeteroGNN (of SAGEConvs, say) and any
    other typed model (:class:`.gnn.RGCNNodeModel`) run the generic
    forward with the graph's type vectors.
    """

    def __init__(
        self,
        model_def: nn.Module,
        params: Optional[Dict[str, torch.Tensor]] = None,
        fast: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if params is not None:
            model_def.load_state_dict(params)
        self.model_def = model_def.to(self.device).eval()
        self.fast = fast
        self._fast_cache: tuple = (None, None)  # (graph, engine)

    def get_hops(self, num_relations: int = 0) -> int:
        """Receptive-field depth, as the model declares it."""
        return self.model_def.num_hops

    @property
    def _typed(self) -> bool:
        """Whether the model's forward also takes ``(node_type,
        edge_type)`` (:func:`.gnn.takes_types`)."""
        return takes_types(self.model_def)

    def forward_fn(self, graph: Graph) -> Callable[[torch.Tensor], torch.Tensor]:
        """``edge_weight -> per-node output`` with the graph captured."""
        types = (graph.node_type, graph.edge_type) if self._typed else ()

        def fwd(ew):
            return self.model_def(graph.x, graph.senders, graph.receivers, ew, *types)
        return fwd

    @torch.no_grad()
    def infer(self, graph: Graph, edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single unperturbed forward (reference ``Model.infer``)."""
        ew = graph.edge_mask.to(graph.x.dtype)
        if edge_weight is not None:
            ew = ew * edge_weight
        return self.forward_fn(graph)(ew)

    @torch.no_grad()
    def perturbed_query_outputs(
        self,
        graph: Graph,
        masks,
        problem: str,
        query: Optional[int],
        chunk_size: int = 128,
        auto_chunk: bool = True,
    ) -> torch.Tensor:
        """Outputs of the black box for every perturbation row.

        masks: [M, S] bool (numpy or tensor), S = padded node count (node and
        graph problems) or padded edge count (edge problems).  Returns [M]
        float32: the query node's prediction per perturbation (node and edge
        problems; for edges, the query edge's receiver) or the pooled graph
        prediction (graph problems).  Masks are taken in chunks of
        ``chunk_size`` rows; the last chunk may be shorter.
        """
        masks = torch.as_tensor(masks, device=self.device)
        if self.fast and isinstance(self.model_def, GCNNodeModel):
            return self._fast_engine(graph).query_outputs(
                masks, query, problem, chunk_size, auto_chunk=auto_chunk
            )
        if self.fast and isinstance(self.model_def, HeteroGNN):
            engine = self._fast_hetero_engine(graph)
            if engine is not None:
                # the engine declines what it cannot serve: the GCN engine
                # unrestricted edge problems up to its DENSE_CAP, or beyond
                # its budget; the GAT engine edge and graph problems
                out = engine.query_outputs(masks, query, problem, chunk_size)
                if out is not None:
                    return out
        base = graph.edge_mask.to(graph.x.dtype)
        snd, rcv = graph.senders, graph.receivers
        is_edge = "edge" in problem
        is_graph = "graph" in problem
        nvalid = graph.node_mask.to(graph.x.dtype)
        fwd = self.forward_fn(graph)
        # homogeneous models exposing backbone/head run the head on the
        # query row only
        split_head = (
            not is_graph
            and not self._typed
            and hasattr(self.model_def, "backbone")
            and hasattr(self.model_def, "head")
        )

        def rows(m):
            mf = m.to(graph.x.dtype)
            ew = base * (mf if is_edge else mf[:, snd] * mf[:, rcv])  # [B, E]
            if split_head:
                h = self.model_def.backbone(graph.x, snd, rcv, ew)
                return self.model_def.head(h[:, query, :])[:, 0]
            out = fwd(ew)  # [B, N, out]
            if is_graph:  # global mean pool over valid nodes
                return (out[..., 0] * nvalid).sum(-1) / torch.clamp(nvalid.sum(), min=1.0)
            return out[:, query, 0]

        return torch.cat([rows(c) for c in masks.split(max(int(chunk_size), 1))])

    def _fast_engine(self, graph: Graph):
        from .fast_gcn import FastBatchedGCN

        if self._fast_cache[0] is graph:
            return self._fast_cache[1]
        engine = FastBatchedGCN(self.model_def, graph, device=self.device)
        self._fast_cache = (graph, engine)
        return engine

    def _fast_hetero_engine(self, graph: Graph):
        """The hetero engine for ``graph`` (cached): the GCN engine, else
        the GAT engine, else None (the generic forward), as the JAX
        package picks them."""
        from .fast_hetero import FastBatchedHeteroGAT, FastBatchedHeteroGCN

        if self._fast_cache[0] is graph:
            return self._fast_cache[1]
        engine = None
        for cls in (FastBatchedHeteroGCN, FastBatchedHeteroGAT):
            try:
                engine = cls(self.model_def, graph, device=self.device)
                break
            except TypeError:
                pass
        self._fast_cache = (graph, engine)
        return engine
