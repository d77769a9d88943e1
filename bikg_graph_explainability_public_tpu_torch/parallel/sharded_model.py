"""Drop-in :class:`..models.adapter.Model` that shards the graph over a mesh.

``Explainer`` talks to the black box only through
``Model.perturbed_query_outputs``; overriding that one method with the
halo-exchange engine makes the whole explanation pipeline (mask sampling,
kernel weighting, surrogate training, DataFrames) run on graphs whose
features, edges and activations are split across ranks::

    model = ShardedModel(mdef, params, make_mesh(8))
    Explainer(feat, edge_index, model, cfg, names).run("q")   # on every rank

Every rank draws the same masks (host numpy from the key words), so every
rank returns the same DataFrames.  Node, edge and graph problems of
:class:`..models.gnn.GCNNodeModel` and of a :class:`..models.gnn.HeteroGNN`
of default GCNConvs run sharded.  Other models raise: a silent replicated
fall-back would run out of memory on exactly the graphs this class exists
for; ``allow_replicated_fallback=True`` opts into it, with a warning.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..graph import Graph, host_view
from ..models.adapter import Model
from ..models.fast_hetero import is_hetero_gcn
from ..models.gnn import GCNNodeModel
from ..utils.device import resolve_device
from .halo import build_halo_partition, halo_masked_outputs, halo_masked_outputs_hetero
from .mesh import axis_size, mesh_device


class ShardedModel(Model):
    """Model adapter whose batched masked forward runs halo-partitioned.
    Its device is this rank's on ``mesh`` (``device``, if given, must be
    that one)."""

    def __init__(
        self,
        model_def,
        params,
        mesh,
        axis: str = "data",
        fast: bool = True,
        allow_replicated_fallback: bool = False,
        device=None,
    ):
        dev = mesh_device(mesh)
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"this rank's device on the mesh is {dev}, not {device}")
        super().__init__(model_def, params, fast=fast, device=dev)
        self.mesh = mesh
        self.axis = axis
        self.allow_replicated_fallback = allow_replicated_fallback
        self._halo_cache: tuple = (None, None)

    @property
    def n_devices(self) -> int:
        """Mesh size this model is partitioned over."""
        return axis_size(self.mesh, self.axis)

    def _halo(self, graph: Graph):
        """(partition, this rank's feature block, hetero rows or None),
        built once per graph."""
        if self._halo_cache[0] is graph:
            return self._halo_cache[1]
        hv = host_view(graph)
        e = graph.num_edges
        part = build_halo_partition(hv.senders[:e], hv.receivers[:e], graph.n_pad, self.n_devices)
        me, nl = self.mesh.get_local_rank(self.axis), part.n_local
        x = np.zeros((part.n_total, graph.num_features), np.float32)
        x[: graph.n_pad] = hv.x
        x_loc = torch.from_numpy(x[me * nl : (me + 1) * nl]).to(self.device)
        hetero = None
        if is_hetero_gcn(self.model_def):
            # edge type per local edge slot (padding slots read edge 0, but
            # every use is multiplied by edge_valid)
            etype_loc = hv.edge_type[part.edge_id[me]].astype(np.int64)
            nt = np.full((part.n_total,), -1, np.int64)
            nt[: graph.n_pad] = np.where(hv.node_mask, hv.node_type, -1)
            nt = nt[me * nl : (me + 1) * nl]
            scope = np.stack([
                nt == self.model_def.node_type_names.index(rel[-1])
                for rel in self.model_def.relations
            ]).astype(np.float32)
            hetero = (torch.from_numpy(etype_loc).to(self.device),
                      torch.from_numpy(scope).to(self.device))
        entry = (part, x_loc, hetero)
        self._halo_cache = (graph, entry)
        return entry

    def perturbed_query_outputs(
        self,
        graph: Graph,
        masks,
        problem: str,
        query: Optional[int],
        chunk_size: int = 128,
        auto_chunk: bool = True,
    ) -> torch.Tensor:
        """Distributed masked forwards: one output per row of ``masks``
        (the whole [M, S] batch, the same on every rank), computed over the
        halo partition and returned on every rank.  ``auto_chunk`` matches
        the base adapter's signature; the halo path takes ``chunk_size``
        as it is, padding a short last chunk to it."""
        hetero_ok = is_hetero_gcn(self.model_def)
        if not isinstance(self.model_def, GCNNodeModel) and not hetero_ok:
            if not self.allow_replicated_fallback:
                raise NotImplementedError(
                    "ShardedModel serves GCNNodeModel and HeteroGNNs of default GCNConvs; "
                    "the replicated path would hold the full graph on every rank. Pass "
                    "allow_replicated_fallback=True to opt in explicitly."
                )
            warnings.warn(
                "ShardedModel: replicated fall-back (full graph on every rank) "
                f"for {type(self.model_def).__name__}",
                stacklevel=2,
            )
            return super().perturbed_query_outputs(graph, masks, problem, query, chunk_size)
        part, x, hetero = self._halo(graph)
        masks = torch.as_tensor(masks, device=self.device)
        if "edge" not in problem:
            me, nl = self.mesh.get_local_rank(self.axis), part.n_local
            cols = masks.new_zeros((masks.shape[0], part.n_total))
            cols[:, : masks.shape[1]] = masks
            masks = cols[:, me * nl : (me + 1) * nl]
        kw = dict(problem=problem, query=None if "graph" in problem else int(query),
                  axis=self.axis, num_nodes=graph.num_nodes)
        if hetero_ok:
            def run(chunk):
                return halo_masked_outputs_hetero(self, x, chunk, part, self.mesh, *hetero, **kw)
        else:
            def run(chunk):
                return halo_masked_outputs(self, x, chunk, part, self.mesh, **kw)

        m = masks.shape[0]
        outs = []
        for start in range(0, m, chunk_size):
            chunk = masks[start : start + chunk_size]
            if chunk.shape[0] < chunk_size and start > 0:
                # one chunk shape throughout, as the JAX package compiles one
                pad = chunk.new_zeros((chunk_size - chunk.shape[0], chunk.shape[1]))
                outs.append(run(torch.cat([chunk, pad]))[: chunk.shape[0]])
            else:
                outs.append(run(chunk))
        return torch.cat(outs) if len(outs) > 1 else outs[0]
