"""Batched masked forwards of heterogeneous models: a :class:`.gnn.HeteroGNN`
whose convs are all GCNConvs (the reference's trained hetero checkpoint,
:class:`FastBatchedHeteroGCN`), or all GATConvs without self-loops (the
reference hetero test model, :class:`FastBatchedHeteroGAT`, node problems
on receptive-field plans only, as in the JAX package).

In the GCN engine each relation ``r`` has its own masked degree, with
self-loops only on its destination type (``scope_r``, PyG ``HeteroConv`` semantics), and a layer's
output is the sum over relations.  Three tiers, as in the JAX package's
``models/fast_hetero.py``:

* **receptive-field plans** (node and edge queries, any graph size): the
  query's ball, per-relation adjacency slices stacked on a leading R axis,
  batched matmuls;
* **dense** (unrestricted, up to ``DENSE_CAP`` padded nodes): a lazy
  ``[R, N, N]`` adjacency, one product ``A_r @ [N, B*C]`` per relation and
  layer, activations node-major ``[N, B, C]``;
* **ELL** (unrestricted, above ``DENSE_CAP``): one prefix-valid neighbour
  table per relation over the relation's type-scoped rows (sources in the
  row union ``[lo, hi)`` of its two types' blocks, outputs in its
  destination block ``[d0, d1)``).  Layer 1 is one batched product of
  per-sample slot coefficients with a batch-shared gather of the first
  layer's features over every relation's slots (``g0_all [N, K_tot + R,
  C1]``, the last R slots the self terms) while that gather fits
  ``_G0_BUDGET_BYTES``, else kernel 2.3 per relation on broadcast
  features.  Layers >= 2 run one kernel per relation: 2.3 (the separable
  gather-sum) for node masks, 2.4 (the weighted gather-sum on sample-major
  coefficients ``[B, d1 - d0, K_r]``) for edge masks.

Departures from the JAX engine: node-major activations in every tier
(``batch_node_outputs`` returns ``[N, B, C]``); float32 throughout (no
bf16 aggregation on the card); chunks with a ragged last one; a relation's
bias is multiplied by its scope on the ELL tier too, and where one relation
cannot be type-scoped (a type without nodes, or a type whose rows are not
contiguous) every relation runs on the full row range.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph import host_view
from ..ops.ell import NeighborTable, build_neighbor_table_edges
from ..ops.spmm import gather_sum_batched_separable, weighted_gather_sum_batched
from ..utils.device import resolve_device
from .fast_gcn import _PLAN_DEG_ENTRY_CAP, _ball_geometry, _chunks, _pad16
from .gnn import HeteroGNN
from .layers import GATConv, GCNConv, relu


class HeteroQueryPlan(NamedTuple):
    """Receptive-field restriction for one query node: the geometry of
    :class:`.fast_gcn.QueryPlan` (BFS over the union of all relations),
    with per-relation adjacency slices on a leading R axis.

    vp:       [Ps] node ids, distance-ordered (query first)
    a_deg:    [R, Ps, N_pad] adjacency rows at vp (no self-loops; empty
              for the GAT engine)
    a_layers: [R, P_0, Ps] for the first layer, then [R, P_i, P_{i-1}]
    p_sizes:  (P_0, ..., P_{L-1}) padded prefix lengths
    scope_v:  [R, Ps] each relation's destination-type scope at vp
    """

    vp: torch.Tensor
    a_deg: torch.Tensor
    a_layers: Tuple[torch.Tensor, ...]
    p_sizes: Tuple[int, ...]
    scope_v: torch.Tensor


class HeteroEdgeQueryPlan(NamedTuple):
    """Receptive-field restriction for edge-masked forwards: the geometry
    of :class:`.fast_gcn.EdgeQueryPlan` per relation (the relation's edges
    inside the ball, their one-hot placement matrices for the degrees and
    for each layer)."""

    vp: torch.Tensor
    p_sizes: Tuple[int, ...]
    scope_v: torch.Tensor
    deg_eid: Tuple[torch.Tensor, ...]  # per relation
    deg_onehot: Tuple[torch.Tensor, ...]
    layer_eid: Tuple[Tuple[torch.Tensor, ...], ...]  # [layer][relation]
    layer_onehot: Tuple[Tuple[torch.Tensor, ...], ...]


class EllTier(NamedTuple):
    """The ELL tier's operands, built once per engine.

    ranges:   per relation (lo, hi, d0, d1): source rows [lo, hi), output
              rows [d0, d1)
    tables:   per relation, the prefix-valid table over ``d1 - d0`` rows
              whose sources are local to ``lo``
    deg_snd / deg_rcv: every relation's non-loop edges, senders global,
              receivers offset by ``ri * N`` (one ``index_add_`` gives every
              relation's masked neighbour counts)
    koffs:    each relation's first slot in the fused layout
    nbr_all / valid_all: [N, K_tot] the relations' tables embedded in full
              rows, sources global and offset by ``ri * N`` (None beyond
              the layer-1 budget)
    g0_all:   [N, K_tot + R, C1] the first layer's features at every slot,
              then each relation's own row (its self slot)
    """

    ranges: List[Tuple[int, int, int, int]]
    tables: List[NeighborTable]
    deg_snd: torch.Tensor
    deg_rcv: torch.Tensor
    koffs: List[int]
    nbr_all: Optional[torch.Tensor]
    valid_all: Optional[torch.Tensor]
    g0_all: Optional[torch.Tensor]


def _rsqrt0(deg: torch.Tensor) -> torch.Tensor:
    """``deg^-1/2``, 0 where ``deg`` is 0 (a node outside a relation's
    destination type with no in-edges of it)."""
    return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg))


def _assemble(pieces: Dict[Tuple[int, int], torch.Tensor], n: int) -> torch.Tensor:
    """ReLU of per-destination-block pieces ``[d1 - d0, B, C]`` placed in
    full rows ``[n, B, C]``, zero elsewhere.  The blocks must be disjoint
    (one per destination type)."""
    keys = sorted(pieces)
    if any(a[1] > b[0] for a, b in zip(keys, keys[1:])) or keys[-1][1] > n:
        raise AssertionError(f"destination blocks {keys} overlap or pass {n} rows")
    if keys == [(0, n)]:
        return pieces[keys[0]].relu_()
    first = pieces[keys[0]]
    h = first.new_zeros((n,) + tuple(first.shape[1:]))
    for (d0, d1), p in pieces.items():
        h[d0:d1] = p.relu_()
    return h


def dense_hetero_mask_scales(adj_r: torch.Tensor, scope: torch.Tensor,
                             m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The node-mask scales of the dense hetero GCN layer, over any leading
    batch axes: node-major float masks ``m [..., n, B]`` over per-relation
    adjacencies ``adj_r [..., R, n, n]`` (``adj_r[r, v, u]`` counts the
    non-loop edges u -> v of relation r) and destination-type scopes
    ``scope [..., R, n]``.  Returns ``(s, self_w)``, both ``[..., R, n,
    B]``: ``s = m * deg_r^-1/2`` and ``self_w = scope_r / deg_r`` with
    ``deg_r = scope_r + m * (A_r @ m)`` (0 where ``deg_r`` is 0)."""
    m = m.contiguous()[..., None, :, :]  # [..., 1, n, B]
    sc = scope[..., None]
    dis = _rsqrt0(sc + m * (adj_r @ m))
    return m * dis, sc * dis * dis


def dense_hetero_gcn_layers(adj_r, scope, s, self_w, xw0, conv_layers) -> torch.Tensor:
    """The mask-scaled dense hetero GCN layers over any leading batch axes:
    relation ``r`` of a layer is ``s_r * (A_r @ (s_r * HW_r)) + self_r *
    HW_r + b_r * scope_r``, and the layer is the ReLU of the sum over
    relations.

    ``adj_r [..., R, n, n]`` and ``scope [..., R, n]`` as in
    :func:`dense_hetero_mask_scales`, which gives ``s`` and ``self_w``;
    ``xw0`` indexed by relation, ``xw0[r] [..., n, C]``, the first layer's
    transformed features, shared by every mask; ``conv_layers`` the model's
    ``ModuleDict``s in relation order.  Activations are node-major ``[...,
    n, B, C]`` as in :func:`.fast_gcn.dense_gcn_layers`, one product ``A_r
    @ [n, B*C]`` per relation a layer; returns the last layer's.
    """
    h = None
    for li, layer in enumerate(conv_layers):
        out = None
        for ri, conv in enumerate(layer.values()):
            sr = s[..., ri, :, :, None]
            hw = xw0[ri][..., None, :] if li == 0 else h[..., : conv.in_features] @ conv.weight.T
            t = sr * hw
            t = sr * (adj_r[..., ri, :, :] @ t.flatten(-2)).view(t.shape)
            t += self_w[..., ri, :, :, None] * hw
            if conv.bias is not None:
                t += conv.bias * scope[..., ri, :, None, None]
            out = t if out is None else out.add_(t)
        h = relu(out)
    return h


def _relation_scopes(model_def: HeteroGNN, graph) -> np.ndarray:
    """``[R, N]`` float32: 1 on the valid nodes of each relation's
    destination type."""
    hv = host_view(graph)
    names = model_def.node_type_names
    return np.stack(
        [(hv.node_type == names.index(rel[-1])) & hv.node_mask for rel in model_def.relations]
    ).astype(np.float32)


def _ball_slices(et, rcv_pos, snd_pos, keep, p_s: int, p_sizes, nrel: int) -> List[np.ndarray]:
    """Per layer ``i``, the multiplicities ``[R, P_i, P_{i-1}]`` (``P_{-1}
    = p_s``) of the edges ``keep`` whose receiver lies in the layer's
    output prefix and whose sender in its input prefix, one slice a
    relation."""
    out, prev = [], p_s
    for p in p_sizes:
        a_i = np.zeros((nrel, p, prev), np.float32)
        for ri in range(nrel):
            sel = (keep & (et == ri) & (rcv_pos >= 0) & (rcv_pos < p)
                   & (snd_pos >= 0) & (snd_pos < prev))
            np.add.at(a_i[ri], (rcv_pos[sel], snd_pos[sel]), 1.0)
        out.append(a_i)
        prev = p
    return out


def is_hetero_gcn(model_def) -> bool:
    """Whether ``model_def`` is a :class:`.gnn.HeteroGNN` whose convs are
    all default GCNConvs (normalised, with self-loops, not ``improved``):
    the model the engine computes."""
    return isinstance(model_def, HeteroGNN) and all(
        isinstance(c, GCNConv) and c.normalize and c.add_self_loops and not c.improved
        for layer in model_def.conv_layers
        for c in layer.values()
    )


class FastBatchedHeteroGCN:
    """Batched masked forward engine for one (HeteroGNN of GCNConvs, graph)
    pair.  ``device=None`` means the CUDA card; the graph must live there.
    Raises ``TypeError`` for any other model (the adapter then runs the
    generic forward).

    ``DENSE_CAP`` (padded nodes of the unrestricted dense tier),
    ``_ELL_CHUNK`` (masks a step on the ELL tier) and ``_G0_BUDGET_BYTES``
    (the layer-1 gather's budget) are the JAX engine's values, kept as class
    attributes.
    """

    DENSE_CAP = 4096
    _ELL_CHUNK = 48
    _G0_BUDGET_BYTES = 6 << 30

    def __init__(self, model_def: HeteroGNN, graph, restrict: bool = True, device=None):
        if not is_hetero_gcn(model_def):
            raise TypeError("the fast hetero engine needs a HeteroGNN of default GCNConvs")
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph is on {graph.device}, engine on {self.device}")
        self.model = model_def.to(self.device)
        self.graph = graph
        self.restrict = restrict
        self._plans: dict = {}
        self._edge_plans: dict = {}
        self._adj: Optional[torch.Tensor] = None
        self._ell: Optional[EllTier] = None
        self.scope = torch.from_numpy(_relation_scopes(model_def, graph)).to(self.device)  # [R, N]
        # the first layer's transformed features per relation, on the host
        hv = host_view(graph)
        xw0 = [
            hv.x[:, : conv.in_features] @ conv.weight.detach().cpu().numpy().T
            for conv in model_def.conv_layers[0].values()
        ]
        self.xw0 = torch.from_numpy(np.stack(xw0).astype(np.float32)).to(self.device)  # [R, N, C1]

    def _layers(self):
        """Per conv layer, its (relation index, conv) pairs."""
        return [list(enumerate(layer.values())) for layer in self.model.conv_layers]

    # ------------------------------------------------------------------
    # dense tier
    # ------------------------------------------------------------------
    @property
    def adj(self) -> torch.Tensor:
        """Dense per-relation adjacency ``[R, N, N]`` (receiver-major,
        multiplicity kept, self-loops dropped), built on first unrestricted
        use: query plans never pay its R*N^2 memory."""
        if self._adj is None:
            g = self.graph
            hv = host_view(g)
            snd, rcv = hv.senders[: g.num_edges], hv.receivers[: g.num_edges]
            et = hv.edge_type[: g.num_edges]
            nrel = len(self.model.relations)
            adjs = np.zeros((nrel, g.n_pad, g.n_pad), np.float32)
            for ri in range(nrel):
                keep = (et == ri) & (snd != rcv)
                np.add.at(adjs[ri], (rcv[keep], snd[keep]), 1.0)
            self._adj = torch.from_numpy(adjs).to(self.device)
        return self._adj

    @torch.no_grad()
    def batch_node_outputs(self, masks: torch.Tensor) -> torch.Tensor:
        """Dense tier: every node's backbone output for each node-mask row,
        node-major ``[N, B, C]``."""
        s, self_w = dense_hetero_mask_scales(self.adj, self.scope, masks.float().t())
        return dense_hetero_gcn_layers(self.adj, self.scope, s, self_w, self.xw0,
                                       self.model.conv_layers)

    # ------------------------------------------------------------------
    # receptive-field plans
    # ------------------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def query_plan(self, query: int) -> Optional[HeteroQueryPlan]:
        """Receptive-field plan for node query ``query`` (cached; None when
        its degree rows would pass ``_PLAN_DEG_ENTRY_CAP`` entries)."""
        q = int(query)
        if q in self._plans:
            return self._plans[q]
        g = self.graph
        n = g.n_pad
        et = host_view(g).edge_type[: g.num_edges]
        snd, rcv, vp, pos, p_s, p_sizes = _ball_geometry(g, q, self.model.num_hops)
        nrel = len(self.model.relations)
        plan = None
        if p_s * n * nrel <= _PLAN_DEG_ENTRY_CAP:
            keep_ns = snd != rcv
            rcv_pos, snd_pos = pos[rcv], pos[snd]
            a_deg = np.zeros((nrel, p_s, n), np.float32)
            for ri in range(nrel):
                keep = keep_ns & (et == ri) & (rcv_pos >= 0)
                np.add.at(a_deg[ri], (rcv_pos[keep], snd[keep]), 1.0)
            a_layers = _ball_slices(et, rcv_pos, snd_pos, keep_ns, p_s, p_sizes, nrel)
            vp_t = self._t(vp)
            plan = HeteroQueryPlan(
                vp=vp_t, a_deg=self._t(a_deg), a_layers=tuple(self._t(a) for a in a_layers),
                p_sizes=p_sizes, scope_v=self.scope[:, vp_t],
            )
        self._plans[q] = plan
        return plan

    def edge_query_plan(self, query: int) -> HeteroEdgeQueryPlan:
        """Receptive-field plan for edge-masked forwards around node
        ``query`` (the query edge's receiver; cached)."""
        q = int(query)
        if q in self._edge_plans:
            return self._edge_plans[q]
        g = self.graph
        snd, rcv, vp, pos, p_s, p_sizes = _ball_geometry(g, q, self.model.num_hops)
        et = host_view(g).edge_type[: g.num_edges]
        eids = np.arange(g.num_edges, dtype=np.int64)
        keep = snd != rcv
        nrel = len(self.model.relations)

        def onehot(rows_sel, cols_sel, eid_sel, rows, cols):
            rp, cp, ei, val = _pad16(rows_sel.astype(np.int64), cols_sel.astype(np.int64), eid_sel)
            oh = np.zeros((rp.shape[0], rows * cols), np.float32)
            oh[np.arange(rp.shape[0]), rp * cols + cp] = val
            return self._t(ei), self._t(oh)

        rcv_pos, snd_pos = pos[rcv], pos[snd]
        deg_eid, deg_onehot = [], []
        layer_eid = [[] for _ in p_sizes]
        layer_onehot = [[] for _ in p_sizes]
        for ri in range(nrel):
            base = keep & (et == ri)
            in_deg = base & (rcv_pos >= 0)
            ei, oh = onehot(rcv_pos[in_deg], np.zeros(int(in_deg.sum()), np.int64),
                            eids[in_deg], p_s, 1)
            deg_eid.append(ei)
            deg_onehot.append(oh)
            prev = p_s
            for li, p in enumerate(p_sizes):
                sel = base & (rcv_pos >= 0) & (rcv_pos < p) & (snd_pos >= 0) & (snd_pos < prev)
                ei, oh = onehot(rcv_pos[sel], snd_pos[sel], eids[sel], p, prev)
                layer_eid[li].append(ei)
                layer_onehot[li].append(oh)
                prev = p
        vp_t = self._t(vp)
        plan = HeteroEdgeQueryPlan(
            vp=vp_t, p_sizes=p_sizes, scope_v=self.scope[:, vp_t],
            deg_eid=tuple(deg_eid), deg_onehot=tuple(deg_onehot),
            layer_eid=tuple(tuple(x) for x in layer_eid),
            layer_onehot=tuple(tuple(x) for x in layer_onehot),
        )
        self._edge_plans[q] = plan
        return plan

    def _plan_layers(self, plan, h0_terms, layer_agg, self_w) -> torch.Tensor:
        """The conv layers on a plan's ball, shared by node and edge plans:
        ``h0_terms(ri, n0)`` is relation ri's first-layer aggregate and
        ``layer_agg(li, ri, prev, ni, hw)`` a later layer's; ``self_w [R,
        B, Ps]`` the self-loop weights.  Returns the query row's head
        output ``[B]``."""
        xw0_v, scope_v = self.xw0[:, plan.vp], plan.scope_v
        h = prev = None
        for li, layer in enumerate(self._layers()):
            ni = plan.p_sizes[li]
            out = None
            for ri, conv in layer:
                if li == 0:
                    hw = xw0_v[ri]
                    t = h0_terms(ri, ni)
                else:
                    hw = h[..., : conv.in_features] @ conv.weight.T  # [B, prev, C]
                    t = layer_agg(li, ri, prev, ni, hw)
                t = t + self_w[ri][:, :ni, None] * hw[..., :ni, :]
                if conv.bias is not None:
                    t = t + conv.bias * scope_v[ri][None, :ni, None]
                out = t if out is None else out + t
            h = relu(out)
            prev = ni
        return self.model.head(h[:, 0, :])[:, 0]

    def _restricted_outputs(self, masks: torch.Tensor, plan: HeteroQueryPlan) -> torch.Tensor:
        """Node-masked forward on the query's ball only: ``[B]`` query
        predictions, the same as the full forward's."""
        m = masks.float()  # [B, N]
        mv = m[:, plan.vp]  # [B, Ps]
        neigh = m @ plan.a_deg.transpose(1, 2)  # [R, B, Ps]
        deg = plan.scope_v[:, None, :] + mv[None] * neigh
        dis = _rsqrt0(deg)
        s = mv[None] * dis  # [R, B, Ps]

        def h0_terms(ri, n0):
            agg = plan.a_layers[0][ri] @ (s[ri][:, :, None] * self.xw0[ri, plan.vp])  # [B, P0, C1]
            return s[ri][:, :n0, None] * agg

        def layer_agg(li, ri, prev, ni, hw):
            agg = plan.a_layers[li][ri] @ (s[ri][:, :prev, None] * hw)
            return s[ri][:, :ni, None] * agg

        return self._plan_layers(plan, h0_terms, layer_agg, plan.scope_v[:, None, :] * dis * dis)

    def _restricted_edge_outputs(self, masks: torch.Tensor, plan: HeteroEdgeQueryPlan) -> torch.Tensor:
        """Edge-masked forward on the query's ball only: per relation, the
        masked edges leave its adjacency (one-hot contraction) and its
        self-loops stay on within its destination type."""
        m = masks.float()  # [B, E_pad]
        b = m.shape[0]
        nrel = len(plan.deg_eid)
        deg = torch.stack([
            plan.scope_v[ri][None, :] + m[:, plan.deg_eid[ri]] @ plan.deg_onehot[ri]
            for ri in range(nrel)
        ])  # [R, B, Ps]
        dis = _rsqrt0(deg)

        def layer_adj(li, ri, prev, ni):
            a = (m[:, plan.layer_eid[li][ri]] @ plan.layer_onehot[li][ri]).view(b, ni, prev)
            return a * dis[ri][:, :ni, None] * dis[ri][:, None, :prev]

        def h0_terms(ri, n0):
            return layer_adj(0, ri, plan.vp.shape[0], n0) @ self.xw0[ri, plan.vp]

        def layer_agg(li, ri, prev, ni, hw):
            return layer_adj(li, ri, prev, ni) @ hw

        return self._plan_layers(plan, h0_terms, layer_agg, plan.scope_v[:, None, :] * dis * dis)

    # ------------------------------------------------------------------
    # ELL tier
    # ------------------------------------------------------------------
    def _rel_ranges(self) -> List[Tuple[int, int, int, int]]:
        """Per relation ``(lo, hi, d0, d1)``: its source rows, the union of
        its two types' blocks, and its output rows, its destination type's
        block.  Every relation takes ``(0, N, 0, N)`` where any type's rows
        are not contiguous or a relation's type has no node."""
        g = self.graph
        n = g.n_pad
        hv = host_view(g)
        names = self.model.node_type_names
        blocks = {}
        full = [(0, n, 0, n)] * len(self.model.relations)
        for t in range(len(names)):
            idx = np.nonzero((hv.node_type == t) & hv.node_mask)[0]
            if idx.size and int(idx[-1]) - int(idx[0]) + 1 != idx.size:
                return full
            blocks[t] = (int(idx[0]), int(idx[-1]) + 1) if idx.size else None
        out = []
        for rel in self.model.relations:
            src, dst = blocks[names.index(rel[0])], blocks[names.index(rel[-1])]
            if src is None or dst is None:
                return full
            out.append((min(src[0], dst[0]), max(src[1], dst[1]), dst[0], dst[1]))
        return out

    def _ell_setup(self) -> EllTier:
        """The ELL tier's tables and layer-1 layout, built once (host
        numpy, then uploaded); each table's prefix check runs here."""
        if self._ell is not None:
            return self._ell
        g = self.graph
        n = g.n_pad
        hv = host_view(g)
        snd, rcv = hv.senders[: g.num_edges], hv.receivers[: g.num_edges]
        et = hv.edge_type[: g.num_edges]
        eids = np.arange(g.num_edges, dtype=np.int32)
        keep_ns = snd != rcv  # gcn_norm drops data self-loops
        ranges = self._rel_ranges()
        host_tables, tables, deg_snd, deg_rcv = [], [], [], []
        for ri, (lo, hi, d0, d1) in enumerate(ranges):
            sel = keep_ns & (et == ri)
            t = build_neighbor_table_edges(d1 - d0, snd[sel] - lo, rcv[sel] - d0, eids[sel],
                                           device="cpu")
            host_tables.append(t)
            dev_t = NeighborTable(t.nbr.to(self.device), t.valid.to(self.device),
                                  t.eid.to(self.device))
            dev_t.deg  # the host-side prefix check, once per table
            tables.append(dev_t)
            deg_snd.append(snd[sel])
            deg_rcv.append(rcv[sel] + ri * n)
        koffs = list(np.cumsum([0] + [t.k for t in host_tables]))
        c1 = self.xw0.shape[-1]
        nbr_all = valid_all = g0_all = None
        if sum(t.nbr.numel() for t in host_tables) * c1 * 4 <= self._G0_BUDGET_BYTES:
            nbr_np = np.zeros((n, koffs[-1]), np.int64)
            valid_np = np.zeros((n, koffs[-1]), np.float32)
            for ri, (t, (lo, hi, d0, d1)) in enumerate(zip(host_tables, ranges)):
                nbr_np[d0:d1, koffs[ri]: koffs[ri + 1]] = t.nbr.numpy() + lo + ri * n
                valid_np[d0:d1, koffs[ri]: koffs[ri + 1]] = t.valid.numpy()
            self_cols = np.arange(n)[:, None] + n * np.arange(len(ranges))[None, :]  # [N, R]
            nbr_all = self._t(nbr_np)
            valid_all = self._t(valid_np)
            g0_all = self.xw0.reshape(-1, c1)[self._t(np.concatenate([nbr_np, self_cols], 1))]
        self._ell = EllTier(
            ranges=ranges, tables=tables,
            deg_snd=self._t(np.concatenate(deg_snd).astype(np.int64)),
            deg_rcv=self._t(np.concatenate(deg_rcv).astype(np.int64)),
            koffs=[int(k) for k in koffs], nbr_all=nbr_all, valid_all=valid_all, g0_all=g0_all,
        )
        return self._ell

    def _layer1_fused(self, ell: EllTier, coeff: torch.Tensor) -> torch.Tensor:
        """Layer 1 as one batched product: slot coefficients ``[N, K_tot +
        R, B]`` (the self slots' last) with the shared gather ``g0_all``,
        plus each relation's bias on its scope; ``[N, B, C1]`` after ReLU."""
        h = torch.bmm(coeff.transpose(1, 2), ell.g0_all)  # [N, B, C1]
        for ri, conv in self._layers()[0]:
            if conv.bias is not None:
                h += self.scope[ri][:, None, None] * conv.bias
        return relu(h)

    def _ell_layers(self, ell: EllTier, h: torch.Tensor, aggregate, self_w) -> torch.Tensor:
        """Conv layers >= 2 on the ELL tier, one aggregation per relation:
        ``aggregate(ri, feats [hi - lo, B*C], b)`` returns ``[d1 - d0,
        B*C]``; ``self_w(ri)`` the relation's self-loop weights ``[N, B]``.
        Returns the last layer's ``[N, B, C]``."""
        n, b = h.shape[0], h.shape[1]
        for layer in self._layers()[1:]:
            pieces: Dict[Tuple[int, int], torch.Tensor] = {}
            for ri, conv in layer:
                lo, hi, d0, d1 = ell.ranges[ri]
                hw = h[lo:hi, :, : conv.in_features] @ conv.weight.T  # [hi-lo, B, C]
                f = hw.shape[-1]
                t = aggregate(ri, hw.view(hi - lo, b * f), b).view(d1 - d0, b, f)
                t += self_w(ri)[d0:d1, :, None] * hw[d0 - lo: d1 - lo]
                if conv.bias is not None:
                    t += self.scope[ri][d0:d1, None, None] * conv.bias
                pieces[(d0, d1)] = t if (d0, d1) not in pieces else pieces[(d0, d1)].add_(t)
                del hw
            h = _assemble(pieces, n)
        return h

    @torch.no_grad()
    def batch_node_outputs_ell(self, masks: torch.Tensor) -> torch.Tensor:
        """ELL tier: every node's backbone output for each node-mask row,
        node-major ``[N, B, C]``.  Layers >= 2 run kernel 2.3 once per
        relation."""
        ell = self._ell_setup()
        n, nrel = self.graph.n_pad, len(ell.ranges)
        m = masks.float().t().contiguous()  # [N, B]
        b = m.shape[1]
        # every relation's masked neighbour count in one index_add_
        cnt = m.new_zeros((nrel * n, b)).index_add_(0, ell.deg_rcv, m[ell.deg_snd])
        deg = self.scope[:, :, None] + m * cnt.view(nrel, n, b)
        dis = _rsqrt0(deg)
        a = m * dis  # [R, N, B]: the separable factor of every edge weight
        self_w = self.scope[:, :, None] * dis * dis  # [R, N, B]
        del cnt, deg, dis

        def aggregate(ri, feats, b):
            lo, hi, d0, d1 = ell.ranges[ri]
            return gather_sum_batched_separable(
                a[ri, lo:hi].t(), feats, b, table=ell.tables[ri], post_a_bn=a[ri, d0:d1].t()
            )

        if ell.nbr_all is not None:
            dest = torch.cat([
                a[ri][:, None, :].expand(n, ell.koffs[ri + 1] - ell.koffs[ri], b)
                for ri in range(nrel)
            ], dim=1)  # [N, K_tot, B]: each slot's destination factor
            coeff = ell.valid_all[:, :, None] * dest * a.view(nrel * n, b)[ell.nbr_all]
            del dest
            h = self._layer1_fused(ell, torch.cat([coeff, self_w.permute(1, 0, 2)], dim=1))
            del coeff
        else:
            # over the budget: kernel 2.3 per relation on broadcast features
            pieces: Dict[Tuple[int, int], torch.Tensor] = {}
            for ri, conv in self._layers()[0]:
                lo, hi, d0, d1 = ell.ranges[ri]
                xw = self.xw0[ri]
                c1 = xw.shape[-1]
                feats = xw[lo:hi, None, :].expand(hi - lo, b, c1).reshape(hi - lo, b * c1)
                t = aggregate(ri, feats, b).view(d1 - d0, b, c1)
                t += self_w[ri][d0:d1, :, None] * xw[d0:d1, None, :]
                if conv.bias is not None:
                    t += self.scope[ri][d0:d1, None, None] * conv.bias
                pieces[(d0, d1)] = t if (d0, d1) not in pieces else pieces[(d0, d1)].add_(t)
            h = _assemble(pieces, n)
        return self._ell_layers(ell, h, aggregate, lambda ri: self_w[ri])

    @torch.no_grad()
    def _ell_edge_h(self, masks: torch.Tensor) -> Optional[torch.Tensor]:
        """ELL tier: every node's backbone output for each edge-mask row,
        ``[N, B, C]``, or None beyond the layer-1 budget.  Edge masks are
        not separable: each relation's slot coefficients ``w[s, v, k] =
        m_e * dis_r[v] * dis_r[src]`` are built once, sample-major ``[B, d1
        - d0, K_r]``, and weigh every layer: layer 1 through the fused
        product, layers >= 2 through kernel 2.4, which reads them as they
        are."""
        ell = self._ell_setup()
        if ell.nbr_all is None:
            return None
        n, nrel = self.graph.n_pad, len(ell.ranges)
        m = masks.float()  # [B, E_pad]
        b = m.shape[0]
        coeffs, self_ws = [], []
        coeff_all = m.new_zeros((n, ell.koffs[-1] + nrel, b))
        for ri, (lo, hi, d0, d1) in enumerate(ell.ranges):
            table = ell.tables[ri]
            w_raw = table.valid * m[:, table.eid]  # [B, rows, K_r]
            deg = self.scope[ri].repeat(b, 1)  # [B, N]
            deg[:, d0:d1] += w_raw.sum(2)
            dis = _rsqrt0(deg)
            coeff = w_raw * dis[:, d0:d1, None] * dis[:, lo:hi][:, table.nbr]
            coeffs.append(coeff)
            self_w = (self.scope[ri] * dis * dis).t()  # [N, B]
            self_ws.append(self_w)
            coeff_all[d0:d1, ell.koffs[ri]: ell.koffs[ri + 1]] = coeff.permute(1, 2, 0)
            coeff_all[:, ell.koffs[-1] + ri] = self_w
            del w_raw, deg, dis
        h = self._layer1_fused(ell, coeff_all)
        del coeff_all

        def aggregate(ri, feats, b):
            return weighted_gather_sum_batched(None, feats, b, table=ell.tables[ri],
                                               w_sample=coeffs[ri])

        return self._ell_layers(ell, h, aggregate, lambda ri: self_ws[ri])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def query_outputs(
        self,
        masks: torch.Tensor,
        query: Optional[int],
        problem: str = "node_prediction",
        chunk_size: int = 128,
    ) -> Optional[torch.Tensor]:
        """``[M]`` predictions of the query node (node problems; for edge
        problems the query edge's receiver) or of the pooled graph, for bool
        masks ``[M, N_pad]`` (node and graph problems) or ``[M, E_pad]``
        (edge problems).  Concrete node and edge queries run on their
        plans in chunks of ``chunk_size``; unrestricted forwards on the
        dense tier (the same chunks) up to ``DENSE_CAP`` padded nodes and
        on the ELL tier (chunks of ``_ELL_CHUNK``) above it.  Returns None
        for what the engine does not serve, as the JAX engine does: an
        unrestricted edge problem up to ``DENSE_CAP``, or above it beyond
        the layer-1 budget or without a concrete query."""
        masks = torch.as_tensor(masks, device=self.device)
        is_graph, is_edge = "graph" in problem, "edge" in problem
        concrete = isinstance(query, (int, np.integer))
        if self.restrict and not is_graph and concrete:
            if is_edge:
                plan, step = self.edge_query_plan(int(query)), self._restricted_edge_outputs
            else:
                plan, step = self.query_plan(int(query)), self._restricted_outputs
            if plan is not None:
                return torch.cat([step(c, plan) for c in _chunks(masks, chunk_size)])
        ell = self.graph.n_pad > self.DENSE_CAP
        if is_edge and (
            not ell or self._ell_setup().nbr_all is None or not (is_graph or concrete)
        ):
            return None
        nvalid = self.graph.node_mask.float()
        head = self.model.head

        def run_chunk(mc):
            if not ell:
                h = self.batch_node_outputs(mc)
            else:
                h = self._ell_edge_h(mc) if is_edge else self.batch_node_outputs_ell(mc)
            if is_graph:  # [N, B, C] -> pooled [B]
                out = head(h)[..., 0]
                return (out * nvalid[:, None]).sum(0) / torch.clamp(nvalid.sum(), min=1.0)
            return head(h[int(query)])[:, 0]

        chunk = self._ELL_CHUNK if ell else chunk_size
        return torch.cat([run_chunk(c) for c in _chunks(masks, chunk)])


class FastBatchedHeteroGAT:
    """Batched masked forwards of a :class:`.gnn.HeteroGNN` whose convs are
    all :class:`.layers.GATConv` without self-loops (the reference hetero
    *test* model): node problems, on receptive-field plans.

    Per relation and layer, attention is a softmax over each destination's
    present in-edges.  On the query's ball the logits are a small ``[B,
    P_i, P_{i-1}, H]`` tensor; parallel edges share one logit, so their
    multiplicity enters as ``log A`` on it, and a mask enters only as the
    presence of both ends (no gathers, no segment operations).  Layer 0's
    input is the ball's features, shared by every mask (``[1, P_s, F]``);
    activations are batch-major ``[B, P, C]``, the layout the batched
    products take.  Edge and graph problems, and ``restrict=False``, get
    None from :meth:`query_outputs` (the adapter then runs the generic
    forward), as from the JAX engine.  ``device=None`` means the CUDA
    card; the graph must live there.  Raises ``TypeError`` for any other
    model.
    """

    def __init__(self, model_def: HeteroGNN, graph, restrict: bool = True, device=None):
        if not isinstance(model_def, HeteroGNN) or not all(
            isinstance(c, GATConv) for layer in model_def.conv_layers for c in layer.values()
        ):
            raise TypeError("the fast hetero GAT engine needs a HeteroGNN of GATConvs")
        if any(c.add_self_loops for layer in model_def.conv_layers for c in layer.values()):
            raise TypeError("the fast hetero GAT engine does not serve add_self_loops GATConvs")
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph is on {graph.device}, engine on {self.device}")
        self.model = model_def.to(self.device)
        self.graph = graph
        self.restrict = restrict
        self._plans: dict = {}
        self.scope = torch.from_numpy(_relation_scopes(model_def, graph)).to(self.device)  # [R, N]

    def query_plan(self, query: int) -> HeteroQueryPlan:
        """Receptive-field plan for node query ``query`` (cached): per layer
        and relation the edge multiplicities ``[R, P_i, P_{i-1}]`` inside
        the ball.  Data self-loops stay: they are real edges for GAT.
        ``a_deg`` is empty (no degrees here)."""
        q = int(query)
        if q in self._plans:
            return self._plans[q]
        g = self.graph
        et = host_view(g).edge_type[: g.num_edges]
        snd, rcv, vp, pos, p_s, p_sizes = _ball_geometry(g, q, self.model.num_hops)
        nrel = len(self.model.relations)
        a_layers = _ball_slices(et, pos[rcv], pos[snd], np.ones(len(rcv), bool), p_s, p_sizes, nrel)
        vp_t = torch.from_numpy(vp).to(self.device)
        plan = HeteroQueryPlan(
            vp=vp_t, a_deg=torch.zeros((nrel, 0, 0), device=self.device),
            a_layers=tuple(torch.from_numpy(a).to(self.device) for a in a_layers),
            p_sizes=p_sizes, scope_v=self.scope[:, vp_t],
        )
        self._plans[q] = plan
        return plan

    def _restricted_outputs(self, masks: torch.Tensor, plan: HeteroQueryPlan) -> torch.Tensor:
        """Node-masked forward on the query's ball only: ``[B]`` query
        predictions, the same as the full forward's."""
        live = masks[:, plan.vp] > 0  # [B, Ps]
        h = self.graph.x[plan.vp][None]  # [1, Ps, F]: layer 0's input, shared
        prev = plan.vp.shape[0]
        for li, layer in enumerate(self.model.conv_layers):
            ni = plan.p_sizes[li]
            out = None
            for ri, conv in enumerate(layer.values()):
                hc = (conv.heads, conv.out_features)
                xs = conv.lin_src(h[..., : conv.in_src]).unflatten(-1, hc)  # [b, prev, H, C]
                xd = conv.lin_dst(h[:, :ni, : conv.in_dst]).unflatten(-1, hc)  # [b, ni, H, C]
                a_src = (xs * conv.att_src).sum(-1)  # [b, prev, H]
                a_dst = (xd * conv.att_dst).sum(-1)  # [b, ni, H]
                z = torch.nn.functional.leaky_relu(
                    a_src[:, None, :, :] + a_dst[:, :, None, :], conv.negative_slope
                )  # [b, ni, prev, H]
                adj = plan.a_layers[li][ri]  # [ni, prev]
                z = z + torch.where(adj > 0, torch.log(torch.clamp(adj, min=1e-30)), 0.0)[..., None]
                pres = ((adj > 0)[None, :, :, None] & live[:, None, :prev, None]
                        & live[:, :ni, None, None])  # [B, ni, prev, 1]
                z = torch.where(pres, z, -math.inf)
                zmax = z.amax(2, keepdim=True)
                zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)
                e = torch.where(pres, torch.exp(z - zmax), 0.0)
                alpha = e / torch.clamp(e.sum(2, keepdim=True), min=1e-30)  # [B, ni, prev, H]
                # [B, H, ni, prev] @ [b, H, prev, C]: layer 0's b = 1 broadcasts
                msg = (alpha.permute(0, 3, 1, 2) @ xs.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
                contrib = msg.flatten(-2) if conv.concat else msg.mean(-2)
                if conv.bias is not None:
                    contrib = contrib + conv.bias * plan.scope_v[ri][None, :ni, None]
                out = contrib if out is None else out + contrib
            h = relu(out)
            prev = ni
        return self.model.head(h[:, 0, :])[:, 0]

    @torch.no_grad()
    def query_outputs(
        self,
        masks: torch.Tensor,
        query: Optional[int],
        problem: str = "node_prediction",
        chunk_size: int = 128,
    ) -> Optional[torch.Tensor]:
        """``[M]`` predictions of node ``query`` for bool node masks ``[M,
        N_pad]``, in chunks of ``chunk_size`` (the last may be shorter), or
        None for what the engine does not serve: edge and graph problems,
        a query that is not a concrete index, ``restrict=False``."""
        if ("edge" in problem or "graph" in problem or not self.restrict
                or not isinstance(query, (int, np.integer))):
            return None
        masks = torch.as_tensor(masks, device=self.device)
        plan = self.query_plan(int(query))
        return torch.cat([self._restricted_outputs(c, plan) for c in _chunks(masks, chunk_size)])
