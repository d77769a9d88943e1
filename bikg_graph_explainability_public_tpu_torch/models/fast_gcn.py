"""Batched masked forwards of a GCN node model (the explainer hot loop).

Takes a :class:`.gnn.GCNNodeModel` and one padded graph, precomputes
everything batch-invariant (the first layer's transformed features, the
neighbour table, the dense adjacency or the query plans), and evaluates B
node-mask or edge-mask perturbations at once:

* **dense** tier (N_pad <= DENSE_THRESHOLD, the computational-subgraph
  case): a node-masked GCN layer is ``h_b = diag(s_b) A diag(s_b) XW +
  deg_b^-1 XW`` with ``s_b = m_b * rsqrt(deg_b)``: batched matmuls, or with
  ``backend="pallas"`` the fused hand-written layers
  (:mod:`..ops.gcn_layer_cuda`, kernels 2.1 and 2.2).  Node and edge
  queries go through receptive-field plans that keep only the query's ball.
* **ELL** tier (larger graphs, and every unrestricted edge-mask forward):
  layer 1 contracts per-sample slot coefficients with a batch-shared gather
  ``XW[nbr]``; layers >= 2 run the separable gather-sum for node masks
  (kernel 2.3) and the weighted gather-sum for edge masks (kernel 2.4),
  through :mod:`..ops.spmm`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph import host_view
from ..ops.ell import (
    build_neighbor_table,
    ell_aggregate_shared,
    gcn_coeffs_from_edge_mask,
    gcn_coeffs_from_node_mask,
)
from ..ops.gcn_layer_cuda import masked_gcn_layer, masked_gcn_layer_batched
from ..ops.spmm import gather_sum_batched_separable, weighted_gather_sum_batched
from ..runtime import native
from ..utils.device import resolve_device
from ..utils.padding import round_up_pow2
from .gnn import GCNNodeModel
from .layers import refuse_row_sharded, relu

#: below this padded node count, use the dense-adjacency formulation
DENSE_THRESHOLD = 4096

#: skip the receptive-field plan when the degree-rows matrix would exceed
#: this many entries (Ps x N_pad) — fall back to the unrestricted path
_PLAN_DEG_ENTRY_CAP = 1 << 25

#: per-chunk intermediate budget for auto-grown restricted chunks
_RESTRICT_CHUNK_BYTES = 256 * 1024 * 1024


def _dense_adjacency(graph, device) -> torch.Tensor:
    """Dense [N_pad, N_pad] adjacency (receiver-major, data self-loops
    excluded, duplicate edges counted) built host-side."""
    n = graph.n_pad
    hv = host_view(graph)
    snd = hv.senders[: graph.num_edges]
    rcv = hv.receivers[: graph.num_edges]
    keep = snd != rcv
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (rcv[keep], snd[keep]), 1.0)
    return torch.from_numpy(a).to(device)


def dense_mask_scales(adj: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The node-mask scales of the dense GCN layer, over any leading batch
    axes: node-major float masks ``m [..., n, B]`` over adjacencies ``adj
    [..., n, n]`` (``adj[v, u]`` counts the non-loop edges u -> v).
    Returns ``(s, self_w)``, both ``[..., n, B]``: ``s = m * deg^-1/2`` and
    ``self_w = 1 / deg`` with ``deg = 1 + m * (A @ m)``."""
    # node-major in memory too: the scales' layout is what every layer's
    # activations inherit, and A @ [n, B*C] needs them contiguous
    m = m.contiguous()
    deg = 1.0 + m * (adj @ m)
    dis = torch.rsqrt(deg)
    return m * dis, dis * dis


def dense_gcn_layers(adj, s, self_w, xw0, convs) -> torch.Tensor:
    """The mask-scaled dense GCN layers over any leading batch axes: each
    conv is ``relu(s * (A @ (s * XW)) + self_w * XW + b)``.

    ``adj [..., n, n]``; ``s`` and ``self_w [..., n, B]`` from
    :func:`dense_mask_scales`; ``xw0 [..., n, C]``, the first conv's
    transformed features, shared by every mask.  Activations are node-major
    ``[..., n, B, C]``, so each aggregation is one product ``A @ [n, B*C]``;
    returns the last layer's.
    """
    s, self_w = s[..., None], self_w[..., None]
    h = None
    for li, conv in enumerate(convs):
        hw = xw0[..., None, :] if li == 0 else h[..., : conv.in_features] @ conv.weight.T
        # one name for the activation-sized results, so each dies as soon
        # as the next is made (the in-place adds round as the plain ones)
        h = s * hw
        h = s * (adj @ h.flatten(-2)).view(h.shape)
        h += self_w * hw
        if conv.bias is not None:
            h += conv.bias
        h = relu(h)
    return h


class QueryPlan(NamedTuple):
    """Receptive-field restriction for one query node.

    A GCN output at the query depends only on nodes within L hops (L = conv
    layers): conv layer ``i`` (0-based) needs rows at in-distance <= L-1-i,
    the normalised mask scale ``s`` is read at distance <= L, and degrees at
    distance <= L read raw mask bits of distance <= L+1.  Everything is
    ordered by BFS in-distance with the query at row 0, so each layer's
    support is a prefix.

    vp:       [Ps] node ids, distance-ordered (query first)
    a_deg:    [Ps, N_pad] adjacency rows at vp (multiplicity, no self-loops)
    a_layers: per conv layer i: [P_0, Ps] (i=0) / [P_i, P_{i-1}] (i>0)
    p_sizes:  (P_0, ..., P_{L-1}) padded prefix lengths
    """

    vp: torch.Tensor
    a_deg: torch.Tensor
    a_layers: Tuple[torch.Tensor, ...]
    p_sizes: Tuple[int, ...]


def _ball_geometry(graph, query: int, num_layers: int):
    """BFS geometry shared by the plan builders: in-distance from the query,
    distance-ordered padded support ``vp`` (query first), position map, and
    per-layer padded prefix sizes."""
    n = graph.n_pad
    hv = host_view(graph)
    snd = hv.senders[: graph.num_edges]
    rcv = hv.receivers[: graph.num_edges]
    row_ptr, col, _eid = hv.csr()
    dist = native.bfs_levels_csr(n, row_ptr, col, query, num_layers)
    p_s = min(round_up_pow2(int((dist <= num_layers).sum())), n)
    order = np.argsort(dist, kind="stable").astype(np.int64)
    vp = order[:p_s]
    pos = np.full(n, -1, np.int64)
    pos[vp] = np.arange(p_s)
    p_sizes = []
    prev = p_s
    for i in range(num_layers):
        k = int((dist <= num_layers - 1 - i).sum())
        p = min(round_up_pow2(k), prev, n)
        p_sizes.append(p)
        prev = p
    return snd, rcv, vp, pos, p_s, tuple(p_sizes)


def _build_query_plan(graph, query: int, num_layers: int, device) -> Optional[QueryPlan]:
    """Host-side BFS + adjacency slicing, uploaded once."""
    n = graph.n_pad
    snd, rcv, vp, pos, p_s, p_sizes = _ball_geometry(graph, query, num_layers)
    if p_s * n > _PLAN_DEG_ENTRY_CAP:
        return None
    # multi-edge multiplicity kept, self-loops dropped (as _dense_adjacency)
    keep = snd != rcv
    s_k, r_k = snd[keep], rcv[keep]
    rcv_pos = pos[r_k]  # position of receiver in vp, -1 if outside
    in_vp = rcv_pos >= 0
    a_deg = np.zeros((p_s, n), np.float32)
    np.add.at(a_deg, (rcv_pos[in_vp], s_k[in_vp]), 1.0)
    a_layers = []
    snd_pos = pos[s_k]
    prev = p_s
    for p in p_sizes:
        sel = (rcv_pos >= 0) & (rcv_pos < p) & (snd_pos >= 0) & (snd_pos < prev)
        a_i = np.zeros((p, prev), np.float32)
        np.add.at(a_i, (rcv_pos[sel], snd_pos[sel]), 1.0)
        a_layers.append(torch.from_numpy(a_i).to(device))
        prev = p
    return QueryPlan(
        vp=torch.from_numpy(vp).to(device),
        a_deg=torch.from_numpy(a_deg).to(device),
        a_layers=tuple(a_layers),
        p_sizes=p_sizes,
    )


class EdgeQueryPlan(NamedTuple):
    """Receptive-field restriction for edge-masked forwards.

    Same BFS geometry as :class:`QueryPlan`, but the per-sample adjacency is
    rebuilt from the edge mask as a one-hot contraction over the (few) edges
    inside the ball: gathered mask bits [B, E_i] @ one-hot placement matrix
    [E_i, P_i * P_{i-1}] -> the layer's per-sample adjacency; degree rows
    likewise.  Edge lists are padded to multiples of 16 with zero rows.
    """

    vp: torch.Tensor
    p_sizes: Tuple[int, ...]
    deg_eid: torch.Tensor
    deg_onehot: torch.Tensor
    layer_eid: Tuple[torch.Tensor, ...]
    layer_onehot: Tuple[torch.Tensor, ...]


def _pad16(*arrays):
    """Pad 1-D arrays to a multiple of 16 (at least 16) with zeros; the last
    array returned marks the real entries with 1.0."""
    n = arrays[0].shape[0]
    p = max(16, -(-n // 16) * 16)
    val = np.zeros(p, np.float32)
    val[:n] = 1.0
    out = []
    for a in arrays:
        b = np.zeros(p, a.dtype)
        b[:n] = a
        out.append(b)
    return out + [val]


def _build_edge_query_plan(graph, query: int, num_layers: int, device) -> EdgeQueryPlan:
    """Host-side BFS and one-hot placement matrices, uploaded once."""
    snd, rcv, vp, pos, p_s, p_sizes = _ball_geometry(graph, query, num_layers)
    eids = np.arange(graph.num_edges, dtype=np.int64)
    keep = snd != rcv
    s_k, r_k, e_k = snd[keep], rcv[keep], eids[keep]
    rcv_pos, snd_pos = pos[r_k], pos[s_k]

    def onehot(sel_rows, sel_cols, sel_eid, rows, cols):
        rp, cp, ei, val = _pad16(
            sel_rows.astype(np.int64), sel_cols.astype(np.int64), sel_eid
        )
        oh = np.zeros((rp.shape[0], rows * cols), np.float32)
        oh[np.arange(rp.shape[0]), rp * cols + cp] = val
        return torch.from_numpy(ei).to(device), torch.from_numpy(oh).to(device)

    in_deg = rcv_pos >= 0
    deg_eid, deg_onehot = onehot(
        rcv_pos[in_deg], np.zeros(int(in_deg.sum()), np.int64), e_k[in_deg], p_s, 1
    )
    layer_eid, layer_onehot = [], []
    prev = p_s
    for p in p_sizes:
        sel = (rcv_pos >= 0) & (rcv_pos < p) & (snd_pos >= 0) & (snd_pos < prev)
        ei, oh = onehot(rcv_pos[sel], snd_pos[sel], e_k[sel], p, prev)
        layer_eid.append(ei)
        layer_onehot.append(oh)
        prev = p
    return EdgeQueryPlan(
        vp=torch.from_numpy(vp).to(device),
        p_sizes=p_sizes,
        deg_eid=deg_eid,
        deg_onehot=deg_onehot,
        layer_eid=tuple(layer_eid),
        layer_onehot=tuple(layer_onehot),
    )


def _chunks(masks: torch.Tensor, chunk: int):
    """Row chunks of ``chunk`` masks; the last may be shorter.  (The JAX
    engine runs the whole batch as one step when ``chunk`` does not divide
    it; rows are independent, so the outputs are the same.)"""
    return masks.split(max(int(chunk), 1))


class FastBatchedGCN:
    """Batched masked forward engine for one (model, graph) pair.

    ``device=None`` means the CUDA card; the graph must live on the same
    device.  ``mode`` forces the "dense" or "ell" tier (default: by size).
    ``backend`` picks the dense tier's unrestricted node-mask layers, with
    the JAX package's names: ``"xla"`` runs them as unfused torch ops,
    ``"pallas"`` as the fused hand-written CUDA layers (kernels 2.1 and
    2.2; their plain versions on the CPU).  It changes nothing else.
    """

    def __init__(
        self,
        model_def: GCNNodeModel,
        graph,
        mode: Optional[str] = None,
        backend: str = "xla",
        restrict: bool = True,
        device=None,
    ):
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {backend!r}; 'xla' or 'pallas'")
        refuse_row_sharded(model_def, "FastBatchedGCN")
        self.backend = backend
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph is on {graph.device}, engine on {self.device}")
        self.restrict = restrict
        self.model = model_def.to(self.device)
        self.graph = graph
        if mode is None:
            mode = "dense" if graph.n_pad <= DENSE_THRESHOLD else "ell"
        if mode not in ("dense", "ell"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        # host-side precompute of the first layer's transformed features
        conv0 = self.model.conv[0]
        w0 = conv0.weight.detach().cpu().numpy()
        x_np = host_view(graph).x[:, : conv0.in_features]
        self.xw0 = torch.from_numpy(x_np @ w0.T).to(self.device)  # [N, C1]
        # both tiers: edge-mask forwards of dense-mode engines use it too
        self.table = build_neighbor_table(graph)
        self.adj = _dense_adjacency(graph, self.device) if mode == "dense" else None
        self._adj16: Optional[torch.Tensor] = None  # bf16 copy, built once
        self._plans: dict = {}  # query -> Optional[QueryPlan]
        self._edge_plans: dict = {}  # query -> EdgeQueryPlan

    def _coeffs(self, masks: torch.Tensor, is_edge: bool):
        fn = gcn_coeffs_from_edge_mask if is_edge else gcn_coeffs_from_node_mask
        return fn(self.table, masks.float())

    # ------------------------------------------------------------------
    # dense-adjacency tier
    # ------------------------------------------------------------------
    def _dense_outputs(self, masks: torch.Tensor) -> torch.Tensor:
        s, self_w = dense_mask_scales(self.adj, masks.float().t())  # [N, B]
        if self.backend == "pallas":
            return self._dense_outputs_pallas(s.t().contiguous(), self_w.t().contiguous())
        h = dense_gcn_layers(self.adj, s, self_w, self.xw0, self.model.conv)
        return h.transpose(0, 1)  # [B, N, C]

    def _dense_outputs_pallas(self, s: torch.Tensor, self_w: torch.Tensor) -> torch.Tensor:
        """The fused layers: one kernel 2.1 call for the first conv layer,
        one kernel 2.2 call for each later one."""
        if self._adj16 is None:
            self._adj16 = self.adj.to(torch.bfloat16)
        convs = self.model.conv
        h = masked_gcn_layer(
            self._adj16, self.xw0, s, self_w, convs[0].bias, apply_relu=True
        )
        for conv in convs[1:]:
            h = masked_gcn_layer_batched(
                self._adj16,
                h[..., : conv.in_features].contiguous(),
                conv.weight.t().contiguous(),
                s,
                self_w,
                conv.bias,
                apply_relu=True,
            )
        return h

    @torch.no_grad()
    def batch_node_outputs(
        self, masks: torch.Tensor, is_edge: bool = False, g0: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Per-node backbone outputs for a chunk of masks: [B, N, C_last].
        Node masks are [B, N_pad]; edge masks (``is_edge``) are [B, E_pad]
        and run on the table in both tiers.

        ``g0``: the batch-shared first-layer gather ``xw0[nbr]``; pass it in
        to compute it once for many chunks."""
        if self.mode == "dense" and not is_edge:
            return self._dense_outputs(masks)
        mf = masks.float()
        coeff, self_w = self._coeffs(mf, is_edge)  # [B,N,K], [B,N]
        convs = self.model.conv
        if g0 is None:
            g0 = self.xw0[self.table.nbr]
        h = ell_aggregate_shared(coeff, g0) + self_w[:, :, None] * self.xw0
        if convs[0].bias is not None:
            h = h + convs[0].bias
        h = relu(h)
        b, n = self_w.shape
        if is_edge and len(convs) > 1:
            # edge masks are not separable: the slot coefficients of layer 1,
            # sample-major [B,N,K] as made, are the weights of every later layer
            w_sample = coeff.contiguous()
        elif not is_edge:
            # node masks are: w[e] = a[snd]*a[rcv], a = mask * deg^-1/2
            a_bn = mf * torch.sqrt(self_w)  # [B, N]
        for conv in convs[1:]:
            hw = h[..., : conv.in_features] @ conv.weight.T  # [B, N, F]
            f_dim = hw.shape[-1]
            # batch-contiguous layout: every slot reads one contiguous row
            hw_t = hw.transpose(0, 1).reshape(n, b * f_dim)
            if is_edge:
                out_t = weighted_gather_sum_batched(None, hw_t, b, table=self.table, w_sample=w_sample)
            else:
                out_t = gather_sum_batched_separable(a_bn, hw_t, b, table=self.table)
            h = out_t.view(n, b, f_dim).transpose(0, 1) + self_w[:, :, None] * hw
            if conv.bias is not None:
                h = h + conv.bias
            h = relu(h)
        return h

    def query_plan(self, query: int) -> Optional[QueryPlan]:
        """Receptive-field plan for ``query`` (cached; None if infeasible)."""
        q = int(query)
        if q not in self._plans:
            self._plans[q] = _build_query_plan(
                self.graph, q, len(self.model.conv), self.device
            )
        return self._plans[q]

    def _restricted_outputs(self, masks: torch.Tensor, plan: QueryPlan) -> torch.Tensor:
        """Node-masked forward on the query's receptive field only: [B] query
        predictions.  Mathematically identical to the full forward at a
        fraction of the work: [B,N,C] layers shrink to [B,P,C]."""
        m = masks.float()  # [B, N_pad]
        mv = m[:, plan.vp]  # [B, Ps]
        deg = 1.0 + mv * (m @ plan.a_deg.T)
        dis = torch.rsqrt(deg)
        self_w = dis * dis
        s = mv * dis  # [B, Ps]
        convs = self.model.conv
        xw0_v = self.xw0[plan.vp]  # [Ps, C1]
        n0 = plan.p_sizes[0]
        agg = (plan.a_layers[0][None] * s[:, None, :]) @ xw0_v  # [B, P0, C1]
        h = s[:, :n0, None] * agg + self_w[:, :n0, None] * xw0_v[:n0]
        if convs[0].bias is not None:
            h = h + convs[0].bias
        h = relu(h)
        prev = n0
        for i, conv in enumerate(convs[1:], start=1):
            hw = h[..., : conv.in_features] @ conv.weight.T  # [B, prev, C]
            ni = plan.p_sizes[i]
            agg = torch.matmul(plan.a_layers[i], s[:, :prev, None] * hw)
            h = s[:, :ni, None] * agg + self_w[:, :ni, None] * hw[:, :ni]
            if conv.bias is not None:
                h = h + conv.bias
            h = relu(h)
            prev = ni
        # the query sits at row 0 of every prefix
        return self.model.head(h[:, 0, :])[:, 0]

    def edge_query_plan(self, query: int) -> EdgeQueryPlan:
        """Receptive-field plan for edge-masked forwards (cached)."""
        q = int(query)
        if q not in self._edge_plans:
            self._edge_plans[q] = _build_edge_query_plan(
                self.graph, q, len(self.model.conv), self.device
            )
        return self._edge_plans[q]

    def _restricted_edge_outputs(self, masks: torch.Tensor, plan: EdgeQueryPlan) -> torch.Tensor:
        """Edge-masked forward restricted to the query's receptive field: [B]
        query predictions.  The per-sample adjacency of each layer is
        rebuilt from the edge mask by a one-hot contraction (masked edges
        dropped, unit self-loops always on)."""
        m = masks.float()  # [B, E_pad]
        b = m.shape[0]
        deg = 1.0 + m[:, plan.deg_eid] @ plan.deg_onehot  # [B, Ps]
        dis = torch.rsqrt(deg)
        self_w = dis * dis
        xw0_v = self.xw0[plan.vp]
        convs = self.model.conv

        def layer_adj(i, prev, ni):
            a = (m[:, plan.layer_eid[i]] @ plan.layer_onehot[i]).view(b, ni, prev)
            return a * dis[:, :ni, None] * dis[:, None, :prev]

        n0 = plan.p_sizes[0]
        agg = layer_adj(0, plan.vp.shape[0], n0) @ xw0_v  # [B, P0, C1]
        h = agg + self_w[:, :n0, None] * xw0_v[:n0]
        if convs[0].bias is not None:
            h = h + convs[0].bias
        h = relu(h)
        prev = n0
        for i, conv in enumerate(convs[1:], start=1):
            hw = h[..., : conv.in_features] @ conv.weight.T
            ni = plan.p_sizes[i]
            h = torch.matmul(layer_adj(i, prev, ni), hw) + self_w[:, :ni, None] * hw[:, :ni]
            if conv.bias is not None:
                h = h + conv.bias
            h = relu(h)
            prev = ni
        return self.model.head(h[:, 0, :])[:, 0]

    def _plan_row_bytes(self, plan, n_cols: int, is_edge: bool) -> int:
        """Estimated f32 bytes of restricted-forward intermediates PER mask
        row — sizes the auto-grown chunk (see ``query_outputs``)."""
        c1 = max(self.xw0.shape[1], max(c.weight.shape[0] for c in self.model.conv))
        sizes = list(plan.p_sizes)
        ps = int(plan.vp.shape[0])
        if is_edge:
            prevs = [ps] + sizes[:-1]
            width = (
                sum(p * pv for p, pv in zip(sizes, prevs))
                + 2 * sum(p * c1 for p in sizes)
                + int(plan.deg_onehot.shape[0])
            )
        else:
            width = ps * c1 + 3 * sum(p * c1 for p in sizes)
        return 4 * (n_cols + width)

    @torch.no_grad()
    def query_outputs(
        self,
        masks: torch.Tensor,
        query: Optional[int],
        problem: str = "node_prediction",
        chunk_size: int = 128,
        auto_chunk: bool = True,
    ) -> torch.Tensor:
        """[B] query predictions (or pooled graph predictions) for bool
        masks [B, N_pad] (node and graph problems) or [B, E_pad] (edge
        problems, whose query is the query edge's receiver node).

        ``auto_chunk=False`` pins the restricted path to ``chunk_size`` rows
        per step — callers that set an explicit ``forward_chunk`` keep their
        memory bound even if the byte estimate would permit growth."""
        is_edge = "edge" in problem
        is_graph = "graph" in problem
        if self.restrict and not is_graph and isinstance(query, (int, np.integer)):
            if is_edge:
                plan, step = self.edge_query_plan(int(query)), self._restricted_edge_outputs
            else:
                plan, step = self.query_plan(int(query)), self._restricted_outputs
            if plan is not None:
                m_total = masks.shape[0]
                # the restricted intermediates scale with the (small) ball,
                # so grow the chunk by doubling while the estimated per-chunk
                # footprint stays under budget, keeping equal chunks
                chunk_r = chunk_size
                if auto_chunk:
                    cap = max(
                        1,
                        _RESTRICT_CHUNK_BYTES
                        // self._plan_row_bytes(plan, masks.shape[1], is_edge),
                    )
                    if m_total <= cap:
                        chunk_r = m_total
                    else:
                        while chunk_r * 2 <= cap and m_total % (chunk_r * 2) == 0:
                            chunk_r *= 2
                return torch.cat([step(c, plan) for c in _chunks(masks, chunk_r)])
        nvalid = self.graph.node_mask.float()
        # the batch-shared gather, once for all chunks
        g0 = self.xw0[self.table.nbr] if self.mode == "ell" else None

        def run_chunk(mchunk):
            h = self.batch_node_outputs(mchunk, is_edge, g0=g0)
            if is_graph:
                out = self.model.head(h)  # [b, N, out]
                return (out[..., 0] * nvalid).sum(-1) / torch.clamp(nvalid.sum(), min=1.0)
            return self.model.head(h[:, query, :])[:, 0]  # head on the query row only

        return torch.cat([run_chunk(c) for c in _chunks(masks, chunk_size)])
