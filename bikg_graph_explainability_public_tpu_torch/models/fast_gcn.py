"""Batched masked forwards of a GCN node model (the explainer hot loop).

Takes a :class:`.gnn.GCNNodeModel` and one padded graph, precomputes
everything batch-invariant (the first layer's transformed features, the
neighbour table, the dense adjacency or the query plans), and evaluates B
node-mask perturbations at once:

* **dense** tier (N_pad <= DENSE_THRESHOLD, the computational-subgraph
  case): a node-masked GCN layer is ``h_b = diag(s_b) A diag(s_b) XW +
  deg_b^-1 XW`` with ``s_b = m_b * rsqrt(deg_b)``: batched matmuls.  Node
  queries go through receptive-field plans that keep only the query's ball.
* **ELL** tier (larger graphs): layer 1 contracts per-sample slot
  coefficients with a batch-shared gather ``XW[nbr]``; layers >= 2 run the
  separable gather-sum (:func:`..ops.spmm.gather_sum_batched_separable`),
  which on the card is the hand-written CUDA kernel.

Node-mask problems only: edge problems and the fused dense layers of the
JAX package's ``backend="pallas"`` are later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph import host_view
from ..ops.ell import build_neighbor_table, ell_aggregate_shared, gcn_coeffs_from_node_mask
from ..ops.spmm import gather_sum_batched_separable
from ..runtime import native
from ..utils.device import resolve_device
from ..utils.padding import round_up_pow2
from .gnn import GCNNodeModel
from .layers import relu

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


def _chunks(masks: torch.Tensor, chunk: int):
    """Row chunks of ``chunk`` masks; the last may be shorter.  (The JAX
    engine runs the whole batch as one step when ``chunk`` does not divide
    it; rows are independent, so the outputs are the same.)"""
    return masks.split(max(int(chunk), 1))


class FastBatchedGCN:
    """Batched node-masked forward engine for one (model, graph) pair.

    ``device=None`` means the CUDA card; the graph must live on the same
    device.  ``mode`` forces the "dense" or "ell" tier (default: by size).
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
        if backend != "xla":
            raise NotImplementedError(
                f"backend={backend!r}: the fused dense GCN layers are not ported"
            )
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
        self.table = build_neighbor_table(graph) if mode == "ell" else None
        self.adj = _dense_adjacency(graph, self.device) if mode == "dense" else None
        self._plans: dict = {}  # query -> Optional[QueryPlan]

    # ------------------------------------------------------------------
    # dense-adjacency tier
    # ------------------------------------------------------------------
    def _dense_outputs(self, masks: torch.Tensor) -> torch.Tensor:
        a = self.adj  # [N, N], a[v, u] = multiplicity of edge u -> v
        m = masks.float()  # [B, N]
        deg = 1.0 + m * (m @ a.T)
        dis = torch.rsqrt(deg)  # [B, N]
        self_w = dis * dis  # [B, N] = 1/deg
        s = m * dis  # [B, N]

        def layer(feats_w):
            # feats_w: [N, C] (first layer, batch-shared) or [B, N, C]
            return s[:, :, None] * torch.matmul(a, s[:, :, None] * feats_w)

        def finish(h, conv):
            if conv.bias is not None:
                h = h + conv.bias
            return relu(h)

        convs = self.model.conv
        h = finish(layer(self.xw0) + self_w[:, :, None] * self.xw0, convs[0])
        for conv in convs[1:]:
            hw = h[..., : conv.in_features] @ conv.weight.T
            h = finish(layer(hw) + self_w[:, :, None] * hw, conv)
        return h

    @torch.no_grad()
    def batch_node_outputs(
        self, masks: torch.Tensor, is_edge: bool = False, g0: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Per-node backbone outputs for a chunk of node masks: [B, N, C_last].

        ``g0``: the batch-shared first-layer gather ``xw0[nbr]``; pass it in
        to compute it once for many chunks."""
        if is_edge:
            raise NotImplementedError("edge problems are not ported yet")
        if self.mode == "dense":
            return self._dense_outputs(masks)
        mf = masks.float()
        coeff, self_w = gcn_coeffs_from_node_mask(self.table, mf)  # [B,N,K], [B,N]
        convs = self.model.conv
        if g0 is None:
            g0 = self.xw0[self.table.nbr]
        h = ell_aggregate_shared(coeff, g0) + self_w[:, :, None] * self.xw0
        if convs[0].bias is not None:
            h = h + convs[0].bias
        h = relu(h)
        # node masks are separable: w[e] = a[snd]*a[rcv], a = mask * deg^-1/2
        a_bn = mf * torch.sqrt(self_w)  # [B, N]
        b, n = mf.shape
        for conv in convs[1:]:
            hw = h[..., : conv.in_features] @ conv.weight.T  # [B, N, F]
            f_dim = hw.shape[-1]
            # batch-contiguous layout: every slot reads one contiguous row
            hw_t = hw.transpose(0, 1).reshape(n, b * f_dim)
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

    def _plan_row_bytes(self, plan: QueryPlan, n_cols: int) -> int:
        """Estimated f32 bytes of restricted-forward intermediates PER mask
        row — sizes the auto-grown chunk (see ``query_outputs``)."""
        c1 = max(self.xw0.shape[1], max(c.weight.shape[0] for c in self.model.conv))
        ps = int(plan.vp.shape[0])
        width = ps * c1 + 3 * sum(p * c1 for p in plan.p_sizes)
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
        node masks [B, N_pad].

        ``auto_chunk=False`` pins the restricted path to ``chunk_size`` rows
        per step — callers that set an explicit ``forward_chunk`` keep their
        memory bound even if the byte estimate would permit growth."""
        if "edge" in problem:
            raise NotImplementedError("edge problems are not ported yet")
        is_graph = "graph" in problem
        if self.restrict and not is_graph and isinstance(query, (int, np.integer)):
            plan = self.query_plan(int(query))
            if plan is not None:
                m_total = masks.shape[0]
                # the restricted intermediates scale with the (small) ball,
                # so grow the chunk by doubling while the estimated per-chunk
                # footprint stays under budget, keeping equal chunks
                chunk_r = chunk_size
                if auto_chunk:
                    cap = max(
                        1, _RESTRICT_CHUNK_BYTES // self._plan_row_bytes(plan, masks.shape[1])
                    )
                    if m_total <= cap:
                        chunk_r = m_total
                    else:
                        while chunk_r * 2 <= cap and m_total % (chunk_r * 2) == 0:
                            chunk_r *= 2
                return torch.cat(
                    [self._restricted_outputs(c, plan) for c in _chunks(masks, chunk_r)]
                )
        nvalid = self.graph.node_mask.float()
        # the batch-shared gather, once for all chunks
        g0 = self.xw0[self.table.nbr] if self.mode == "ell" else None

        def run_chunk(mchunk):
            h = self.batch_node_outputs(mchunk, g0=g0)
            if is_graph:
                out = self.model.head(h)  # [b, N, out]
                return (out[..., 0] * nvalid).sum(-1) / torch.clamp(nvalid.sum(), min=1.0)
            return self.model.head(h[:, query, :])[:, 0]  # head on the query row only

        return torch.cat([run_chunk(c) for c in _chunks(masks, chunk_size)])
