"""Halo-exchange partitioning: sharded node features, O(boundary) comms.

:mod:`.edge_partition` shards edges but replicates node features, combining
partial aggregates with an ``O(N)`` ``all_reduce``.  Here nodes are
range-partitioned (rank r owns rows ``[r * n_local, (r + 1) * n_local)``),
edges live with their *receiver's* owner (so every aggregation output is
rank-local), and the only communication per layer is an ``all_to_all`` of
exactly the **boundary rows** each rank's edge block reads from remote
owners.

The partition is planned on the host once per (graph, rank count), the same
on every rank (:func:`..runtime.native.build_halo_plan`), and reused for
every layer and perturbation batch.  Node arrays going in and node results
coming out are this rank's block; the masked outputs are the full ``[B]``
on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import refuse_row_sharded
from ..runtime import native
from ..utils.padding import round_up


@dataclasses.dataclass(frozen=True)
class LocalHalo:
    """One rank's rows of a :class:`HaloPartition`, on its device.

    send_idx:   [D, halo] — local rows to ship to each peer (0-padded)
    edge_slot:  [E_loc] — per edge, its row of the lookup buffer
                ``cat([own rows (n_local), received rows (D * halo)])``
    edge_rcv:   [E_loc] — receiver row, local to the rank
    edge_id:    [E_loc] — global edge id, for per-edge weight gathers
    edge_valid: [E_loc] float32 — 1 for real edges, 0 for padding
    is_self:    [E_loc] bool — data self-loops (replaced by the unit loop)
    """

    send_idx: torch.Tensor
    edge_slot: torch.Tensor
    edge_rcv: torch.Tensor
    edge_id: torch.Tensor
    edge_valid: torch.Tensor
    is_self: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Static halo-exchange plan for one (graph, n_devices) pair, host
    numpy, the same on every rank.

    Node u is owned by rank ``u // n_local``; edge e by the owner of its
    receiver.  Per-rank arrays are stacked on a leading rank axis.

    n_local:    nodes per rank (global padded node count = D * n_local)
    halo:       boundary rows per (owner, requester) pair (padded)
    send_idx:   [D, D, halo] int32 — rank o's local rows to ship to rank d
                (``send_idx[o, d]``); 0-padded
    edge_slot:  [D, E_loc] int32 — per edge, index into the rank-local
                ``cat([own rows (n_local), received halo rows (D*halo)])``
    edge_rcv:   [D, E_loc] int32 — receiver row id local to the rank
    edge_id:    [D, E_loc] int32 — original (global) edge id
    edge_valid: [D, E_loc] float32 — 1 for real edges, 0 for padding
    """

    n_local: int
    halo: int
    send_idx: np.ndarray
    edge_slot: np.ndarray
    edge_rcv: np.ndarray
    edge_id: np.ndarray
    edge_valid: np.ndarray
    _local: Dict[tuple, LocalHalo] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def n_devices(self) -> int:
        """Number of shards."""
        return self.send_idx.shape[0]

    @property
    def n_total(self) -> int:
        """Global padded node count."""
        return self.n_devices * self.n_local

    def local(self, rank: int, device) -> LocalHalo:
        """Rank ``rank``'s rows on ``device`` (uploaded once, then cached)."""
        key = (rank, str(device))
        if key not in self._local:
            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a[rank])).to(device)

            slot, rcv = up(self.edge_slot).long(), up(self.edge_rcv).long()
            self._local[key] = LocalHalo(
                send_idx=up(self.send_idx).long(), edge_slot=slot, edge_rcv=rcv,
                edge_id=up(self.edge_id).long(), edge_valid=up(self.edge_valid),
                is_self=(slot == rcv) & (slot < self.n_local),
            )
        return self._local[key]


def build_halo_partition(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int, n_devices: int
) -> HaloPartition:
    """Host-side partitioner (:func:`..runtime.native.build_halo_plan`)."""
    n_local = round_up(max((num_nodes + n_devices - 1) // n_devices, 1), 8)
    halo, _e_loc, send_idx, edge_slot, edge_rcv, edge_id, edge_valid = native.build_halo_plan(
        n_devices * n_local, senders, receivers, n_local, n_devices
    )
    return HaloPartition(n_local, halo, send_idx, edge_slot, edge_rcv, edge_id, edge_valid)


def pad_nodes(x, part: HaloPartition) -> torch.Tensor:
    """Zero-pad a [N, ...] node array to the partition's global row count
    (rank r's block is then rows ``[r * n_local, (r + 1) * n_local)``)."""
    x = torch.as_tensor(x)
    if x.shape[0] == part.n_total:
        return x
    pad = x.new_zeros((part.n_total - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


def _exchange(h_loc: torch.Tensor, send_idx: torch.Tensor, group) -> torch.Tensor:
    """Ship this rank's boundary rows to every peer; return the rank's
    lookup buffer ``[n_local + D*halo, F]`` (JAX's ``all_to_all`` with
    ``split_axis=0, concat_axis=0``: chunk d goes to rank d, and the rows
    from rank o land in block o)."""
    send = h_loc[send_idx.reshape(-1)].contiguous()  # [D*halo, F]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat([h_loc, recv])


def _axis(mesh, axis: str):
    """(group, this rank's coordinate) of mesh axis ``axis``."""
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def _segment_sum(msg: torch.Tensor, rcv: torch.Tensor, n: int) -> torch.Tensor:
    return msg.new_zeros((n,) + tuple(msg.shape[1:])).index_add_(0, rcv, msg)


def halo_gather_sum(
    edge_weight: torch.Tensor,
    feats: torch.Tensor,
    part: HaloPartition,
    mesh,
    axis: str = "data",
) -> torch.Tensor:
    """out[v] = sum_e w_e * feats[senders_e] over the halo partition.

    ``feats`` is this rank's block ``[n_local, F]`` and so is the result;
    ``edge_weight`` [E] is replicated (gathered per block by edge id).
    """
    group, me = _axis(mesh, axis)
    loc = part.local(me, feats.device)
    buf = _exchange(feats, loc.send_idx, group)
    w = edge_weight[loc.edge_id] * loc.edge_valid
    return _segment_sum(w[:, None] * buf[loc.edge_slot], loc.edge_rcv, part.n_local)


def _edge_weights(masks, loc: LocalHalo, is_edge: bool, group) -> torch.Tensor:
    """Per local edge and mask ``[E_loc, B]``, data self-loops zeroed:
    an edge mask's own column (``masks`` [B, E], replicated), or the
    product of its endpoints' node masks (``masks`` [B, n_local], this
    rank's columns; the boundary rows arrive by one exchange)."""
    if is_edge:
        w = loc.edge_valid[:, None] * masks.to(torch.float32).T[loc.edge_id]
    else:
        mt = masks.to(torch.float32).T.contiguous()  # [n_local, B]
        m_buf = _exchange(mt, loc.send_idx, group)
        w = loc.edge_valid[:, None] * m_buf[loc.edge_slot] * mt[loc.edge_rcv]
    return torch.where(loc.is_self[:, None], torch.zeros_like(w), w)


def _readout(model_def, h, me: int, n_local: int, is_graph: bool, query, nn: int, group):
    """The replicated ``[B]`` result: a graph problem pools the head over
    the real rows, a node problem keeps the query owner's head output."""
    if is_graph:
        out_nodes = model_def.head(h)[..., 0]  # [n_local, B]
        row_ok = (me * n_local + torch.arange(n_local, device=h.device)) < nn
        pooled = (out_nodes * row_ok[:, None].to(out_nodes.dtype)).sum(0)
        dist.all_reduce(pooled, group=group)
        return pooled / float(nn)
    q_dev, q_loc = divmod(int(query), n_local)
    out = model_def.head(h[q_loc])[:, 0]
    # only the owner's output counts; zero the rest BEFORE the sum, since
    # head(0) != 0 (biases)
    if me != q_dev:
        out = torch.zeros_like(out)
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def halo_masked_outputs(
    model,
    x: torch.Tensor,
    masks: torch.Tensor,
    part: HaloPartition,
    mesh,
    problem: str = "node_prediction",
    query: Optional[int] = None,
    axis: str = "data",
    num_nodes: Optional[int] = None,
) -> torch.Tensor:
    """Batched perturbed outputs of a :class:`..models.gnn.GCNNodeModel`
    (``model``, a :class:`..models.adapter.Model`) over the halo partition:
    B perturbations of a graph whose features, edges and activations are
    sharded.  Activations stay node-major ``[n_local, B, C]``, so each
    exchange ships whole boundary rows for the entire batch; node masks
    are exchanged once and reused by every layer.

    ``x``: this rank's feature block ``[n_local, F]``.  Problems:
      * node_prediction:  ``masks`` [B, n_local], this rank's columns;
        returns the query node's prediction per perturbation.
      * edge_prediction:  ``masks`` [B, E] (global edge ids, replicated);
        each edge block gathers its own weights by ``edge_id``.
      * graph_prediction: ``masks`` as for nodes; returns the mean-pooled
        prediction over the first ``num_nodes`` rows (a local pool + one
        ``all_reduce``).
    The result, ``[B]``, is the same on every rank.
    """
    mdef = model.model_def
    refuse_row_sharded(mdef, "halo_masked_outputs")
    group, me = _axis(mesh, axis)
    n_local = part.n_local
    loc = part.local(me, x.device)
    slot, rcv = loc.edge_slot, loc.edge_rcv
    nn = part.n_total if num_nodes is None else int(num_nodes)

    w_e = _edge_weights(masks, loc, "edge" in problem, group)  # [E_loc, B]
    b = w_e.shape[1]
    dis = torch.rsqrt(1.0 + _segment_sum(w_e, rcv, n_local))  # [n_local, B]
    dis_buf = _exchange(dis, loc.send_idx, group)
    norm_e = (w_e * dis_buf[slot] * dis[rcv])[:, :, None]  # [E_loc, B, 1]
    self_w = (dis * dis)[:, :, None]

    h = None  # [n_local, B, C] after the first layer
    for conv in mdef.conv:
        if h is None:
            hw = x[:, : conv.in_features] @ conv.weight.T  # [n_local, C], batch-shared
            c = hw.shape[-1]
            msg = _exchange(hw, loc.send_idx, group)[slot][:, None, :] * norm_e
            self_term = self_w * hw[:, None, :]
        else:
            hw = h[..., : conv.in_features] @ conv.weight.T  # [n_local, B, C]
            c = hw.shape[-1]
            buf = _exchange(hw.reshape(n_local, b * c), loc.send_idx, group)
            msg = buf[slot].reshape(-1, b, c) * norm_e
            self_term = self_w * hw
        h = _segment_sum(msg.reshape(-1, b * c), rcv, n_local).reshape(n_local, b, c) + self_term
        if conv.bias is not None:
            h = h + conv.bias
        h = torch.relu(h)
    return _readout(mdef, h, me, n_local, "graph" in problem, query, nn, group)


@torch.no_grad()
def halo_masked_outputs_hetero(
    model,
    x: torch.Tensor,
    masks: torch.Tensor,
    part: HaloPartition,
    mesh,
    etype_loc: torch.Tensor,  # [E_loc] — edge type per local edge slot
    scope_loc: torch.Tensor,  # [R, n_local] f32 — dst-type scope per relation
    problem: str = "node_prediction",
    query: Optional[int] = None,
    axis: str = "data",
    num_nodes: Optional[int] = None,
) -> torch.Tensor:
    """Batched perturbed outputs of a :class:`..models.gnn.HeteroGNN` of
    default GCNConvs over the halo partition (arguments as
    :func:`halo_masked_outputs`; ``etype_loc`` and ``scope_loc`` are this
    rank's rows).

    Each relation carries its own masked degree, with the self-loop and the
    bias scoped to its destination node type (PyG ``HeteroConv``,
    ``aggr='sum'``).  One exchange a layer: the halo buffer ships the
    untransformed activations and each rank applies every relation's
    weight to its own and halo rows; the R normalisation vectors share one
    exchange too.
    """
    mdef = model.model_def
    refuse_row_sharded(mdef, "halo_masked_outputs_hetero")
    group, me = _axis(mesh, axis)
    n_local = part.n_local
    loc = part.local(me, x.device)
    slot, rcv = loc.edge_slot, loc.edge_rcv
    nn = part.n_total if num_nodes is None else int(num_nodes)
    nrel = len(mdef.relations)

    w_base = _edge_weights(masks, loc, "edge" in problem, group)  # [E_loc, B]
    b = w_base.shape[1]
    rel_sel = torch.stack([(etype_loc == ri) for ri in range(nrel)]).to(w_base.dtype)
    w_rel = rel_sel[:, :, None] * w_base[None]  # [R, E_loc, B]
    deg = scope_loc[:, :, None] + torch.stack(
        [_segment_sum(w, rcv, n_local) for w in w_rel]
    )  # [R, n_local, B]
    dis = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)), torch.zeros_like(deg))
    dis_flat = dis.permute(1, 0, 2).reshape(n_local, nrel * b)
    dis_buf = _exchange(dis_flat, loc.send_idx, group).reshape(-1, nrel, b)
    norm_e = w_rel * dis_buf[slot].permute(1, 0, 2) * dis[:, rcv]  # [R, E_loc, B]
    self_w = scope_loc[:, :, None] * dis * dis  # [R, n_local, B]

    h = None  # [n_local, B, C]
    for layer in mdef.conv_layers:
        c_in = next(iter(layer.values())).in_features
        if h is None:
            buf = _exchange(x[:, :c_in].contiguous(), loc.send_idx, group)  # [rows, c_in]
        else:
            c_prev = h.shape[-1]
            buf = _exchange(h.reshape(n_local, b * c_prev), loc.send_idx, group)
            buf = buf.reshape(-1, b, c_prev)[..., :c_in]
        out = None
        for ri, conv in enumerate(layer.values()):
            hw = buf @ conv.weight.T  # [rows, C] (layer 1) or [rows, B, C]
            c = hw.shape[-1]
            if h is None:
                msg = hw[slot][:, None, :] * norm_e[ri][:, :, None]
                self_term = self_w[ri][:, :, None] * hw[:n_local, None, :]
            else:
                msg = hw[slot] * norm_e[ri][:, :, None]
                self_term = self_w[ri][:, :, None] * hw[:n_local]
            contrib = _segment_sum(msg.reshape(-1, b * c), rcv, n_local).reshape(n_local, b, c)
            contrib = contrib + self_term
            if conv.bias is not None:
                contrib = contrib + conv.bias * scope_loc[ri][:, None, None]
            out = contrib if out is None else out + contrib
        h = torch.relu(out)
    return _readout(mdef, h, me, n_local, "graph" in problem, query, nn, group)


def halo_masked_query_outputs(
    model,
    x: torch.Tensor,
    masks: torch.Tensor,
    part: HaloPartition,
    mesh,
    query: int,
    axis: str = "data",
) -> torch.Tensor:
    """Node-problem shorthand for :func:`halo_masked_outputs`."""
    return halo_masked_outputs(
        model, x, masks, part, mesh, problem="node_prediction", query=query, axis=axis,
    )


@torch.no_grad()
def halo_gcn_forward(
    model,
    x: torch.Tensor,
    edge_weight: torch.Tensor,
    part: HaloPartition,
    mesh,
    axis: str = "data",
    senders: Optional[torch.Tensor] = None,
    receivers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full GCN forward with nodes, edges and activations sharded: this
    rank's output block ``[n_local, out]`` from its feature block ``x``.

    Every layer: local matmul -> halo exchange of boundary rows -> local
    segment sum.  Communication per layer is ``D * halo * F`` elements per
    rank, independent of N.  ``senders``/``receivers`` are unused (the
    partition encodes them), kept for symmetry with
    :func:`.edge_partition.partitioned_gcn_forward`.
    """
    mdef = model.model_def
    refuse_row_sharded(mdef, "halo_gcn_forward")
    group, me = _axis(mesh, axis)
    n_local = part.n_local
    loc = part.local(me, x.device)
    slot, rcv = loc.edge_slot, loc.edge_rcv
    w_e = edge_weight[loc.edge_id] * loc.edge_valid
    # self-loop data edges are replaced by the unit self loop (gcn_norm)
    w_e = torch.where(loc.is_self, torch.zeros_like(w_e), w_e)
    dis = torch.rsqrt(1.0 + _segment_sum(w_e, rcv, n_local))
    dis_buf = _exchange(dis[:, None], loc.send_idx, group)[:, 0]
    norm_e = w_e * dis_buf[slot] * dis[rcv]
    self_w = dis * dis

    h = x
    for conv in mdef.conv:
        hw = h[:, : conv.in_features] @ conv.weight.T
        buf = _exchange(hw, loc.send_idx, group)
        h = _segment_sum(norm_e[:, None] * buf[slot], rcv, n_local) + self_w[:, None] * hw
        if conv.bias is not None:
            h = h + conv.bias
        h = torch.relu(h)
    return mdef.head(h)
