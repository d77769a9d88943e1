"""GNN layers with PyG-exact numerics, for masked batched execution.

Each layer's ``forward`` is the JAX package's ``apply(params, ...)`` with
the parameters held by the module, under the same names (the JAX tree
paths, which are PyG's state-dict keys: ``lin_src.weight``, ``att_src``,
...).  ``edge_weight`` carries both graph validity and perturbation masks
(0 = edge absent), and may have leading batch dimensions (``[..., E]``, with
features ``[N, F]`` or ``[..., N, F]``): a batch of perturbed graphs is one
call.  Aggregation is plain PyTorch (``index_add_`` / ``scatter_reduce_``),
as the JAX layers use segment operations and no Pallas kernel.

``dst_scope`` (``[N]``, 1 on the nodes of a relation's destination type)
is what :class:`.gnn.HeteroGNN` passes each relation's conv: GCNConv puts
its self-loops and bias only there, GATConv and GATv2Conv their bias, and
SAGEConv its whole output (root term and bias included), as PyG's
``to_hetero`` writes a relation's SAGE output to destination rows only.
GraphConv and GINConv take no ``dst_scope``.

Initialisation draws from ``generator`` (a ``torch.Generator``; ``None``
means torch's default one); it does not reproduce JAX's draw, since
weights are carried across with :func:`.checkpoint.params_from_numpy`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.norm import gcn_norm_weights
from ..ops.segment import segment_max, segment_softmax, segment_sum
from ..ops.spmm import weighted_gather_sum


def relu(x: torch.Tensor) -> torch.Tensor:
    """Rectified linear unit."""
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logistic sigmoid."""
    return torch.sigmoid(x)


def _uniform(shape, limit: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-limit, limit, generator=generator))


def _glorot(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    """Glorot-uniform over the last two axes, as the JAX package's ``glorot``."""
    fan_in, fan_out = shape[-1], shape[-2] if len(shape) > 1 else shape[-1]
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def refuse_row_sharded(model_def: nn.Module, reader: str) -> None:
    """Raise ``ValueError`` where a module of ``model_def`` holds only a row
    block of its weight (``parallel.shard_params_model_axis``): ``reader``
    reads weights directly and would compute on the block.  Such a model
    runs on its own forward, whose hooks gather the blocks' outputs."""
    if any(getattr(m, "row_sharded", False) for m in model_def.modules()):
        raise ValueError(
            f"{reader} reads whole weights, but the model is tensor-parallel (row-sharded "
            "modules); run it through its own forward (Model(..., fast=False), Model.infer)"
        )


class Linear(nn.Module):
    """Dense layer, torch layout: weight [out, in], y = x W^T + b."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        limit = math.sqrt(1.0 / in_features)
        self.weight = _uniform((out_features, in_features), limit, generator)
        self.bias = _uniform((out_features,), limit, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x @ W.T + b."""
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        return y


class GCNConv(nn.Module):
    """PyG-exact GCN convolution: ``out = D^-1/2 (A+I) D^-1/2 X W^T + b``.

    Parameter layout matches PyG's ``lin.weight`` [out, in] and ``bias``.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        improved: bool = False,
        add_self_loops: bool = True,
        normalize: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.improved = improved
        self.add_self_loops = add_self_loops
        self.normalize = normalize
        self.weight = _glorot((out_features, in_features), generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_weight: torch.Tensor,
        *,
        dst_scope: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Symmetric-normalised masked graph convolution."""
        num_nodes = x.shape[-2]
        xw = x[..., : self.in_features] @ self.weight.T
        if self.normalize:
            norm_e, self_w = gcn_norm_weights(
                senders,
                receivers,
                edge_weight.to(xw.dtype),
                num_nodes,
                improved=self.improved,
                add_self_loops=self.add_self_loops,
                self_loop_mask=dst_scope,
            )
        else:
            norm_e = edge_weight.to(xw.dtype)
            self_w = xw.new_zeros(norm_e.shape[:-1] + (num_nodes,))
        out = weighted_gather_sum(norm_e, xw, senders, receivers, num_nodes)
        return _add_bias(out + self_w[..., None] * xw, self.bias, dst_scope)


def _add_bias(out: torch.Tensor, bias: Optional[torch.Tensor],
              dst_scope: Optional[torch.Tensor]) -> torch.Tensor:
    """``out + bias``, the bias only on the rows of ``dst_scope`` where one
    is given."""
    if bias is None:
        return out
    if dst_scope is None:
        return out + bias
    return out + bias * dst_scope.to(out.dtype)[:, None]


def _segment(fn, data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``fn`` of :mod:`..ops.segment` (which reduces the leading axis) over
    axis -2 of ``data [..., E, X]``: the edge axis under any batch axes."""
    return fn(data.movedim(-2, 0), ids, n).movedim(0, -2)


def _attention(
    logits: torch.Tensor,        # [..., E, H] attention logits of the edges
    logit_self: Optional[torch.Tensor],  # [..., N, H] of the unit self-loops
    xs: torch.Tensor,            # [..., N, H, C] messages of the senders
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_weight: torch.Tensor,   # [..., E]; 0 = edge absent
) -> torch.Tensor:               # [..., N, H, C]
    """Softmax over each receiver's present in-edges, then the weighted sum
    of the senders' messages.  Masked edges leave the softmax (the
    static-shape equivalent of deleting them); with ``logit_self`` a unit
    self-loop per node enters it and is never masked (PyG's homogeneous
    default, which the reference's mega-graph keeps for masked nodes)."""
    n, (h, c) = xs.shape[-3], xs.shape[-2:]
    present = (edge_weight > 0)[..., None]
    logits = torch.where(present, logits, -math.inf)
    if logit_self is None:
        alpha = _segment(segment_softmax, logits, receivers, n) * present
        msg = (alpha[..., None] * xs[..., senders, :, :]).flatten(-2)
        return _segment(segment_sum, msg, receivers, n).unflatten(-1, (h, c))
    seg_max = _segment(segment_max, logits, receivers, n)
    m = torch.maximum(torch.where(torch.isfinite(seg_max), seg_max, -math.inf), logit_self)
    ex = torch.where(present, torch.exp(logits - m[..., receivers, :]), 0.0)
    ex_self = torch.exp(logit_self - m)
    denom = _segment(segment_sum, ex, receivers, n) + ex_self
    denom = torch.where(denom == 0.0, 1.0, denom)
    msg = (ex[..., None] * xs[..., senders, :, :]).flatten(-2)
    out = _segment(segment_sum, msg, receivers, n).unflatten(-1, (h, c)) + ex_self[..., None] * xs
    return out / denom[..., None]


class _AttentionConv(nn.Module):
    """What GATConv and GATv2Conv share: heads, the concat/mean of heads and
    the output bias."""

    def __init__(self, in_features, out_features, heads, concat, negative_slope,
                 add_self_loops, bias):
        super().__init__()
        self.in_src, self.in_dst = in_features
        self.out_features = out_features
        self.heads = heads
        self.concat = concat
        self.negative_slope = negative_slope
        self.add_self_loops = add_self_loops
        width = heads * out_features if concat else out_features
        self.bias = nn.Parameter(torch.zeros(width)) if bias else None

    def _finish(self, out: torch.Tensor, dst_scope: Optional[torch.Tensor]) -> torch.Tensor:
        out = out.flatten(-2) if self.concat else out.mean(-2)
        return _add_bias(out, self.bias, dst_scope)


class GATConv(_AttentionConv):
    """PyG-exact GAT convolution (bipartite ``(-1, -1)`` form): separate
    source/target linear maps, additive attention with leaky-relu, softmax
    over incoming edges.

    Parameters: ``lin_src.weight``, ``lin_dst.weight`` [H*C, in], ``att_src``,
    ``att_dst`` [1, H, C], ``bias`` [H*C] (concat) or [C].  A PyG
    homogeneous checkpoint holds one shared ``lin_src``; the importer copies
    it into both maps, as the JAX package does.
    """

    def __init__(
        self,
        in_features: Tuple[int, int],
        out_features: int,
        heads: int = 1,
        concat: bool = True,
        negative_slope: float = 0.2,
        add_self_loops: bool = False,
        bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(in_features, out_features, heads, concat, negative_slope,
                         add_self_loops, bias)
        hc = heads * out_features
        self.lin_src = Linear(self.in_src, hc, bias=False, generator=generator)
        self.lin_dst = Linear(self.in_dst, hc, bias=False, generator=generator)
        self.att_src = _glorot((1, heads, out_features), generator)
        self.att_dst = _glorot((1, heads, out_features), generator)

    def forward(self, x, senders, receivers, edge_weight, *,
                dst_scope: Optional[torch.Tensor] = None,
                x_dst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked attention convolution, [..., N, H*C] or [..., N, C].
        ``x_dst`` (default ``x``) feeds the destination projection."""
        hc = (self.heads, self.out_features)
        xs = self.lin_src(x[..., : self.in_src]).unflatten(-1, hc)
        xd = self.lin_dst((x if x_dst is None else x_dst)[..., : self.in_dst]).unflatten(-1, hc)
        a_src = (xs * self.att_src).sum(-1)  # [..., N, H]
        a_dst = (xd * self.att_dst).sum(-1)
        slope = self.negative_slope
        logits = nn.functional.leaky_relu(a_src[..., senders, :] + a_dst[..., receivers, :], slope)
        logit_self = (
            nn.functional.leaky_relu(a_src + a_dst, slope) if self.add_self_loops else None
        )
        out = _attention(logits, logit_self, xs, senders, receivers, edge_weight)
        return self._finish(out, dst_scope)


class GATv2Conv(_AttentionConv):
    """PyG-exact GATv2 convolution: per edge (j -> i)
    ``e_ij = att . leaky_relu(lin_l(x_j) + lin_r(x_i))``, softmax over
    incoming edges, ``out_i = sum_j alpha_ij lin_l(x_j)``.

    Parameters: ``lin_l``, ``lin_r`` (Linear(in, H*C), with bias when
    ``bias``), ``att`` [1, H, C], ``bias``.  With ``share_weights`` the
    forward reads ``lin_l`` for both sides; ``lin_r`` stays only to keep
    PyG's key layout.
    """

    def __init__(
        self,
        in_features: Tuple[int, int],
        out_features: int,
        heads: int = 1,
        concat: bool = True,
        negative_slope: float = 0.2,
        add_self_loops: bool = True,
        bias: bool = True,
        share_weights: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(in_features, out_features, heads, concat, negative_slope,
                         add_self_loops, bias)
        self.share_weights = share_weights
        hc = heads * out_features
        self.lin_l = Linear(self.in_src, hc, bias=bias, generator=generator)
        self.lin_r = Linear(self.in_dst, hc, bias=bias, generator=generator)
        if share_weights:
            self.lin_r.load_state_dict(self.lin_l.state_dict())
        self.att = _glorot((1, heads, out_features), generator)

    def forward(self, x, senders, receivers, edge_weight, *,
                dst_scope: Optional[torch.Tensor] = None,
                x_dst: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked GATv2 attention convolution; ``x_dst`` (default ``x``)
        feeds the destination projection."""
        hc = (self.heads, self.out_features)
        xl = self.lin_l(x[..., : self.in_src]).unflatten(-1, hc)
        lin_r = self.lin_l if self.share_weights else self.lin_r
        xr = lin_r((x if x_dst is None else x_dst)[..., : self.in_dst]).unflatten(-1, hc)
        slope = self.negative_slope
        pre = xl[..., senders, :, :] + xr[..., receivers, :, :]  # [..., E, H, C]
        logits = (nn.functional.leaky_relu(pre, slope) * self.att).sum(-1)
        logit_self = (
            (nn.functional.leaky_relu(xl + xr, slope) * self.att).sum(-1)
            if self.add_self_loops else None
        )
        out = _attention(logits, logit_self, xl, senders, receivers, edge_weight)
        return self._finish(out, dst_scope)


def _mean_weights(edge_weight, receivers, n):
    """Per-receiver sum of the edge weights, ``[..., N, 1]``, 1 where 0."""
    den = _segment(segment_sum, edge_weight[..., None], receivers, n)
    return torch.where(den > 0, den, 1.0)


class SAGEConv(nn.Module):
    """PyG-exact GraphSAGE convolution (mean aggregation):
    ``out = lin_l(mean_w{x_u}) + lin_r(x)``.

    Parameters: ``lin_l`` (aggregated neighbours, with bias), ``lin_r``
    (root, no bias).  The mean is weighted by ``edge_weight``: masked edges
    leave both numerator and denominator.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.lin_l = Linear(in_features, out_features, bias=bias, generator=generator)
        self.lin_r = Linear(in_features, out_features, bias=False, generator=generator)

    def forward(self, x, senders, receivers, edge_weight, *,
                dst_scope: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean-aggregate neighbours + root transform; ``dst_scope`` zeroes
        the whole output off its rows (the root term would otherwise leak
        onto every node type)."""
        n = x.shape[-2]
        xin = x[..., : self.in_features]
        ew = edge_weight.to(xin.dtype)
        agg = weighted_gather_sum(ew, xin, senders, receivers, n) / _mean_weights(ew, receivers, n)
        out = agg @ self.lin_l.weight.T + xin @ self.lin_r.weight.T
        if self.lin_l.bias is not None:
            out = out + self.lin_l.bias
        return out if dst_scope is None else out * dst_scope.to(out.dtype)[:, None]


class RGCNConv(nn.Module):
    """PyG-exact relational GCN convolution over a typed homogeneous graph:
    ``out_i = x_i @ root + sum_r mean_{j in N_r(i)} x_j @ W_r + bias``,
    optionally with bases ``W_r = sum_b comp[r, b] V_b``.

    Parameters in PyG's layout, not ``nn.Linear``-transposed: ``weight``
    ``[R, in, out]`` (``[num_bases, in, out]`` with ``comp [R,
    num_bases]``), ``root [in, out]``, ``bias [out]``.  The mean is
    weighted by ``edge_weight``: a masked edge leaves both numerator and
    denominator, and a relation with no live edge into a node adds 0.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        num_relations: int,
        num_bases: Optional[int] = None,
        bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.num_relations = num_relations
        self.num_bases = num_bases
        n_w = num_relations if num_bases is None else num_bases
        self.weight = _glorot((n_w, in_features, out_features), generator)
        self.comp = None if num_bases is None else _glorot((num_relations, num_bases), generator)
        self.root = _glorot((in_features, out_features), generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x, senders, receivers, edge_weight, edge_type, *,
                dst_scope: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-relation weighted mean of the senders, through the
        relation's weight, plus the root transform and the bias."""
        n = x.shape[-2]
        xin = x[..., : self.in_features]
        w = self.weight if self.comp is None else torch.einsum("rb,bio->rio", self.comp, self.weight)
        out = xin @ self.root
        for r in range(self.num_relations):
            ew_r = (edge_weight * (edge_type == r).to(edge_weight.dtype)).to(xin.dtype)
            agg = weighted_gather_sum(ew_r, xin, senders, receivers, n) / _mean_weights(ew_r, receivers, n)
            out = out + agg @ w[r]
        return _add_bias(out, self.bias, dst_scope)


class GraphConv(nn.Module):
    """PyG-exact GraphConv (weighted-sum aggregation):
    ``out = lin_rel(sum_w{x_u}) + lin_root(x)``.

    Parameters: ``lin_rel`` (aggregated neighbours, with bias), ``lin_root``
    (root, no bias).  Masked edges contribute nothing to the sum.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.lin_rel = Linear(in_features, out_features, bias=bias, generator=generator)
        self.lin_root = Linear(in_features, out_features, bias=False, generator=generator)

    def forward(self, x, senders, receivers, edge_weight) -> torch.Tensor:
        """Weighted-sum-aggregate neighbours + root transform."""
        xin = x[..., : self.in_features]
        agg = weighted_gather_sum(edge_weight.to(xin.dtype), xin, senders, receivers, x.shape[-2])
        out = agg @ self.lin_rel.weight.T + xin @ self.lin_root.weight.T
        return out if self.lin_rel.bias is None else out + self.lin_rel.bias


class GINConv(nn.Module):
    """PyG-exact GIN convolution: ``out = mlp((1 + eps) x + sum_w{x_u})``.

    The MLP is Linear/ReLU alternating (``mlp_channels`` hidden widths, then
    ``out_features``): parameters ``nn.{i}.weight``, ``nn.{i}.bias`` (the
    JAX tree's list index; PyG's ``nn.Sequential`` counts the ReLUs too, and
    the importer maps) and the scalar ``eps``.
    """

    def __init__(self, in_features: int, out_features: int, mlp_channels: Tuple[int, ...] = (),
                 eps: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        dims = (in_features,) + tuple(mlp_channels) + (out_features,)
        self.nn = nn.ModuleList(
            Linear(a, b, generator=generator) for a, b in zip(dims[:-1], dims[1:])
        )
        self.eps = nn.Parameter(torch.tensor(float(eps)))

    def forward(self, x, senders, receivers, edge_weight) -> torch.Tensor:
        """(1 + eps) * x + sum of neighbours, through the MLP."""
        xin = x[..., : self.in_features]
        agg = weighted_gather_sum(edge_weight.to(xin.dtype), xin, senders, receivers, x.shape[-2])
        h = (1.0 + self.eps) * xin + agg
        for i, lin in enumerate(self.nn):
            h = lin(h)
            if i != len(self.nn) - 1:
                h = relu(h)
        return h
