"""Data and tensor parallelism for the explanation pipeline.

The perturbation batch is pure data parallelism: mask rows split over the
``data`` axis, the graph and model are replicated, and the surrogate's
batch-loss gradient is summed over the ranks.  Layer output dimensions can
split over a ``model`` axis (tensor parallelism for wide hidden layers).
JAX gets the collectives from GSPMD; here each is written out, and the
numerics equal a single device's up to the order of the sums.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from ..explain.kernels import log_shap_weights, log_weight_max
from ..graph import Graph
from ..models.adapter import Model
from ..models.layers import GCNConv, GraphConv, Linear, SAGEConv
from .mesh import axis_size, batch_sharding, mesh_device

Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_batch(masks, mesh, axis: Axes = "data") -> torch.Tensor:
    """This rank's rows of a [B, S] mask batch split over ``axis`` (a
    name, or names split jointly, outermost first), on the rank's device.
    B must divide by the axes' size (pad rows with all-False masks and
    zero kernel weight if not)."""
    from torch.distributed.tensor import Shard

    masks = torch.as_tensor(masks, device=mesh_device(mesh))
    idx, count = 0, 1
    for dim, p in enumerate(batch_sharding(mesh, axis)):
        if isinstance(p, Shard):
            idx = idx * mesh.size(dim) + mesh.get_local_rank(dim)
            count *= mesh.size(dim)
    if masks.shape[0] % count:
        raise ValueError(f"a batch of {masks.shape[0]} rows does not split over {count} ranks")
    blk = masks.shape[0] // count
    return masks[idx * blk : (idx + 1) * blk]


def gather_rows(local: torch.Tensor, mesh, axis: Axes = "data") -> torch.Tensor:
    """Inverse of :func:`shard_batch`: every rank's block, concatenated in
    rank order, on every rank."""
    for name in reversed(_axes(axis)):  # innermost first: blocks stay host-major
        parts = [torch.empty_like(local) for _ in range(axis_size(mesh, name))]
        dist.all_gather(parts, local.contiguous(), group=mesh.get_group(name))
        local = torch.cat(parts)
    return local


def gather_nodes(local: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The whole padded node array ``[D * n_local, ...]`` from each rank's
    block, on every rank (torch tensors are not global; for tests and
    callers, not for the hot path)."""
    return gather_rows(local, mesh, axis)


def _all_reduce(t: torch.Tensor, mesh, axes: tuple, op=dist.ReduceOp.SUM) -> torch.Tensor:
    for name in axes:
        dist.all_reduce(t, op=op, group=mesh.get_group(name))
    return t


def replicate(tree, mesh):
    """Every tensor of a tensor, list, tuple or dict moved to this rank's
    device (each rank holds its own replica)."""
    dev = mesh_device(mesh)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def _gather_columns(group, size: int):
    def hook(_module, _inputs, out):
        parts = [torch.empty_like(out) for _ in range(size)]
        dist.all_gather(parts, out.contiguous(), group=group)
        return torch.cat(parts, dim=-1)
    return hook


def shard_params_model_axis(model: Model, mesh, axis: str = "model") -> Model:
    """Tensor-parallel placement, in place: every ``Linear`` and
    ``GCNConv`` whose output dimension divides the axis size keeps its row
    block of the weight (torch layout [out, in]) and of the bias, and a
    forward hook gathers its output columns over the axis's group; every
    other parameter stays whole.  The Linears of SAGE and GraphConv convs
    stay whole, since their parent reads the weights directly.

    ``Model.infer`` and the generic forward serve such a model; the fast
    engines, ``explain_many`` and the halo forwards read whole weights and
    raise ``ValueError``.  Returns ``model``.
    """
    size = axis_size(mesh, axis)
    me, group = mesh.get_local_rank(axis), mesh.get_group(axis)
    mdef = model.model_def
    read_by_parent = {
        id(c) for m in mdef.modules() if isinstance(m, (SAGEConv, GraphConv)) for c in m.children()
    }
    for mod in list(mdef.modules()):
        if not isinstance(mod, (Linear, GCNConv)) or id(mod) in read_by_parent:
            continue
        out = mod.weight.shape[0]
        if out % size:
            continue
        rows = slice(me * (out // size), (me + 1) * (out // size))
        mod.weight = nn.Parameter(mod.weight.detach()[rows].clone())
        if mod.bias is not None:
            mod.bias = nn.Parameter(mod.bias.detach()[rows].clone())
        mod.row_sharded = True
        mod.register_forward_hook(_gather_columns(group, size))
    return model


def sharded_query_outputs(
    model: Model,
    graph: Graph,
    masks,
    problem: str,
    query: Optional[int],
    mesh,
) -> torch.Tensor:
    """Perturbed query outputs with the batch split over ``data``.

    Same contract as :meth:`..models.adapter.Model.perturbed_query_outputs`,
    given the whole ``masks`` on every rank: each rank runs its B / D rows
    with no communication until one ``all_gather`` returns the ``[B]``
    outputs on every rank.
    """
    local = shard_batch(masks, mesh)
    out = model.perturbed_query_outputs(graph, local, problem, query, chunk_size=local.shape[0])
    return gather_rows(out, mesh)


def explain_training_step(
    model: Model,
    graph: Graph,
    problem: str,
    query: Optional[int],
    num_valid: int,
    lr: float = 0.01,
    l1_lambda: float = 1e-4,
    weight_decay: float = 1e-2,
    *,
    mesh=None,
    axes: Sequence[str] = ("data",),
):
    """One surrogate-training step: masked black-box forwards over the mask
    batch -> KernelSHAP weights -> weighted loss -> Adam update.

    Returns ``step(w, m, v, t, mask_batch) -> (w, m, v, t, loss)``.  With
    a ``mesh``, ``mask_batch`` is this rank's block of the batch split
    over ``axes`` (:func:`shard_batch`): the kernel's normaliser is the
    batch-wide maximum, the weighted MSE's numerator, the kernel sum and
    the batch size are summed over the ranks, so the loss is the global
    one, and so is the data gradient; the L1 and weight-decay terms are
    added once.  ``w``, ``m``, ``v`` [S] and ``t`` are replicated.
    """
    axes = tuple(reversed(_axes(axes))) if mesh is not None else ()

    @torch.no_grad()
    def step(w, m, v, t, mask_batch):
        outputs = model.perturbed_query_outputs(
            graph, mask_batch, problem, query, chunk_size=mask_batch.shape[0]
        )
        logw, valid = log_shap_weights(mask_batch, num_valid)
        top = _all_reduce(log_weight_max(logw, valid), mesh, axes, dist.ReduceOp.MAX)
        kern = torch.where(valid, torch.exp(logw - top), torch.zeros_like(logw))
        col_valid = (torch.arange(w.shape[0], device=w.device) < num_valid).to(torch.float32)
        mf = mask_batch.to(torch.float32)
        r = mf @ w - outputs
        sums = torch.stack([(kern * r * r).sum(), kern.sum(), r.new_tensor(float(r.shape[0]))])
        num, ksum, batch = _all_reduce(sums, mesh, axes)
        ksum = torch.clamp(ksum, min=1e-30)
        loss = num / batch / ksum + l1_lambda * (w.abs() * col_valid).sum() / num_valid
        g = _all_reduce(mf.T @ (kern * ((1.0 / ksum) / batch) * (2.0 * r)), mesh, axes)
        g = g + torch.sign(w) * (l1_lambda * col_valid) / num_valid
        g = (g + weight_decay * w) * col_valid
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9**t)
        vhat = v / (1.0 - 0.999**t)
        w = w - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        return w, m, v, t, loss

    return step
