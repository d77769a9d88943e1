"""Scale-out on ``torch.distributed``: process groups and device meshes,
data and tensor sharding, edge partitioning, halo exchange.

Three tiers, as in the JAX package:

1. :mod:`.mesh` / :mod:`.sharding`: split the perturbation batch (``data``
   axis) and wide layers (``model`` axis) across ranks.
2. :mod:`.edge_partition`: edges split, features replicated, an
   ``all_reduce`` combines the partial sums (comms O(N)).
3. :mod:`.halo`: nodes, edges and activations split, an ``all_to_all`` of
   boundary rows a layer (comms O(boundary), independent of N).

The SPMD contract.  JAX is single-controller: one process sees every
device, arrays are global, and GSPMD or ``shard_map`` places the work.
PyTorch is multi-controller: one process a device, each holding its own
tensors, every collective written out.  So:

- Every rank runs the same program, launched by torchrun or by
  :func:`.mesh.spawn`, and holds the whole host-side graph and the
  host-built plans.  A ``cuda`` mesh runs NCCL with rank r on
  ``cuda:LOCAL_RANK``, a ``cpu`` mesh gloo; nothing swaps one backend for
  the other.
- Sharded inputs and results are this rank's block: :func:`shard_batch`,
  :func:`partition_edges`, the node arrays of the halo functions, and what
  JAX returns as ``out_specs=P(axis)`` (:func:`halo_gather_sum` and
  :func:`halo_gcn_forward` return ``[n_local, F]``).
  :func:`gather_nodes` returns the whole padded array on every rank (for
  tests and callers, not the hot path).
- Replicated results are the same full tensor on every rank: JAX's
  ``out_specs=P()`` (the ``partitioned_*`` functions,
  ``halo_masked_outputs*``, :func:`sharded_query_outputs`,
  ``ShardedModel.perturbed_query_outputs``, ``explain_many(mesh=)``).  So
  ``Explainer.run`` with a :class:`ShardedModel` runs whole on every rank:
  mask draws are host numpy seeded from key words, equal on every rank, and
  every rank returns the same DataFrames.

Names and parameter order are JAX's, with these departures:

================================  =============================================
JAX                               here
================================  =============================================
``(model_def, params, ...)``      a :class:`..models.adapter.Model` (the
                                  parameters live in its module):
                                  ``halo_masked_outputs``,
                                  ``halo_masked_outputs_hetero``,
                                  ``halo_masked_query_outputs``,
                                  ``halo_gcn_forward``, ``partitioned_gcn_forward``
``shard_params_model_axis(        ``(model, mesh, axis)``: the model's modules
params, mesh, axis)``             keep row blocks in place, with hooks
``explain_training_step(...)``    appends ``*, mesh=None, axes=("data",)``: a
                                  rank's block does not know its sharding
``make_mesh(n_devices)``          ``n_devices`` must equal the world size;
                                  appends ``*, device=None`` (the device type)
``make_multihost_mesh``,          append ``*, device=None`` (the backend, the
``initialize_distributed``        device type)
``ShardedModel(...)``             appends ``device=None`` (must be the rank's)
``batch_sharding`` and kin        ``torch.distributed.tensor`` placements, not
                                  ``NamedSharding`` (descriptors only)
================================  =============================================

Added: :func:`.mesh.spawn` (the counterpart of JAX's in-process virtual
mesh) and :func:`gather_nodes`.
"""

from .mesh import batch_sharding, make_mesh, replicated, spawn
from .sharding import (
    explain_training_step,
    gather_nodes,
    shard_batch,
    shard_params_model_axis,
    sharded_query_outputs,
)
from .edge_partition import (
    partition_edges,
    partitioned_gather_sum,
    partitioned_gcn_forward,
)
from .sharded_model import ShardedModel
from .halo import (
    HaloPartition,
    build_halo_partition,
    halo_gather_sum,
    halo_gcn_forward,
    halo_masked_outputs,
    halo_masked_query_outputs,
    pad_nodes,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "explain_training_step",
    "shard_batch",
    "shard_params_model_axis",
    "sharded_query_outputs",
    "partition_edges",
    "partitioned_gather_sum",
    "partitioned_gcn_forward",
    "HaloPartition",
    "build_halo_partition",
    "halo_gather_sum",
    "halo_gcn_forward",
    "halo_masked_outputs",
    "halo_masked_query_outputs",
    "pad_nodes",
    "ShardedModel",
    "spawn",
    "gather_nodes",
]
