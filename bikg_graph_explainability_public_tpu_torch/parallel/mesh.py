"""Process groups and device meshes on ``torch.distributed``.

One process per device: rank r of a ``cuda`` mesh drives ``cuda:LOCAL_RANK``
over NCCL, a ``cpu`` mesh runs on gloo.  :func:`initialize_distributed`
joins the group (torchrun's or JAX's environment, or explicit arguments),
:func:`make_mesh` / :func:`make_multihost_mesh` lay the ranks out as a
:class:`~torch.distributed.device_mesh.DeviceMesh`, and :func:`spawn` starts
a whole group on this host (the tests' and the CLI test's launcher).

Multi-host launch recipe (one process per device, same program everywhere)::

    torchrun --nnodes H --nproc-per-node G ... script.py
    # in script.py
    from bikg_graph_explainability_public_tpu_torch.parallel import mesh as pxmesh
    pxmesh.initialize_distributed()          # reads torchrun's environment
    m = pxmesh.make_multihost_mesh()         # ("host", "data"), node-major
    dfs = px.explain_many(model, g, queries, cfg, mesh=m)
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

#: seconds a collective waits for its peers before it fails (a mismatched
#: collective raises instead of hanging)
TIMEOUT_S = 120.0

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> bool:
    """Join the process group of a multi-process run.

    ``coordinator_address`` is ``host:port`` (a TCP store) or
    ``file:///path`` (a file store every rank can reach).  Missing
    arguments come from JAX's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
    ``PROCESS_ID`` or torchrun's ``MASTER_ADDR`` + ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``.  With neither, this is a single-process run:
    it starts nothing and returns False.  ``device`` picks the backend:
    NCCL for CUDA (``None``; the process then takes ``cuda:LOCAL_RANK``),
    gloo for ``"cpu"``.  Idempotent; returns whether more than one process
    is in the group.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without the number of "
            "processes and this process's id (arguments, NUM_PROCESSES / PROCESS_ID "
            "or WORLD_SIZE / RANK)"
        )
    dev_type = resolve_device(device).type
    if dev_type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count() if local is None else local)
    init = coordinator_address
    if not init.startswith(("file://", "tcp://")):
        init = f"tcp://{init}"
    dist.init_process_group(
        _BACKEND[dev_type], init_method=init, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return int(num_processes) > 1


def _mesh(device, shape: Tuple[int, ...], axis_names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() first, or launch with "
            "torchrun (or parallel.spawn)"
        )
    dev_type = resolve_device(device).type
    backend = dist.get_backend()
    if backend != _BACKEND[dev_type]:
        raise ValueError(f"a {dev_type} mesh needs {_BACKEND[dev_type]}, the group runs {backend}")
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    *,
    device=None,
):
    """A mesh over every rank of the group (``n_devices`` must be the world
    size: a rank cannot sit outside the mesh it computes on).

    Default: 1-D ``data`` mesh (perturbation-batch parallelism).  Pass
    ``axis_names=("data", "model")`` with a ``shape`` for 2-D sharding.
    ``device``: the mesh's device type, CUDA unless ``"cpu"``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}) in a group of {world} ranks: launch {n_devices} "
            "processes (one per device)"
        )
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return _mesh(device, shape, axis_names)


def make_multihost_mesh(
    axis_names: Tuple[str, ...] = ("host", "data"),
    hosts: Optional[int] = None,
    inner_shape: Optional[Tuple[int, ...]] = None,
    *,
    device=None,
):
    """Global mesh with an outermost ``host`` axis.

    Ranks are node-major, as torchrun numbers them, so each row of the
    ``host`` axis is one machine: collectives over ``host`` cross the
    network once, collectives over the inner axes stay inside a machine.
    ``hosts`` defaults to ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (1 without
    torchrun); passing it folds the ranks of one machine into an emulated
    topology.  ``inner_shape`` factors each host's ranks further, e.g.
    ``axis_names=("host", "data", "model")``, ``inner_shape=(2, 2)``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if hosts is None:
        hosts = world // (_env_int("LOCAL_WORLD_SIZE") or world)
    if world % hosts:
        raise ValueError(f"{world} ranks do not fold into {hosts} hosts")
    if inner_shape is None:
        inner_shape = (world // hosts,) + (1,) * (len(axis_names) - 2)
    return _mesh(device, (hosts,) + tuple(inner_shape), axis_names)


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along the mesh axis named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device on a
    ``cuda`` mesh (``cuda:LOCAL_RANK`` after :func:`initialize_distributed`),
    else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh, axis: Union[str, Tuple[str, ...]] = "data") -> tuple:
    """Placements of a [B, ...] perturbation batch: rows split over
    ``axis`` (a name, or names split jointly, outermost first), replicated
    over the other mesh axes."""
    from torch.distributed.tensor import Replicate, Shard

    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(Shard(0) if name in axes else Replicate() for name in mesh.mesh_dim_names)


def hierarchical_batch_sharding(mesh) -> tuple:
    """Rows split over every batch-like mesh axis (``host`` and ``data``
    jointly): the multi-host placement of a perturbation or query batch."""
    return batch_sharding(mesh, tuple(a for a in mesh.mesh_dim_names if a in ("host", "data")))


def replicated(mesh) -> tuple:
    """Placements that replicate a tensor on every rank."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def _rank_main(rank, fn, world_size, store, device, out_path, args):
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    initialize_distributed(f"file://{store}", world_size, rank, device=device)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device="cpu", timeout: float = 120.0):
    """Run ``fn(*args)`` on ``world_size`` new ranks of this host and
    return rank 0's result (a picklable, module-level ``fn``).

    Each rank joins a group over a file store in a temporary directory
    (gloo for ``device="cpu"``, NCCL on ``cuda:rank`` otherwise) with one
    CPU thread.  The ranks are joined with a deadline: if one raises, or
    ``timeout`` seconds pass, every rank is killed and this raises.  This
    is the port's counterpart of JAX's in-process virtual mesh.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "result.pkl")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, os.path.join(tmp, "store"), str(device), out_path,
                              args),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(min(deadline - time.monotonic(), 1.0), 0.01)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world_size} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(out_path, "rb") as f:
            return pickle.load(f)
