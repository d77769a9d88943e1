"""The ELL gather-sums: hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

* :func:`gather_sum_static` (``csrc/gather_sum_static.cu``): static
  separable weights with a fused output scale, the node-mask layers >= 2.
* :func:`batched_gather_sum` (``csrc/batched_gather_sum.cu``): per-slot,
  per-sample weights ``w_slot [N, K, B]``, the edge-mask layers >= 2.

Each wrapper launches its kernel for tensors on the card and runs the plain
version for tensors on the CPU; there is no other route.  The kernels are
built at first CUDA use (:mod:`.cuda_build`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import Kernel

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (feats, dtype, nbr, deg, post_scale | w_slot, out, n, k, w, f, vec, stream)
_ARGS = [_p, _i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _p]

#: kernel 2.3, the static separable gather-sum
GATHER_SUM_STATIC = Kernel("gather_sum_static.cu", "gather_sum_static", _ARGS)
#: kernel 2.4, the weighted gather-sum
BATCHED_GATHER_SUM = Kernel("batched_gather_sum.cu", "batched_gather_sum", _ARGS)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(table, feats: torch.Tensor, b: int):
    if feats.dim() != 2 or feats.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"feats must be [N_src, B*F] float32 or bfloat16, got "
            f"{tuple(feats.shape)} {feats.dtype}"
        )
    w = feats.shape[1]
    if b < 1 or w % b:
        raise ValueError(f"feature width {w} is not a multiple of b={b}")
    if table.nbr.dtype != torch.int32 or table.nbr.device != feats.device:
        raise ValueError("table.nbr must be int32 on the features' device")
    if table.n_src > feats.shape[0]:
        raise ValueError(
            f"table reads source row {table.n_src - 1} of {feats.shape[0]}"
        )


def _check_f32(name: str, t: Optional[torch.Tensor], shape, feats: torch.Tensor):
    if t is not None and (
        tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != feats.device
    ):
        raise ValueError(f"{name} must be {list(shape)} float32 on the features' device")


def _launch(kernel: Kernel, table, feats: torch.Tensor, b: int, extra: Optional[torch.Tensor]):
    """The launch both wrappers share; ``extra`` is post_scale or w_slot."""
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    deg = table.deg
    tensors = [feats, table.nbr, deg] + ([extra] if extra is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel.symbol} needs contiguous tensors")
    n, k = table.nbr.shape
    w = feats.shape[1]
    f = w // b
    out = torch.empty((n, w), dtype=torch.float32, device=feats.device)
    if n == 0 or w == 0:
        return out
    vec = 16 // feats.element_size()
    if f % vec or feats.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    with torch.cuda.device(feats.device):
        kernel.launch(
            feats.data_ptr(), _DTYPE_CODE[feats.dtype], table.nbr.data_ptr(),
            deg.data_ptr(), None if extra is None else extra.data_ptr(),
            out.data_ptr(), n, k, w, f, vec,
            torch.cuda.current_stream(feats.device).cuda_stream,
        )
    return out


def gather_sum_static_plain(
    table, feats: torch.Tensor, b: int, post_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Kernel 2.3's function in plain PyTorch: a loop over the K slots with
    a select on ``k < deg``, so memory stays ``[N, B*F]`` and non-finite
    values in rows that no valid slot names cannot reach the sum."""
    n, k = table.nbr.shape
    w = feats.shape[1]
    deg = table.deg
    out = torch.zeros((n, w), dtype=torch.float32, device=feats.device)
    zero = out.new_zeros(())
    for j in range(k):
        take = (deg > j)[:, None]
        out += torch.where(take, feats[table.nbr[:, j]].float(), zero)
    if post_scale is not None:
        out = (out.view(n, b, w // b) * post_scale[:, :, None]).view(n, w)
    return out


def gather_sum_static(
    table, feats: torch.Tensor, b: int, post_scale: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``out[v, s*F:(s+1)*F] = post_scale[v, s] * sum_{k < deg[v]}
    feats[nbr[v, k], s*F:(s+1)*F]`` over a prefix-valid
    :class:`.ell.NeighborTable`; float32 ``[N, B*F]``.

    On a CUDA tensor this launches kernel 2.3 (or raises); on a CPU tensor
    it runs :func:`gather_sum_static_plain`.
    """
    _check(table, feats, b)
    _check_f32("post_scale", post_scale, (table.nbr.shape[0], b), feats)
    if feats.device.type == "cpu":
        return gather_sum_static_plain(table, feats, b, post_scale)
    return _launch(GATHER_SUM_STATIC, table, feats, b, post_scale)


def slot_weights(table, edge_weight: torch.Tensor) -> torch.Tensor:
    """``[E, B]`` per-edge weights (indexed by the table's ``eid``) to the
    slot layout ``[N, K, B]``, zero on invalid slots."""
    return edge_weight[table.eid.long()] * table.valid[:, :, None]


def batched_gather_sum_plain(table, feats: torch.Tensor, b: int, w_slot: torch.Tensor) -> torch.Tensor:
    """Kernel 2.4's function in plain PyTorch: a loop over the K slots with
    a select on ``k < deg``; each valid slot adds ``w * x``."""
    n, k = table.nbr.shape
    w = feats.shape[1]
    f = w // b
    deg = table.deg
    out = torch.zeros((n, b, f), dtype=torch.float32, device=feats.device)
    zero = out.new_zeros(())
    for j in range(k):
        take = (deg > j)[:, None, None]
        term = w_slot[:, j, :, None] * feats[table.nbr[:, j]].float().view(n, b, f)
        out += torch.where(take, term, zero)
    return out.view(n, w)


def batched_gather_sum(
    table,
    edge_weight: Optional[torch.Tensor],
    feats: torch.Tensor,
    b: int,
    w_slot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[v, s*F:(s+1)*F] = sum_{k < deg[v]} w_slot[v, k, s] *
    feats[nbr[v, k], s*F:(s+1)*F]`` over a prefix-valid
    :class:`.ell.NeighborTable`; float32 ``[N, B*F]``.

    ``w_slot`` ``[N, K, B]`` float32: slot-layout weights (the engines'
    coefficient tensors).  Without it they are built from ``edge_weight``
    ``[E, B]`` as :func:`slot_weights` does.  On a CUDA tensor this launches
    kernel 2.4 (or raises); on a CPU tensor it runs
    :func:`batched_gather_sum_plain`.
    """
    _check(table, feats, b)
    if w_slot is None:
        if edge_weight is None:
            raise ValueError("pass edge_weight or w_slot")
        w_slot = slot_weights(table, edge_weight.float())
    n, k = table.nbr.shape
    _check_f32("w_slot", w_slot, (n, k, b), feats)
    if feats.device.type == "cpu":
        return batched_gather_sum_plain(table, feats, b, w_slot)
    return _launch(BATCHED_GATHER_SUM, table, feats, b, w_slot)
