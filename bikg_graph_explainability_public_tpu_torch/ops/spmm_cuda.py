"""The ELL gather-sums: hand-written CUDA kernels for Hopper, their plain
PyTorch versions and :func:`spmm_ell`, the entry that routes by schedule.

* :func:`gather_sum_static` (``csrc/gather_sum_static.cu``, kernel 2.3):
  static separable weights with a fused output scale, the node-mask layers
  >= 2.
* :func:`batched_gather_sum` (``csrc/batched_gather_sum.cu``, kernel 2.4):
  per-slot, per-sample weights, sample-major ``w_sample [B, N, K]`` (the
  edge-mask layers >= 2) or slot-major ``w_slot [N, K, B]`` (the JAX
  signature, through :func:`slot_transpose`).
* :func:`ell_valid_sum` (``ell_valid_sum`` of ``csrc/gather_sum_static.cu``,
  kernels 2.5 and 2.8): the valid-prefix sum, 2.3 without the scale.
* :func:`spmm_ell_weighted` (``csrc/spmm_ell_weighted.cu``, kernels 2.6 and
  2.7): slot weights, static ``[N, K]`` (multiplied) or ``[N, K, wb]`` with
  ``wb`` in ``{1, B}`` (selected: a slot of weight 0 adds nothing).
* :func:`spmm_ell_all_slots` (kernel 2.9, the ELL prototype of the JAX
  package's benchmarks): every slot summed, on 2.6's static walk.

Kernels 2.3, 2.4, 2.5 and 2.8, and 2.6/2.7 with one weight per slot, run
one band-major walk whose column band of the source rows stays in L2
(``csrc/ell_band.cuh``; :func:`band_plan` picks the band and the persistent
grid).

Each wrapper launches its kernel for tensors on the card and runs the plain
version for tensors on the CPU; there is no other route.  The kernels are
built at first CUDA use (:mod:`.cuda_build`).  The TPU's four schedules of
``spmm_ell_pallas`` compute two functions, so :func:`spmm_ell` sends them to
two kernels and counts each schedule's launches apart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .cuda_build import Kernel
from .ell import NeighborTable

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (feats, dtype, nbr, deg, post_scale or w_bnk, out, n, k, w, f, band, rows,
#  grid, counter, vec, stream)
_STATIC_ARGS = [_p, _i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _i, _i, _p, _i, _p]
# (w_slot, w_bnk, rows, b, stream)
_TRANSPOSE_ARGS = [_p, _p, _i64, _i64, _p]
# (feats, dtype, nbr, deg, out, n, k, w, f, band, rows, grid, counter, vec,
#  stream)
_VALID_ARGS = [_p, _i, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _i, _i, _p, _i, _p]
# (feats, dtype, nbr, deg, w_slot, out, n, k, w, f, wb, select, band, rows,
#  grid, counter, vec, stream)
_WEIGHTED_ARGS = [
    _p, _i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _p, _i, _p,
]

#: kernel 2.3, the static separable gather-sum
GATHER_SUM_STATIC = Kernel("gather_sum_static.cu", "gather_sum_static", _STATIC_ARGS)
#: kernel 2.4, the weighted gather-sum on sample-major weights
BATCHED_GATHER_SUM = Kernel("batched_gather_sum.cu", "batched_gather_sum", _STATIC_ARGS)
#: kernel 2.4's slot-major entry: the [N, K, B] -> [B, N, K] weight copy
SLOT_TRANSPOSE = Kernel("batched_gather_sum.cu", "slot_transpose", _TRANSPOSE_ARGS)
#: kernels 2.5 (``sched="v6"``) and 2.8 (``"v5"``): one CUDA function,
#: counted per schedule
ELL_VALID_SUM = {
    s: Kernel("gather_sum_static.cu", "ell_valid_sum", _VALID_ARGS) for s in ("v6", "v5")
}
#: kernels 2.6 (``sched="v3"``) and 2.7 (``"fused"``): one CUDA function,
#: counted per schedule
SPMM_ELL_WEIGHTED = {
    s: Kernel("spmm_ell_weighted.cu", "spmm_ell_weighted", _WEIGHTED_ARGS)
    for s in ("v3", "fused")
}
#: kernel 2.9, the all-slot sum: 2.6's static walk, counted apart
SPMM_ELL_ALL_SLOTS = Kernel("spmm_ell_weighted.cu", "spmm_ell_weighted", _WEIGHTED_ARGS)

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


def _vec(feats: torch.Tensor, out: torch.Tensor, f: int) -> int:
    """Elements per lane: 16 bytes' worth where F is a multiple of it and
    both pointers are 16-byte aligned, else 1."""
    vec = 16 // feats.element_size()
    if f % vec or feats.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    return vec


def _prepare(kernel: Kernel, table, feats: torch.Tensor, weights):
    """Device and contiguity checks; the float32 output ``[N, W]``."""
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    tensors = [feats, table.nbr, table.deg] + [t for t in weights if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel.symbol} needs contiguous tensors")
    return torch.empty((table.nbr.shape[0], feats.shape[1]), dtype=torch.float32, device=feats.device)


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
    return _static_launch(GATHER_SUM_STATIC, table, feats, b, post_scale)


def ell_valid_sum(table, feats: torch.Tensor, b: int, *, sched: str = "v6") -> torch.Tensor:
    """``out[v] = sum_{k < deg[v]} feats[nbr[v, k]]``: :func:`gather_sum_static`
    without the output scale, float32 ``[N, B*F]``.

    On a CUDA tensor this launches kernel 2.5 (``sched="v6"``) or 2.8
    (``"v5"``), one CUDA function counted per schedule (or raises); on a
    CPU tensor it runs :func:`gather_sum_static_plain`.
    """
    _check(table, feats, b)
    if sched not in ELL_VALID_SUM:
        raise ValueError(f"ell_valid_sum serves sched 'v6' and 'v5', not {sched!r}")
    if feats.device.type == "cpu":
        return gather_sum_static_plain(table, feats, b)
    return _static_launch(ELL_VALID_SUM[sched], table, feats, b)


def slot_weights(table, edge_weight: torch.Tensor) -> torch.Tensor:
    """``[E, B]`` per-edge weights (indexed by the table's ``eid``) to the
    slot layout ``[N, K, B]``, zero on invalid slots."""
    return edge_weight[table.eid.long()] * table.valid[:, :, None]


def batched_gather_sum_plain(table, feats: torch.Tensor, b: int, w_slot: torch.Tensor) -> torch.Tensor:
    """Kernel 2.4's function in plain PyTorch: a loop over the K slots with
    a select on ``k < deg``; each valid slot adds ``w * x``.  ``w_slot``
    ``[N, K, B]``, or sample-major weights as ``w_sample.permute(1, 2, 0)``."""
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


def slot_transpose_plain(w_slot: torch.Tensor) -> torch.Tensor:
    """:func:`slot_transpose` in plain PyTorch."""
    return w_slot.permute(2, 0, 1).contiguous()


def slot_transpose(w_slot: torch.Tensor) -> torch.Tensor:
    """Slot-major weights ``[N, K, B]`` float32 to sample-major ``[B, N, K]``
    (a copy).  On a CUDA tensor this launches the tiled transpose of
    ``csrc/batched_gather_sum.cu`` (or raises); on a CPU tensor it runs
    :func:`slot_transpose_plain`."""
    if w_slot.dim() != 3 or w_slot.dtype != torch.float32:
        raise ValueError(f"w_slot must be [N, K, B] float32, got {tuple(w_slot.shape)} {w_slot.dtype}")
    if w_slot.device.type == "cpu":
        return slot_transpose_plain(w_slot)
    if w_slot.device.type != "cuda" or not w_slot.is_contiguous():
        raise ValueError("slot_transpose needs a contiguous CUDA or CPU tensor")
    n, k, b = w_slot.shape
    out = torch.empty((b, n, k), dtype=torch.float32, device=w_slot.device)
    if out.numel():
        with torch.cuda.device(w_slot.device):
            SLOT_TRANSPOSE.launch(w_slot.data_ptr(), out.data_ptr(), n * k, b,
                                  torch.cuda.current_stream(w_slot.device).cuda_stream)
    return out


def batched_gather_sum(
    table,
    edge_weight: Optional[torch.Tensor],
    feats: torch.Tensor,
    b: int,
    w_slot: Optional[torch.Tensor] = None,
    w_sample: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[v, s*F:(s+1)*F] = sum_{k < deg[v]} w[v, k, s] *
    feats[nbr[v, k], s*F:(s+1)*F]`` over a prefix-valid
    :class:`.ell.NeighborTable`; float32 ``[N, B*F]``.

    The weights, float32, zero on invalid slots, in one of three forms:

    * ``w_sample`` ``[B, N, K]``, contiguous: sample-major, as the engine's
      coefficient tensor is made; the kernel reads it as it is;
    * ``w_slot`` ``[N, K, B]``: slot-major, the JAX entry's layout; on the
      card :func:`slot_transpose` makes the sample-major copy first (at
      ``b = 1`` the two layouts are one);
    * neither: built from ``edge_weight`` ``[E, B]`` as :func:`slot_weights`
      does.

    On a CUDA tensor this launches kernel 2.4, the band walk over
    sample-major weights (or raises); on a CPU tensor it runs
    :func:`batched_gather_sum_plain`.  Weights shared by all samples,
    ``w_slot [N, K, 1]`` (or ``edge_weight [E, 1]``) with ``b > 1``, go to
    :func:`spmm_ell_weighted` (kernel 2.6), as the JAX entry falls back to
    its v3 schedule for them; a slot of weight 0 then adds nothing.
    """
    _check(table, feats, b)
    n, k = table.nbr.shape
    if w_sample is not None:
        if w_slot is not None:
            raise ValueError("pass w_slot or w_sample, not both")
        _check_f32("w_sample", w_sample, (b, n, k), feats)
        if feats.device.type == "cpu":
            return batched_gather_sum_plain(table, feats, b, w_sample.permute(1, 2, 0))
        return _static_launch(BATCHED_GATHER_SUM, table, feats, b, w_sample)
    if w_slot is None:
        if edge_weight is None:
            raise ValueError("pass edge_weight, w_slot or w_sample")
        w_slot = slot_weights(table, edge_weight.float())
    if b > 1 and w_slot.dim() == 3 and w_slot.shape[2] == 1:
        return spmm_ell_weighted(table, w_slot, feats, b)
    _check_f32("w_slot", w_slot, (n, k, b), feats)
    if feats.device.type == "cpu":
        return batched_gather_sum_plain(table, feats, b, w_slot)
    w_slot = w_slot.contiguous()
    w_sample = w_slot.view(1, n, k) if b == 1 else slot_transpose(w_slot)
    return _static_launch(BATCHED_GATHER_SUM, table, feats, b, w_sample)


def spmm_ell_weighted_plain(table, w_slot: torch.Tensor, feats: torch.Tensor, b: int) -> torch.Tensor:
    """Kernels 2.6 and 2.7's function in plain PyTorch: a loop over the K
    slots with a select on ``k < deg``.  Static weights ``[N, K]`` multiply
    (each valid slot adds ``w * x``); ``[N, K, wb]`` weights select (a valid
    slot adds ``w * x`` where ``w != 0`` and nothing where ``w == 0``)."""
    n, k = table.nbr.shape
    w = feats.shape[1]
    f = w // b
    deg = table.deg
    static = w_slot.dim() == 2
    w3 = w_slot[:, :, None] if static else w_slot
    out = torch.zeros((n, b, f), dtype=torch.float32, device=feats.device)
    zero = out.new_zeros(())
    for j in range(k):
        wj = w3[:, j, :, None]  # [N, wb, 1]
        take = (deg > j)[:, None, None] if static else (deg > j)[:, None, None] & (wj != 0)
        out += torch.where(take, wj * feats[table.nbr[:, j]].float().view(n, b, f), zero)
    return out.view(n, w)


#: the band walk's block, as in ``csrc/ell_band.cuh``: threads (each
#: warp takes its own work items), the rows of an item at most, and the
#: persistent blocks per SM
BAND_THREADS, BAND_MAX_ROWS, BAND_BLOCKS_PER_SM = 128, 256, 4
#: the slots a warp stages at a time, over the rows of its item
BAND_WARP_STAGE = 512
#: the passes a warp makes over an item's rows (32 / lanes rows a pass)
BAND_PASSES = 16
#: the bytes of each source row a band takes: 64 float32 or 128 bfloat16
#: columns, two 128-byte lines
BAND_BYTES = 256
#: the L2 share one band of all source rows may take (the H100's L2 is
#: 50 MB); above it the band halves, down to one 128-byte line a row
L2_BAND_BUDGET = 32 << 20
_LINE_BYTES = 128


class BandPlan(NamedTuple):
    """The band walk of one call: ``band`` columns a band, ``rows``
    destination rows a work item, ``grid`` persistent blocks, ``items``
    work items (bands x row chunks, numbered band-major)."""

    band: int
    rows: int
    grid: int
    items: int

    @property
    def tile(self) -> int:
        """The slots of a row that a warp stages at a time (``kt``): a row
        of higher degree takes more than one slot tile, and kernel 2.3
        scales it in the last."""
        return BAND_WARP_STAGE // self.rows


def band_plan(
    n: int, w: int, itemsize: int, vec: int, sms: int, band: Optional[int] = None,
    passes: int = BAND_PASSES,
) -> BandPlan:
    """The band walk for ``[n, w]`` features of ``itemsize`` bytes read
    ``vec`` elements a lane, on a card of ``sms`` SMs.  The band is
    :data:`BAND_BYTES` of each row, halved while ``n * band * itemsize``
    exceeds :data:`L2_BAND_BUDGET` (not below one 128-byte line), and no
    wider than ``w`` or 32 lanes of a warp; ``band`` overrides that choice.
    A work item is ``passes`` passes of a warp over its rows, at most
    :data:`BAND_MAX_ROWS`.  A band is a multiple of ``vec``, so every band
    starts 16-byte aligned where ``vec > 1``."""
    if band is None:
        band = BAND_BYTES // itemsize
        while band * itemsize > _LINE_BYTES and n * band * itemsize > L2_BAND_BUDGET:
            band //= 2
        band = min(band, 32 * vec)
    band = min(band, max(w, vec))
    lanes = band // vec
    if band % vec or not 1 <= lanes <= 32:
        raise ValueError(f"band of {band} columns does not suit {vec}-element lanes")
    rows = min(32 // lanes * passes, BAND_MAX_ROWS)
    items = -(-n // rows) * -(-w // band)
    return BandPlan(band, rows, min(items, sms * BAND_BLOCKS_PER_SM), items)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _weighted_args(table, w_slot, feats, out, b, vec, plan, counter, stream) -> tuple:
    """The C function's arguments, in the order of :data:`_WEIGHTED_ARGS`;
    ``counter`` is the band walk's (None for per-sample weights, which take
    the row schedule and no plan)."""
    n, k = table.nbr.shape
    w = feats.shape[1]
    wb = 1 if w_slot.dim() == 2 else w_slot.shape[2]
    return (
        feats.data_ptr(), _DTYPE_CODE[feats.dtype], table.nbr.data_ptr(), table.deg.data_ptr(),
        w_slot.data_ptr(), out.data_ptr(), n, k, w, w // b, wb, int(w_slot.dim() == 3),
        plan.band, plan.rows, plan.grid, counter, vec, stream,
    )


def uses_band_walk(w_slot: torch.Tensor, b: int) -> bool:
    """Whether kernels 2.6/2.7 run the band walk for these weights: one
    weight per slot (static, or broadcast, or per-sample with b = 1).
    Per-sample weights ``[N, K, B]`` take the row schedule: a band lies in
    one sample and would read one weight per 32-byte sector."""
    return w_slot.dim() == 2 or w_slot.shape[2] == 1 or b == 1


def _plan(feats: torch.Tensor, out: torch.Tensor, b: int, band, passes):
    """(vec, plan) of a band-walk launch that writes ``out``."""
    n, w = out.shape
    vec = _vec(feats, out, w // b)
    sms = _sm_count(feats.device.index)
    return vec, band_plan(n, w, feats.element_size(), vec, sms, band, passes)


def _static_args(kernel: Kernel, table, feats, out, b, operand, vec, plan, counter,
                 stream) -> tuple:
    """The C function's arguments, in the order of ``kernel.argtypes``:
    :data:`_STATIC_ARGS` (``gather_sum_static``, whose ``operand`` is
    ``post_scale`` or None for a null pointer; ``batched_gather_sum``, whose
    ``operand`` is ``w_bnk``) or :data:`_VALID_ARGS` (``ell_valid_sum``,
    which takes neither)."""
    n, k = table.nbr.shape
    w = feats.shape[1]
    scale = (None if operand is None else operand.data_ptr(),)
    return (
        feats.data_ptr(), _DTYPE_CODE[feats.dtype], table.nbr.data_ptr(), table.deg.data_ptr(),
        *(scale if kernel.argtypes is _STATIC_ARGS else ()),
        out.data_ptr(), n, k, w, w // b, plan.band, plan.rows, plan.grid, counter, vec, stream,
    )


def _static_launch(kernel: Kernel, table, feats, b: int, operand=None, band=None,
                   passes=BAND_PASSES):
    """Launch kernel 2.3 (``operand``: ``post_scale`` or None), 2.4
    (``w_bnk``), 2.5 or 2.8 on CUDA tensors: the band walk; ``band`` and
    ``passes`` override :func:`band_plan`'s choice."""
    out = _prepare(kernel, table, feats, (operand,))
    n, w = out.shape
    if n == 0 or w == 0:
        return out
    vec, plan = _plan(feats, out, b, band, passes)
    dev = feats.device
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernel.launch(*_static_args(
            kernel, table, feats, out, b, operand, vec, plan, counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        ))
    return out


def _weighted_launch(kernel: Kernel, table, w_slot, feats, b: int, band=None, passes=BAND_PASSES):
    """Launch kernels 2.6/2.7 on CUDA tensors; ``band`` and ``passes``
    override :func:`band_plan`'s choice for the band walk."""
    out = _prepare(kernel, table, feats, (w_slot,))
    n, w = out.shape
    if n == 0 or w == 0:
        return out
    vec, plan = _plan(feats, out, b, band, passes)
    dev = feats.device
    counter = torch.zeros(1, dtype=torch.int32, device=dev) if uses_band_walk(w_slot, b) else None
    with torch.cuda.device(dev):
        kernel.launch(*_weighted_args(
            table, w_slot, feats, out, b, vec, plan, None if counter is None else counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        ))
    return out


def spmm_ell_weighted(
    table, w_slot: torch.Tensor, feats: torch.Tensor, b: int, *, sched: str = "v3"
) -> torch.Tensor:
    """``out[v, s*F:(s+1)*F] = sum_{k < deg[v]} w[v, k, s] *
    feats[nbr[v, k], s*F:(s+1)*F]`` over a prefix-valid
    :class:`.ell.NeighborTable`; float32 ``[N, B*F]``.

    ``w_slot`` float32: static ``[N, K]`` (one weight per slot, multiplied),
    or ``[N, K, wb]`` with ``wb`` 1 (broadcast over the samples) or ``b``
    (per sample), selected: a slot of weight 0 adds nothing, even where its
    source row holds NaN.  On a CUDA tensor this launches kernel 2.6
    (``sched="v3"``) or 2.7 (``"fused"``), one CUDA function counted per
    schedule (or raises); on a CPU tensor it runs
    :func:`spmm_ell_weighted_plain`.
    """
    _check(table, feats, b)
    if sched not in SPMM_ELL_WEIGHTED:
        raise ValueError(f"spmm_ell_weighted serves sched 'v3' and 'fused', not {sched!r}")
    n, k = table.nbr.shape
    wb = 1 if w_slot.dim() == 2 else w_slot.shape[-1]
    if wb not in (1, b):
        raise ValueError(f"w_slot has {wb} weights per slot; expected 1 or b={b}")
    _check_f32("w_slot", w_slot, (n, k) if w_slot.dim() == 2 else (n, k, wb), feats)
    if feats.device.type == "cpu":
        return spmm_ell_weighted_plain(table, w_slot, feats, b)
    return _weighted_launch(SPMM_ELL_WEIGHTED[sched], table, w_slot, feats, b)


def all_slots_table(nbr: torch.Tensor):
    """A :class:`.ell.NeighborTable` over ``nbr [N, K]`` int32 whose every
    slot is valid (``deg = K`` on every row), for :func:`spmm_ell_all_slots`.
    Its degrees are checked on the host at first use, so build it once for
    many calls on the same ``nbr``."""
    n, k = nbr.shape
    ones = torch.ones((), dtype=torch.float32, device=nbr.device).expand(n, k)
    zeros = torch.zeros((), dtype=torch.int32, device=nbr.device).expand(n, k)
    return NeighborTable(nbr=nbr, valid=ones, eid=zeros)


def spmm_ell_all_slots(
    nbr: torch.Tensor, wk: torch.Tensor, x: torch.Tensor, *, table=None
) -> torch.Tensor:
    """``out[v] = sum over all K slots of wk[v, k] * x[nbr[v, k]]``, float32
    ``[N, F]``: the function of the JAX package's ELL prototype
    (``benchmarks/exp_spmm_pallas_proto.py::make_pallas_ell``), whose padded
    slots carry ``nbr = 0, wk = 0`` and are summed like the others.

    ``nbr [N, K]`` int32, ``wk [N, K]`` float32, ``x [N_src, F]`` float32 or
    bfloat16; ``table`` is :func:`all_slots_table` of ``nbr`` (built here
    when None).  On a CUDA tensor this launches kernel 2.6's static walk,
    counted as kernel 2.9 (or raises); on a CPU tensor it runs
    :func:`spmm_ell_weighted_plain`.
    """
    if table is None:
        table = all_slots_table(nbr)
    elif table.nbr is not nbr:
        raise ValueError("table is not all_slots_table(nbr)")
    _check(table, x, 1)
    _check_f32("wk", wk, tuple(nbr.shape), x)
    if x.device.type == "cpu":
        return spmm_ell_weighted_plain(table, wk, x, 1)
    return _weighted_launch(SPMM_ELL_ALL_SLOTS, table, wk, x, 1)


#: the schedules of the JAX package's ``spmm_ell_pallas``
SCHEDS = ("v3", "fused", "v5", "v6", "v7")


def spmm_ell(
    table,
    w_slot: torch.Tensor,
    feats: torch.Tensor,
    b: int = 1,
    *,
    sched: str = "v3",
    post_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ELL SpMM entry, ``out[v] = sum_k w[v, k] * feats[nbr[v, k]]``:
    the JAX package's ``spmm_ell_pallas`` with the table in place of its
    DMA plan.  Float32 ``[N, B*F]``.

    ``w_slot`` is static ``[N, K]`` or weighted ``[N, K, wb]``; the routes:

    * ``"v7"``: static weights to kernel 2.3 (:func:`gather_sum_static`, with
      ``post_scale``), weighted ones to kernel 2.4
      (:func:`batched_gather_sum`), ``wb == b`` only;
    * ``"v6"``, ``"v5"``: static weights to kernels 2.5 and 2.8
      (:func:`ell_valid_sum`); weighted ones are refused;
    * ``"v3"``, ``"fused"``: both modes to kernels 2.6 and 2.7
      (:func:`spmm_ell_weighted`), ``wb`` 1 or ``b``.

    For v5, v6 and v7 static weights must be the table's validity (checked
    on the host); the kernels take the valid-prefix length ``deg`` instead.
    ``post_scale [N, B]`` is fused by v7 only and refused elsewhere (the JAX
    entry ignores it there).  On CUDA tensors each route launches its
    kernel or raises; on CPU tensors it runs the kernel's plain version.
    """
    if sched not in SCHEDS:
        raise ValueError(f"unknown sched {sched!r}; one of {SCHEDS}")
    if post_scale is not None and sched != "v7":
        raise ValueError(f"sched={sched!r} takes no post_scale (only 'v7' fuses it)")
    if w_slot.dim() == 2:
        if sched in ("v3", "fused"):
            return spmm_ell_weighted(table, w_slot, feats, b, sched=sched)
        _check_f32("w_slot", w_slot, tuple(table.valid.shape), table.valid)
        if w_slot is not table.valid and not torch.equal(w_slot, table.valid):
            raise ValueError(f"sched={sched!r} takes the table's validity as static weights")
        if sched == "v7":
            return gather_sum_static(table, feats, b, post_scale)
        return ell_valid_sum(table, feats, b, sched=sched)
    if w_slot.dim() != 3:
        raise ValueError(f"w_slot must be [N, K] or [N, K, wb], got {tuple(w_slot.shape)}")
    if sched in ("v5", "v6"):
        raise ValueError(f"sched={sched!r} serves the static mode only")
    if sched == "v7":
        if w_slot.shape[2] != b:
            raise ValueError(
                f"sched='v7' weighted mode needs per-sample weights (wb={w_slot.shape[2]} != b={b})"
            )
        return batched_gather_sum(table, None, feats, b, w_slot=w_slot)
    return spmm_ell_weighted(table, w_slot, feats, b, sched=sched)
