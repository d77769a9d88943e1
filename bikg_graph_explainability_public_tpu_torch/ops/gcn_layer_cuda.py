"""The fused dense masked GCN layers: hand-written CUDA kernels for Hopper
(``csrc/masked_gcn_layer.cu``) and their plain PyTorch versions.

For a batch of mask scalings ``s_b = m_b * deg_b^-1/2`` over one dense
adjacency ``A`` (bf16; edge multiplicities are exact in it),

    H[b] = act( s_b . (A @ bf16(s_b . XW_b)) + self_w_b . XW_b + bias )

with float32 accumulation.  :func:`masked_gcn_layer` takes one batch-shared
``XW [N, C]`` (kernel 2.1); :func:`masked_gcn_layer_batched` takes
per-sample ``h [B, N, C_in]`` and ``w_t [C_in, C]`` and computes
``XW_b = h_b @ W`` in float32 itself (kernel 2.2).  The signatures and
layouts are the JAX package's ``ops/pallas_gcn.py``; its TPU padding is not
carried over.

On the card each layer is two launches.  The first writes the scaled
operand once, K-major: ``S^T [B*C, ld]`` bf16 with row ``b*C + c`` and
column ``u`` (:func:`scaled_operand` for 2.1; 2.2's float32 transform writes
it beside ``hw``).  The second is the TMA + ``wgmma`` aggregation with the
layer's epilogue.  TMA needs row strides that are multiples of 16 bytes,
so ``ld`` is ``N`` rounded up to 8 and, when ``N % 8 != 0``, the wrapper
copies ``A`` into an ``[N, ld]`` buffer (:func:`pad_adjacency`: one
``N * ld`` bf16 copy per call, 2 MB at N = 1000).

Each wrapper launches its kernels for tensors on the card and runs the
plain version for tensors on the CPU; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import Kernel

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (adj, st, xw, s, self_w, bias, out, n, ld, c, b, per_sample, relu, vec, stream)
_AGG_ARGS = [_p, _p, _p, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _i, _i, _p]

#: kernel 2.1, the layer with a batch-shared operand (counted at its
#: aggregation launch; its operand launch is counted in OPERAND)
MASKED_GCN_LAYER = Kernel("masked_gcn_layer.cu", "masked_gcn_agg", _AGG_ARGS)
#: kernel 2.1's first launch, the scaled operand ``S^T`` from ``XW``
OPERAND = Kernel(
    "masked_gcn_layer.cu", "scaled_operand", [_p, _p, _p, _i64, _i64, _i64, _i64, _p]
)
#: kernel 2.2, the layer with per-sample operands (counted at its
#: aggregation launch; its transform launch is counted in TRANSFORM)
MASKED_GCN_LAYER_BATCHED = Kernel("masked_gcn_layer.cu", "masked_gcn_agg", _AGG_ARGS)
#: kernel 2.2's first launch, ``XW_b = h_b @ W`` in float32 and ``S^T``
TRANSFORM = Kernel(
    "masked_gcn_layer.cu", "batched_transform",
    [_p, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i64, _i, _p],
)


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check(adj, s, self_w, bias, c: int, device):
    n = adj.shape[0]
    _need(adj.dim() == 2 and adj.shape == (n, n) and adj.dtype == torch.bfloat16,
          f"adj must be [N, N] bfloat16, got {tuple(adj.shape)} {adj.dtype}")
    _need(s.dim() == 2 and s.shape[1] == n and s.dtype == torch.float32,
          f"s must be [B, {n}] float32, got {tuple(s.shape)} {s.dtype}")
    _need(self_w.shape == s.shape and self_w.dtype == torch.float32,
          f"self_w must be {list(s.shape)} float32")
    _need(bias is None or (tuple(bias.shape) == (c,) and bias.dtype == torch.float32),
          f"bias must be [{c}] float32")
    tensors = [adj, s, self_w] + ([bias] if bias is not None else [])
    _need(all(t.device == device for t in tensors), "all tensors must be on one device")


def _epilogue(agg, s, self_w, xw, bias, apply_relu):
    res = s[:, :, None] * agg + self_w[:, :, None] * xw
    if bias is not None:
        res = res + bias
    return torch.clamp(res, min=0.0) if apply_relu else res


def _aggregate_plain(adj, s, xw):
    """``A @ bf16(s_b . XW_b)`` in float32 ([B, N, C]); the bf16 products
    are exact in float32, so only the summation order is the kernel's own."""
    scaled = (s[:, :, None] * xw).to(torch.bfloat16)
    return torch.matmul(adj.float(), scaled.float())


def masked_gcn_layer_plain(adj_bf16, xw, s, self_w, bias=None, apply_relu=True):
    """Kernel 2.1's function in plain PyTorch."""
    agg = _aggregate_plain(adj_bf16, s, xw[None])
    return _epilogue(agg, s, self_w, xw[None], bias, apply_relu)


def masked_gcn_layer_batched_plain(adj_bf16, h, w_t, s, self_w, bias=None, apply_relu=True):
    """Kernel 2.2's function in plain PyTorch."""
    hw = torch.matmul(h, w_t)
    return _epilogue(_aggregate_plain(adj_bf16, s, hw), s, self_w, hw, bias, apply_relu)


# ---------------------------------------------------------------------------
# the kernels' layouts, in plain PyTorch
# ---------------------------------------------------------------------------


def operand_stride(n: int) -> int:
    """The row stride ``ld`` of ``A`` and ``S^T`` on the card: ``N``
    rounded up to 8 bf16 (16 bytes, TMA's stride unit)."""
    return (n + 7) // 8 * 8


def pad_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """``A [N, N]`` with its rows padded by zeros to ``operand_stride(N)``
    columns; ``A`` itself when ``N % 8 == 0``."""
    n = adj.shape[0]
    ld = operand_stride(n)
    return adj if ld == n else F.pad(adj, (0, ld - n)).contiguous()


def scaled_operand_plain(s: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """The aggregation's operand in the kernels' layout: ``S^T [B*C, ld]``
    bf16, row ``b*C + c``, column ``u``, ``bf16(s[b, u] * XW_b[u, c])``
    rounded to nearest even, zero in the columns ``u >= N``.  ``xw`` is
    ``[N, C]`` (shared) or ``[B, N, C]``."""
    b, n = s.shape
    c = xw.shape[-1]
    scaled = (s[:, :, None] * xw).to(torch.bfloat16)  # [B, N, C]
    st = scaled.permute(0, 2, 1).reshape(b * c, n)
    return F.pad(st, (0, operand_stride(n) - n)).contiguous()


def aggregate_operand_plain(adj_padded: torch.Tensor, st: torch.Tensor, b: int) -> torch.Tensor:
    """``A @ bf16(s_b . XW_b)`` ([B, N, C], float32) from the padded
    adjacency ``[N, ld]`` and ``S^T [B*C, ld]``, as the aggregation kernel
    reads them."""
    n = adj_padded.shape[0]
    agg = torch.matmul(adj_padded.float(), st.float().t())  # [N, B*C]
    return agg.view(n, b, -1).permute(1, 0, 2)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _aligned(*tensors, to: int = 16) -> bool:
    return all(t is None or t.data_ptr() % to == 0 for t in tensors)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def scaled_operand(s: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """Kernel 2.1's operand ``S^T [B*C, ld]`` (see
    :func:`scaled_operand_plain`) from ``s [B, N]`` and the shared
    ``xw [N, C]``, both float32 and contiguous: the operand kernel on a CUDA
    tensor (or raises), the plain version on the CPU."""
    _need(s.dim() == 2 and s.dtype == torch.float32,
          f"s must be [B, N] float32, got {tuple(s.shape)} {s.dtype}")
    b, n = s.shape
    _need(xw.dim() == 2 and xw.shape[0] == n and xw.dtype == torch.float32,
          f"xw must be [{n}, C] float32, got {tuple(xw.shape)} {xw.dtype}")
    _need(s.is_contiguous() and xw.is_contiguous(), "scaled_operand needs contiguous tensors")
    _need(s.device == xw.device, "all tensors must be on one device")
    if xw.device.type == "cpu":
        return scaled_operand_plain(s, xw)
    _need(xw.device.type == "cuda", f"unsupported device {xw.device}")
    c = xw.shape[1]
    ld = operand_stride(n)
    st = torch.empty((b * c, ld), dtype=torch.bfloat16, device=xw.device)
    if st.numel():
        with torch.cuda.device(xw.device):
            OPERAND.launch(xw.data_ptr(), s.data_ptr(), st.data_ptr(), n, c, b, ld,
                           _stream(xw.device))
    return st


def _aggregate(kernel, adj, st, xw, s, self_w, bias, apply_relu, per_sample):
    """The aggregation launch: ``out [B, N, C]`` from ``A``, the operand
    ``st`` and the self term's ``xw``."""
    b, n = s.shape
    c = xw.shape[-1]
    _need(st.dtype == torch.bfloat16 and st.shape == (b * c, operand_stride(n))
          and st.is_contiguous(), "the operand must be a contiguous [B*C, ld] bfloat16")
    out = torch.empty((b, n, c), dtype=torch.float32, device=s.device)
    adj_p = pad_adjacency(adj)
    # the epilogue's grouped path: 32-column groups inside one sample, 8-byte
    # loads and stores
    vec = int(c % 32 == 0 and _aligned(xw, bias, out, to=8))
    with torch.cuda.device(s.device):
        kernel.launch(
            adj_p.data_ptr(), st.data_ptr(), xw.data_ptr(), s.data_ptr(), self_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, adj_p.shape[1], c, b, int(per_sample), int(bool(apply_relu)), vec,
            _stream(s.device),
        )
    return out


def _contiguous(name: str, tensors) -> None:
    _need(all(t is None or t.is_contiguous() for t in tensors), f"{name} needs contiguous tensors")


def masked_gcn_layer(
    adj_bf16: torch.Tensor,  # [N, N] bf16
    xw: torch.Tensor,  # [N, C] f32 (batch-shared operand)
    s: torch.Tensor,  # [B, N] f32
    self_w: torch.Tensor,  # [B, N] f32
    bias: Optional[torch.Tensor],  # [C] f32, or None
    apply_relu: bool = True,
) -> torch.Tensor:  # [B, N, C] f32
    """Fused masked GCN layer with a batch-shared operand: kernel 2.1 on a
    CUDA tensor (two launches: the operand, then the aggregation; or
    raises), :func:`masked_gcn_layer_plain` on the CPU."""
    n = adj_bf16.shape[0]
    _need(xw.dim() == 2 and xw.shape[0] == n and xw.dtype == torch.float32,
          f"xw must be [{n}, C] float32, got {tuple(xw.shape)} {xw.dtype}")
    _check(adj_bf16, s, self_w, bias, xw.shape[1], xw.device)
    if xw.device.type == "cpu":
        return masked_gcn_layer_plain(adj_bf16, xw, s, self_w, bias, apply_relu)
    _need(xw.device.type == "cuda", f"unsupported device {xw.device}")
    _contiguous(MASKED_GCN_LAYER.symbol, [adj_bf16, xw, s, self_w, bias])
    b, c = s.shape[0], xw.shape[1]
    if b == 0 or n == 0 or c == 0:
        return torch.empty((b, n, c), dtype=torch.float32, device=xw.device)
    st = scaled_operand(s, xw)
    return _aggregate(MASKED_GCN_LAYER, adj_bf16, st, xw, s, self_w, bias, apply_relu, False)


def masked_gcn_layer_batched(
    adj_bf16: torch.Tensor,  # [N, N] bf16
    h: torch.Tensor,  # [B, N, C_in] f32 (per-sample features)
    w_t: torch.Tensor,  # [C_in, C] f32 (weight, already transposed)
    s: torch.Tensor,  # [B, N] f32
    self_w: torch.Tensor,  # [B, N] f32
    bias: Optional[torch.Tensor],  # [C] f32, or None
    apply_relu: bool = True,
) -> torch.Tensor:  # [B, N, C] f32
    """Fused masked GCN layer with per-sample operands ``XW_b = h_b @ W``:
    kernel 2.2 on a CUDA tensor (two launches: the float32 transform, which
    also writes the operand, then the aggregation; or raises),
    :func:`masked_gcn_layer_batched_plain` on the CPU."""
    b, n = s.shape
    _need(h.dim() == 3 and h.shape[:2] == (b, n) and h.dtype == torch.float32,
          f"h must be [{b}, {n}, C_in] float32, got {tuple(h.shape)} {h.dtype}")
    _need(w_t.dim() == 2 and w_t.shape[0] == h.shape[2] and w_t.dtype == torch.float32,
          f"w_t must be [{h.shape[2]}, C] float32, got {tuple(w_t.shape)} {w_t.dtype}")
    _check(adj_bf16, s, self_w, bias, w_t.shape[1], h.device)
    _need(w_t.device == h.device, "all tensors must be on one device")
    if h.device.type == "cpu":
        return masked_gcn_layer_batched_plain(adj_bf16, h, w_t, s, self_w, bias, apply_relu)
    _need(h.device.type == "cuda", f"unsupported device {h.device}")
    _contiguous(TRANSFORM.symbol, [adj_bf16, h, w_t, s, self_w, bias])
    c_in, c = w_t.shape
    if b == 0 or n == 0 or c == 0:
        return torch.empty((b, n, c), dtype=torch.float32, device=h.device)
    ld = operand_stride(n)
    hw = torch.empty((b, n, c), dtype=torch.float32, device=h.device)
    st = torch.empty((b * c, ld), dtype=torch.bfloat16, device=h.device)
    vec = int(c_in % 4 == 0 and c % 4 == 0 and _aligned(h, w_t, hw))
    with torch.cuda.device(h.device):
        TRANSFORM.launch(
            h.data_ptr(), w_t.data_ptr(), s.data_ptr(), hw.data_ptr(), st.data_ptr(),
            b, n, c_in, c, ld, vec, _stream(h.device),
        )
    return _aggregate(MASKED_GCN_LAYER_BATCHED, adj_bf16, st, hw, s, self_w, bias, apply_relu, True)
