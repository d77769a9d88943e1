"""The fused dense masked GCN layers: hand-written CUDA kernels for Hopper
(``csrc/masked_gcn_layer.cu``) and their plain PyTorch versions.

For a batch of mask scalings ``s_b = m_b * deg_b^-1/2`` over one dense
adjacency ``A`` (bf16; edge multiplicities are exact in it),

    H[b] = act( s_b . (A @ bf16(s_b . XW_b)) + self_w_b . XW_b + bias )

with float32 accumulation.  :func:`masked_gcn_layer` takes one batch-shared
``XW [N, C]`` (kernel 2.1); :func:`masked_gcn_layer_batched` takes
per-sample ``h [B, N, C_in]`` and ``w_t [C_in, C]`` and computes
``XW_b = h_b @ W`` in float32 itself (kernel 2.2: a hand-written transform,
then the same aggregation).  The signatures and layouts are the JAX
package's ``ops/pallas_gcn.py``; its TPU padding is not carried over.

Each wrapper launches its kernel for tensors on the card and runs the plain
version for tensors on the CPU; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import Kernel

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (adj, xw, s, self_w, bias, out, n, c, b, per_sample, relu, avec, stream)
_AGG_ARGS = [_p, _p, _p, _p, _p, _p, _i64, _i64, _i64, _i, _i, _i, _p]

#: kernel 2.1, the layer with a batch-shared operand
MASKED_GCN_LAYER = Kernel("masked_gcn_layer.cu", "masked_gcn_agg", _AGG_ARGS)
#: kernel 2.2, the layer with per-sample operands (counted at its
#: aggregation launch; its transform launch is counted in TRANSFORM)
MASKED_GCN_LAYER_BATCHED = Kernel("masked_gcn_layer.cu", "masked_gcn_agg", _AGG_ARGS)
#: kernel 2.2's first launch, ``XW_b = h_b @ W`` in float32
TRANSFORM = Kernel(
    "masked_gcn_layer.cu", "batched_transform", [_p, _p, _p, _i64, _i64, _i64, _p]
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


def _aggregate(kernel, adj, xw, s, self_w, bias, apply_relu, per_sample):
    tensors = [adj, xw, s, self_w] + ([bias] if bias is not None else [])
    _need(all(t.is_contiguous() for t in tensors), f"{kernel.symbol} needs contiguous tensors")
    b, n = s.shape
    c = xw.shape[-1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=s.device)
    if b == 0 or n == 0 or c == 0:
        return out
    avec = int(n % 8 == 0 and adj.data_ptr() % 16 == 0)
    with torch.cuda.device(s.device):
        kernel.launch(
            adj.data_ptr(), xw.data_ptr(), s.data_ptr(), self_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            n, c, b, int(per_sample), int(bool(apply_relu)), avec,
            torch.cuda.current_stream(s.device).cuda_stream,
        )
    return out


def masked_gcn_layer(
    adj_bf16: torch.Tensor,  # [N, N] bf16
    xw: torch.Tensor,  # [N, C] f32 (batch-shared operand)
    s: torch.Tensor,  # [B, N] f32
    self_w: torch.Tensor,  # [B, N] f32
    bias: Optional[torch.Tensor],  # [C] f32, or None
    apply_relu: bool = True,
) -> torch.Tensor:  # [B, N, C] f32
    """Fused masked GCN layer with a batch-shared operand: kernel 2.1 on a
    CUDA tensor (or raises), :func:`masked_gcn_layer_plain` on the CPU."""
    n = adj_bf16.shape[0]
    _need(xw.dim() == 2 and xw.shape[0] == n and xw.dtype == torch.float32,
          f"xw must be [{n}, C] float32, got {tuple(xw.shape)} {xw.dtype}")
    _check(adj_bf16, s, self_w, bias, xw.shape[1], xw.device)
    if xw.device.type == "cpu":
        return masked_gcn_layer_plain(adj_bf16, xw, s, self_w, bias, apply_relu)
    _need(xw.device.type == "cuda", f"unsupported device {xw.device}")
    return _aggregate(MASKED_GCN_LAYER, adj_bf16, xw, s, self_w, bias, apply_relu, False)


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
    kernel 2.2 on a CUDA tensor (two launches: the float32 transform, then
    the aggregation; or raises), :func:`masked_gcn_layer_batched_plain` on
    the CPU."""
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
    _need(h.is_contiguous() and w_t.is_contiguous(), "batched_transform needs contiguous tensors")
    c_in, c = w_t.shape
    hw = torch.empty((b, n, c), dtype=torch.float32, device=h.device)
    if b * n and c:
        with torch.cuda.device(h.device):
            TRANSFORM.launch(
                h.data_ptr(), w_t.data_ptr(), hw.data_ptr(), b * n, c_in, c,
                torch.cuda.current_stream(h.device).cuda_stream,
            )
    return _aggregate(MASKED_GCN_LAYER_BATCHED, adj_bf16, hw, s, self_w, bias, apply_relu, True)
