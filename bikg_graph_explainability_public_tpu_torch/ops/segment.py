"""Segment / scatter primitives for neighbourhood aggregation (the
torch-scatter role), over the leading axis of ``data``."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment mean (empty segments give 0)."""
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    cnt = torch.clamp(cnt, min=1)
    return s / cnt.reshape((-1,) + (1,) * (data.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max (empty segments give -inf)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), float("-inf"))
    idx = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)


def segment_softmax(
    logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Numerically stable softmax within segments (PyG ``softmax(alpha, index)``)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[segment_ids])
    denom = segment_sum(ex, segment_ids, num_segments)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return ex / denom[segment_ids]


def scatter_or(mask_updates: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
    """Boolean scatter-OR: out[index[i]] |= mask_updates[i]."""
    out = torch.zeros(size, dtype=torch.int32, device=mask_updates.device)
    out.scatter_reduce_(0, index, mask_updates.to(torch.int32), reduce="amax")
    return out.to(torch.bool)
