"""KernelSHAP weighting, computed in log space.

Reference: ``src/pathway_explanations/kernels.py``.  The kernel is
``exp(log-kernel - max(log-kernel))`` with ``lgamma``: the surrogate loss
``mean(w * diff) / w.sum()`` is invariant to scaling ``w`` by a positive
constant, so the max-normalisation changes nothing downstream, and in log
space the binomial never overflows.  Reference quirk kept for parity:
``num_total = S - 1`` where S is the mask width (``kernels.py:146``).
"""

from __future__ import annotations

from typing import Optional

import torch


def _log_binom(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """log C(n, k) via lgamma."""
    return torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)


def log_shap_weights(mask: torch.Tensor, num_valid_columns: Optional[int] = None):
    """``(log-kernel, valid)`` per row of a [..., M, S] boolean mask: the
    unnormalised log KernelSHAP weight and whether the row has one
    (``1 <= k <= S_eff - 1``)."""
    s_eff = num_valid_columns if num_valid_columns is not None else mask.shape[-1]
    k = mask.sum(dim=-1).to(torch.float32)
    n = torch.tensor(float(s_eff - 1), dtype=torch.float32, device=mask.device)
    logw = (
        torch.log(n)
        - _log_binom(n + 1.0, k)
        - torch.log(torch.clamp(n + 1.0 - k, min=1e-30))
        - torch.log(torch.clamp(k, min=1e-30))
    )
    return logw, (k >= 1.0) & (k <= n)


def log_weight_max(logw: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The largest finite valid log weight of each leading index
    ([..., 1]; -1e30 where there is none): :func:`shap_kernel`'s
    normaliser."""
    safe = torch.where(valid & torch.isfinite(logw), logw, torch.full_like(logw, -1e30))
    return safe.max(dim=-1, keepdim=True).values


def shap_kernel(
    mask: torch.Tensor,
    num_valid_columns: Optional[int] = None,
    *,
    normalized: bool = True,
) -> torch.Tensor:
    """Per-row KernelSHAP weight for a [..., M, S] boolean mask (normalised
    over the M rows of each leading index).

    kernel(k) = n / (C(n+1, k) * (n+1-k) * k) with n = S_eff - 1.  Rows with
    k == 0 or k == S_eff get weight 0.  ``num_valid_columns``: actual element
    count S_eff when the mask is padded wider (padding columns False).
    """
    logw, valid = log_shap_weights(mask, num_valid_columns)
    if normalized:
        logw = logw - log_weight_max(logw, valid)
    w = torch.exp(logw)
    return torch.where(valid, w, torch.zeros_like(w))


def approximate_shap_kernel_parity(
    mask: torch.Tensor, num_valid_columns: Optional[int] = None, ref: int = 1000
) -> torch.Tensor:
    """Behavioural-parity port of the reference's >1000-element approximation
    (``kernels.py:22-80``): a scaled C(ref, k*ref/n) lookup, normalised to
    max 1 as :func:`shap_kernel` is.  Kept only so the two weighting schemes
    can be compared; the log-space kernel is exact and is the default."""
    s_eff = num_valid_columns if num_valid_columns is not None else mask.shape[1]
    num_active = mask.sum(dim=1).to(torch.float32)
    num_total = float(s_eff - 1)
    f32 = dict(dtype=torch.float32, device=mask.device)
    idx_grid = torch.arange(ref, **f32)
    log_choose = _log_binom(torch.tensor(float(ref), **f32), idx_grid)
    index = torch.clamp((num_active * 1000.0 / num_total).to(torch.int32), 0, ref - 1)
    total = torch.tensor(num_total, **f32)
    log_kernel = (
        torch.log(total)
        - (log_choose[index.long()] + torch.log(total / 1000.0))
        - torch.log(torch.clamp(num_active, min=1e-30))
        - torch.log(torch.clamp(total - num_active, min=1e-30))
    )
    valid = (num_active >= 1.0) & (num_active <= num_total)
    safe = torch.where(valid & torch.isfinite(log_kernel), log_kernel,
                       torch.full_like(log_kernel, -1e30))
    return torch.where(valid, torch.exp(log_kernel - safe.max()), torch.zeros_like(log_kernel))
