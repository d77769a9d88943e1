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
    s_eff = num_valid_columns if num_valid_columns is not None else mask.shape[-1]
    k = mask.sum(dim=-1).to(torch.float32)
    n = torch.tensor(float(s_eff - 1), dtype=torch.float32, device=mask.device)
    logw = (
        torch.log(n)
        - _log_binom(n + 1.0, k)
        - torch.log(torch.clamp(n + 1.0 - k, min=1e-30))
        - torch.log(torch.clamp(k, min=1e-30))
    )
    valid = (k >= 1.0) & (k <= n)
    if normalized:
        safe = torch.where(valid & torch.isfinite(logw), logw, torch.full_like(logw, -1e30))
        logw = logw - safe.max(dim=-1, keepdim=True).values
    w = torch.exp(logw)
    return torch.where(valid, w, torch.zeros_like(w))
