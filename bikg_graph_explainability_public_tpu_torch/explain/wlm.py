"""Weighted linear regression surrogate (the explanation engine).

Reference: ``src/pathway_explanations/wlm.py`` (L5).  The phases are
decoupled: all perturbed black-box outputs are computed up front by the
batched masked forward (:meth:`..models.adapter.Model.perturbed_query_outputs`),
the KernelSHAP weights of every row come from one kernel call, and the
surrogate is trained over [epochs, batch, S] tensors for all repeats at
once.

Numerics follow the reference: loss = ``mean(k*(pred-y)^2)/k.sum() +
l1*mean(|w|)`` (``wlm.py:491-520``, ``101-129``), Adam(lr,
weight_decay=1e-2) with torch's update order (``wlm.py:477-478``), and a
single bias-free linear map (``wlm.py:17-61``).  The gradient and the Adam
step are written out as the JAX package computes them.  Reference bug fixed
by design: the reference snapshots a lazy ``parameters()`` generator as
"best parameters" (``wlm.py:94``); here the best-loss weights are kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import prng, profiling
from .kernels import shap_kernel


class TrainResult(NamedTuple):
    """Surrogate training output: weights, per-epoch losses, best epoch."""
    weights: torch.Tensor  # [S] best-loss surrogate coefficients
    losses: torch.Tensor  # [epochs]
    best_epoch: torch.Tensor  # scalar int


def init_surrogate_weights(key: np.ndarray, width: int, num_valid: int) -> torch.Tensor:
    """torch ``nn.Linear(num_elements, 1, bias=False)`` init: U(-1/sqrt(n),
    1/sqrt(n)) (``wlm.py:45``), drawn from the key data ``key`` as
    ``jax.random.uniform`` draws it; padding columns start (and stay) at
    zero."""
    limit = math.sqrt(1.0 / max(num_valid, 1))
    w = prng.uniform(key, width, -limit, limit)
    return torch.from_numpy(w * (np.arange(width) < num_valid).astype(np.float32))


def train_surrogate(
    w0: torch.Tensor,  # [T, S]
    masks: torch.Tensor,  # [T, epochs, batch, S] float32
    outputs: torch.Tensor,  # [T, epochs, batch]
    kernels: torch.Tensor,  # [T, epochs, batch]
    num_valid: int,
    lr: float = 0.01,
    l1_lambda: float = 1e-4,
    weight_decay: float = 1e-2,
) -> TrainResult:
    """Train T independent weighted linear surrogates with Adam, one step
    per epoch; returns TrainResult with a leading repeat axis."""
    t_rep, epochs, batch, width = masks.shape
    dev = masks.device
    f32 = torch.float32
    col_valid = (torch.arange(width, device=dev) < num_valid).to(f32)
    w = w0.to(dev, f32)
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    best_w = w
    best_loss = torch.full((t_rep,), math.inf, dtype=f32, device=dev)
    step = torch.zeros((), dtype=f32, device=dev)
    b1, b2 = torch.tensor(0.9, dtype=f32, device=dev), torch.tensor(0.999, dtype=f32, device=dev)
    l1_scale = l1_lambda * (1.0 / num_valid)
    losses, improved_all = [], []
    for e in range(epochs):
        mask_b, y_b, k_b = masks[:, e], outputs[:, e], kernels[:, e]
        pred = torch.bmm(mask_b, w[:, :, None])[:, :, 0]  # [T, batch]
        r = pred - y_b
        ksum = torch.clamp(k_b.sum(-1), min=1e-30)  # [T]
        loss = (k_b * r * r).mean(-1) / ksum + l1_lambda * (w.abs() * col_valid).sum(-1) / num_valid
        # d loss / d w, in the order reverse-mode autodiff takes it
        g_pred = (k_b * ((1.0 / ksum) / batch)[:, None]) * (2.0 * r)
        g = torch.bmm(mask_b.transpose(1, 2), g_pred[:, :, None])[:, :, 0]
        g = g + torch.sign(w) * (l1_scale * col_valid)
        g = (g + weight_decay * w) * col_valid  # torch Adam weight_decay
        step = step + 1.0
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - torch.pow(b1, step))
        vhat = v / (1.0 - torch.pow(b2, step))
        w = w - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        improved = loss < best_loss
        best_w = torch.where(improved[:, None], w, best_w)
        best_loss = torch.where(improved, loss, best_loss)
        losses.append(loss)
        improved_all.append(improved)
    losses_t = torch.stack(losses, dim=1)  # [T, epochs]
    idx = torch.arange(epochs, device=dev)
    best_epoch = torch.where(torch.stack(improved_all, dim=1), idx, -1).max(dim=1).values
    return TrainResult(weights=best_w, losses=losses_t, best_epoch=best_epoch)


def _default_chunk(epochs: int, batch_size: int) -> int:
    """Largest whole-epoch multiple of ``batch_size`` that stays <= 512
    rows per forward chunk."""
    c = 1
    for cand in range(epochs, 0, -1):
        if epochs % cand == 0 and cand * batch_size <= 512:
            c = cand
            break
    return c * batch_size


def _fit(masks, model, graph, params, problem, query, num_elements, batch_size,
         init_keys, chunk_size) -> TrainResult:
    """Forwards, kernels and training for masks [T, M, S] bool (numpy) and
    init key data [T, 2]."""
    t, m_used, width = masks.shape
    epochs = m_used // batch_size
    auto_chunk = chunk_size is None
    if chunk_size is None:
        chunk_size = _default_chunk(epochs, batch_size)
    with profiling.span("forwards"):
        masks_t = torch.as_tensor(masks, device=model.device)
        profiling.count("upload_bytes", masks.nbytes)
        # rows are independent: one chunked pass over all repeats' rows
        outputs = model.perturbed_query_outputs(
            graph, masks_t.reshape(t * m_used, width), problem, query,
            chunk_size=chunk_size, auto_chunk=auto_chunk,
        ).reshape(t, epochs, batch_size)
    with profiling.span("fit"):
        # the kernel's max-normalisation stays within each repeat's rows
        kernels = shap_kernel(masks_t, num_valid_columns=num_elements)
        w0 = torch.stack(
            [init_surrogate_weights(k, width, num_elements) for k in init_keys]
        )
        return train_surrogate(
            w0,
            masks_t.to(torch.float32).reshape(t, epochs, batch_size, width),
            outputs,
            kernels.reshape(t, epochs, batch_size),
            num_valid=num_elements,
            lr=float(abs(params.get("lr", 0.01))),
            l1_lambda=float(params.get("l1_lambda", 1e-4)),
            weight_decay=float(params.get("weight_decay", 1e-2)),
        )


def train_model_repeats(
    masks: np.ndarray,
    model,
    graph,
    params: dict,
    problem: str,
    query: Optional[int],
    num_elements: int,
    batch_size: int,
    keys: np.ndarray,
    chunk_size: Optional[int] = None,
) -> TrainResult:
    """All ``times`` repeats of the surrogate fit at once.

    masks: [T, M, S] bool — repeat i's sampled mask rows; keys: [T, 2, 2]
    uint32 key data (init key at [:, 1]).  Returns a TrainResult with
    leading repeat dims: weights [T, S], losses [T, epochs], best_epoch [T].
    """
    return _fit(masks, model, graph, params, problem, query, num_elements,
                batch_size, np.asarray(keys)[:, 1], chunk_size)


def train_model(
    mask: np.ndarray,
    model,
    graph,
    params: dict,
    problem: str,
    query: Optional[int],
    num_elements: int,
    batch_size: int,
    key: np.ndarray,
    chunk_size: Optional[int] = None,
) -> TrainResult:
    """End-to-end surrogate fit for one repeat (reference ``train_model``,
    ``wlm.py:132-278``): mask [M, S] bool with M divisible by
    ``batch_size``; ``key`` is the [2] init key data."""
    r = _fit(mask[None], model, graph, params, problem, query, num_elements,
             batch_size, np.asarray(key)[None], chunk_size)
    return TrainResult(weights=r.weights[0], losses=r.losses[0], best_epoch=r.best_epoch[0])
