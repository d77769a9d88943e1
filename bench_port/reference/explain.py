"""The plain reference of an explanation: subgraph, masks, the model's
perturbed outputs, KernelSHAP weights and the surrogate's Adam fit.

Plain PyTorch and numpy in float32, with nothing of the program under test:
the subgraph comes from :mod:`bench_port.graphgen`'s breadth-first search,
every draw from :mod:`.prng` (a frozen copy of the keys the program
derives), the forwards from the configuration's family module
(:mod:`.gcn`, :mod:`.hetero_gcn`), which compute the query row of a GCN by
``index_add_`` over masked edge weights.

Departures from the reference library, each also the program's:

* The KernelSHAP weight is computed in log space with ``lgamma`` and
  max-normalised over a query's rows (the library builds the binomial
  directly, and approximates it above 1000 elements); the loss is
  invariant to the scale.
* The surrogate keeps the weights after the step of the epoch whose loss
  was lowest (the library keeps a lazy ``parameters()`` generator, which
  ends up as the last epoch's weights).
* Rows are cut to ``epochs`` equal batches, the shuffled remainder dropped
  (the library's data loader keeps a ragged last batch).
* Masks come from counter-based keys (threefry and Philox), not from
  torch's global generator.

The control, the precision below the float32 the configurations state, is
the same reference in TF32: every product's operands rounded to TF32's
10-bit mantissa and accumulated in float32, as a tensor core takes them
(the first layer's ``X W``, each message of the aggregation, the head, the
surrogate's products).  It is emulated on every device, so that it does not
hang on which shapes cuBLAS would give to its tensor cores.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

from . import prng


class Sub(NamedTuple):
    """A query's computational subgraph: ``nodes`` (sorted parent ids),
    local ``snd`` / ``rcv`` / ``etype`` of its induced edges in the parent's
    edge order, and the query's local index."""

    nodes: np.ndarray
    snd: np.ndarray
    rcv: np.ndarray
    etype: np.ndarray
    query: int


def subgraph(nodes: np.ndarray, edges: np.ndarray, etype: np.ndarray, query: int) -> Sub:
    """The subgraph induced on ``nodes`` (sorted), relabelled in ascending
    parent order."""
    loc = np.full(int(max(edges.max(initial=0), nodes.max(initial=0))) + 1, -1, np.int64)
    loc[nodes] = np.arange(nodes.size)
    keep = (loc[edges[0]] >= 0) & (loc[edges[1]] >= 0)
    return Sub(nodes=nodes, snd=loc[edges[0][keep]], rcv=loc[edges[1][keep]],
               etype=etype[keep], query=int(loc[query]))


def pow2(n: int, minimum: int = 8) -> int:
    """The padded width of ``n`` elements: the next power of two, at least
    ``minimum``."""
    return max(minimum, 1 << max(int(n) - 1, 0).bit_length())


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), as a float32 tensor."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


class Precision:
    """The precision of the reference's products: float32, or TF32 for the
    control."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand as this precision holds it."""
        return _round_tf32(t) if self.tf32 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in this precision, accumulated in float32."""
        return self.operand(a) @ self.operand(b)

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """cuBLAS in true float32 (TF32 off) while the reference runs, set
        back after."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class MatmulWithGrad(torch.autograd.Function):
    """``a @ b`` whose backward products are in the same precision."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return prec.mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return ctx.prec.mm(g, b.transpose(-1, -2)), ctx.prec.mm(a.transpose(-1, -2), g), None


# ---------------------------------------------------------------------------
# KernelSHAP weights and the surrogate
# ---------------------------------------------------------------------------


def kernel_weights(masks: torch.Tensor, n: int) -> torch.Tensor:
    """KernelSHAP weight of each row of ``masks [R, W]`` (bool, ``n`` valid
    columns): ``n' / (C(n'+1, k) (n'+1-k) k)`` with ``n' = n - 1`` and
    ``k`` the row's ones, 0 where ``k`` is 0 or above ``n'``; divided by
    the largest over the rows."""
    k = masks.sum(-1).to(torch.float32)
    nn_ = torch.tensor(float(n - 1), dtype=torch.float32, device=masks.device)
    log_binom = torch.lgamma(nn_ + 2.0) - torch.lgamma(k + 1.0) - torch.lgamma(nn_ + 2.0 - k)
    logw = (torch.log(nn_) - log_binom - torch.log(torch.clamp(nn_ + 1.0 - k, min=1e-30))
            - torch.log(torch.clamp(k, min=1e-30)))
    valid = (k >= 1.0) & (k <= nn_)
    top = torch.where(valid, logw, torch.full_like(logw, -1e30)).max()
    return torch.where(valid, torch.exp(logw - top), torch.zeros_like(logw))


def fit(x: torch.Tensor, y: torch.Tensor, kern: torch.Tensor, w0: torch.Tensor, epochs: int,
        lr: float, l1: float, wd: float, prec: Precision) -> torch.Tensor:
    """Adam on the weighted linear surrogate ``pred = x @ w``, one batch an
    epoch: ``x [epochs * bs, n]`` float, ``y`` and ``kern [epochs * bs]``,
    ``w0 [n]``.  The loss is ``mean(k (pred - y)^2) / sum(k) + l1 *
    mean(|w|)``, Adam with ``weight_decay`` ``wd`` (torch's, added to the
    gradient).  Returns the weights after the step of the epoch whose loss
    was lowest."""
    bs = x.shape[0] // epochs
    xb = x.reshape(epochs, bs, -1)
    yb, kb = y.reshape(epochs, bs), kern.reshape(epochs, bs)
    w = w0.clone().reshape(-1, 1).requires_grad_(True)
    opt = torch.optim.Adam([w], lr=lr, weight_decay=wd, foreach=False)
    best, best_loss = w0.clone(), math.inf
    for e in range(epochs):
        pred = MatmulWithGrad.apply(xb[e], w, prec)[:, 0]
        r = pred - yb[e]
        loss = (kb[e] * r * r).mean() / kb[e].sum() + l1 * w.abs().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        val = float(loss.detach())
        if val < best_loss:
            best_loss = val
            best = w.detach()[:, 0].clone()
    return best


# ---------------------------------------------------------------------------
# the two entries' explanations
# ---------------------------------------------------------------------------


def _outputs(family, params, x: torch.Tensor, sub: Sub, masks: torch.Tensor,
             prec: Precision, rows_per_chunk: int) -> torch.Tensor:
    """The model's query output for every mask row ``masks [R, n]``."""
    outs = [family.query_outputs(params, x, sub, m.to(torch.float32), prec)
            for m in masks.split(rows_per_chunk)]
    return torch.cat(outs)


def _chunk_rows(n_edges: int) -> int:
    """Mask rows a forward chunk, so that ``[rows, E]`` stays near 2**26."""
    return int(max(1, min(250, (1 << 26) // max(n_edges, 1))))


def explain_many_shapley(family, params, x_all: torch.Tensor, sub: Sub, cfg: dict,
                         position: int, times: int, prec: Precision) -> torch.Tensor:
    """One query's mean element scores over ``times`` repeats as
    ``explain_many`` defines them in Shapley mode: repeat ``t``'s key is
    ``fold_in(fold_in(PRNGKey(seed), t), position)`` (``position``: the
    query's place in its call's list); its masks ``bernoulli(fold_in(key,
    0), 0.5, (samples * epochs, width))`` on the first ``n`` columns, rows
    in draw order; its initialisation ``U(-1, 1)`` from ``fold_in(key, 1)``
    over ``sqrt(n)``."""
    dev = x_all.device
    n = sub.nodes.size
    width = pow2(n)
    epochs = int(cfg["epochs"])
    n_masks = int(cfg["interpret_samples"]) * epochs
    x = x_all[torch.as_tensor(sub.nodes, device=dev)]
    scores = []
    with prec.active():
        for t in range(times):
            key = prng.fold_in(prng.fold_in(prng.root_key(int(cfg.get("seed", 0))), t), position)
            keys = torch.tensor(key.astype(np.int64)[None], device=dev)
            masks = prng.bernoulli_tensor(prng.fold_in_tensor(keys, 0), 0.5, n_masks,
                                          width)[0, :, :n]
            w0 = (prng.uniform_tensor(prng.fold_in_tensor(keys, 1), width, -1.0, 1.0)[0, :n]
                  * torch.rsqrt(torch.tensor(float(n), device=dev)))
            y = _outputs(family, params, x, sub, masks, prec, _chunk_rows(sub.snd.size))
            kern = kernel_weights(masks, n)
            scores.append(fit(masks.to(torch.float32), y, kern, w0, epochs,
                              float(abs(cfg.get("lr", 0.01))), float(cfg.get("l1_lambda", 1e-4)),
                              float(cfg.get("weight_decay", 1e-2)), prec))
    return torch.stack(scores).mean(0)


def _philox_streams(key: np.ndarray, count: int):
    """``count`` numpy Philox generators from one key's words."""
    words = np.asarray(key).astype(np.uint64).ravel()
    k0, k1 = int(words[0]), int(words[-1])
    golden = 0x9E3779B97F4A7C15
    return [np.random.Generator(np.random.Philox(key=np.array(
        [k0, (k1 ^ (golden * (i + 1))) & 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)))
        for i in range(count)]


def run_shapley_masks(key: np.ndarray, n: int, width: int, total: int, epochs: int) -> np.ndarray:
    """``Explainer.run``'s Shapley masks of one repeat: ``total`` rows of
    fair coins over ``width`` columns (columns from ``n`` on False) from the
    first Philox stream of ``key``, shuffled by a permutation from the
    second, cut to ``epochs`` equal batches."""
    rng_mask, rng_perm = _philox_streams(key, 2)
    bits = rng_mask.random((total, width), dtype=np.float32) < 0.5
    bits[:, n:] = False
    bits = bits[rng_perm.permutation(total)]
    bs = max(total // epochs, 1)
    return bits[: bs * min(epochs, total)]


def explain_run_shapley(family, params, x_all: torch.Tensor, sub: Sub, cfg: dict, times: int,
                        prec: Precision) -> torch.Tensor:
    """One query's mean element scores over ``times`` repeats as
    ``Explainer.run`` defines them in Shapley mode: repeat ``t``'s keys are
    ``split(fold_in(PRNGKey(seed), t))`` (masks from the first, the
    initialisation ``U(-1/sqrt(n), 1/sqrt(n))`` from the second)."""
    dev = x_all.device
    n = sub.nodes.size
    width = pow2(n)
    epochs = int(cfg["epochs"])
    total = abs(int(cfg["interpret_samples"])) * abs(epochs)
    kd = prng.repeat_split_key_data(int(cfg.get("seed", 0)), times)
    x = x_all[torch.as_tensor(sub.nodes, device=dev)]
    limit = math.sqrt(1.0 / max(n, 1))
    scores = []
    with prec.active():
        for t in range(times):
            masks = torch.as_tensor(run_shapley_masks(kd[t, 0], n, width, total, epochs)[:, :n],
                                    device=dev)
            y = _outputs(family, params, x, sub, masks, prec, _chunk_rows(sub.snd.size))
            kern = kernel_weights(masks, n)
            w0 = torch.as_tensor(prng.uniform(kd[t, 1], width, -limit, limit)[:n], device=dev)
            scores.append(fit(masks.to(torch.float32), y, kern, w0, min(epochs, total),
                              float(abs(cfg.get("lr", 0.01))), float(cfg.get("l1_lambda", 1e-4)),
                              float(cfg.get("weight_decay", 1e-2)), prec))
    return torch.stack(scores).mean(0)


def gaps(program: np.ndarray, reference: np.ndarray) -> Tuple[float, float, float]:
    """The median, the 99th percentile and the widest of the gaps between a
    query's program and reference scores, each as a share of the median
    reference score's size (inf where the program's are not finite or not
    as many)."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if program.shape != reference.shape or not np.isfinite(program).all():
        return math.inf, math.inf, math.inf
    scale = max(float(np.median(np.abs(reference))), 1e-30)
    gap = np.abs(program - reference) / scale
    return float(np.median(gap)), float(np.quantile(gap, 0.99)), float(gap.max())
