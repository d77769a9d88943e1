"""Plain reference forward of the ``gcn`` family: ``GCNConv`` layers with
ReLU, then the fully connected head and a sigmoid (PyG's ``GCNConv``:
``D^-1/2 (A + I) D^-1/2 X W^T + b``, data self-loops replaced by one unit
self-loop a node), on node masks: edge ``u -> v`` weighs ``m[u] * m[v]``.

Parameters are a dict of tensors under the names ``conv.<l>.weight``
``[out, in]``, ``conv.<l>.bias``, ``fc.<i>.weight``, ``fc.<i>.bias``.
"""

from __future__ import annotations

import torch

from .explain import Precision, Sub


def conv_scales(w: torch.Tensor, snd: torch.Tensor, rcv: torch.Tensor, n: int):
    """``(norm [B, E], self_w [B, n])`` of GCN normalisation for edge
    weights ``w [B, E]`` (self-loop edges already weigh 0)."""
    deg = torch.ones(w.shape[0], n, dtype=w.dtype, device=w.device).index_add_(1, rcv, w)
    dis = torch.rsqrt(deg)
    return dis[:, snd] * w * dis[:, rcv], 1.0 / deg


def aggregate(norm, self_w, hw, snd, rcv, prec: Precision, rows=None):
    """``sum_e norm[:, e] hw[:, snd_e]`` into each receiver, plus the
    self-loop term, each product's operands in ``prec``: every node ``[B,
    n, C]``, or the query row ``[B, C]`` where ``rows`` is that row's
    index."""
    norm, self_w, hw = prec.operand(norm), prec.operand(self_w), prec.operand(hw)
    if rows is not None:
        sel = rcv == rows
        msg = norm[:, sel, None] * hw[:, snd[sel]]
        return msg.sum(1) + self_w[:, rows, None] * hw[:, rows]
    out = self_w[..., None] * hw
    return out.index_add_(1, rcv, norm[..., None] * hw[:, snd])


def head(params: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The fully connected head and the sigmoid on ``[B, C]`` rows."""
    i = 0
    while f"fc.{i}.weight" in params:
        h = prec.mm(h, params[f"fc.{i}.weight"].T) + params[f"fc.{i}.bias"]
        i += 1
        h = torch.relu(h) if f"fc.{i}.weight" in params else torch.sigmoid(h)
    return h[:, 0]


def edge_weights(m: torch.Tensor, snd: torch.Tensor, rcv: torch.Tensor) -> torch.Tensor:
    """Node masks ``m [B, n]`` as edge weights, self-loop edges at 0."""
    return m[:, snd] * m[:, rcv] * (snd != rcv).to(m.dtype)


def query_outputs(params: dict, x: torch.Tensor, sub: Sub, m: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """The model's output at the query for each node mask ``m [B, n]``."""
    dev = x.device
    snd = torch.as_tensor(sub.snd, device=dev)
    rcv = torch.as_tensor(sub.rcv, device=dev)
    n = x.shape[0]
    norm, self_w = conv_scales(edge_weights(m, snd, rcv), snd, rcv, n)
    layers = sum(1 for k in params if k.startswith("conv.") and k.endswith(".weight"))
    h = None
    for li in range(layers):
        w, b = params[f"conv.{li}.weight"], params[f"conv.{li}.bias"]
        hw = prec.mm(x, w.T)[None].expand(m.shape[0], -1, -1) if li == 0 else prec.mm(h, w.T)
        last = li == layers - 1
        h = torch.relu(aggregate(norm, self_w, hw, snd, rcv, prec, sub.query if last else None) + b)
    return head(params, h, prec)
