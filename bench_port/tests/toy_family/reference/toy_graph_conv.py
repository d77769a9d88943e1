"""Plain reference forward of the ``toy_graph_conv`` family: each layer
``relu(W_rel sum_{u -> v} w_e h_u + b_rel + W_root h_v)`` (PyG
``GraphConv``), then the fully connected head and a sigmoid, on node
masks: edge ``u -> v`` weighs ``m[u] * m[v]``."""

from __future__ import annotations

import torch

from bench_port.reference.explain import Precision, Sub
from bench_port.reference.gcn import head


def query_outputs(params: dict, x: torch.Tensor, sub: Sub, m: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """The model's output at the query for each node mask ``m [B, n]``."""
    snd = torch.as_tensor(sub.snd, device=x.device)
    rcv = torch.as_tensor(sub.rcv, device=x.device)
    w = m[:, snd] * m[:, rcv]
    layers = sum(1 for k in params if k.endswith(".lin_rel.weight"))
    h = x[None].expand(m.shape[0], -1, -1)
    for li in range(layers):
        w_rel, b_rel = params[f"conv.{li}.lin_rel.weight"], params[f"conv.{li}.lin_rel.bias"]
        w_root = params[f"conv.{li}.lin_root.weight"]
        msg = prec.operand(w)[..., None] * prec.operand(h[:, snd])
        if li == layers - 1:
            agg = msg[:, rcv == sub.query].sum(1)
            h = h[:, sub.query]
        else:
            agg = torch.zeros_like(h).index_add_(1, rcv, msg)
        h = torch.relu(prec.mm(agg, w_rel.T) + b_rel + prec.mm(h, w_root.T))
    return head(params, h, prec)
