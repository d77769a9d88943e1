"""Plain reference forward of the ``hetero_gcn`` family: one ``GCNConv`` a
relation in each layer, their outputs summed per node (PyG ``HeteroConv``
with ``aggr="sum"``), ReLU, then the fully connected head and a sigmoid.
With one node type every relation's conv puts its self-loop and bias on
every node.  Relation ``r``'s conv sees only the edges of type ``r``.

Parameters: ``conv.<l>.<src>__<rel>__<dst>.weight`` / ``.bias`` in the
configuration's relation order, and the head's ``fc.<i>.*``.
"""

from __future__ import annotations

import torch

from .explain import Precision, Sub
from .gcn import aggregate, conv_scales, edge_weights, head


def query_outputs(params: dict, x: torch.Tensor, sub: Sub, m: torch.Tensor,
                  prec: Precision, relations=None) -> torch.Tensor:
    """The model's output at the query for each node mask ``m [B, n]``;
    ``relations``: the relation keys in edge-type order (read from the
    parameter names when None)."""
    dev = x.device
    snd = torch.as_tensor(sub.snd, device=dev)
    rcv = torch.as_tensor(sub.rcv, device=dev)
    et = torch.as_tensor(sub.etype, device=dev)
    n = x.shape[0]
    if relations is None:
        relations = [k.split(".")[2] for k in params
                     if k.startswith("conv.0.") and k.endswith(".weight")]
    layers = len({k.split(".")[1] for k in params if k.startswith("conv.")})
    w_all = edge_weights(m, snd, rcv)
    scales = [conv_scales(w_all * (et == ri).to(w_all.dtype), snd, rcv, n)
              for ri in range(len(relations))]
    h = None
    for li in range(layers):
        last = li == layers - 1
        out = 0.0
        for ri, rel in enumerate(relations):
            w, b = params[f"conv.{li}.{rel}.weight"], params[f"conv.{li}.{rel}.bias"]
            hw = prec.mm(x, w.T)[None].expand(m.shape[0], -1, -1) if li == 0 else prec.mm(h, w.T)
            norm, self_w = scales[ri]
            out = out + aggregate(norm, self_w, hw, snd, rcv, prec, sub.query if last else None) + b
        h = torch.relu(out)
    return head(params, h, prec)
