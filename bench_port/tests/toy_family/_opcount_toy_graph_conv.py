"""The useful operations of one ``toy_graph_conv`` explanation: a mask
row's layers each sum its edges' messages at the layer's input width and
make two products a node; the head on the query row; the surrogate's two
``[bs, W]`` products an epoch."""

from __future__ import annotations


def explanation_flops(model: dict, nodes: int, edges: int, rows: int, epochs: int,
                      times: int) -> float:
    """Operations of explaining one query (``metrics/_opcount.py``'s
    signature)."""
    dims = [model["in_features"]] + list(model["conv_channels"])
    per_row = sum(2.0 * edges * a + 4.0 * nodes * a * b for a, b in zip(dims[:-1], dims[1:]))
    fc = list(model["fc_channels"]) + [model["out_features"]]
    per_row += sum(2.0 * a * b for a, b in zip(fc[:-1], fc[1:]))
    surrogate = epochs * 4.0 * (rows // epochs) * nodes
    return times * (rows * per_row + surrogate)
