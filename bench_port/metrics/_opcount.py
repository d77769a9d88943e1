"""The useful operations of one explanation, from shapes: the reference
algorithm's work, whatever the program does to compute it.

Per mask row, each GCN layer's sparse aggregation over the subgraph's
edges and one self-loop a node (``2 (E + N) C``; a hetero layer has one
self-loop a node for each relation), the layer's own product for layers
after the first, and the head on the query row.  The first layer's ``X W``
is shared by every mask and counted once an explanation (a relation).
Each surrogate epoch adds its two ``[bs, W]`` products (``4 bs W``).  A
dense formulation's ``n^2`` work is not useful work and does not count.
"""

from __future__ import annotations


def explanation_flops(model: dict, nodes: int, edges: int, rows: int, epochs: int,
                      times: int) -> float:
    """Operations of explaining one query with ``rows`` mask rows a repeat,
    ``times`` repeats, on a subgraph of ``nodes`` nodes and ``edges`` edges."""
    rels = len(model.get("relations", [None]))
    dims = [model["in_features"]] + list(model["conv_channels"])
    first = 2.0 * nodes * dims[0] * dims[1] * rels
    per_row = 0.0
    for li, c in enumerate(dims[1:]):
        per_row += 2.0 * (edges + rels * nodes) * c
        if li > 0:
            per_row += 2.0 * nodes * dims[li] * c * rels
    fc = list(model["fc_channels"]) + [model["out_features"]]
    per_row += sum(2.0 * a * b for a, b in zip(fc[:-1], fc[1:]))
    bs = rows // epochs
    surrogate = epochs * 4.0 * bs * nodes
    return first + times * (rows * per_row + surrogate)
