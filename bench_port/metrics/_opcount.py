"""The useful operations of one explanation, from shapes: the reference
algorithm's work, whatever the program does to compute it.

Per mask row, each GCN layer's sparse aggregation over the subgraph's
edges and one self-loop a node (``2 (E + N) C``; a hetero layer has one
self-loop a node for each relation), the layer's own product for layers
after the first, and the head on the query row.  The first layer's ``X W``
is shared by every mask and counted once an explanation (a relation).
Each surrogate epoch adds its two ``[bs, W]`` products (``4 bs W``).  A
dense formulation's ``n^2`` work is not useful work and does not count.

That is the count of the ``gcn`` and ``hetero_gcn`` families.  Another
family's count is ``explanation_flops`` of its own file,
``_opcount_<family>.py`` beside this one, with the same signature;
:func:`count_for` finds it.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
#: the families whose work :func:`explanation_flops` counts
GCN_FAMILIES = ("gcn", "hetero_gcn")


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


def count_for(family: str, folder: str = HERE) -> Optional[Callable[..., float]]:
    """The operation count of ``family``: :func:`explanation_flops` for the
    GCN families, ``explanation_flops`` of ``<folder>/_opcount_<family>.py``
    where that file exists, else None (no family is counted as another)."""
    if family in GCN_FAMILIES:
        return explanation_flops
    path = os.path.join(folder, f"_opcount_{family}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"bench_port.metrics._opcount_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.explanation_flops
