"""The yardstick's operation count against a hand count."""

from __future__ import annotations

import numpy as np

from bench_port import strata
from bench_port.metrics import _opcount

# a 6-node graph whose gene 2 reaches every other node but 3 within two hops
SIX = np.array([[0, 1, 2, 4, 5, 1], [1, 2, 3, 2, 4, 0]])
MODEL = {"in_features": 4, "conv_channels": [3], "fc_channels": [3, 2], "out_features": 1}


def test_gcn_count_by_hand():
    nodes, edges = strata.subgraph_sizes(6, SIX, 2, "cpu")
    n, e = int(nodes[2]), int(edges[2])
    assert (n, e) == (5, 5)
    # X W once: 2*5*4*3 = 120.  A mask row: aggregation 2*(5 + 5)*3 = 60,
    # head 2*3*2 + 2*2*1 = 16.  10 rows in 5 epochs of 2: surrogate
    # 5 * 4 * 2 * 5 = 200 a repeat.  Two repeats: 120 + 2*(10*76 + 200).
    assert _opcount.explanation_flops(MODEL, n, e, rows=10, epochs=5, times=2) == 2040.0


def test_hetero_count_by_hand():
    model = dict(MODEL, relations=[["g", "r1", "g"], ["g", "r2", "g"], ["g", "r3", "g"]])
    # X W once a relation: 3*120 = 360.  A row: 2*(5 + 3*5)*3 = 120, head 16.
    assert _opcount.explanation_flops(model, 5, 5, rows=10, epochs=5, times=2) == 360 + 2 * (
        10 * 136 + 200)


def test_second_layer_adds_its_product():
    model = dict(MODEL, conv_channels=[3, 3], fc_channels=[3, 2])
    one = _opcount.explanation_flops(MODEL, 5, 5, rows=1, epochs=1, times=1)
    two = _opcount.explanation_flops(model, 5, 5, rows=1, epochs=1, times=1)
    # layer 2: aggregation 2*(5+5)*3 = 60 and its X W, 2*5*3*3 = 90, a row
    assert two - one == 150.0
