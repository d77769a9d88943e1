"""The yardstick's operation count against a hand count and against its
numbers before families were looked up; the table of peaks."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import strata
from bench_port.metrics import _opcount, _peaks
from bench_port.registry import Registry

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


# each configuration's count at every subgraph class of the traffic, 1000 rows
# in 50 epochs, 3 repeats, as the count read before it looked families up
CLASSES = [(1024, 8192), (1024, 16384), (2048, 16384), (2048, 32768), (4096, 65536),
           (4096, 131072), (8192, 131072), (8192, 262144), (16384, 262144), (16384, 524288)]
PINNED = {
    "gcn16-hetionet-genes": [
        904576512.0, 1691008512.0, 1804353024.0, 3377217024.0, 6749634048.0, 13041090048.0,
        13494468096.0, 26077380096.0, 26984136192.0, 52149960192.0],
    "hgcn16-hetionet-genes3": [
        1106689536.0, 1893121536.0, 2208579072.0, 3781443072.0, 7558086144.0, 13849542144.0,
        15111372288.0, 27694284288.0, 30217944576.0, 55383768576.0],
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_each_configurations_count_is_unchanged_at_every_class(config):
    model = Registry().config(config)["model"]
    count = _opcount.count_for(model["family"])
    assert count is _opcount.explanation_flops
    assert [count(model, n, e, 1000, 50, 3) for n, e in CLASSES] == PINNED[config]


def test_a_family_without_a_count_has_none(tmp_path):
    assert _opcount.count_for("gat") is None
    (tmp_path / "_opcount_gat.py").write_text(
        "def explanation_flops(model, nodes, edges, rows, epochs, times):\n"
        "    return 7.0 * nodes\n")
    assert _opcount.count_for("gat", str(tmp_path))({}, 3, 0, 1, 1, 1) == 21.0
    assert _opcount.count_for("gcn", str(tmp_path)) is _opcount.explanation_flops


def test_the_peaks_know_the_h100_alone():
    kind = "NVIDIA H100 80GB HBM3"
    assert (_peaks.fp32_peak(kind), _peaks.tf32_tensor_peak(kind), _peaks.bf16_tensor_peak(kind),
            _peaks.hbm_peak(kind)) == (67e12, 494.7e12, 989.4e12, 3.35e12)
    for peak in (_peaks.fp32_peak, _peaks.tf32_tensor_peak, _peaks.bf16_tensor_peak,
                 _peaks.hbm_peak):
        assert peak("cpu") is None
