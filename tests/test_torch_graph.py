"""PyTorch port: graph container, host builders, neighbour tables and k-hop
extraction are exactly equal to the JAX package's and to the reference's
hand-enumerated computational subgraphs."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from bikg_graph_explainability_public_tpu import graph as jgraph
from bikg_graph_explainability_public_tpu.ops import ell as jell
from bikg_graph_explainability_public_tpu.ops import khop as jkhop
from bikg_graph_explainability_public_tpu.runtime import native as jnative
from bikg_graph_explainability_public_tpu.utils import padding as jpadding
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.ops import ell as tell
from bikg_graph_explainability_public_tpu_torch.ops import khop as tkhop
from bikg_graph_explainability_public_tpu_torch.runtime import native as tnative
from bikg_graph_explainability_public_tpu_torch.utils import padding as tpadding

from fixtures import make_graph

HERE = os.path.dirname(os.path.abspath(__file__))
GT = os.path.join(HERE, "..", "test_data", "ref_comp_graph_gt.npz")
GT_NAMES = os.path.join(HERE, "..", "test_data", "ref_comp_graph_gt_names.json")

FIELDS = ("x", "senders", "receivers", "node_mask", "edge_mask", "node_type", "edge_type")


def _graphs(n=60, e=300, seed=0, pad_mode="multiple", self_loops=True):
    feat, ei, _ = make_graph(n=n, f=6, e=e, seed=seed, self_loops=self_loops)
    return (
        jgraph.from_arrays(feat, ei, pad_mode=pad_mode),
        tgraph.from_arrays(feat, ei, pad_mode=pad_mode, device="cpu"),
    )


def _assert_graph_equal(tg, jg):
    assert (tg.n_pad, tg.e_pad, tg.num_nodes, tg.num_edges) == (
        jg.n_pad, jg.e_pad, jg.num_nodes, jg.num_edges
    )
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), err_msg=name
        )


@pytest.mark.parametrize("pad_mode", ["multiple", "pow2", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_from_arrays_equal(seed, pad_mode):
    jg, tg = _graphs(seed=seed, pad_mode=pad_mode)
    _assert_graph_equal(tg, jg)
    assert tg.device == torch.device("cpu")
    for problem in ("node_prediction", "graph_prediction"):
        assert tgraph.element_size(tg, problem) == jgraph.element_size(jg, problem)


def test_from_arrays_rejects_bad_input():
    feat, ei, _ = make_graph(n=10, f=3, e=20)
    with pytest.raises(ValueError):
        tgraph.from_arrays(feat, ei[:1], device="cpu")
    with pytest.raises(ValueError):
        tgraph.from_arrays(feat, ei, node_budget=4, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_equal(seed):
    jg, tg = _graphs(seed=seed)
    for got, want in zip(tgraph.host_view(tg).csr(), jgraph.host_view(jg).csr()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "n,e,k", [(50, 200, None), (50, 200, 16), (300, 3000, None), (300, 3000, 32)]
)
def test_native_builders_equal(n, e, k):
    rng = np.random.default_rng(n + e)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    assert tnative.max_degree(n, dst) == jnative.max_degree(n, dst)
    kk = k or -(-jnative.max_degree(n, dst) // 8) * 8
    for got, want in zip(tnative.build_ell(n, src, dst, kk), jnative.build_ell(n, src, dst, kk)):
        np.testing.assert_array_equal(got, want)
    row_ptr, col, _ = jnative.build_csr(n, src, dst)
    for q in (0, n // 2):
        for hops in (1, 2, 3):
            np.testing.assert_array_equal(
                tnative.bfs_levels_csr(n, row_ptr, col, q, hops),
                jnative.bfs_levels_csr(n, row_ptr, col, q, hops),
            )
            np.testing.assert_array_equal(
                tnative.khop_reachable(n, src, dst, q, hops),
                jnative.khop_reachable(n, src, dst, q, hops),
            )


@pytest.mark.parametrize("k", [None, 16, 32])
@pytest.mark.parametrize("seed", [0, 3])
def test_neighbor_table_equal(seed, k):
    jg, tg = _graphs(n=120, e=900, seed=seed)
    jt = jell.build_neighbor_table(jg, k=k)
    tt = tell.build_neighbor_table(tg, k=k)
    assert tt.k == jt.k and tt.k % 8 == 0
    assert tt.nbr.dtype == torch.int32
    np.testing.assert_array_equal(tt.nbr.numpy(), np.asarray(jt.nbr))
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_array_equal(tt.eid.numpy(), np.asarray(jt.eid))
    v = np.asarray(jt.valid) > 0
    np.testing.assert_array_equal(tt.deg.numpy(), v.sum(1))
    assert tt.n_src == int(np.asarray(jt.nbr)[v].max()) + 1


def test_neighbor_table_overflow_raises():
    jg, tg = _graphs(n=20, e=400)
    with pytest.raises(ValueError, match="overflow"):
        tell.build_neighbor_table(tg, k=8)


@pytest.mark.parametrize("pad_mode", ["pow2", "multiple"])
@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("query", [0, 10, 33])
def test_khop_equal(query, hops, pad_mode):
    jg, tg = _graphs(n=36, e=116, seed=0)
    js = jkhop.extract_khop_subgraph(jg, query, hops, pad_mode=pad_mode)
    ts = tkhop.extract_khop_subgraph(tg, query, hops, pad_mode=pad_mode)
    _assert_graph_equal(ts.graph, js.graph)
    assert ts.query == js.query
    np.testing.assert_array_equal(ts.parent_nodes, np.asarray(js.parent_nodes))
    np.testing.assert_array_equal(ts.parent_edge_mask, np.asarray(js.parent_edge_mask))


def test_khop_isolated_query_gets_self_loop():
    feat = np.zeros((5, 2), np.float32)
    ei = np.array([[0, 1], [1, 2]])
    jg = jgraph.from_arrays(feat, ei)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    js = jkhop.extract_khop_subgraph(jg, 4, 2)
    ts = tkhop.extract_khop_subgraph(tg, 4, 2)
    _assert_graph_equal(ts.graph, js.graph)
    assert ts.graph.num_edges == 1


@pytest.fixture(scope="module")
def gt():
    d = np.load(GT)
    with open(GT_NAMES) as f:
        names = json.load(f)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((36, 12), dtype=np.float32)
    g = tgraph.from_arrays(
        feat, d["edge_index"], node_type=d["node_types"], edge_type=d["edge_types"],
        pad_mode="exact", device="cpu",
    )
    return d, names, g, feat


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_khop_reference_ground_truth(gt, hops):
    d, names, g, feat = gt
    sub = tkhop.extract_khop_subgraph(g, int(d["query"]), hops, pad_mode="exact")
    kept = sub.parent_nodes[: sub.graph.num_nodes]
    np.testing.assert_array_equal(kept, d[f"hop{hops}_nodes"])
    assert [str(i) for i in kept] == names[str(hops)]
    assert sub.query == int(d[f"hop{hops}_query_pos"])
    np.testing.assert_array_equal(
        sub.graph.node_type.numpy()[: sub.graph.num_nodes], d[f"hop{hops}_node_types"]
    )
    np.testing.assert_allclose(sub.graph.x.numpy()[: sub.graph.num_nodes], feat[kept])
    ne = sub.graph.num_edges
    snd, rcv = sub.graph.senders.numpy()[:ne], sub.graph.receivers.numpy()[:ne]
    got = set(zip(snd.tolist(), rcv.tolist()))
    assert got == {(int(s), int(r)) for s, r in d[f"hop{hops}_edge_index"].T}


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 4097])
def test_padding_equal(n):
    for mode in ("pow2", "multiple", "exact"):
        assert tpadding.pad_budget(n, mode, 8) == jpadding.pad_budget(n, mode, 8)
    assert tpadding.round_up(n, 8) == jpadding.round_up(n, 8)
    assert tpadding.round_up_pow2(n) == jpadding.round_up_pow2(n)
