"""PyTorch port: the batched masked-forward engine ``FastBatchedGCN`` against
the JAX engine on the same graph, weights and masks, in each of its modes:
receptive-field plans for node and edge queries (dense tier), the
unrestricted dense tier (unfused, and fused with ``backend="pallas"``), and
the ELL tier, whose layers >= 2 run the separable gather-sum for node masks
and the weighted gather-sum for edge masks (the JAX side on its v7 Pallas
kernels in interpret mode); and which of the engine's structures each
forward builds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.models.fast_gcn import FastBatchedGCN as JEngine
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.models import fast_gcn as tfast
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
from bikg_graph_explainability_public_tpu_torch.utils import profiling

from fixtures import make_graph

#: float32, another summation order; the ELL tier adds one gather-sum layer
TOL = dict(rtol=1e-5, atol=1e-6)
#: the fused layers' bf16 operands against float32 (tests/test_pallas_gcn.py)
TOL_BF16 = dict(rtol=5e-2, atol=6e-2)


def _setup(n, e, conv, fc, seed=0):
    feat, ei, _ = make_graph(n=n, f=12, e=e, seed=seed)
    jdef = px.GCNNodeModel(12, conv_channels=conv, fc_channels=fc)
    params = jdef.init(jax.random.PRNGKey(seed))
    tdef = GCNNodeModel(12, conv_channels=conv, fc_channels=fc)
    tdef.load_state_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    jg = px.from_arrays(feat, ei)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    return jdef, params, tdef, jg, tg


def _masks(g, rows, seed=1, p=0.3):
    m = np.random.default_rng(seed).random((rows, g.n_pad)) > p
    m[:, g.num_nodes:] = False
    return m


def _edge_masks(g, rows, seed=1, p=0.3):
    m = np.random.default_rng(seed).random((rows, g.e_pad)) > p
    m[:, g.num_edges:] = False
    return m


@pytest.fixture(scope="module")
def small():
    return _setup(200, 900, (16, 16), (16, 8))


@pytest.mark.parametrize("chunk,auto", [(16, True), (16, False), (20, False), (64, True)])
@pytest.mark.parametrize("query", [0, 57, 199])
def test_restricted_node_matches_jax(small, query, chunk, auto):
    jdef, params, tdef, jg, tg = small
    je = JEngine(jdef, params, jg)
    te = tfast.FastBatchedGCN(tdef, tg, device="cpu")
    assert te.mode == je.mode == "dense"
    masks = _masks(jg, 48)
    want = np.asarray(
        je.query_outputs(jnp.asarray(masks), query, chunk_size=chunk, auto_chunk=auto)
    )
    got = te.query_outputs(torch.from_numpy(masks), query, chunk_size=chunk, auto_chunk=auto)
    assert te.query_plan(query) is not None
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(
    "problem,query", [("node_prediction", 3), ("node_prediction", 150), ("graph_prediction", None)]
)
def test_dense_unrestricted_matches_jax(small, problem, query):
    jdef, params, tdef, jg, tg = small
    je = JEngine(jdef, params, jg, restrict=False)
    te = tfast.FastBatchedGCN(tdef, tg, restrict=False, device="cpu")
    masks = _masks(jg, 24, seed=2)
    want = np.asarray(je.query_outputs(jnp.asarray(masks), query, problem, chunk_size=8))
    got = te.query_outputs(torch.from_numpy(masks), query, problem, chunk_size=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ell_graph_problem_matches_jax_v7():
    """ELL tier at b*F = 32*16 = 512: JAX runs its v7 kernel (interpret)."""
    jdef, params, tdef, jg, tg = _setup(300, 1500, (16, 16), (16, 8), seed=3)
    je = JEngine(jdef, params, jg, mode="ell", spmm_backend="pallas")
    te = tfast.FastBatchedGCN(tdef, tg, mode="ell", device="cpu")
    masks = _masks(jg, 64, seed=3)
    want = np.asarray(je.query_outputs(jnp.asarray(masks), None, "graph_prediction", chunk_size=32))
    got = te.query_outputs(torch.from_numpy(masks), None, "graph_prediction", chunk_size=32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("conv", [(8, 8), (8, 8, 8)])
@pytest.mark.parametrize("problem,query", [("node_prediction", 5), ("graph_prediction", None)])
def test_ell_matches_jax_xla(problem, query, conv):
    """ELL tier, JAX on its XLA segment-sum path; a ragged last chunk."""
    jdef, params, tdef, jg, tg = _setup(120, 500, conv, (8, 4), seed=4)
    je = JEngine(jdef, params, jg, mode="ell", restrict=False, spmm_backend="xla")
    te = tfast.FastBatchedGCN(tdef, tg, mode="ell", restrict=False, device="cpu")
    masks = _masks(jg, 20, seed=4)
    want = np.asarray(je.query_outputs(jnp.asarray(masks), query, problem, chunk_size=20))
    got = te.query_outputs(torch.from_numpy(masks), query, problem, chunk_size=6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_batch_node_outputs_dense_and_ell_agree(small):
    _, _, tdef, _, tg = small
    masks = torch.from_numpy(_masks(tg, 6, seed=5))
    dense = tfast.FastBatchedGCN(tdef, tg, mode="dense", device="cpu").batch_node_outputs(masks)
    ell = tfast.FastBatchedGCN(tdef, tg, mode="ell", device="cpu").batch_node_outputs(masks)
    assert dense.shape == ell.shape == (6, tg.n_pad, 16)
    np.testing.assert_allclose(ell.numpy(), dense.numpy(), **TOL)


def test_large_graph_picks_ell_tier():
    feat, ei, _ = make_graph(n=tfast.DENSE_THRESHOLD + 100, f=4, e=9000, seed=6)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    te = tfast.FastBatchedGCN(GCNNodeModel(4, (8,), (8, 4)), tg, device="cpu")
    assert te.mode == "ell" and te.adj is None and te.table.k % 8 == 0


def test_unported_branches_raise(small):
    """Edge masks and ``backend="pallas"`` are ported; unknown tiers and
    backends raise, and the JAX engine's ``spmm_backend`` and ``dtype``
    knobs are not taken (the port always runs its kernels in float32)."""
    _, _, tdef, _, tg = small
    with pytest.raises(ValueError):
        tfast.FastBatchedGCN(tdef, tg, backend="mosaic", device="cpu")
    with pytest.raises(ValueError):
        tfast.FastBatchedGCN(tdef, tg, mode="sparse", device="cpu")
    with pytest.raises(TypeError):
        tfast.FastBatchedGCN(tdef, tg, spmm_backend="xla", device="cpu")
    te = tfast.FastBatchedGCN(tdef, tg, backend="pallas", device="cpu")
    out = te.query_outputs(torch.ones((2, tg.e_pad), dtype=torch.bool), 0, "edge_prediction")
    assert out.shape == (2,) and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def edge_small():
    """Duplicate edges and data self-loops (both kept by the masks, the
    self-loops replaced by unit loops in the forward)."""
    feat, ei, _ = make_graph(n=60, f=12, e=240, seed=9)
    ei = np.concatenate([ei, ei[:, :7]], axis=1)
    conv, fc = (16, 16), (16, 8)
    jdef = px.GCNNodeModel(12, conv_channels=conv, fc_channels=fc)
    params = jdef.init(jax.random.PRNGKey(9))
    tdef = GCNNodeModel(12, conv_channels=conv, fc_channels=fc)
    tdef.load_state_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    return jdef, params, tdef, px.from_arrays(feat, ei), tgraph.from_arrays(feat, ei, device="cpu")


@pytest.mark.parametrize("chunk,auto", [(16, True), (16, False), (20, False)])
@pytest.mark.parametrize("query", [0, 17, 59])
def test_restricted_edge_matches_jax(edge_small, query, chunk, auto):
    jdef, params, tdef, jg, tg = edge_small
    je = JEngine(jdef, params, jg)
    te = tfast.FastBatchedGCN(tdef, tg, device="cpu")
    masks = _edge_masks(jg, 48, seed=query)
    want = np.asarray(je.query_outputs(
        jnp.asarray(masks), query, "edge_prediction", chunk_size=chunk, auto_chunk=auto
    ))
    got = te.query_outputs(
        torch.from_numpy(masks), query, "edge_prediction", chunk_size=chunk, auto_chunk=auto
    )
    plan = te.edge_query_plan(query)
    jplan = je.edge_query_plan(query)
    assert plan.p_sizes == jplan.p_sizes
    np.testing.assert_array_equal(plan.deg_eid.numpy(), jplan.deg_eid)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["dense", "ell"])
@pytest.mark.parametrize("query", [4, 30])
def test_unrestricted_edge_matches_jax_xla(edge_small, mode, query):
    """Dense-mode engines run edge masks on the table too; a ragged last
    chunk on the port's side."""
    jdef, params, tdef, jg, tg = edge_small
    je = JEngine(jdef, params, jg, mode=mode, restrict=False, spmm_backend="xla")
    te = tfast.FastBatchedGCN(tdef, tg, mode=mode, restrict=False, device="cpu")
    masks = _edge_masks(jg, 20, seed=query)
    want = np.asarray(je.query_outputs(jnp.asarray(masks), query, "edge_prediction", chunk_size=20))
    got = te.query_outputs(torch.from_numpy(masks), query, "edge_prediction", chunk_size=6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["dense", "ell"])
def test_unrestricted_edge_matches_jax_v7w(edge_small, mode):
    """b*F = 32*16 = 512: the JAX side on its weighted v7 kernel (interpret)."""
    jdef, params, tdef, jg, tg = edge_small
    je = JEngine(jdef, params, jg, mode=mode, restrict=False, spmm_backend="pallas")
    te = tfast.FastBatchedGCN(tdef, tg, mode=mode, restrict=False, device="cpu")
    masks = _edge_masks(jg, 64, seed=11)
    want = np.asarray(je.query_outputs(jnp.asarray(masks), 12, "edge_prediction", chunk_size=32))
    got = te.query_outputs(torch.from_numpy(masks), 12, "edge_prediction", chunk_size=32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_edge_plan_equals_unrestricted_edge_forward(edge_small):
    _, _, tdef, _, tg = edge_small
    fast = tfast.FastBatchedGCN(tdef, tg, device="cpu")
    full = tfast.FastBatchedGCN(tdef, tg, restrict=False, device="cpu")
    masks = torch.from_numpy(_edge_masks(tg, 16, seed=12))
    for q in (0, 33):
        np.testing.assert_allclose(
            fast.query_outputs(masks, q, "edge_prediction").numpy(),
            full.query_outputs(masks, q, "edge_prediction").numpy(),
            **TOL,
        )


@pytest.mark.parametrize(
    "problem,query", [("node_prediction", 3), ("graph_prediction", None)]
)
def test_pallas_backend_matches_jax_pallas(small, problem, query):
    """The fused layers against the JAX package's (interpret mode): the
    same bf16 roundings, so float32 order plus rare last-bit differences
    of ``h @ W`` before its rounding (tests/test_torch_gcn_layer.py)."""
    jdef, params, tdef, jg, tg = small
    je = JEngine(jdef, params, jg, backend="pallas", restrict=False)
    te = tfast.FastBatchedGCN(tdef, tg, backend="pallas", restrict=False, device="cpu")
    masks = _masks(jg, 16, seed=6)
    want = np.asarray(je.query_outputs(jnp.asarray(masks), query, problem, chunk_size=8))
    got = te.query_outputs(torch.from_numpy(masks), query, problem, chunk_size=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_pallas_backend_matches_xla_backend(small):
    _, _, tdef, _, tg = small
    fused = tfast.FastBatchedGCN(tdef, tg, backend="pallas", restrict=False, device="cpu")
    plain = tfast.FastBatchedGCN(tdef, tg, restrict=False, device="cpu")
    masks = torch.from_numpy(_masks(tg, 12, seed=7))
    a = fused.batch_node_outputs(masks)
    b = plain.batch_node_outputs(masks)
    assert a.shape == b.shape == (12, tg.n_pad, 16)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL_BF16)
    assert fused._adj16.dtype == torch.bfloat16 and plain._adj16 is None
    # restricted node queries and every edge-mask forward ignore the backend
    cases = (("node_prediction", _masks, (True,)), ("edge_prediction", _edge_masks, (True, False)))
    for prob, make, restricts in cases:
        m = torch.from_numpy(make(tg, 8, seed=8))
        for restrict in restricts:
            e1 = tfast.FastBatchedGCN(tdef, tg, backend="pallas", restrict=restrict, device="cpu")
            e2 = tfast.FastBatchedGCN(tdef, tg, restrict=restrict, device="cpu")
            torch.testing.assert_close(e1.query_outputs(m, 5, prob), e2.query_outputs(m, 5, prob))


@pytest.mark.parametrize("mode", ["dense", "ell"])
def test_plans_build_neither_table_nor_adjacency(small, mode):
    """Node and edge queries served by their plans leave the table and the
    dense adjacency unbuilt, and answer exactly as an engine holding both."""
    _, _, tdef, _, tg = small
    lazy = tfast.FastBatchedGCN(tdef, tg, mode=mode, device="cpu")
    built = tfast.FastBatchedGCN(tdef, tg, mode=mode, device="cpu")
    assert built.table.k % 8 == 0 and (built.adj is None) == (mode == "ell")
    for problem, make in (("node_prediction", _masks), ("edge_prediction", _edge_masks)):
        m = torch.from_numpy(make(tg, 24, seed=13))
        for q in (0, 57):
            assert torch.equal(lazy.query_outputs(m, q, problem), built.query_outputs(m, q, problem))
    assert lazy.query_plan(57) is not None
    assert lazy._table is None and lazy._adj is None


@pytest.mark.parametrize("mode", ["dense", "ell"])
@pytest.mark.parametrize(
    "problem,query,restrict",
    [("node_prediction", 5, False), ("graph_prediction", None, True), ("edge_prediction", 5, False)],
)
def test_unrestricted_forwards_build_what_they_read_once(small, mode, problem, query, restrict):
    """Unrestricted forwards build the structure they read on first use,
    count it and its bytes, and reuse it: the dense tier's node masks read
    the adjacency alone, edge masks and the ELL tier the table alone."""
    _, _, tdef, _, tg = small
    te = tfast.FastBatchedGCN(tdef, tg, mode=mode, restrict=restrict, device="cpu")
    m = torch.from_numpy((_edge_masks if "edge" in problem else _masks)(tg, 12, seed=14))
    with profiling.recording() as rec:
        with profiling.span("forwards"):
            first = te.query_outputs(m, query, problem, chunk_size=8)
            table, adj = te._table, te._adj
            second = te.query_outputs(m, query, problem, chunk_size=8)
    assert torch.equal(first, second)
    assert te._table is table and te._adj is adj
    reads_adj = mode == "dense" and "edge" not in problem
    assert (adj is not None) == reads_adj and (table is None) == reads_adj
    counts = rec.totals()["forwards", "forwards"]
    assert counts.get("dense_adjacency_builds", 0) == int(reads_adj)
    assert counts.get("neighbor_table_builds", 0) == int(not reads_adj)
    built = (adj,) if reads_adj else (table.nbr, table.valid, table.eid)
    assert counts["upload_bytes"] == sum(a.nbytes for a in built)
    if mode == "ell":
        assert te.adj is None and te._adj is None
