"""PyTorch port: the batched masked-forward engine ``FastBatchedGCN`` against
the JAX engine on the same graph, weights and masks, in each of its modes:
receptive-field plans (dense tier), the unrestricted dense tier, and the ELL
tier, whose layers >= 2 run the separable gather-sum (the JAX side on its
v7 Pallas kernel in interpret mode)."""

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

from fixtures import make_graph

#: float32, another summation order; the ELL tier adds one gather-sum layer
TOL = dict(rtol=1e-5, atol=1e-6)


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
    _, _, tdef, _, tg = small
    with pytest.raises(NotImplementedError):
        tfast.FastBatchedGCN(tdef, tg, backend="pallas", device="cpu")
    te = tfast.FastBatchedGCN(tdef, tg, device="cpu")
    with pytest.raises(NotImplementedError):
        te.query_outputs(torch.zeros((2, tg.e_pad), dtype=torch.bool), 0, "edge_prediction")
    with pytest.raises(ValueError):
        tfast.FastBatchedGCN(tdef, tg, mode="sparse", device="cpu")
