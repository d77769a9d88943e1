"""PyTorch port: ``FastBatchedHeteroGCN`` against the JAX package's engine
and against its generic forward (``HeteroGNN.apply`` through
``Model(fast=False)``) on the same graph, weights and masks, tier by tier:
receptive-field plans for node and edge queries, the unrestricted dense
tier, and the ELL tier (reached as the JAX tests reach it, with
``DENSE_CAP`` set low on both engines): node, graph and edge masks, layer 1
fused or, over its budget, on the gather-sum.  On the CPU the JAX side
takes its XLA route and the port its kernels' plain versions.

Also here: the reference faults the port does not inherit (a relation's
bias off its scope where types interleave; a type without nodes), and the
plain versions of kernels 2.3 and 2.4 at type-scoped shapes against a
dense reference.  Tolerance ``rtol=1e-4, atol=1e-5``: float32 in another
summation order."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.graph import hetero_to_homo as jhetero_to_homo
from bikg_graph_explainability_public_tpu.models.fast_hetero import FastBatchedHeteroGCN as JEngine
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.models import fast_hetero as tfast
from bikg_graph_explainability_public_tpu_torch.models import gnn as tgnn
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy
from bikg_graph_explainability_public_tpu_torch.ops import spmm, spmm_cuda
from bikg_graph_explainability_public_tpu_torch.ops.ell import build_neighbor_table_edges

TOL = dict(rtol=1e-4, atol=1e-5)
RELS = [("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a")]
TEngine = tfast.FastBatchedHeteroGCN


def _weights(types, rels, in_features, conv, seed):
    """The same weights in both packages, biases random (JAX's init puts
    zeros there, which would hide a bias on the wrong rows)."""
    jdef = px.hetero_gcn_for_relations(types, rels, in_features, conv_channels=conv,
                                       fc_channels=(conv[-1], 4))
    params = jax.tree_util.tree_map(np.asarray, jdef.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in params["conv"]:
        for p in layer.values():
            p["bias"] = rng.normal(size=p["bias"].shape).astype(np.float32)
    tdef = tgnn.hetero_gcn_for_relations(types, rels, in_features, conv_channels=conv,
                                         fc_channels=(conv[-1], 4))
    tdef.load_state_dict(params_from_numpy(params))
    return jdef, params, tdef


def _two_type_setup(seed=80, conv=(6,)):
    """``tests/test_fast_hetero.py::_two_type_setup``'s graph."""
    rng = np.random.default_rng(seed)
    feat = {"a": rng.normal(size=(9, 5)).astype(np.float32),
            "b": rng.normal(size=(7, 5)).astype(np.float32)}
    ei = {
        RELS[0]: np.stack([rng.integers(0, 9, 12), rng.integers(0, 7, 12)]),
        RELS[1]: np.stack([rng.integers(0, 7, 10), rng.integers(0, 9, 10)]),
        RELS[2]: np.stack([rng.integers(0, 9, 8), rng.integers(0, 9, 8)]),
    }
    jg, _ = jhetero_to_homo(feat, ei)
    tg, _ = tgraph.hetero_to_homo(feat, ei, device="cpu")
    return (*_weights(["a", "b"], RELS, 5, conv, seed), jg, tg)


def _masks(width, rows=24, seed=1, keep=0.6):
    return np.random.default_rng(seed).random((rows, width)) < keep


def _generic(jdef, params, jg, masks, problem, query):
    return np.asarray(px.Model(jdef, params, fast=False).perturbed_query_outputs(
        jg, jnp.asarray(masks), problem, query))


@pytest.fixture
def low_cap(monkeypatch):
    """Both engines above DENSE_CAP: the unrestricted forwards run the ELL tier."""
    monkeypatch.setattr(JEngine, "DENSE_CAP", 4)
    monkeypatch.setattr(TEngine, "DENSE_CAP", 4)


CASES = [  # (problem, query, restrict)
    ("node_prediction", 3, True),     # node plan
    ("node_prediction", 15, True),
    ("edge_prediction", 3, True),     # edge plan
    ("node_prediction", 3, False),    # dense tier
    ("graph_prediction", None, False),
]


@pytest.mark.parametrize("conv", [(6,), (6, 6)])
@pytest.mark.parametrize("problem,query,restrict", CASES)
def test_dense_tier_and_plans_match_jax(problem, query, restrict, conv):
    jdef, params, tdef, jg, tg = _two_type_setup(seed=81, conv=conv)
    masks = _masks(jg.e_pad if "edge" in problem else jg.n_pad)
    je = JEngine(jdef, params, jg, restrict=restrict)
    te = TEngine(tdef, tg, restrict=restrict, device="cpu")
    want = np.asarray(je.query_outputs(jnp.asarray(masks), query, problem))
    # chunks of 10 with a ragged last one
    got = te.query_outputs(torch.from_numpy(masks), query, problem, chunk_size=10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _generic(jdef, params, jg, masks, problem, query), **TOL)
    if restrict and "edge" not in problem:
        assert te.query_plan(query) is not None and te._adj is None


def test_unrestricted_edge_under_the_cap_declines():
    jdef, params, tdef, jg, tg = _two_type_setup()
    masks = np.ones((4, tg.e_pad), bool)
    te = TEngine(tdef, tg, restrict=False, device="cpu")
    assert te.query_outputs(torch.from_numpy(masks), 3, "edge_prediction") is None
    assert JEngine(jdef, params, jg, restrict=False).query_outputs(masks, 3, "edge_prediction") is None
    # the adapter falls back to the generic forward
    got = Model(tdef, device="cpu").perturbed_query_outputs(tg, masks, "edge_prediction", 3)
    np.testing.assert_allclose(got.numpy(), _generic(jdef, params, jg, masks, "edge_prediction", 3), **TOL)


@pytest.mark.parametrize("problem,query,over_budget", [
    ("node_prediction", 3, False), ("graph_prediction", None, False), ("edge_prediction", 3, False),
    # over budget, layer 1 runs the gather-sum; the edge forward then
    # declines (test_ell_edge_over_budget_declines_to_generic)
    ("node_prediction", 3, True), ("graph_prediction", None, True),
])
def test_ell_tier_matches_jax(low_cap, monkeypatch, problem, query, over_budget):
    if over_budget:
        monkeypatch.setattr(JEngine, "_G0_BUDGET_BYTES", 0)
        monkeypatch.setattr(TEngine, "_G0_BUDGET_BYTES", 0)
    jdef, params, tdef, jg, tg = _two_type_setup(seed=86, conv=(6, 6))
    masks = _masks(jg.e_pad if "edge" in problem else jg.n_pad, rows=20, seed=2)
    je = JEngine(jdef, params, jg, restrict=False)
    te = TEngine(tdef, tg, restrict=False, device="cpu")
    want = np.asarray(je.query_outputs(jnp.asarray(masks), query, problem))
    got = te.query_outputs(torch.from_numpy(masks), query, problem)
    ell = te._ell
    assert te._adj is None and (ell.nbr_all is None) == over_budget
    # type-scoped: (a, r1, b) reads a and b rows, writes the b block
    assert ell.ranges == [(0, 16, 9, 16), (0, 16, 0, 9), (0, 9, 0, 9)]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _generic(jdef, params, jg, masks, problem, query), **TOL)


def test_ell_edge_over_budget_declines_to_generic(low_cap, monkeypatch):
    monkeypatch.setattr(TEngine, "_G0_BUDGET_BYTES", 0)
    jdef, params, tdef, jg, tg = _two_type_setup(seed=87, conv=(6, 6))
    masks = _masks(tg.e_pad, rows=8, seed=3)
    te = TEngine(tdef, tg, restrict=False, device="cpu")
    assert te.query_outputs(torch.from_numpy(masks), 3, "edge_prediction") is None
    model = Model(tdef, device="cpu")
    model._fast_cache = (tg, te)
    got = model.perturbed_query_outputs(tg, masks, "edge_prediction", 3)
    np.testing.assert_allclose(got.numpy(), _generic(jdef, params, jg, masks, "edge_prediction", 3), **TOL)


@pytest.mark.parametrize("problem,query", [("node_prediction", 2), ("graph_prediction", None)])
def test_adapter_dispatch_ell_matches_generic(low_cap, problem, query):
    """``Model.perturbed_query_outputs`` through the hetero engine (ELL
    tier, chunks of ``_ELL_CHUNK`` with a ragged last one) against JAX's
    generic forward, and the port's own generic forward."""
    jdef, params, tdef, jg, tg = _two_type_setup(seed=88, conv=(6, 6))
    masks = _masks(tg.n_pad, rows=60, seed=4)
    want = _generic(jdef, params, jg, masks, problem, query)
    got = Model(tdef, device="cpu").perturbed_query_outputs(tg, masks, problem, query)
    slow = Model(tdef, device="cpu", fast=False).perturbed_query_outputs(tg, masks, problem, query)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(slow.numpy(), want, **TOL)


def _typed_graph(node_type, seed, n_edges=40):
    """A hand-built typed graph (no ``hetero_to_homo``): node types as given,
    edges drawn per relation between nodes of its two types."""
    rng = np.random.default_rng(seed)
    node_type = np.asarray(node_type, np.int32)
    feat = rng.normal(size=(node_type.size, 5)).astype(np.float32)
    snd, rcv, et = [], [], []
    for ri, (s, _, d) in enumerate(RELS):
        src = np.nonzero(node_type == "ab".index(s))[0]
        dst = np.nonzero(node_type == "ab".index(d))[0]
        snd.append(rng.choice(src, n_edges))
        rcv.append(rng.choice(dst, n_edges))
        et.append(np.full(n_edges, ri, np.int32))
    ei = np.stack([np.concatenate(snd), np.concatenate(rcv)])
    et = np.concatenate(et)
    jg = px.from_arrays(feat, ei, node_type=node_type, edge_type=et)
    tg = tgraph.from_arrays(feat, ei, node_type=node_type, edge_type=et, device="cpu")
    return jg, tg


@pytest.mark.parametrize("problem,query", [
    ("node_prediction", 4), ("graph_prediction", None), ("edge_prediction", 4),
])
def test_interleaved_types_bias_on_its_scope(low_cap, problem, query):
    """Reference fault (``fast_hetero.py:653,698,862``): where the types'
    rows interleave, the ELL tier runs every relation on the full row range
    and the JAX engine adds each relation's bias to every node.  The port
    multiplies it by the relation's scope: held against JAX's generic
    forward."""
    jg, tg = _typed_graph([0, 1] * 8 + [0, 0, 1], seed=5)
    jdef, params, tdef = _weights(["a", "b"], RELS, 5, (6, 6), seed=6)
    te = TEngine(tdef, tg, restrict=False, device="cpu")
    masks = _masks(tg.e_pad if "edge" in problem else tg.n_pad, rows=12, seed=7)
    got = te.query_outputs(torch.from_numpy(masks), query, problem)
    assert te._ell.ranges == [(0, tg.n_pad, 0, tg.n_pad)] * 3
    np.testing.assert_allclose(got.numpy(), _generic(jdef, params, jg, masks, problem, query), **TOL)


@pytest.mark.parametrize("problem,query", [
    ("node_prediction", 2), ("graph_prediction", None), ("edge_prediction", 2),
])
def test_type_without_nodes_runs_every_relation_full_range(low_cap, problem, query):
    """Reference fault (``fast_hetero.py:565``): a relation whose type has no
    node falls to the full row range while the others stay scoped, and the
    JAX engine's ``assemble`` then stacks overlapping blocks.  The port runs
    every relation on the full range: held against JAX's generic forward."""
    rng = np.random.default_rng(8)
    rels = [("a", "r1", "c"), ("c", "r2", "a"), ("a", "r3", "b")]
    feat = {"a": rng.normal(size=(9, 5)).astype(np.float32),
            "b": np.zeros((0, 5), np.float32),
            "c": rng.normal(size=(7, 5)).astype(np.float32)}
    ei = {rels[0]: np.stack([rng.integers(0, 9, 14), rng.integers(0, 7, 14)]),
          rels[1]: np.stack([rng.integers(0, 7, 12), rng.integers(0, 9, 12)]),
          rels[2]: np.zeros((2, 0), np.int64)}
    jg, _ = jhetero_to_homo(feat, ei)
    tg, _ = tgraph.hetero_to_homo(feat, ei, device="cpu")
    jdef, params, tdef = _weights(["a", "b", "c"], rels, 5, (6, 6), seed=9)
    te = TEngine(tdef, tg, restrict=False, device="cpu")
    masks = _masks(tg.e_pad if "edge" in problem else tg.n_pad, rows=12, seed=10)
    got = te.query_outputs(torch.from_numpy(masks), query, problem)
    assert te._ell.ranges == [(0, tg.n_pad, 0, tg.n_pad)] * 3
    np.testing.assert_allclose(got.numpy(), _generic(jdef, params, jg, masks, problem, query), **TOL)


def _scoped_table(n_out, n_src, k, seed, dead=5):
    """A type-scoped table: ``n_out`` rows (the last ``dead`` of degree 0)
    over ``n_src`` source rows, ``k`` slots (not a multiple of 8)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, 3 * n_out)
    dst = rng.integers(0, n_out - dead, 3 * n_out)
    keep = np.bincount(dst, minlength=n_out)[dst] <= k
    src, dst = src[keep], dst[keep]
    t = build_neighbor_table_edges(n_out, src, dst, np.arange(src.size, dtype=np.int32), k=k,
                                   device="cpu")
    dense = np.zeros((n_out, n_src), np.float32)
    np.add.at(dense, (dst, src), 1.0)
    return t, dense, src, dst


@pytest.mark.parametrize("n_out,n_src", [(30, 70), (50, 20)])
def test_scoped_plain_versions_match_dense(n_out, n_src):
    """Kernels 2.3 and 2.4's plain versions (what the wrappers run on the
    CPU) where source and output rows differ, K = 12, rows of degree 0:
    against ``A_scoped @ X`` in numpy."""
    b, f = 3, 4
    t, dense, src, dst = _scoped_table(n_out, n_src, 12, seed=n_out)
    assert t.k == 12 and int((t.deg == 0).sum()) >= 5
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n_src, b * f)).astype(np.float32)
    post = rng.normal(size=(n_out, b)).astype(np.float32)
    got = spmm_cuda.gather_sum_static(t, torch.from_numpy(x), b, post_scale=torch.from_numpy(post))
    want = ((dense @ x).reshape(n_out, b, f) * post[:, :, None]).reshape(n_out, b * f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # per-edge, per-sample weights, sample-major
    w_e = rng.normal(size=(src.size, b)).astype(np.float32)
    w_bnk = spmm_cuda.slot_weights(t, torch.from_numpy(w_e)).permute(2, 0, 1).contiguous()
    got = spmm_cuda.batched_gather_sum(t, None, torch.from_numpy(x), b, w_sample=w_bnk)
    want = np.zeros((n_out, b, f), np.float32)
    np.add.at(want, dst, w_e[:, :, None] * x[src].reshape(-1, b, f))
    np.testing.assert_allclose(got.numpy(), want.reshape(n_out, b * f), rtol=1e-5, atol=1e-5)
    # the separable entry the ELL tier calls: source and destination factors
    a_src = rng.random((b, n_src)).astype(np.float32)
    a_dst = rng.random((b, n_out)).astype(np.float32)
    got = spmm.gather_sum_batched_separable(torch.from_numpy(a_src), torch.from_numpy(x), b, table=t,
                                            post_a_bn=torch.from_numpy(a_dst))
    scaled = (x.reshape(n_src, b, f) * a_src.T[:, :, None]).reshape(n_src, b * f)
    want = ((dense @ scaled).reshape(n_out, b, f) * a_dst.T[:, :, None]).reshape(n_out, b * f)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_engine_takes_cuda_by_default_and_refuses_other_models():
    _, _, tdef, _, tg = _two_type_setup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(tdef, tg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgraph.hetero_to_homo({"a": np.zeros((2, 3), np.float32)},
                                  {("a", "r", "a"): np.zeros((2, 1), np.int64)})
    sage = tgnn.HeteroGNN(["a", "b"], [{r: tgnn.SAGEConv(5, 6) for r in RELS}], (6, 4))
    with pytest.raises(TypeError):
        TEngine(sage, tg, device="cpu")
    assert Model(sage, device="cpu")._fast_hetero_engine(tg) is None


@pytest.mark.parametrize("n_out,n_src,band", [
    (50_000, 100_000, 64),   # the hetero full graph's relations: 25.6 MB resident
    (50_000, 200_000, 32),   # 51.2 MB of source rows: the band halves
    (200_000, 50_000, 64),   # many output rows over few source rows
])
def test_band_plan_sizes_the_band_from_the_source_rows(n_out, n_src, band):
    """The band walk keeps one band of the *source* rows in L2, so a
    type-scoped launch sizes it from them, not from its output rows."""
    plan = spmm_cuda.band_plan(n_out, 48 * 128, 4, 4, 132, n_src=n_src)
    assert plan.band == band
    assert plan.items == -(-n_out // plan.rows) * -(-48 * 128 // band)
