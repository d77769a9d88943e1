"""PyTorch port: ``explain_many`` on heterogeneous GCNs gives the JAX
package's frames for the same seed (same index order, ``rtol=1e-4,
atol=1e-6``): node problems on the hetero_dense formulation (Shapley mode
with one and three repeats, with and without size buckets, and community
mode), edge problems on one relation and graph problems on the typed coo
route, subgraphs in which a relation has no edges or a node type is absent,
and the typed stack's arrays.  Type ids outside the model's lists raise.

The model has two conv layers of different widths, (8, 5), so the second
layer runs on a running width other than ``in_features``; its biases are
non-zero, so a bias off its relation's scope would show."""

from __future__ import annotations

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import bikg_graph_explainability_public_tpu as jpx
from bikg_graph_explainability_public_tpu.explain import batch as jbatch
import bikg_graph_explainability_public_tpu_torch as px
from bikg_graph_explainability_public_tpu_torch.explain import batch as tbatch
from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy
from bikg_graph_explainability_public_tpu_torch.utils.profiling import PhaseTimer

#: the same float32 forwards in another order, then 50 Adam steps
TOL = dict(rtol=1e-4, atol=1e-6)
RELS = [("a", "r1", "b"), ("b", "r2", "a")]
NA, NB, F, E = 14, 12, 6, 40
CONV, FC = (8, 5), (5, 4)
CFG = {"seed": 3, "interpret_samples": 20, "epochs": 50, "lr": 0.01, "l1_lambda": 1e-4}
NAMES = [f"a{i}" for i in range(NA)] + [f"b{i}" for i in range(NB)]
EDGE_NAMES = [f"e{i}" for i in range(2 * E)]
#: node queries of both types (a3, b3, a9, b6)
QUERIES = [3, NA + 3, 9, NA + 6]


def _models(rels, seed):
    """The JAX model and the port's, on the same seeded weights (non-zero
    biases), carried by ``params_from_numpy``."""
    jdef = jpx.hetero_gcn_for_relations(["a", "b"], rels, F, conv_channels=CONV, fc_channels=FC)
    params = jax.tree_util.tree_map(np.asarray, jdef.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in params["conv"]:
        for p in layer.values():
            p["bias"] = rng.normal(size=p["bias"].shape).astype(np.float32) * 0.3
    tdef = px.hetero_gcn_for_relations(["a", "b"], rels, F, conv_channels=CONV, fc_channels=FC)
    return jpx.Model(jdef, params), px.Model(tdef, params_from_numpy(params), device="cpu")


def _setup(feat, ei, rels, seed):
    jm, tm = _models(rels, seed)
    jg, _ = jpx.hetero_to_homo(feat, ei)
    tg, _ = px.hetero_to_homo(feat, ei, device="cpu")
    return dict(feat=feat, ei=ei, jm=jm, tm=tm, jg=jg, tg=tg, cache={})


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    feat = {"a": rng.normal(size=(NA, F)).astype(np.float32),
            "b": rng.normal(size=(NB, F)).astype(np.float32)}
    ei = {RELS[0]: np.stack([rng.integers(0, NA, E), rng.integers(0, NB, E)]),
          RELS[1]: np.stack([rng.integers(0, NB, E), rng.integers(0, NA, E)])}
    return _setup(feat, ei, RELS, 2)


#: three relations, few edges: a0 -> a1 -> ... -> a6 (r3), a_i -> b_i (r1),
#: b10, b11 -> a13 (r2)
SPARSE_RELS = [("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a")]
SPARSE_QUERIES = {
    # a4's ball is a1..a4: only r3 has edges, and type b is absent
    "type_absent": [4],
    # b2's ball is b2, a2, a1, a0 (r1, r3): r2 has no edges
    "relation_without_edges": [NA + 2],
    # a13's ball is a13, b10, b11, a10, a11 (r1, r2): r3 has no edges
    "mixed": [13, NA + 2, 4],
}


@pytest.fixture(scope="module")
def sparse():
    rng = np.random.default_rng(8)
    feat = {"a": rng.normal(size=(NA, F)).astype(np.float32),
            "b": rng.normal(size=(NB, F)).astype(np.float32)}
    ei = {
        SPARSE_RELS[0]: np.stack([np.arange(NB), np.arange(NB)]),
        SPARSE_RELS[1]: np.array([[10, 11], [13, 13]]),
        SPARSE_RELS[2]: np.stack([np.arange(6), np.arange(1, 7)]),
    }
    return _setup(feat, ei, SPARSE_RELS, 4)


def _both(s, key, queries, cfg=CFG, **kw):
    """(port frames, JAX frames) of one call; the JAX side cached by key."""
    if key not in s["cache"]:
        s["cache"][key] = jbatch.explain_many(s["jm"], s["jg"], queries, cfg, **kw)
    return tbatch.explain_many(s["tm"], s["tg"], queries, cfg, **kw), s["cache"][key]


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    assert got.index.name == want.index.name
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


def _assert_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _assert_frames(g[0], w[0])
            _assert_frames(g[1], w[1])
        else:
            _assert_frames(g, w)


# ---------------------------------------------------------------------------
# the typed stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("problem", ["node_prediction", "edge_prediction", "graph_prediction"])
def test_typed_stack_matches_jax(setup, problem):
    queries = QUERIES if problem == "node_prediction" else [1, E + 5]
    seeds = tbatch._seed_nodes(setup["tg"], queries, problem)
    assert seeds == jbatch._seed_nodes(setup["jg"], queries, problem)
    node = problem == "node_prediction"
    full = problem == "graph_prediction"
    got = tbatch._Stack(setup["tg"], seeds, 3, need_edges=not node, typed=True, full_graph=full,
                        rel_model=setup["tm"].model_def if node else None)
    want = jbatch._Stack(setup["jg"], seeds, 3, need_edges=not node, typed=True, full_graph=full,
                         rel_model=setup["jm"].model_def if node else None)
    assert (got.n_pad, got.e_pad, got.qn) == (want.n_pad, want.e_pad, want.qn)
    names = ["xs", "snds", "rcvs", "evalid", "qidx", "nvalid", "evalid_count", "ntype", "etype"]
    if node:
        names += ["adjs_r", "scopes"]
        assert got.adjs is None and want.adjs is None
        # padding nodes lie in no relation's scope; every valid node in one
        assert (got.scopes.sum(1)[:, : got.nvalid.min()] >= 1).all()
    else:
        assert got.adjs_r is None and got.scopes is None
    for name in names:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for a, b in zip(got.parent_nodes + got.parent_edges, want.parent_nodes + want.parent_edges):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# node problems: the hetero_dense formulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("times,size_buckets", [(1, True), (3, True), (1, False), (3, False)])
def test_shapley_node_problem_matches_jax(setup, times, size_buckets):
    kw = dict(names=NAMES, times=times, size_buckets=size_buckets)
    got, want = _both(setup, ("shapley", times, size_buckets), QUERIES, **kw)
    _assert_results(got, want)
    if times > 1:
        assert all((df["config_value_std"] > 0).any() for df in got)


def test_community_mode_matches_jax(setup):
    """Communities over both types; the queries' subgraphs meet different
    numbers of them, so their community batches differ in size."""
    rng = np.random.default_rng(40)
    pathways = [[NAMES[int(v)] for v in rng.choice(NA + NB, 4, replace=False)] for _ in range(9)]
    pathway_names = [f"c{i}" for i in range(9)]
    kw = dict(names=NAMES, times=2, pathways=pathways, pathway_names=pathway_names)
    got, want = _both(setup, "community", QUERIES, **kw)
    _assert_results(got, want)


def test_hetero_dense_is_the_typed_forward(setup):
    """The hetero_dense formulation gives the model's own forward (the
    typed coo route) on the same stack and masks."""
    tm = setup["tm"]
    seeds = tbatch._seed_nodes(setup["tg"], QUERIES, "node_prediction")
    dense = tbatch._Stack(setup["tg"], seeds, 3, need_edges=False, rel_model=tm.model_def)
    coo = tbatch._Stack(setup["tg"], seeds, 3, need_edges=True, typed=True)
    t = {k: torch.from_numpy(getattr(coo, k)) for k in
         ("xs", "snds", "rcvs", "evalid", "ntype", "etype", "qidx", "nvalid")}
    masks = torch.from_numpy(np.random.default_rng(3).random((coo.qn, 30, coo.n_pad)) < 0.6)
    with torch.no_grad():
        got = tbatch._hetero_dense_outputs(
            tm.model_def, t["xs"], torch.from_numpy(dense.adjs_r), torch.from_numpy(dense.scopes),
            t["qidx"], masks, chunk=7,
        )
        want = tbatch._coo_outputs(
            tm.model_def, "node_prediction", t["xs"], t["snds"], t["rcvs"], t["evalid"],
            t["ntype"], t["etype"], t["qidx"], t["nvalid"], masks, chunk=30,
        )
    assert got.shape == (coo.qn, 30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(SPARSE_QUERIES))
def test_sparse_subgraphs_match_jax(sparse, case):
    """A subgraph in which a node type is absent, or a relation has no
    edges: the relations with nothing to do keep only their scoped self
    terms, or nothing."""
    got, want = _both(sparse, case, SPARSE_QUERIES[case], names=NAMES, times=2)
    _assert_results(got, want)
    if case == "type_absent":
        assert list(got[0].index) and all(n.startswith("a") for n in got[0].index)


# ---------------------------------------------------------------------------
# edge and graph problems: the typed coo route
# ---------------------------------------------------------------------------


def test_edge_problem_on_one_relation_matches_jax(setup):
    """Edge queries of relation r2 (homogenised edges E .. 2E - 1)."""
    kw = dict(names=EDGE_NAMES, problem="edge_prediction", times=2)
    got, want = _both(setup, "edge", [E + 1, E + 7, E + 20], **kw)
    _assert_results(got, want)
    assert all(n.startswith("e") for df in got for n in df.index)


def test_graph_problem_matches_jax(setup):
    kw = dict(names=NAMES, problem="graph_prediction")
    got, want = _both(setup, "graph", [0, 1], **kw)
    _assert_results(got, want)
    assert len(got[0]) == NA + NB


# ---------------------------------------------------------------------------
# caches and refusals
# ---------------------------------------------------------------------------


def test_plan_cache_hit_and_determinism(setup):
    kw = dict(names=NAMES, times=2)
    first = tbatch._explain_many(setup["tm"], setup["tg"], QUERIES, CFG, **kw)
    timer = PhaseTimer()
    again = tbatch._explain_many(setup["tm"], setup["tg"], QUERIES, CFG, timer=timer, **kw)
    assert "plan_build" not in timer.counts
    for a, b in zip(first, again):
        assert a.names == b.names
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)


@pytest.mark.parametrize("what", ["node type", "edge type"])
def test_out_of_range_type_ids_raise(setup, what):
    """Type ids are positions in the model's lists: an id past them names
    no type of the model."""
    tg = setup["tg"]
    hv = tg.host
    nt = hv.node_type[: tg.num_nodes].copy()
    et = hv.edge_type[: tg.num_edges].copy()
    if what == "node type":
        nt[5] = 2
    else:
        et[3] = 2
    ei = np.stack([hv.senders[: tg.num_edges], hv.receivers[: tg.num_edges]])
    bad = from_arrays(hv.x[: tg.num_nodes], ei, node_type=nt, edge_type=et, device="cpu")
    with pytest.raises(ValueError, match=what):
        tbatch.explain_many(setup["tm"], bad, QUERIES, CFG, names=NAMES)
