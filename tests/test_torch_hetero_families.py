"""PyTorch port: the heterogeneous SAGE and GAT families against the JAX
package on the same seeded numpy inputs.

The layers' relation scopes (``dst_scope``: the bias of GATConv and
GATv2Conv, the whole output of SAGEConv) and GAT's ``x_dst``, on batched
edge weights; hetero SAGE and GAT ``HeteroGNN`` forwards; their importers
and ``import_any`` (mixed relation families too); ``FastBatchedHeteroGAT``
against JAX's engine and the port's generic forward (one and two layers,
two heads averaged, duplicate edges, data self-loops, masked query rows, a
relation without an edge in the ball); the adapter's engine choice; and
``Explainer.run`` and ``explain_many`` frames.  Biases are drawn non-zero
(JAX's init puts zeros there, which would hide a bias off its scope).

Tolerance ``rtol=1e-4, atol=1e-5``: float32 in another summation order
(and, for frames, then the surrogate's Adam steps), frames in the same
index order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bikg_graph_explainability_public_tpu as jpx
from bikg_graph_explainability_public_tpu.explain import batch as jbatch
from bikg_graph_explainability_public_tpu.models import layers as jlayers
from bikg_graph_explainability_public_tpu.models import torch_import as jimport
from bikg_graph_explainability_public_tpu.models.fast_hetero import FastBatchedHeteroGAT as JGAT
import bikg_graph_explainability_public_tpu_torch as px
from bikg_graph_explainability_public_tpu_torch.explain import batch as tbatch
from bikg_graph_explainability_public_tpu_torch.models import fast_hetero as tfast
from bikg_graph_explainability_public_tpu_torch.models import layers as tlayers
from bikg_graph_explainability_public_tpu_torch.models import torch_import as timport
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
RELS = [("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a")]
NA, NB, F = 9, 7, 5
CFG = {"seed": 3, "interpret_samples": 10, "epochs": 20, "lr": 0.01, "l1_lambda": 1e-4}


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nonzero_biases(tree, seed):
    """Every ``bias`` leaf of the conv layers drawn from N(0, 0.3)."""
    rng = np.random.default_rng(seed)

    def visit(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "bias":
                    node[k] = (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
                else:
                    visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    visit(tree["conv"])
    return tree


# ---------------------------------------------------------------------------
# layers: scopes and x_dst
# ---------------------------------------------------------------------------

CONVS = {
    "gat": lambda m: m.GATConv((6, 6), 5),
    "gat_heads2_mean": lambda m: m.GATConv((6, 6), 4, heads=2, concat=False),
    "gat_self_loops": lambda m: m.GATConv((6, 6), 4, heads=2, add_self_loops=True),
    "gatv2": lambda m: m.GATv2Conv((6, 6), 4, heads=2),
    "sage": lambda m: m.SAGEConv(6, 5),
}
LAYER_CASES = [(name, scope, xd) for name in CONVS for scope in (False, True)
               for xd in ((False, True) if name != "sage" else (False,))]


@pytest.mark.parametrize("name,scoped,with_x_dst", LAYER_CASES)
def test_conv_scope_and_x_dst_match_jax(name, scoped, with_x_dst):
    rng = np.random.default_rng(11)
    n, e, b = 20, 70, 3
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x_dst = rng.normal(size=(n, 6)).astype(np.float32)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    ew = (rng.random((b, e)) > 0.3).astype(np.float32)
    scope = rng.random(n) > 0.5
    jconv, tconv = CONVS[name](jlayers), CONVS[name](tlayers)
    params = _tree(jconv.init(jax.random.PRNGKey(7)))
    _nonzero_biases({"conv": [params]}, 7)
    tconv.load_state_dict(params_from_numpy(params))
    kw = dict(dst_scope=jnp.asarray(scope) if scoped else None)
    tkw = dict(dst_scope=torch.from_numpy(scope) if scoped else None)
    if with_x_dst:
        kw["x_dst"], tkw["x_dst"] = jnp.asarray(x_dst), torch.from_numpy(x_dst)
    want = jax.vmap(lambda w: jconv.apply(params, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
                                          w, **kw))(jnp.asarray(ew))
    with torch.no_grad():
        got = tconv(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(r),
                    torch.from_numpy(ew), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if scoped and name == "sage":
        # the whole output is scoped, root term and bias included
        assert not got[:, ~scope].any()


# ---------------------------------------------------------------------------
# HeteroGNN forwards
# ---------------------------------------------------------------------------


def _graph(seed, extra=None):
    """Two types, three relations of random edges; ``extra`` appended to
    each relation's edge index (duplicates, self-loops)."""
    rng = np.random.default_rng(seed)
    feat = {"a": rng.normal(size=(NA, F)).astype(np.float32),
            "b": rng.normal(size=(NB, F)).astype(np.float32)}
    sizes = {"a": NA, "b": NB}
    ei = {r: np.stack([rng.integers(0, sizes[r[0]], 12), rng.integers(0, sizes[r[-1]], 12)])
          for r in RELS}
    for r, cols in (extra or {}).items():
        ei[r] = np.concatenate([ei[r], np.asarray(cols)], axis=1)
    return feat, ei


def _factory(family):
    return {"gat": "hetero_gat_for_relations", "sage": "hetero_sage_for_relations"}[family]


def _models(family, conv, fc, seed, rels=RELS):
    """The JAX HeteroGNN (model, params) and the port's, on one weight draw."""
    jdef = getattr(jpx, _factory(family))(["a", "b"], rels, F, conv_channels=conv, fc_channels=fc)
    params = _nonzero_biases(_tree(jdef.init(jax.random.PRNGKey(seed))), seed)
    tdef = getattr(px, _factory(family))(["a", "b"], rels, F, conv_channels=conv, fc_channels=fc)
    tdef.load_state_dict(params_from_numpy(params))
    return jdef, params, tdef


@pytest.mark.parametrize("family", ["gat", "sage"])
def test_hetero_forward_matches_jax(family):
    feat, ei = _graph(1)
    jdef, params, tdef = _models(family, (6, 5), (5, 4), seed=2)
    jg, _ = jpx.hetero_to_homo(feat, ei)
    tg, _ = px.hetero_to_homo(feat, ei, device="cpu")
    want = np.asarray(jpx.Model(jdef, params, fast=False).infer(jg))
    got = px.Model(tdef, device="cpu", fast=False).infer(tg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    masks = np.random.default_rng(3).random((6, jg.n_pad)) < 0.6
    want = jpx.Model(jdef, params, fast=False).perturbed_query_outputs(
        jg, jnp.asarray(masks), "node_prediction", 2)
    got = px.Model(tdef, device="cpu", fast=False).perturbed_query_outputs(
        tg, masks, "node_prediction", 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hetero_defaults_are_jax_s():
    """``hetero_gat_for_relations``'s defaults: conv (2,), fc (2, 2, 4),
    ``GATConv((prev, prev), c, add_self_loops=False)``."""
    tdef = px.hetero_gat_for_relations(["a", "b"], RELS, F)
    jdef = jpx.hetero_gat_for_relations(["a", "b"], RELS, F)
    assert tdef.fc_channels == jdef.fc_channels == (2, 2, 4)
    for tl, jl in zip(tdef.conv_layers, jdef.conv_layers):
        for rel in jl:
            t, j = tl[rel], jl[rel]
            assert isinstance(t, px.GATConv) and not t.add_self_loops
            assert (t.in_src, t.in_dst, t.out_features, t.heads, t.concat) == (
                j.in_src, j.in_dst, j.out_features, j.heads, j.concat)
    params = params_from_numpy(_tree(jdef.init(jax.random.PRNGKey(0))))
    assert set(params) == set(tdef.state_dict())


# ---------------------------------------------------------------------------
# importers
# ---------------------------------------------------------------------------


def _pyg_state_dict(families, conv=(6, 4), fc=(4, 3), seed=4, lin_dst=True):
    """A PyG ``HeteroConv`` state dict (``conv.{2i}.convs.<src__rel__dst>.``,
    head ``fc.{2j}``), relation ``k`` of every layer of ``families[k]``."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd, prev = {}, F
    for i, c in enumerate(conv):
        for rel, fam in zip(RELS, families):
            pre = f"conv.{2 * i}.convs.{'__'.join(rel)}."
            if fam == "gcn":
                sd[pre + "lin.weight"], sd[pre + "bias"] = w(c, prev), w(c)
            elif fam == "sage":
                sd[pre + "lin_l.weight"], sd[pre + "lin_l.bias"] = w(c, prev), w(c)
                sd[pre + "lin_r.weight"] = w(c, prev)
            else:
                sd[pre + "lin_src.weight"] = w(c, prev)
                if lin_dst:
                    sd[pre + "lin_dst.weight"] = w(c, prev)
                sd[pre + "att_src"], sd[pre + "att_dst"] = w(1, 1, c), w(1, 1, c)
                sd[pre + "bias"] = w(c)
        prev = c
    dims = (conv[-1],) + tuple(fc[1:]) + (1,)
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"fc.{2 * j}.weight"], sd[f"fc.{2 * j}.bias"] = w(b, a), w(b)
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize("family,lin_dst", [("sage", True), ("gat", True), ("gat", False)])
def test_hetero_family_importers_match_jax(family, lin_dst):
    sd = _pyg_state_dict([family] * 3, lin_dst=lin_dst)
    got = getattr(timport, f"hetero_{family}_params")(_torch_sd(sd))
    want = params_from_numpy(_tree(getattr(jimport, f"hetero_{family}_params")(sd)))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    if family == "gat" and not lin_dst:
        torch.testing.assert_close(got["conv.1.a__r1__b.lin_dst.weight"],
                                   got["conv.1.a__r1__b.lin_src.weight"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not 'gcn'"):
        timport.hetero_gcn_params(_torch_sd(sd))
    with pytest.raises(ValueError, match=f"not '{family}'"):
        getattr(timport, f"hetero_{family}_params")(_torch_sd(_pyg_state_dict(["gcn"] * 3)))


@pytest.mark.parametrize("families", [("sage",) * 3, ("gat",) * 3, ("gcn", "sage", "gat")])
def test_import_any_hetero_matches_jax(families):
    sd = _pyg_state_dict(list(families), seed=6)
    jdef, jparams = jimport.import_any(sd)
    tdef, tparams = timport.import_any(_torch_sd(sd))
    assert tdef.node_type_names == jdef.node_type_names
    assert tdef.relations == jdef.relations
    for tl, jl in zip(tdef.conv_layers, jdef.conv_layers):
        assert [type(c).__name__ for c in tl.values()] == [type(c).__name__ for c in jl.values()]
    tdef.load_state_dict(tparams)
    feat, ei = _graph(5)
    ei = {r: ei[r] for r in jdef.relations}
    jg, _ = jpx.hetero_to_homo(feat, ei)
    tg, _ = px.hetero_to_homo(feat, ei, device="cpu")
    want = np.asarray(jpx.Model(jdef, jparams, fast=False).infer(jg))
    got = px.Model(tdef, device="cpu", fast=False).infer(tg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_import_any_refuses_other_hetero_families():
    sd = _pyg_state_dict(["gcn"] * 3)
    pre = "conv.0.convs.a__r1__b."
    w = sd.pop(pre + "lin.weight")  # the relation becomes a GraphConv
    sd[pre + "lin_rel.weight"], sd[pre + "lin_root.weight"] = w, w.copy()
    for imp in (jimport.import_any, lambda d: timport.import_any(_torch_sd(d))):
        with pytest.raises(ValueError, match="'graphconv' is not supported"):
            imp(sd)


# ---------------------------------------------------------------------------
# FastBatchedHeteroGAT
# ---------------------------------------------------------------------------


def _heads2_mean_models(seed):
    """Two layers of two heads averaged (``concat=False``)."""
    def layers(m):
        return [{r: m.GATConv((F, F), 6, heads=2, concat=False) for r in RELS},
                {r: m.GATConv((6, 6), 5, heads=2, concat=False) for r in RELS}]

    jdef = jpx.HeteroGNN(["a", "b"], layers(jlayers), (5, 4))
    params = _nonzero_biases(_tree(jdef.init(jax.random.PRNGKey(seed))), seed)
    tdef = px.HeteroGNN(["a", "b"], layers(tlayers), (5, 4))
    tdef.load_state_dict(params_from_numpy(params))
    return jdef, params, tdef


#: a relation without an edge in the query's ball: r2's one edge, b5 -> a8,
#: lies outside a0's and b1's two-hop balls (a2 -> a0, a1 -> a2, a0 -> a1
#: by r3; a_i -> b_i by r1)
SPARSE_EI = {
    RELS[0]: np.stack([np.arange(NB), np.arange(NB)]),
    RELS[1]: np.array([[5], [8]]),
    RELS[2]: np.array([[2, 1, 0], [0, 2, 1]]),
}

ENGINE_CASES = {
    # (graph, model, queries)
    "one_layer": (lambda: _graph(85), lambda: _models("gat", (6,), (6, 4), 85), (0, 3, NA + 2)),
    "two_layers_self_loops_duplicates": (
        lambda: _graph(86, extra={RELS[2]: [[2, 4, 3, 3], [2, 4, 5, 5]], RELS[0]: [[1, 1], [2, 2]]}),
        lambda: _models("gat", (6, 6), (6, 4), 86), (0, 2, 4, NA + 2)),
    "heads2_mean": (lambda: _graph(87), lambda: _heads2_mean_models(87), (1, NA + 3)),
    "relation_without_edges": (
        lambda: ({"a": np.random.default_rng(8).normal(size=(NA, F)).astype(np.float32),
                  "b": np.random.default_rng(9).normal(size=(NB, F)).astype(np.float32)}, SPARSE_EI),
        lambda: _models("gat", (6, 6), (6, 4), 88), (0, NA + 1)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_gat_engine_matches_jax_engine_and_generic_forward(case):
    make_graph, make_models, queries = ENGINE_CASES[case]
    feat, ei = make_graph()
    jdef, params, tdef = make_models()
    jg, _ = jpx.hetero_to_homo(feat, ei)
    tg, _ = px.hetero_to_homo(feat, ei, device="cpu")
    jeng = JGAT(jdef, params, jg)
    teng = tfast.FastBatchedHeteroGAT(tdef, tg, device="cpu")
    generic = px.Model(tdef, device="cpu", fast=False)
    masks = np.random.default_rng(1).random((24, tg.n_pad)) < 0.6
    for q in queries:
        m = masks.copy()
        m[:5, q] = False  # masked query rows
        want = np.asarray(jeng.query_outputs(jnp.asarray(m), q, "node_prediction"))
        got = teng.query_outputs(m, q, "node_prediction", chunk_size=10)  # a ragged last chunk
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        plain = generic.perturbed_query_outputs(tg, m, "node_prediction", q)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    if case == "relation_without_edges":
        plan = teng.query_plan(0)
        assert plan.a_deg.numel() == 0
        assert all(a[1].sum() == 0 for a in plan.a_layers)  # r2 has no edge in the ball
    if case == "two_layers_self_loops_duplicates":
        assert max(float(a.max()) for a in teng.query_plan(2).a_layers) >= 2  # multiplicity


def test_adapter_picks_the_gat_engine_and_it_declines_edges_and_graphs():
    feat, ei = _graph(90)
    jdef, params, tdef = _models("gat", (6,), (6, 4), 90)
    tg, _ = px.hetero_to_homo(feat, ei, device="cpu")
    jg, _ = jpx.hetero_to_homo(feat, ei)
    fast = px.Model(tdef, device="cpu")
    engine = fast._fast_hetero_engine(tg)
    assert isinstance(engine, tfast.FastBatchedHeteroGAT)
    assert fast._fast_hetero_engine(tg) is engine  # cached per graph
    generic = px.Model(tdef, device="cpu", fast=False)
    rng = np.random.default_rng(2)
    nm, em = rng.random((8, tg.n_pad)) < 0.6, rng.random((8, tg.e_pad)) < 0.6
    assert engine.query_outputs(em, 3, "edge_prediction") is None
    assert engine.query_outputs(nm, None, "graph_prediction") is None
    unrestricted = tfast.FastBatchedHeteroGAT(tdef, tg, restrict=False, device="cpu")
    assert unrestricted.query_outputs(nm, 3, "node_prediction") is None
    for masks, problem, q in ((em, "edge_prediction", 3), (nm, "graph_prediction", None),
                              (nm, "node_prediction", 3)):
        got = fast.perturbed_query_outputs(tg, masks, problem, q)
        np.testing.assert_allclose(got.numpy(), generic.perturbed_query_outputs(
            tg, masks, problem, q).numpy(), **TOL)
        want = jpx.Model(jdef, params).perturbed_query_outputs(jg, jnp.asarray(masks), problem, q)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("model", ["sage", "gat_self_loops", "gatv2"])
def test_gat_engine_refuses_other_convs(model):
    tg, _ = px.hetero_to_homo(*_graph(91), device="cpu")
    layer = {
        "sage": lambda r: tlayers.SAGEConv(F, 4),
        "gat_self_loops": lambda r: tlayers.GATConv((F, F), 4, add_self_loops=True),
        # not a GATConv: the check is exact
        "gatv2": lambda r: tlayers.GATv2Conv((F, F), 4, add_self_loops=False),
    }[model]
    tdef = px.HeteroGNN(["a", "b"], [{r: layer(r) for r in RELS}], (4, 3))
    with pytest.raises(TypeError):
        tfast.FastBatchedHeteroGAT(tdef, tg, device="cpu")
    assert px.Model(tdef, device="cpu")._fast_hetero_engine(tg) is None


# ---------------------------------------------------------------------------
# Explainer.run and explain_many
# ---------------------------------------------------------------------------


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns) and got.index.name == want.index.name
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


NODE_NAMES = {"a": [f"a{i}" for i in range(NA)], "b": [f"b{i}" for i in range(NB)]}
EDGE_NAMES = {r: [f"{r[1]}.{i}" for i in range(12)] for r in RELS}
RUNS = {
    "gat_node_engine": ("gat", dict(problem="node_prediction", element_type="a"), NODE_NAMES, "a3"),
    "gat_node_community": ("gat", dict(
        problem="node_prediction", element_type="b",
        pathways={"a": [["a1", "a2", "a5"]], "b": [["b0", "b2", "b4"]]},
        pathway_names={"a": ["pa"], "b": ["pb"]}), NODE_NAMES, "b2"),
    "gat_edge_generic": ("gat", dict(problem="edge_prediction", element_type=RELS[1]), EDGE_NAMES,
                         "r2.4"),
    "sage_node": ("sage", dict(problem="node_prediction", element_type="a"), NODE_NAMES, "a3"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_explainer_run_matches_jax(run):
    family, kw, names, element = RUNS[run]
    feat, ei = _graph(12)
    jdef, params, tdef = _models(family, (6,), (6, 4), 13)
    model = px.Model(tdef, device="cpu")
    jcv, jpw = jpx.Explainer(feat, ei, jpx.Model(jdef, params), CFG, names, **kw).run(element)
    tcv, tpw = px.Explainer(feat, ei, model, CFG, names, device="cpu", **kw).run(element)
    _assert_frames(tcv, jcv)
    if jpw is None:
        assert tpw is None
    else:
        _assert_frames(tpw, jpw)
    if run == "gat_node_engine":
        assert isinstance(model._fast_cache[1], tfast.FastBatchedHeteroGAT)


def test_hetero_gat_explain_many_matches_jax():
    """The typed coo route (hetero GAT node problems take it, as in JAX)."""
    feat, ei = _graph(14)
    jdef, params, tdef = _models("gat", (6,), (6, 4), 15)
    jg, _ = jpx.hetero_to_homo(feat, ei)
    tg, _ = px.hetero_to_homo(feat, ei, device="cpu")
    names = NODE_NAMES["a"] + NODE_NAMES["b"]
    queries = [3, NA + 2, 6]
    cfg = dict(CFG, interpret_samples=20, epochs=50)
    want = jbatch.explain_many(jpx.Model(jdef, params), jg, queries, cfg, names=names)
    got = tbatch.explain_many(px.Model(tdef, device="cpu"), tg, queries, cfg, names=names)
    assert len(got) == len(want) == len(queries)
    for g, w in zip(got, want):
        _assert_frames(g, w)
