"""PyTorch port: the homogeneous model families (GAT, GATv2, SAGE,
GraphConv, GIN), the generic conv-stack model and checkpoint import, held
against the JAX package on the same seeded numpy inputs.

Layers and models are compared at ``rtol=1e-5`` (float32 in another
summation order), with the JAX parameter trees carried across by
``params_from_numpy``; ``Explainer.run`` on the trained GAT fixture at
``rtol=1e-4`` (the same forwards, then 50 Adam steps), same index order.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.models import gnn as jgnn
from bikg_graph_explainability_public_tpu.models import layers as jlayers
from bikg_graph_explainability_public_tpu.models import torch_import as jimport
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
from bikg_graph_explainability_public_tpu_torch.models import gnn as tgnn
from bikg_graph_explainability_public_tpu_torch.models import layers as tlayers
from bikg_graph_explainability_public_tpu_torch.models import torch_import as timport
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy

from fixtures import make_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAT_CKPT = os.path.join(ROOT, "test_data", "gat_homo_1hop_36n_own.pth.tar")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
TOL = dict(rtol=1e-5, atol=1e-6)
#: the same forwards in another order, then 50 Adam steps
RUN_TOL = dict(rtol=1e-4, atol=1e-6)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _graph(seed, n=30, f=6, e=110):
    feat, ei, _ = make_graph(n=n, f=f, e=e, seed=seed)
    s, r = ei.astype(np.int64)
    rng = np.random.default_rng(seed)
    ew = (rng.random((3, e)) > 0.3).astype(np.float32)  # three perturbed graphs
    return feat, s, r, ew


def _apply_each(fn, feat, s, r, ew, per_sample=False):
    """The JAX side, one mask (and, with ``per_sample``, one feature row
    block) at a time."""
    return np.stack([
        np.asarray(fn(jnp.asarray(feat[i] if per_sample else feat), jnp.asarray(s),
                      jnp.asarray(r), jnp.asarray(w)))
        for i, w in enumerate(ew)
    ])


def _hold_layer(jlayer, tlayer, seed, f_in=6):
    feat, s, r, ew = _graph(seed, f=f_in)
    params = jlayer.init(jax.random.PRNGKey(seed))
    tlayer.load_state_dict(params_from_numpy(_tree(params)))
    args = (torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(ew))
    want = _apply_each(lambda *a: jlayer.apply(params, *a), feat, s, r, ew)
    with torch.no_grad():
        got = tlayer(torch.from_numpy(feat), *args).numpy()  # shared x, batched masks
    np.testing.assert_allclose(got, want, **TOL)
    # per-sample features [B, N, F], as a layer >= 2 sees them
    xb = np.random.default_rng(seed + 1).standard_normal((3,) + feat.shape).astype(np.float32)
    want = _apply_each(lambda *a: jlayer.apply(params, *a), xb, s, r, ew, per_sample=True)
    with torch.no_grad():
        got = tlayer(torch.from_numpy(xb), *args).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # one unbatched mask
    with torch.no_grad():
        one = tlayer(torch.from_numpy(feat), args[0], args[1], args[2][0]).numpy()
    np.testing.assert_allclose(one, _apply_each(
        lambda *a: jlayer.apply(params, *a), feat, s, r, ew[:1])[0], **TOL)


# --- layers ---------------------------------------------------------------


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gatconv_matches_jax(add_self_loops, heads, concat):
    kw = dict(heads=heads, concat=concat, add_self_loops=add_self_loops)
    _hold_layer(jlayers.GATConv((6, 6), 5, **kw), tlayers.GATConv((6, 6), 5, **kw), seed=heads)


@pytest.mark.parametrize("share_weights", [False, True])
@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gatv2conv_matches_jax(add_self_loops, heads, concat, share_weights):
    kw = dict(heads=heads, concat=concat, add_self_loops=add_self_loops, share_weights=share_weights)
    _hold_layer(jlayers.GATv2Conv((6, 6), 5, **kw), tlayers.GATv2Conv((6, 6), 5, **kw), seed=3)


def test_gatv2_share_weights_reads_lin_l():
    """With ``share_weights`` the forward reads lin_l for both sides, so a
    diverged lin_r changes nothing."""
    conv = tlayers.GATv2Conv((6, 6), 5, heads=2, share_weights=True)
    feat, s, r, ew = _graph(4)
    args = (torch.from_numpy(feat), torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(ew))
    with torch.no_grad():
        before = conv(*args)
        torch.testing.assert_close(conv.lin_r.weight, conv.lin_l.weight, rtol=0, atol=0)
        conv.lin_r.weight.add_(1.0)
        torch.testing.assert_close(conv(*args), before, rtol=0, atol=0)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", ["SAGEConv", "GraphConv"])
def test_root_and_neighbour_convs_match_jax(name, bias):
    _hold_layer(getattr(jlayers, name)(6, 5, bias=bias), getattr(tlayers, name)(6, 5, bias=bias), seed=5)


@pytest.mark.parametrize("mlp,eps", [((), 0.0), ((8,), 0.1), ((8, 7), -0.2)])
def test_ginconv_matches_jax(mlp, eps):
    _hold_layer(
        jlayers.GINConv(6, 5, mlp_channels=mlp, eps=eps),
        tlayers.GINConv(6, 5, mlp_channels=mlp, eps=eps), seed=6,
    )


def test_masked_edges_leave_the_softmax():
    """A receiver whose in-edges are all masked keeps only its self-loop
    (the ``isfinite`` guard), and without self-loops gets exactly 0."""
    feat, s, r, ew = _graph(7)
    ew[:] = 0.0
    args = (torch.from_numpy(feat), torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(ew))
    with torch.no_grad():
        for loops in (True, False):
            conv = tlayers.GATConv((6, 6), 5, heads=2, add_self_loops=loops, bias=False)
            out = conv(*args)
            assert torch.isfinite(out).all()
            if loops:  # the softmax over the self-loop alone is 1
                torch.testing.assert_close(out, conv.lin_src(args[0]).expand_as(out))
            else:
                assert (out == 0).all()


# --- models and parameter trees ---------------------------------------------


FACTORIES = {
    "gat": dict(heads=2),
    "gat_mean": dict(heads=2, concat=False, add_self_loops=False),
    "gatv2": dict(heads=2),
    "gatv2_shared": dict(heads=1, share_weights=True),
    "sage": {},
    "graph_conv": {},
    "gin": dict(mlp_hidden=7),
}


def _factory(name):
    fam = name.split("_shared")[0].split("_mean")[0]
    return f"{fam}_node_model", FACTORIES[name]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_models_match_jax(name, seed):
    fn, kw = _factory(name)
    wide = kw.get("heads", 1) if kw.get("concat", True) else 1
    fc = (4 * wide, 3)
    jdef = getattr(jgnn, fn)(6, conv_channels=(8, 4), fc_channels=fc, **kw)
    tdef = getattr(tgnn, fn)(6, conv_channels=(8, 4), fc_channels=fc, **kw)
    params = jdef.init(jax.random.PRNGKey(seed))
    sd = params_from_numpy(_tree(params))
    assert sorted(sd) == sorted(tdef.state_dict())
    tdef.load_state_dict(sd)
    feat, s, r, ew = _graph(seed + 10)
    args = (torch.from_numpy(feat), torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(ew))
    with torch.no_grad():
        got = tdef(*args).numpy()
        back = tdef.backbone(*args[:3], args[3][0]).numpy()
    np.testing.assert_allclose(got, _apply_each(lambda *a: jdef.apply(params, *a), feat, s, r, ew), **TOL)
    np.testing.assert_allclose(
        back, np.asarray(jdef.backbone(params, *map(jnp.asarray, (feat, s, r, ew[0])))), **TOL
    )
    assert tdef.num_hops == jdef.num_hops == 2
    assert isinstance(tdef, tgnn.ConvStackNodeModel)


def test_factory_generator_seeds_the_weights():
    a = tgnn.gat_node_model(6, generator=torch.Generator().manual_seed(3))
    b = tgnn.gat_node_model(6, generator=torch.Generator().manual_seed(3))
    c = tgnn.gat_node_model(6, generator=torch.Generator().manual_seed(4))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    assert not torch.equal(a.state_dict()["conv.0.lin_src.weight"], c.state_dict()["conv.0.lin_src.weight"])


@pytest.mark.parametrize("problem,query", [
    ("node_prediction", 7), ("edge_prediction", 7), ("graph_prediction", None),
])
@pytest.mark.parametrize("name", ["gatv2", "sage", "gin"])
def test_generic_route_matches_jax(name, problem, query):
    """``Model.perturbed_query_outputs`` of a conv-stack model: the generic
    batched forward (head on the query row) against the JAX adapter's vmap."""
    fn, kw = _factory(name)
    jdef = getattr(jgnn, fn)(6, conv_channels=(8, 8), fc_channels=(8 * kw.get("heads", 1), 4), **kw)
    params = jdef.init(jax.random.PRNGKey(2))
    tdef = getattr(tgnn, fn)(6, conv_channels=(8, 8), fc_channels=(8 * kw.get("heads", 1), 4), **kw)
    feat, ei, _ = make_graph(n=30, f=6, e=110, seed=2)
    jg, tg = px.from_arrays(feat, ei), tgraph.from_arrays(feat, ei, device="cpu")
    width = jg.e_pad if problem == "edge_prediction" else jg.n_pad
    masks = np.random.default_rng(1).random((24, width)) > 0.3
    jm = px.Model(jdef, params)
    tm = Model(tdef, params_from_numpy(_tree(params)), device="cpu")
    want = np.asarray(jm.perturbed_query_outputs(jg, jnp.asarray(masks), problem, query, chunk_size=8))
    got = tm.perturbed_query_outputs(tg, masks, problem, query, chunk_size=8).numpy()
    assert got.shape == (24,)
    np.testing.assert_allclose(got, want, **TOL)


# --- checkpoint import --------------------------------------------------------


def _pyg_layer(family, rng, fin, c, heads=1, concat=True, share=False):
    """One PyG conv layer's state dict (numpy) and its output width."""
    def g(*shape):
        return (0.4 * rng.standard_normal(shape)).astype(np.float32)

    out = heads * c if concat else c
    if family == "gcn":
        return {"lin.weight": g(c, fin), "bias": g(c)}, c
    if family == "gat":
        w = g(heads * c, fin)
        return {"lin_src.weight": w, "lin_dst.weight": w, "att_src": g(1, heads, c),
                "att_dst": g(1, heads, c), "bias": g(out)}, out
    if family == "gatv2":
        d = {"lin_l.weight": g(heads * c, fin), "lin_l.bias": g(heads * c),
             "att": g(1, heads, c), "bias": g(out)}
        if not share:
            d.update({"lin_r.weight": g(heads * c, fin), "lin_r.bias": g(heads * c)})
        return d, out
    if family == "sage":
        return {"lin_l.weight": g(c, fin), "lin_l.bias": g(c), "lin_r.weight": g(c, fin)}, c
    if family == "graphconv":
        return {"lin_rel.weight": g(c, fin), "lin_rel.bias": g(c), "lin_root.weight": g(c, fin)}, c
    if family == "gin":
        return {"nn.0.weight": g(7, fin), "nn.0.bias": g(7), "nn.2.weight": g(c, 7),
                "nn.2.bias": g(c), "eps": np.array([0.1], np.float32)}, c
    raise ValueError(family)


def _pyg_state_dict(layers, seed, fin=6):
    """A PyG-layout ``conv.{2i}`` / ``fc.{2j}`` state dict from a seed."""
    rng = np.random.default_rng(seed)
    sd, prev = {}, fin
    for i, (family, c, kw) in enumerate(layers):
        layer, prev = _pyg_layer(family, rng, prev, c, **kw)
        sd.update({f"conv.{2 * i}.{k}": v for k, v in layer.items()})
    for j, (a, b) in enumerate([(prev, 4), (4, 1)]):
        sd[f"fc.{2 * j}.weight"] = (0.4 * rng.standard_normal((b, a))).astype(np.float32)
        sd[f"fc.{2 * j}.bias"] = (0.4 * rng.standard_normal(b)).astype(np.float32)
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _hold_params(got, jtree):
    want = params_from_numpy(_tree(jtree))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        torch.testing.assert_close(v, want[k].reshape(v.shape), rtol=0, atol=0)


STACKS = {
    "gcn": [("gcn", 8, {}), ("gcn", 4, {})],
    "gat": [("gat", 5, dict(heads=2)), ("gat", 4, {})],
    "gat_mean": [("gat", 5, dict(heads=3, concat=False))],
    "gatv2": [("gatv2", 5, dict(heads=2)), ("gatv2", 4, dict(share=True))],
    "sage": [("sage", 8, {}), ("sage", 4, {})],
    "graphconv": [("graphconv", 8, {}), ("graphconv", 4, {})],
    "gin": [("gin", 8, {}), ("gin", 4, {})],
    "gcn_sage": [("gcn", 8, {}), ("sage", 4, {})],
    "gat_gin_graphconv": [("gat", 3, dict(heads=2)), ("gin", 5, {}), ("graphconv", 4, {})],
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_import_any_matches_jax(name):
    sd = _pyg_state_dict(STACKS[name], seed=len(name))
    jdef, jparams = jimport.import_any(sd)
    tdef, tparams = timport.import_any(_torch_sd(sd))
    assert type(tdef).__name__ == type(jdef).__name__
    assert isinstance(tdef, tgnn.GCNNodeModel) == (name == "gcn")
    _hold_params(tparams, jparams)
    tdef.load_state_dict(tparams)
    feat, s, r, ew = _graph(20)
    args = (torch.from_numpy(feat), torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(ew))
    with torch.no_grad():
        got = tdef(*args).numpy()
    np.testing.assert_allclose(got, _apply_each(lambda *a: jdef.apply(jparams, *a), feat, s, r, ew), **TOL)
    assert tdef.num_hops == jdef.num_hops


@pytest.mark.parametrize("name,fn", [
    ("gcn", "gcn_node_model_params"), ("gat", "gat_node_model_params"),
    ("gat_mean", "gat_node_model_params"), ("gatv2", "gatv2_node_model_params"),
    ("sage", "sage_node_model_params"), ("graphconv", "graph_conv_node_model_params"),
    ("gin", "gin_node_model_params"),
])
def test_family_importers_match_jax(name, fn):
    sd = _pyg_state_dict(STACKS[name], seed=3)
    _hold_params(getattr(timport, fn)(_torch_sd(sd)), getattr(jimport, fn)(sd))
    if name.startswith("gat"):
        assert timport.gat_config_from_state_dict(sd) == jimport.gat_config_from_state_dict(sd)
    with pytest.raises(ValueError):  # another family's layout
        getattr(timport, fn)(_torch_sd(_pyg_state_dict(STACKS["gcn" if name == "gin" else "gin"], 3)))


def test_gat_importer_fills_lin_dst_from_the_shared_lin_src():
    sd = _pyg_state_dict(STACKS["gat"], seed=4)
    for k in [k for k in sd if "lin_dst" in k]:
        del sd[k]
    params = timport.gat_node_model_params(_torch_sd(sd))
    _hold_params(params, jimport.gat_node_model_params(sd))
    torch.testing.assert_close(params["conv.0.lin_dst.weight"], params["conv.0.lin_src.weight"])


def test_import_any_refuses_what_is_not_ported_or_unknown():
    sd = _pyg_state_dict(STACKS["gcn"], seed=5)
    # hetero layouts (tests/test_torch_hetero_graph.py and
    # tests/test_torch_hetero_families.py): a layer without relations is
    # refused, as in JAX; hetero SAGE relations and RGCN import as JAX
    # imports them
    hetero = {k.replace("conv.0.", "conv.0.convs.a__to__b."): v for k, v in sd.items()}
    with pytest.raises(ValueError, match="no relations"):
        timport.import_any(hetero)
    sage = _pyg_state_dict(STACKS["sage"], seed=5)
    hetero = {k.replace("conv.0.", "conv.0.convs.a__to__b.").replace("conv.2.", "conv.2.convs.a__to__b."): v
              for k, v in sage.items()}
    tdef, _ = timport.import_any(hetero)
    jdef, _ = jimport.import_any(hetero)
    assert tdef.relations == jdef.relations == [("a", "to", "b")]
    rgcn = {"conv.0.weight": np.zeros((3, 6, 4), np.float32), "conv.0.root": np.zeros((6, 4), np.float32),
            "conv.0.comp": np.zeros((3, 2), np.float32), **{k: v for k, v in sd.items() if k.startswith("fc.")}}
    tdef, _ = timport.import_any(rgcn)
    assert (tdef.num_relations, tdef.conv[0].num_bases) == (3, 2)
    unknown = {"conv.0.foo.weight": np.zeros((4, 6), np.float32), **{k: v for k, v in sd.items() if k.startswith("fc.")}}
    with pytest.raises(ValueError, match="unrecognised"):
        timport.import_any(unknown)
    with pytest.raises(ValueError, match="fc"):
        timport.import_any({k: v for k, v in sd.items() if k.startswith("conv.")})
    with pytest.raises(ValueError, match="conv"):
        timport.import_any({k: v for k, v in sd.items() if k.startswith("fc.")})
    with pytest.raises(ValueError):
        timport.gat_config_from_state_dict(sd)


# --- the trained GAT fixture ------------------------------------------------------


@pytest.fixture(scope="module")
def gat_fixture():
    sd = timport.load_state_dict(GAT_CKPT)
    jsd = jimport.load_state_dict(GAT_CKPT)
    d = np.load(TOY)
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        cfg = json.load(f)
    jm = px.Model(jgnn.gat_node_model(84, conv_channels=(16,), fc_channels=(16, 16, 32)),
                  jimport.gat_node_model_params(jsd))
    tm = Model(tgnn.gat_node_model(84, conv_channels=(16,), fc_channels=(16, 16, 32)),
               timport.gat_node_model_params(sd), device="cpu")
    return sd, jsd, d, cfg, jm, tm


def test_gat_fixture_loads_and_matches_jax(gat_fixture):
    sd, jsd, d, _, jm, tm = gat_fixture
    assert sorted(sd) == sorted(jsd)
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jsd[k])
    tdef, params = timport.import_any(sd)
    assert isinstance(tdef, tgnn.ConvStackNodeModel) and tdef.num_hops == 1
    jg = px.from_arrays(d["feat"], d["edge_index"])
    tg = tgraph.from_arrays(d["feat"], d["edge_index"], device="cpu")
    want = np.asarray(jm.infer(jg))
    got = tm.infer(tg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the trained model fits its labels
    assert ((got[:36, 0] > 0.5) == (d["labels"] > 0.5)).mean() > 0.85


@pytest.mark.parametrize("problem,element", [
    ("node_prediction", "10"), ("edge_prediction", "10"), ("graph_prediction", None),
])
def test_gat_fixture_run_matches_jax(gat_fixture, problem, element):
    _, _, d, cfg, jm, tm = gat_fixture
    feat, ei = d["feat"], d["edge_index"]
    if problem == "edge_prediction":
        names = [str(i) for i in range(ei.shape[1])]
    else:
        names = [str(x) for x in d["names"]]
    jcv, _ = px.Explainer(feat, ei, jm, cfg, names, problem=problem).run(element)
    tcv, tpw = Explainer(feat, ei, tm, cfg, names, problem=problem, device="cpu").run(element)
    assert tpw is None
    assert list(tcv.columns) == list(jcv.columns)
    assert list(tcv.index) == list(jcv.index)
    np.testing.assert_allclose(tcv.to_numpy(), jcv.to_numpy(), **RUN_TOL)
