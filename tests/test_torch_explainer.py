"""PyTorch port: ``Explainer.run`` gives the JAX package's DataFrames for the
same seed (same index order, ``rtol=1e-4, atol=1e-6``), and the pieces under
it (KernelSHAP weights, the surrogate fit, community aggregation) agree with
their JAX counterparts."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.explain import explainer as jexplainer
from bikg_graph_explainability_public_tpu.explain import kernels as jkernels
from bikg_graph_explainability_public_tpu.explain import pathways as jpathways
from bikg_graph_explainability_public_tpu.explain import wlm as jwlm
from bikg_graph_explainability_public_tpu.models.checkpoint import load_params as jload_params
from bikg_graph_explainability_public_tpu_torch import config as tconfig
from bikg_graph_explainability_public_tpu_torch.explain import explainer as texplainer
from bikg_graph_explainability_public_tpu_torch.explain import kernels as tkernels
from bikg_graph_explainability_public_tpu_torch.explain import pathways as tpathways
from bikg_graph_explainability_public_tpu_torch.explain import wlm as twlm
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import (
    load_params,
    params_from_numpy,
)
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel

from fixtures import make_communities, make_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
#: the same float32 forwards in another order, then 50 Adam steps
TOL = dict(rtol=1e-4, atol=1e-6)


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame, ties: bool = False):
    """Same index order and values within TOL.  ``ties=True``: scores that
    lie within TOL of each other may come in either order, so the values
    are compared by name and the order only through the sorted values."""
    assert list(got.columns) == list(want.columns)
    assert got.index.name == want.index.name
    if ties:
        assert sorted(got.index) == sorted(want.index)
        np.testing.assert_allclose(got.loc[want.index].to_numpy(), want.to_numpy(), **TOL)
    else:
        assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


@pytest.fixture(scope="module")
def toy():
    d = np.load(TOY)
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        cfg = json.load(f)
    return d["feat"], d["edge_index"], [str(x) for x in d["names"]], cfg


@pytest.mark.parametrize("times", [1, 3])
@pytest.mark.parametrize("mode", ["shapley", "community"])
def test_fixture_run_matches_jax(toy, mode, times):
    feat, ei, names, cfg = toy
    kw = {}
    if mode == "community":
        pathways, pathway_names = make_communities(len(names))
        kw = dict(pathways=pathways, pathway_names=pathway_names)
    jm = px.Model(px.GCNNodeModel(84), jload_params(CKPT))
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    jcv, jpw = px.Explainer(feat, ei, jm, cfg, names, **kw).run("10", times=times)
    tex = texplainer.Explainer(feat, ei, tm, cfg, names, device="cpu", **kw)
    tcv, tpw = tex.run("10", times=times)
    _assert_frames(tcv, jcv)
    if times > 1:
        assert (tcv["config_value_std"] > 0).any()
    if mode == "shapley":
        assert tpw is None and jpw is None
    else:
        _assert_frames(tpw, jpw)


def test_graph_problem_on_ell_tier_matches_jax():
    """About 4200 nodes: above the dense threshold, so both engines run the
    ELL tier; the pooled prediction is explained with a few epochs."""
    feat, ei, names = make_graph(n=4200, f=12, e=16800, seed=8)
    jdef = px.GCNNodeModel(12, conv_channels=(8, 8), fc_channels=(8, 4))
    params = jdef.init(jax.random.PRNGKey(8))
    tdef = GCNNodeModel(12, conv_channels=(8, 8), fc_channels=(8, 4))
    tm = Model(tdef, params_from_numpy(jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    cfg = {"seed": 2, "interpret_samples": 10, "epochs": 5, "lr": 0.01, "l1_lambda": 1e-4}
    jex = px.Explainer(feat, ei, px.Model(jdef, params), cfg, names, problem="graph_prediction")
    jcv, _ = jex.run(None)
    tex = texplainer.Explainer(feat, ei, tm, cfg, names, problem="graph_prediction", device="cpu")
    tcv, tpw = tex.run(None)
    assert tm._fast_engine(tm._fast_cache[0]).mode == "ell"
    assert tpw is None and len(tcv) == 4200
    # 4200 scores a few 1e-6 apart: last-bit differences of the forwards
    # may swap neighbours that are closer than the tolerance
    _assert_frames(tcv, jcv, ties=True)


def test_private_step_returns_the_arrays_behind_run(toy):
    feat, ei, names, cfg = toy
    pathways, pathway_names = make_communities(len(names))
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    ex = texplainer.Explainer(feat, ei, tm, cfg, names, pathways, pathway_names, device="cpu")
    arrays = ex._explain("10", times=2)
    cv, pw = ex.run("10", times=2)
    order = np.argsort(-arrays.mean, kind="stable")
    assert [arrays.names[i] for i in order] == list(cv.index)
    np.testing.assert_array_equal(arrays.mean[order], cv["config_value_mean"].to_numpy())
    np.testing.assert_array_equal(arrays.std[order], cv["config_value_std"].to_numpy())
    assert list(arrays.pathway_names) == list(pw.index)
    np.testing.assert_array_equal(arrays.pathway_scores, pw["score"].to_numpy())


def test_explainer_checks_its_inputs(toy):
    feat, ei, names, cfg = toy
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    # heterogeneous inputs: an element type needs dict features, and dict
    # communities need dict names
    with pytest.raises(AssertionError, match="dict of node types"):
        texplainer.Explainer(feat, ei, tm, cfg, names, element_type="gene", device="cpu")
    with pytest.raises(ValueError, match="community names"):
        tpathways.Pathways({"gene": [["1"]]}).hetero2homo("node_prediction")
    with pytest.raises(AssertionError):
        texplainer.Explainer(feat, ei, tm, cfg, names, problem="node", device="cpu")
    with pytest.raises(AssertionError, match="not present"):
        texplainer.Explainer(feat, ei, tm, cfg, names, device="cpu").run("nope")
    for backend, error in (("xla", NotImplementedError), ("cusparse", ValueError)):
        params = dict(cfg, spmm_backend=backend)
        ex = texplainer.Explainer(feat, ei, tm, params, names, device="cpu")
        with pytest.raises(error):
            ex.run("10")


@pytest.mark.parametrize("times", [1, 2])
@pytest.mark.parametrize("mode", ["shapley", "community"])
def test_fixture_edge_run_matches_jax(toy, mode, times):
    """``edge_prediction`` on the fixture: one name per edge, the query
    edge's receiver seeds the subgraph, masks are e_pad wide."""
    feat, ei, _, cfg = toy
    edge_names = [str(i) for i in range(ei.shape[1])]
    kw = {}
    if mode == "community":
        pathways, pathway_names = make_communities(len(edge_names), k=6, seed=2)
        kw = dict(pathways=pathways, pathway_names=pathway_names)
    jm = px.Model(px.GCNNodeModel(84), jload_params(CKPT))
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    jcv, jpw = px.Explainer(feat, ei, jm, cfg, edge_names, problem="edge_prediction", **kw).run(
        "10", times=times
    )
    tex = texplainer.Explainer(
        feat, ei, tm, cfg, edge_names, problem="edge_prediction", device="cpu", **kw
    )
    tcv, tpw = tex.run("10", times=times)
    _assert_frames(tcv, jcv)
    assert set(tcv.index) <= set(edge_names) and len(tcv) < len(edge_names)
    if mode == "shapley":
        assert tpw is None and jpw is None
    else:
        _assert_frames(tpw, jpw)


def test_edge_problem_needs_one_name_per_edge(toy):
    feat, ei, names, cfg = toy
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    jm = px.Model(px.GCNNodeModel(84), jload_params(CKPT))
    with pytest.raises(AssertionError, match="one name per EDGE") as got:
        texplainer.Explainer(feat, ei, tm, cfg, names, problem="edge_prediction", device="cpu").run("10")
    with pytest.raises(AssertionError, match="one name per EDGE") as want:
        px.Explainer(feat, ei, jm, cfg, names, problem="edge_prediction").run("10")
    assert str(got.value) == str(want.value)


class SumNeighborFeature(torch.nn.Module):
    """Out[v] = sum over in-edges of w_e * x[snd, 0] (``tests/test_planted_rank.py``):
    the query's prediction is the masked sum of its neighbours' first
    feature, so the edge from the neighbour with the planted large feature
    is the ground-truth top attribution."""

    num_hops = 1

    def forward(self, x, senders, receivers, edge_weight):
        msg = edge_weight * x[senders, 0]  # [..., E]
        out = msg.new_zeros(msg.shape[:-1] + (x.shape[0],))
        return out.index_add_(out.dim() - 1, receivers, msg)[..., None]


def test_planted_edge_ranks_first():
    """Star graph, spokes 1..7 -> hub 0; node 4 carries the signal."""
    n = 8
    feat = np.full((n, 4), 0.1, np.float32)
    feat[4, 0] = 10.0
    ei = np.stack([np.arange(1, n), np.zeros(n - 1, np.int64)])
    edge_names = [f"e{i}" for i in range(ei.shape[1])]
    planted_edge = f"e{int(np.nonzero(ei[0] == 4)[0][0])}"
    cfg = {"seed": 0, "interpret_samples": 100, "epochs": 100, "lr": 0.1, "l1_lambda": 1e-5}
    model = Model(SumNeighborFeature(), device="cpu")
    df, _ = texplainer.Explainer(
        feat, ei, model, cfg, edge_names, problem="edge_prediction", device="cpu"
    ).run(planted_edge, times=2)
    assert df.index.tolist()[0] == planted_edge, df


@pytest.mark.parametrize("width,valid,rtol", [(8, 8, 1e-5), (64, 40, 1e-5), (1024, 1000, 2e-3)])
def test_shap_kernel_matches_jax(width, valid, rtol):
    """The log-kernel holds lgamma(n + 1) in float32; near n = 1000 one ulp
    of it is 5e-4, and XLA's and PyTorch's lgamma differ by a few ulp, so
    the kernel differs by that much relatively there."""
    rng = np.random.default_rng(width)
    masks = rng.random((3, 50, width)) > 0.5
    masks[:, :, valid:] = False
    masks[:, 0] = False  # k == 0 and k == S rows get weight 0
    masks[:, 1, :valid] = True
    want = np.stack([
        np.asarray(jkernels.shap_kernel(jnp.asarray(m), num_valid_columns=valid)) for m in masks
    ])
    got = tkernels.shap_kernel(torch.from_numpy(masks), num_valid_columns=valid).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
    assert (got[:, :2] == 0).all()


@pytest.mark.parametrize("epochs,batch,width,valid", [(50, 20, 8, 8), (20, 10, 40, 33)])
def test_train_surrogate_matches_jax(epochs, batch, width, valid):
    rng = np.random.default_rng(epochs)
    t = 2
    masks = (rng.random((t, epochs, batch, width)) > 0.5).astype(np.float32)
    masks[..., valid:] = 0
    outputs = rng.random((t, epochs, batch)).astype(np.float32)
    kern = rng.random((t, epochs, batch)).astype(np.float32)
    w0 = (rng.uniform(-0.3, 0.3, (t, width)) * (np.arange(width) < valid)).astype(np.float32)
    got = twlm.train_surrogate(
        torch.from_numpy(w0), torch.from_numpy(masks), torch.from_numpy(outputs),
        torch.from_numpy(kern), num_valid=valid,
    )
    for i in range(t):
        want = jwlm.train_surrogate(
            jnp.asarray(w0[i]), jnp.asarray(masks[i]), jnp.asarray(outputs[i]),
            jnp.asarray(kern[i]), num_valid=valid,
        )
        np.testing.assert_allclose(
            got.weights[i].numpy(), np.asarray(want.weights), rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            got.losses[i].numpy(), np.asarray(want.losses), rtol=1e-4, atol=1e-7
        )
        assert int(got.best_epoch[i]) == int(want.best_epoch)


@pytest.mark.parametrize("epochs,batch", [(50, 20), (7, 3), (1, 600), (30, 30)])
def test_default_chunk_matches_jax(epochs, batch):
    assert twlm._default_chunk(epochs, batch) == jwlm._default_chunk(epochs, batch)


def test_pathways_match_jax():
    names = [str(i) for i in range(12)]
    comms = [["3", "1", "20"], ["5"], ["30", "31"], ["11", "0", "7", "2"]]
    jp = jpathways.Pathways(comms, ["a", "b", "c", "d"])
    tp = tpathways.Pathways(comms, ["a", "b", "c", "d"])
    jsub, jnames, _ = jp.comp_graph(names)
    tsub, tnames = tp.comp_graph(names)
    assert (tsub, tnames) == (jsub, jnames)
    inds = tpathways.Pathways(tsub, tnames).names2inds(names)
    assert inds == jpathways.Pathways(jsub, jnames).names2inds(names)
    vals = np.random.default_rng(0).standard_normal(12)
    _assert_frames(
        tpathways.Pathways(tsub, tnames).aggregate(vals, inds),
        jpathways.Pathways(jsub, jnames).aggregate(vals, inds),
    )


def test_weight_stacking_and_frame_match_jax():
    rng = np.random.default_rng(1)
    ws = [rng.standard_normal(9).astype(np.float32) for _ in range(3)]
    names = list("abcdefghi")
    for got, want in zip(texplainer.weight_stacking(ws), jexplainer.weight_stacking(ws)):
        np.testing.assert_array_equal(got, want)
    m, s = texplainer.weight_stacking(ws)
    pd.testing.assert_frame_equal(
        texplainer.config_val_dataframe(m, s, names), jexplainer.config_val_dataframe(m, s, names)
    )
    assert texplainer.extract_index("c", names) == jexplainer.extract_index("c", names) == 2
    assert texplainer.extract_index(4) == 4


def test_config_matches_jax_defaults():
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        cfg = tconfig.load_config(os.path.join(ROOT, "config", "configs.json"))
        ref = json.load(f)
    for key, val in ref.items():
        assert cfg[key] == val and cfg.get(key) == val and key in cfg
    assert tconfig.DEFAULTS == ref
    assert tconfig.load_config().spmm_backend == "auto"
    with pytest.raises(NotImplementedError):
        tconfig.load_config({"spmm_backend": "pallas"})
    with pytest.raises(ValueError):
        tconfig.load_config({"optimizer": "sgd"})
