"""PyTorch port: RGCN (PyG ``RGCNConv`` over a typed homogeneous graph)
against the JAX package on the same seeded numpy inputs.

``RGCNConv`` with and without bases, on batched edge weights with masked
edges, a relation without edges, per-sample features and a ``dst_scope``;
``RGCNNodeModel``; ``rgcn_node_model_params`` and ``import_any``'s RGCN
branch (bases, a layer without bias, RGCN mixed with another family
refused); ``Explainer.run`` frames (the adapter's generic typed forward);
``explain_many`` refusing the model with ``TypeError``, as JAX's does.
Biases are drawn non-zero.  Tolerance ``rtol=1e-4, atol=1e-5``: float32 in
another summation order (frames: then the surrogate's Adam steps), frames
in the same index order.
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
from bikg_graph_explainability_public_tpu.graph import from_arrays as jfrom_arrays
from bikg_graph_explainability_public_tpu.models import layers as jlayers
from bikg_graph_explainability_public_tpu.models import torch_import as jimport
import bikg_graph_explainability_public_tpu_torch as px
from bikg_graph_explainability_public_tpu_torch.explain import batch as tbatch
from bikg_graph_explainability_public_tpu_torch.models import layers as tlayers
from bikg_graph_explainability_public_tpu_torch.models import torch_import as timport
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy

from fixtures import make_graph

TOL = dict(rtol=1e-4, atol=1e-5)
N, F, E, R = 16, 5, 48, 3
CFG = {"seed": 2, "interpret_samples": 10, "epochs": 20, "lr": 0.01, "l1_lambda": 1e-4}


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _typed_graph(seed, n_types=R):
    feat, ei, names = make_graph(n=N, f=F, e=E, seed=seed)
    et = np.random.default_rng(seed).integers(0, n_types, E)
    return feat, ei, et, names


def _with_bias(params, rng):
    if "bias" in params:
        params["bias"] = (rng.normal(size=params["bias"].shape) * 0.3).astype(np.float32)
    return params


@pytest.mark.parametrize("bases", [None, 2])
@pytest.mark.parametrize("case", ["masked", "empty_relation", "per_sample_x", "scoped"])
def test_rgcnconv_matches_jax(bases, case):
    feat, ei, et, _ = _typed_graph(21)
    num_rel = R + 1 if case == "empty_relation" else R  # relation R has no edge
    rng = np.random.default_rng(22)
    s, r = ei
    ew = (rng.random((4, E)) > 0.35).astype(np.float32)
    jconv = jlayers.RGCNConv(F, 4, num_rel, num_bases=bases)
    tconv = tlayers.RGCNConv(F, 4, num_rel, num_bases=bases)
    params = _with_bias(_tree(jconv.init(jax.random.PRNGKey(3))), rng)
    tconv.load_state_dict(params_from_numpy(params))
    assert set(tconv.state_dict()) == set(params)
    x = rng.normal(size=(4, N, F)).astype(np.float32) if case == "per_sample_x" else feat
    scope = rng.random(N) > 0.5 if case == "scoped" else None
    kw = {} if scope is None else dict(dst_scope=jnp.asarray(scope))
    want = jax.vmap(
        lambda xx, w: jconv.apply(params, xx, jnp.asarray(s), jnp.asarray(r), w, jnp.asarray(et), **kw),
        in_axes=(0 if x.ndim == 3 else None, 0),
    )(jnp.asarray(x), jnp.asarray(ew))
    tkw = {} if scope is None else dict(dst_scope=torch.from_numpy(scope))
    with torch.no_grad():
        got = tconv(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(r),
                    torch.from_numpy(ew), torch.from_numpy(et), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.no_grad():  # one unbatched edge weight
        one = tconv(torch.from_numpy(feat), torch.from_numpy(s), torch.from_numpy(r),
                    torch.from_numpy(ew[0]), torch.from_numpy(et), **tkw)
    want_one = jconv.apply(params, jnp.asarray(feat), jnp.asarray(s), jnp.asarray(r),
                           jnp.asarray(ew[0]), jnp.asarray(et), **kw)
    np.testing.assert_allclose(one.numpy(), np.asarray(want_one), **TOL)


def _models(seed, bases=None, conv=(6, 5), fc=(5, 4)):
    jdef = jpx.RGCNNodeModel(F, R, conv_channels=conv, num_bases=bases, fc_channels=fc)
    params = _tree(jdef.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p in params["conv"]:
        _with_bias(p, rng)
    tdef = px.RGCNNodeModel(F, R, conv_channels=conv, num_bases=bases, fc_channels=fc)
    tdef.load_state_dict(params_from_numpy(params))
    return jdef, params, tdef


@pytest.mark.parametrize("bases", [None, 2])
def test_rgcn_node_model_matches_jax(bases):
    feat, ei, et, _ = _typed_graph(23)
    jdef, params, tdef = _models(4, bases)
    assert tdef.typed and tdef.num_hops == jdef.num_hops == 2
    jg = jfrom_arrays(feat, ei, edge_type=et)
    tg = px.from_arrays(feat, ei, edge_type=et, device="cpu")
    jm, tm = jpx.Model(jdef, params), px.Model(tdef, device="cpu")
    np.testing.assert_allclose(tm.infer(tg).numpy(), np.asarray(jm.infer(jg)), **TOL)
    rng = np.random.default_rng(5)
    for problem, width, q in (("node_prediction", tg.n_pad, 3), ("edge_prediction", tg.e_pad, 7),
                              ("graph_prediction", tg.n_pad, None)):
        masks = rng.random((6, width)) < 0.6
        want = jm.perturbed_query_outputs(jg, jnp.asarray(masks), problem, q)
        got = tm.perturbed_query_outputs(tg, masks, problem, q)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rgcn_state_dict(bases=None, bias=(True, True), seed=6, conv=(6, 4)):
    """A PyG ``RGCNConv`` stack's state dict (``conv.{2i}``, ``fc.{2j}``)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) * 0.4).astype(np.float32)

    sd, prev = {}, F
    for i, c in enumerate(conv):
        pre = f"conv.{2 * i}."
        sd[pre + "weight"] = w(R if bases is None else bases, prev, c)
        if bases is not None:
            sd[pre + "comp"] = w(R, bases)
        sd[pre + "root"] = w(prev, c)
        if bias[i]:
            sd[pre + "bias"] = w(c)
        prev = c
    sd["fc.0.weight"], sd["fc.0.bias"] = w(3, conv[-1]), w(3)
    sd["fc.2.weight"], sd["fc.2.bias"] = w(1, 3), w(1)
    return sd


@pytest.mark.parametrize("bases,bias", [(None, (True, True)), (2, (True, True)), (None, (True, False))])
def test_rgcn_import_matches_jax(bases, bias):
    sd = _rgcn_state_dict(bases, bias)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = timport.rgcn_node_model_params(tsd)
    want = params_from_numpy(_tree(jimport.rgcn_node_model_params(sd)))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    jdef, jparams = jimport.import_any(sd)
    tdef, tparams = timport.import_any(tsd)
    assert isinstance(tdef, px.RGCNNodeModel)
    assert (tdef.num_relations, tdef.fc_channels, tdef.out_features) == (
        jdef.num_relations, jdef.fc_channels, jdef.out_features)
    assert [(c.in_features, c.out_features, c.num_bases) for c in tdef.conv] == [
        (c.in_features, c.out_features, c.num_bases) for c in jdef.convs]
    tdef.load_state_dict(tparams)
    feat, ei, et, _ = _typed_graph(24)
    jg = jfrom_arrays(feat, ei, edge_type=et)
    tg = px.from_arrays(feat, ei, edge_type=et, device="cpu")
    np.testing.assert_allclose(px.Model(tdef, device="cpu").infer(tg).numpy(),
                               np.asarray(jpx.Model(jdef, jparams).infer(jg)), **TOL)


def test_import_any_refuses_rgcn_mixed_with_another_family():
    sd = _rgcn_state_dict()
    for k in [k for k in sd if k.startswith("conv.2.")]:
        del sd[k]
    rng = np.random.default_rng(7)
    sd["conv.2.lin.weight"] = rng.normal(size=(4, 6)).astype(np.float32)
    for imp in (jimport.import_any, lambda d: timport.import_any({k: torch.from_numpy(v) for k, v in d.items()})):
        with pytest.raises(ValueError, match="RGCN layers cannot mix"):
            imp(sd)


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns) and got.index.name == want.index.name
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


@pytest.mark.parametrize("mode,times", [("shapley", 1), ("shapley", 2), ("community", 1)])
def test_explainer_run_matches_jax(mode, times):
    feat, ei, et, names = _typed_graph(25)
    jdef, params, tdef = _models(8, bases=2)
    kw = dict(edge_types=et)
    if mode == "community":
        kw.update(pathways=[["1", "2", "3", "5"], ["4", "6", "9"]], pathway_names=["p0", "p1"])
    jcv, jpw = jpx.Explainer(feat, ei, jpx.Model(jdef, params), CFG, names, **kw).run("4", times=times)
    tcv, tpw = px.Explainer(feat, ei, px.Model(tdef, device="cpu"), CFG, names, device="cpu",
                            **kw).run("4", times=times)
    _assert_frames(tcv, jcv)
    if jpw is None:
        assert tpw is None
    else:
        _assert_frames(tpw, jpw)


def test_explain_many_refuses_rgcn_as_jax_does():
    """JAX's coo runner calls any model but a HeteroGNN without its types,
    so RGCN's ``apply`` misses two arguments; the port refuses it before
    any work, naming the limitation."""
    feat, ei, et, names = _typed_graph(26)
    jdef, params, tdef = _models(9)
    jg = jfrom_arrays(feat, ei, edge_type=et)
    tg = px.from_arrays(feat, ei, edge_type=et, device="cpu")
    with pytest.raises(TypeError):
        jbatch.explain_many(jpx.Model(jdef, params), jg, [3], CFG, names=names)
    with pytest.raises(TypeError, match="HeteroGNN"):
        tbatch.explain_many(px.Model(tdef, device="cpu"), tg, [3], CFG, names=names)
    with pytest.raises(TypeError, match="Explainer.run"):
        tbatch._explain_many(px.Model(tdef, device="cpu"), tg, [3, 5], CFG, names=names)
