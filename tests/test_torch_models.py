"""PyTorch port: GCN layers, the node model, checkpoints, the model adapter
and the small ops under them, held against the JAX package on the same
numpy inputs.  Float32 throughout; tolerances allow for another summation
order only."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.models import checkpoint as jckpt
from bikg_graph_explainability_public_tpu.models import layers as jlayers
from bikg_graph_explainability_public_tpu.ops import ell as jell
from bikg_graph_explainability_public_tpu.ops import norm as jnorm
from bikg_graph_explainability_public_tpu.ops import segment as jseg
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.models import checkpoint as tckpt
from bikg_graph_explainability_public_tpu_torch.models import layers as tlayers
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
from bikg_graph_explainability_public_tpu_torch.ops import ell as tell
from bikg_graph_explainability_public_tpu_torch.ops import norm as tnorm
from bikg_graph_explainability_public_tpu_torch.ops import segment as tseg

from fixtures import make_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def toy():
    d = np.load(TOY)
    jg = px.from_arrays(d["feat"], d["edge_index"])
    tg = tgraph.from_arrays(d["feat"], d["edge_index"], device="cpu")
    return d, jg, tg


@pytest.fixture(scope="module")
def fixture_models():
    jparams = jckpt.load_params(CKPT)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jm = px.Model(px.GCNNodeModel(84), jparams)
    tm = Model(GCNNodeModel(84), tckpt.params_from_numpy(tree), device="cpu")
    return jm, tm


def test_load_params_matches_params_from_numpy():
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_params(CKPT))
    a = tckpt.load_params(CKPT)
    b = tckpt.params_from_numpy(tree)
    assert sorted(a) == sorted(b) == sorted(GCNNodeModel(84).state_dict())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_fixture_forward_matches_jax(toy, fixture_models):
    _, jg, tg = toy
    jm, tm = fixture_models
    want = np.asarray(jm.infer(jg))
    got = tm.infer(tg).numpy()
    assert got.shape == want.shape == (jg.n_pad, 1)
    np.testing.assert_allclose(got, want, **TOL)
    # the trained fixture fits its labels, as on the JAX side
    d = np.load(TOY)
    assert ((got[:36, 0] > 0.5) == (d["labels"] > 0.5)).mean() > 0.95


@pytest.mark.parametrize(
    "conv,fc", [((16,), (16, 16, 32)), ((8, 8), (8, 4)), ((12, 12, 12), (12, 6))]
)
@pytest.mark.parametrize("seed", [0, 1])
def test_random_model_forward_matches_jax(seed, conv, fc):
    feat, ei, _ = make_graph(n=40, f=10, e=150, seed=seed)
    jdef = px.GCNNodeModel(10, conv_channels=conv, fc_channels=fc)
    jparams = jdef.init(jax.random.PRNGKey(seed))
    tdef = GCNNodeModel(10, conv_channels=conv, fc_channels=fc)
    tdef.load_state_dict(tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)))
    jg = px.from_arrays(feat, ei)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    rng = np.random.default_rng(seed)
    ew = (rng.random((3, jg.e_pad)) > 0.3).astype(np.float32) * np.asarray(jg.edge_mask)
    want = np.stack([
        np.asarray(jdef.apply(jparams, jg.x, jg.senders, jg.receivers, jnp.asarray(w))) for w in ew
    ])
    with torch.no_grad():
        got = tdef(tg.x, tg.senders, tg.receivers, _t(ew)).numpy()  # batched edge weights
        back = tdef.backbone(tg.x, tg.senders, tg.receivers, _t(ew[0]))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        back.numpy(),
        np.asarray(jdef.backbone(jparams, jg.x, jg.senders, jg.receivers, jnp.asarray(ew[0]))),
        **TOL,
    )
    assert tdef.num_hops == jdef.num_hops == len(conv)


def test_gcn_node_model_rejects_mismatched_head():
    with pytest.raises(ValueError):
        GCNNodeModel(4, conv_channels=(8,), fc_channels=(16, 4))


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    rng = np.random.default_rng(2)
    lin = tlayers.Linear(5, 3, bias=bias)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    p = {"weight": lin.weight.detach().numpy()}
    if bias:
        p["bias"] = lin.bias.detach().numpy()
    want = np.asarray(jlayers.Linear(5, 3, bias=bias).apply(p, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(lin(_t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("improved,add_self_loops,normalize", [
    (False, True, True), (True, True, True), (False, False, True), (False, True, False),
])
def test_gcnconv_options_match_jax(improved, add_self_loops, normalize):
    feat, ei, _ = make_graph(n=20, f=6, e=70, seed=4)
    opts = dict(improved=improved, add_self_loops=add_self_loops, normalize=normalize)
    conv = tlayers.GCNConv(6, 5, **opts)
    jconv = jlayers.GCNConv(6, 5, **opts)
    p = {"weight": conv.weight.detach().numpy(), "bias": np.linspace(-1, 1, 5, dtype=np.float32)}
    with torch.no_grad():
        conv.bias.copy_(_t(p["bias"]))
    ew = np.random.default_rng(4).random(ei.shape[1]).astype(np.float32)
    s, r = ei.astype(np.int64)
    want = np.asarray(jconv.apply(p, *map(jnp.asarray, (feat, s, r, ew))))
    with torch.no_grad():
        got = conv(_t(feat), _t(s), _t(r), _t(ew)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("improved,add_self_loops", [(False, True), (True, True), (False, False)])
def test_gcn_norm_matches_jax(improved, add_self_loops):
    _, ei, _ = make_graph(n=30, e=120, seed=5)
    s, r = ei.astype(np.int64)
    ew = np.random.default_rng(5).random(ei.shape[1]).astype(np.float32)
    mask = np.arange(30) % 3 != 0
    for slm in (None, mask):
        want = jnorm.gcn_norm_weights(
            jnp.asarray(s), jnp.asarray(r), jnp.asarray(ew), 30, improved=improved,
            add_self_loops=add_self_loops, self_loop_mask=None if slm is None else jnp.asarray(slm),
        )
        got = tnorm.gcn_norm_weights(
            _t(s), _t(r), _t(ew), 30, improved=improved, add_self_loops=add_self_loops,
            self_loop_mask=None if slm is None else _t(slm),
        )
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean", "segment_max", "segment_softmax"])
def test_segment_ops_match_jax(fn):
    rng = np.random.default_rng(6)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    ids = rng.integers(0, 9, 40)  # segment 9 of 10 stays empty
    want = np.asarray(getattr(jseg, fn)(jnp.asarray(data), jnp.asarray(ids), 10))
    got = getattr(tseg, fn)(_t(data), _t(ids), 10).numpy()
    if fn == "segment_max":  # empty segments: -inf on both sides
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        got, want = got[np.isfinite(want)], want[np.isfinite(want)]
    np.testing.assert_allclose(got, want, **TOL)


def test_scatter_or_matches_jax():
    rng = np.random.default_rng(7)
    upd = rng.random(30) > 0.5
    idx = rng.integers(0, 12, 30)
    want = np.asarray(jseg.scatter_or(jnp.asarray(upd), jnp.asarray(idx), 12))
    np.testing.assert_array_equal(tseg.scatter_or(_t(upd), _t(idx), 12).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_ell_coeffs_and_shared_aggregate_match_jax(seed):
    """Node-mask coefficients; edge-mask ones in the next test."""
    feat, ei, _ = make_graph(n=50, f=4, e=260, seed=seed)
    jg = px.from_arrays(feat, ei)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    jt, tt = jell.build_neighbor_table(jg), tell.build_neighbor_table(tg)
    rng = np.random.default_rng(seed)
    m = (rng.random((4, jg.n_pad)) > 0.4).astype(np.float32)
    jc, js = jax.vmap(lambda row: jell.gcn_coeffs_from_node_mask(jt, row))(jnp.asarray(m))
    tc, ts = tell.gcn_coeffs_from_node_mask(tt, _t(m))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    xw = rng.standard_normal((jg.n_pad, 6)).astype(np.float32)
    want = jell.ell_aggregate_shared(jc, jnp.asarray(xw)[jt.nbr])
    got = tell.ell_aggregate_shared(tc, _t(xw)[tt.nbr])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_ell_edge_coeffs_match_jax(seed):
    feat, ei, _ = make_graph(n=50, f=4, e=260, seed=seed)
    jg = px.from_arrays(feat, ei)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    jt, tt = jell.build_neighbor_table(jg), tell.build_neighbor_table(tg)
    m = (np.random.default_rng(seed).random((4, jg.e_pad)) > 0.4).astype(np.float32)
    jc, js = jax.vmap(lambda row: jell.gcn_coeffs_from_edge_mask(jt, row))(jnp.asarray(m))
    tc, ts = tell.gcn_coeffs_from_edge_mask(tt, _t(m))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("problem,query", [("node_prediction", 10), ("graph_prediction", None)])
@pytest.mark.parametrize("fast", [True, False])
def test_perturbed_query_outputs_match_jax(toy, fixture_models, problem, query, fast):
    _, jg, tg = toy
    jm, tm = fixture_models
    tm_path = Model(tm.model_def, device="cpu", fast=fast)
    masks = np.random.default_rng(3).random((24, jg.n_pad)) > 0.3
    masks[:, jg.num_nodes:] = False
    want = np.asarray(
        jm.perturbed_query_outputs(jg, jnp.asarray(masks), problem, query, chunk_size=8)
    )
    got = tm_path.perturbed_query_outputs(tg, masks, problem, query, chunk_size=8).numpy()
    assert got.shape == (24,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("query", [10, 25])
@pytest.mark.parametrize("fast", [True, False])
def test_perturbed_edge_outputs_match_jax(toy, fixture_models, fast, query):
    """Edge masks [M, E_pad]: the engine's edge plan (``fast``) or the
    generic route's ``ew = base * mask``, against the JAX adapter's."""
    _, jg, tg = toy
    jm, tm = fixture_models
    jm_path = px.Model(jm.model_def, jm.params, fast=fast)
    tm_path = Model(tm.model_def, device="cpu", fast=fast)
    masks = np.random.default_rng(query).random((24, jg.e_pad)) > 0.3
    masks[:, jg.num_edges:] = False
    want = np.asarray(
        jm_path.perturbed_query_outputs(jg, jnp.asarray(masks), "edge_prediction", query, chunk_size=8)
    )
    got = tm_path.perturbed_query_outputs(tg, masks, "edge_prediction", query, chunk_size=8).numpy()
    assert got.shape == (24,)
    np.testing.assert_allclose(got, want, **TOL)


def test_model_adapter_device_and_hops(toy, fixture_models):
    _, _, tg = toy
    _, tm = fixture_models
    assert tm.device == torch.device("cpu")
    assert tm.get_hops() == 1
    assert all(p.device.type == "cpu" for p in tm.model_def.parameters())
    # edge problems are ported: all edges kept is the unperturbed forward
    out = tm.perturbed_query_outputs(tg, np.ones((1, tg.e_pad), bool), "edge_prediction", 10)
    np.testing.assert_allclose(out.numpy(), tm.infer(tg)[10].numpy(), **TOL)
