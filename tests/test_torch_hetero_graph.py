"""PyTorch port, heterogeneous graphs and models: ``hetero_to_homo`` and its
inverses, ``HeteroGNN``'s forward and the hetero checkpoint importers,
against the JAX package on the same seeded numpy inputs (forwards at
``rtol=1e-4, atol=1e-5``: float32 in another summation order)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu import graph as jgraph
from bikg_graph_explainability_public_tpu.models import torch_import as jimport
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.models import gnn as tgnn
from bikg_graph_explainability_public_tpu_torch.models import torch_import as timport
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
RELS = [("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a")]


def _hetero_inputs(seed=0, na=9, nb=7, fa=5, fb=3):
    """Two node types of different feature widths, three relations."""
    rng = np.random.default_rng(seed)
    feat = {"a": rng.normal(size=(na, fa)).astype(np.float32),
            "b": rng.normal(size=(nb, fb)).astype(np.float32)}
    sizes = {"a": na, "b": nb}
    ei = {r: np.stack([rng.integers(0, sizes[r[0]], 11), rng.integers(0, sizes[r[-1]], 11)])
          for r in RELS}
    return feat, ei


def _host(g, name):
    a = getattr(g, name)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_hetero_to_homo_matches_jax():
    feat, ei = _hetero_inputs()
    jg, jinfo = jgraph.hetero_to_homo(feat, ei)
    tg, tinfo = tgraph.hetero_to_homo(feat, ei, device="cpu")
    for field in ("node_type_names", "edge_type_names", "node_pointers", "edge_pointers",
                  "padded_dims", "node_counts", "edge_counts"):
        assert getattr(tinfo, field) == getattr(jinfo, field), field
    assert tinfo.num_relations == 3 and tinfo.num_node_types == 2
    assert (tg.n_pad, tg.e_pad, tg.num_nodes, tg.num_edges) == (jg.n_pad, jg.e_pad, jg.num_nodes, jg.num_edges)
    for name in ("x", "senders", "receivers", "node_mask", "edge_mask", "node_type", "edge_type"):
        np.testing.assert_array_equal(_host(tg, name), _host(jg, name), err_msg=name)
    # the host view holds the same arrays as the tensors
    np.testing.assert_array_equal(tg.host.edge_type, tg.edge_type.numpy())


def test_hetero_inverses_round_trip():
    feat, ei = _hetero_inputs(seed=1)
    tg, info = tgraph.hetero_to_homo(feat, ei, device="cpu")
    back_ei = tgraph.homo_to_hetero_edge_indices(
        tg.senders, tg.receivers, tg.edge_type, info, num_edges=tg.num_edges)
    want_ei = jgraph.homo_to_hetero_edge_indices(
        tg.host.senders, tg.host.receivers, tg.host.edge_type, info, num_edges=tg.num_edges)
    assert list(back_ei) == RELS
    for r in RELS:
        np.testing.assert_array_equal(back_ei[r], ei[r])
        np.testing.assert_array_equal(back_ei[r], want_ei[r])
    n = tg.num_nodes
    back_x = tgraph.homo_to_hetero_features(tg.x[:n], tg.node_type[:n], info)
    for t in feat:
        np.testing.assert_array_equal(back_x[t], feat[t])
    blocks, dims, ptrs = tgraph.pad_feature_blocks(list(feat.values()))
    jblocks, jdims, jptrs = jgraph.pad_feature_blocks(list(feat.values()))
    assert (dims, ptrs) == (jdims, jptrs) == ([0, 2], [0, 9])
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("names", [
    {"a": ["x", "y"], "b": ["x", "z", "w"]},
    ["p", "q"],
])
def test_hetero_names_to_homo_matches_jax(names):
    got, types = tgraph.hetero_names_to_homo(names)
    want, jtypes = jgraph.hetero_names_to_homo(names)
    assert got == want
    if jtypes is None:
        assert types is None
    else:
        np.testing.assert_array_equal(types, jtypes)


def _models(conv, seed, fc=None, rels=RELS, types=("a", "b"), in_features=5):
    fc = fc or (conv[-1], 4)
    jdef = px.hetero_gcn_for_relations(list(types), rels, in_features, conv_channels=conv,
                                       fc_channels=fc)
    params = jdef.init(jax.random.PRNGKey(seed))
    # random biases (the JAX init puts zeros there)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for layer in params["conv"]:
        for p in layer.values():
            p["bias"] = rng.normal(size=p["bias"].shape).astype(np.float32)
    tdef = tgnn.hetero_gcn_for_relations(list(types), rels, in_features, conv_channels=conv,
                                         fc_channels=fc)
    tdef.load_state_dict(params_from_numpy(params))
    return jdef, params, tdef


@pytest.mark.parametrize("conv", [(6,), (6, 4)])
def test_hetero_gnn_forward_matches_jax(conv):
    feat, ei = _hetero_inputs(seed=2)
    jg, _ = jgraph.hetero_to_homo(feat, ei)
    tg, _ = tgraph.hetero_to_homo(feat, ei, device="cpu")
    jdef, params, tdef = _models(conv, seed=2)
    rng = np.random.default_rng(3)
    ew = (rng.random((4, tg.e_pad)) > 0.3).astype(np.float32) * tg.host.edge_mask
    want = np.stack([
        np.asarray(jdef.apply(params, jg.x, jg.senders, jg.receivers, jax.numpy.asarray(w),
                              jg.node_type, jg.edge_type)) for w in ew
    ])
    got = tdef(tg.x, tg.senders, tg.receivers, torch.from_numpy(ew), tg.node_type, tg.edge_type)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert tdef.num_hops == len(conv) and tdef.relations == RELS
    # the adapter's typed forward is the same forward
    tm = Model(tdef, device="cpu", fast=False)
    np.testing.assert_allclose(tm.infer(tg).numpy(), np.asarray(
        px.Model(jdef, params, fast=False).infer(jg)), **TOL)


def _hetero_state_dict(seed=4, conv=(6, 4), fc=(4, 3), family="gcn"):
    """A PyG ``HeteroConv`` state dict (``conv.{2i}.convs.<src__rel__dst>.``,
    ReLUs interleaved, head ``fc.{2j}``), built with torch."""
    g = torch.Generator().manual_seed(seed)
    sd, prev = {}, 5
    for i, c in enumerate(conv):
        for r in RELS:
            pre = f"conv.{2 * i}.convs.{'__'.join(r)}."
            if family == "gcn":
                sd[pre + "lin.weight"] = torch.randn((c, prev), generator=g)
                sd[pre + "bias"] = torch.randn((c,), generator=g)
            else:
                sd[pre + "lin_l.weight"] = torch.randn((c, prev), generator=g)
                sd[pre + "lin_l.bias"] = torch.randn((c,), generator=g)
                sd[pre + "lin_r.weight"] = torch.randn((c, prev), generator=g)
        prev = c
    dims = (conv[-1],) + tuple(fc[1:]) + (1,)
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"fc.{2 * j}.weight"] = torch.randn((b, a), generator=g)
        sd[f"fc.{2 * j}.bias"] = torch.randn((b,), generator=g)
    return sd


def test_hetero_importers_match_jax():
    sd = _hetero_state_dict()
    sd_np = {k: v.numpy() for k, v in sd.items()}
    assert timport.hetero_relations_from_state_dict(sd) == jimport.hetero_relations_from_state_dict(sd_np)
    params = timport.hetero_gcn_params(sd)
    jparams = jimport.hetero_gcn_params(sd_np)
    np.testing.assert_array_equal(
        params["conv.1.b__r2__a.weight"].numpy(), np.asarray(jparams["conv"][1]["b__r2__a"]["weight"]))
    np.testing.assert_array_equal(params["fc.1.bias"].numpy(), np.asarray(jparams["fc"][1]["bias"]))
    assert set(params) == set(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)))

    # import_any: the model JAX builds, and the same forward on a graph whose
    # dict orders are the sorted ones the importer assumes
    tdef, tparams = timport.import_any(sd)
    jdef, jp = jimport.import_any(sd_np)
    assert isinstance(tdef, tgnn.HeteroGNN)
    assert tdef.node_type_names == jdef.node_type_names == ["a", "b"]
    assert tdef.relations == jdef.relations
    tdef.load_state_dict(tparams)
    feat, ei = _hetero_inputs(seed=5, fb=5)
    ei = {r: ei[r] for r in jdef.relations}
    jg, _ = jgraph.hetero_to_homo(feat, ei)
    tg, _ = tgraph.hetero_to_homo(feat, ei, device="cpu")
    want = np.asarray(px.Model(jdef, jp, fast=False).infer(jg))
    got = Model(tdef, device="cpu", fast=False).infer(tg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_hetero_sage_checkpoint_names_the_next_slice():
    """A hetero SAGE checkpoint imports as the JAX package imports it, with
    the same forward (more in tests/test_torch_hetero_families.py); the GCN
    importer refuses its relations by name."""
    sd = _hetero_state_dict(family="sage")
    jdef, jp = jimport.import_any({k: v.numpy() for k, v in sd.items()})
    tdef, tparams = timport.import_any(sd)
    assert [type(c).__name__ for c in tdef.conv_layers[0].values()] == ["SAGEConv"] * len(RELS)
    tdef.load_state_dict(tparams)
    feat, ei = _hetero_inputs(seed=6, fb=5)
    ei = {r: ei[r] for r in jdef.relations}
    jg, _ = jgraph.hetero_to_homo(feat, ei)
    tg, _ = tgraph.hetero_to_homo(feat, ei, device="cpu")
    want = np.asarray(px.Model(jdef, jp, fast=False).infer(jg))
    np.testing.assert_allclose(Model(tdef, device="cpu", fast=False).infer(tg).numpy(), want, **TOL)
    with pytest.raises(ValueError, match="not 'gcn'"):
        timport.hetero_gcn_params(sd)
