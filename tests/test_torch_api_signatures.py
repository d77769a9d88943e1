"""PyTorch port: the public signatures are the JAX package's.

Every name of ``scripts/api_signatures.json`` (the JAX package's public
signature manifest, read only) that the port also defines is held against
it: the same parameters, in the same order, of the same kinds, with the
same defaults.  Annotations are not compared (``jax.Array`` against
``torch.Tensor``).  The only departures allowed are the rows of
:data:`DEPARTURES`, each of a kind in :data:`ALLOWED`.  Also: the
``Explainer`` called in the reference's positional order, and
``Pathways.comp_graph``'s triple against JAX's.
"""

from __future__ import annotations

import ast
import inspect
import json
import os
import re

import jax
import numpy as np
import pandas as pd
import pytest

import bikg_graph_explainability_public_tpu as jpx
import bikg_graph_explainability_public_tpu_torch as px
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "scripts", "api_signatures.json")) as f:
    MANIFEST = json.load(f)

#: the kinds of departure a row may make: parameters appended after the
#: reference's (the device, a generator for weight draws), and the
#: ``params`` tree, which the port's models keep in their ``nn.Module``s
ALLOWED = dict(append={"device", "generator"}, drop={"params"}, default={"params"})

_GEN = "weights are drawn by a torch.Generator where the JAX package's init takes a key"
_DEV = "where the port puts its tensors; None means the CUDA card"
_MOD = "the parameters live in the nn.Module"

#: name -> (departure, reason)
DEPARTURES = {
    **{name: (dict(append=("generator",)), _GEN) for name in (
        "ConvStackNodeModel.__init__", "GCNNodeModel.__init__", "HeteroGNN.__init__",
        "GCNConv.__init__", "GATConv.__init__", "GATv2Conv.__init__", "GINConv.__init__",
        "GraphConv.__init__", "SAGEConv.__init__", "Linear.__init__",
        "gat_node_model", "gatv2_node_model", "gin_node_model", "graph_conv_node_model",
        "sage_node_model", "hetero_gcn_for_relations", "hetero_sage_for_relations",
        "hetero_gat_for_relations", "RGCNConv.__init__", "RGCNNodeModel.__init__",
    )},
    **{name: (dict(append=("device",)), _DEV) for name in (
        "Data.__init__", "Explainer.__init__", "Kernel.__init__", "from_arrays",
        "hetero_to_homo",
    )},
    **{name: (dict(drop=("params",)), _MOD) for name in (
        "ConvStackNodeModel.backbone", "ConvStackNodeModel.head",
        "HeteroGNN.backbone", "HeteroGNN.head", "RGCNNodeModel.backbone", "RGCNNodeModel.head",
    )},
    "Model.__init__": (
        dict(default={"params": None}, append=("device",)),
        "the module may carry its parameters already (params=None); " + _DEV,
    ),
}


def _manifest_params(sig: str):
    """(name, kind, default source) of each parameter of a manifest
    signature string; a function default reads as its name."""
    src = re.sub(r"<(function|class|bound method) ([^>]+)>", r"\2", sig)
    args = ast.parse(f"def f{src}: pass").body[0].args
    pos = args.posonlyargs + args.args
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    out = [(p.arg, "positional", d and ast.unparse(d)) for p, d in zip(pos, defaults)]
    if args.vararg:
        out.append((args.vararg.arg, "var_positional", None))
    out += [(p.arg, "keyword_only", d and ast.unparse(d))
            for p, d in zip(args.kwonlyargs, args.kw_defaults)]
    if args.kwarg:
        out.append((args.kwarg.arg, "var_keyword", None))
    return out


def _default_source(value) -> str:
    return value.__name__ if callable(value) else repr(value)


def _port_params(fn):
    kinds = {
        inspect.Parameter.POSITIONAL_ONLY: "positional",
        inspect.Parameter.POSITIONAL_OR_KEYWORD: "positional",
        inspect.Parameter.VAR_POSITIONAL: "var_positional",
        inspect.Parameter.KEYWORD_ONLY: "keyword_only",
        inspect.Parameter.VAR_KEYWORD: "var_keyword",
    }
    return [
        (p.name, kinds[p.kind], None if p.default is p.empty else _default_source(p.default))
        for p in inspect.signature(fn).parameters.values()
    ]


def _port_callable(name: str):
    """The port's function or method of a manifest name, or None where the
    port does not define it (the JAX modules' ``init`` / ``apply``, the
    unported names)."""
    if "." not in name:
        return getattr(px, name, None)
    cls_name, meth = name.split(".")
    cls = getattr(px, cls_name, None)
    if cls is None or meth not in vars(cls):
        return None
    fn = vars(cls)[meth]
    return fn.__func__ if isinstance(fn, (staticmethod, classmethod)) else fn


SHARED = sorted(name for name in MANIFEST if _port_callable(name) is not None)


def _apply_departure(want, dep):
    """The manifest's parameters with a table row's departure applied."""
    want = [p for p in want if p[0] not in dep.get("drop", ())]
    default = dep.get("default", {})
    want = [(n, k, repr(default[n]) if n in default else d) for n, k, d in want]
    at = next((i for i, p in enumerate(want) if p[1] in ("keyword_only", "var_keyword")), len(want))
    kind = "keyword_only" if at < len(want) else "positional"
    added = [(n, kind, "None") for n in dep.get("append", ())]
    # appended after the reference's parameters: after the positional ones
    # where those end the list, else among the keyword-only ones at the end
    return want + added if kind == "keyword_only" else want[:at] + added + want[at:]


def test_the_manifest_is_shared_widely():
    """The comparison covers the public surface, not a handful of names."""
    assert len(SHARED) >= 60, SHARED
    for name in ("Explainer.__init__", "Pathways.__init__", "Pathways.comp_graph",
                 "explain_many", "set_seed", "approximate_shap_kernel_parity",
                 "LinearRegression.init", "Graph.edge_index", "Graph.with_features",
                 "get_version", "ExplainerConfig.__init__"):
        assert name in SHARED, name


@pytest.mark.parametrize("name", SHARED)
def test_signature_matches_the_manifest(name):
    want = _manifest_params(MANIFEST[name])
    got = _port_params(_port_callable(name))
    if name in DEPARTURES:
        dep, reason = DEPARTURES[name]
        assert reason
        want = _apply_departure(want, dep)
    assert got == want, f"{name}: port {got} != manifest {want}"


def test_departures_are_of_the_allowed_kinds_and_all_used():
    for name, (dep, reason) in DEPARTURES.items():
        assert name in SHARED, f"stale row {name}"
        assert set(dep) <= set(ALLOWED), name
        for kind, items in dep.items():
            assert set(items) <= ALLOWED[kind], (name, kind, items)
        # a row departs: without it the signature would not match
        assert _port_params(_port_callable(name)) != _manifest_params(MANIFEST[name]), name


# ---------------------------------------------------------------------------
# the repaired signatures in use
# ---------------------------------------------------------------------------


def _hetero_toy():
    rng = np.random.default_rng(3)
    feat = {"a": rng.normal(size=(8, 5)).astype(np.float32),
            "b": rng.normal(size=(6, 5)).astype(np.float32)}
    rels = [("a", "r1", "b"), ("b", "r2", "a")]
    ei = {rels[0]: np.stack([rng.integers(0, 8, 16), rng.integers(0, 6, 16)]),
          rels[1]: np.stack([rng.integers(0, 6, 16), rng.integers(0, 8, 16)])}
    names = {"a": [f"a{i}" for i in range(8)], "b": [f"b{i}" for i in range(6)]}
    jdef = jpx.hetero_gcn_for_relations(["a", "b"], rels, 5, conv_channels=(4,), fc_channels=(4, 3))
    params = jax.tree_util.tree_map(np.asarray, jdef.init(jax.random.PRNGKey(1)))
    tdef = px.hetero_gcn_for_relations(["a", "b"], rels, 5, conv_channels=(4,), fc_channels=(4, 3))
    model = px.Model(tdef, params_from_numpy(params), device="cpu")
    return feat, ei, names, model, jpx.Model(jdef, params)


def test_explainer_takes_the_reference_positional_order():
    """``(feat, ei, model, cfg, names, pathways, pathway_names,
    element_type, problem)`` binds as the reference binds it, and gives the
    keyword call's frames (and JAX's)."""
    feat, ei, names, model, jmodel = _hetero_toy()
    cfg = {"seed": 2, "interpret_samples": 8, "epochs": 10, "lr": 0.01, "l1_lambda": 1e-4}
    positional = px.Explainer(feat, ei, model, cfg, names, None, None, "a", "node_prediction",
                              device="cpu")
    assert positional.element_type == "a" and positional.problem == "node_prediction"
    keyword = px.Explainer(feat, ei, model, cfg, names, element_type="a",
                           problem="node_prediction", device="cpu")
    got, _ = positional.run("a3")
    want, _ = keyword.run("a3")
    pd.testing.assert_frame_equal(got, want)
    ref, _ = jpx.Explainer(feat, ei, jmodel, cfg, names, None, None, "a",
                           "node_prediction").run("a3")
    assert list(got.index) == list(ref.index)
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=1e-4, atol=1e-6)


def test_pathways_comp_graph_triple_matches_jax():
    """``Pathways(communities, names, types).comp_graph`` keeps each kept
    community's type, as JAX's does; without types the third item is
    None."""
    comms = {"a": [["a1", "a3", "zz"], ["a7"]], "b": [["b0", "b2"], ["b9"], ["b1", "a2"]]}
    cnames = {"a": ["pa", "pb"], "b": ["pc", "pd", "pe"]}
    flat, fnames, types = px.Pathways(comms, cnames).hetero2homo("node_prediction")
    jflat, jfnames, jtypes = jpx.Pathways(
        {k: [list(c) for c in v] for k, v in comms.items()}, cnames
    ).hetero2homo("node_prediction")
    assert (flat, fnames) == (jflat, jfnames)
    np.testing.assert_array_equal(types, jtypes)
    sub = ["a1", "a2", "a7", "b2", "b5"]
    got = px.Pathways(flat, fnames, types).comp_graph(sub)
    want = jpx.Pathways(jflat, jfnames, jtypes).comp_graph(sub)
    assert got[:2] == want[:2]
    assert got[2].dtype == want[2].dtype
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], [0, 0, 1, 1])  # pa, pb, pc, pe
    assert px.Pathways(flat, fnames).comp_graph(sub)[2] is None
