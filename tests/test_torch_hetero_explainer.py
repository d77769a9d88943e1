"""PyTorch port: ``Explainer.run`` on heterogeneous dict inputs gives the
JAX package's DataFrames for the same seed (same index order, ``rtol=1e-4,
atol=1e-5``): node, edge and graph problems, Shapley and community mode
(list and dict communities, of names and of integers), one and three
repeats, ``element_type`` lookups with names repeated across types.  Also
the reference faults the port does not inherit: integer hetero communities
shifted twice by a second run, and type ids taken by position."""

from __future__ import annotations

import copy

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu_torch.explain.batch import explain_many
from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
from bikg_graph_explainability_public_tpu_torch.explain.pathways import Pathways
from bikg_graph_explainability_public_tpu_torch.models import gnn as tgnn
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
RELS = [("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a")]
NA, NB, F = 14, 10, 6
CFG = {"seed": 3, "interpret_samples": 10, "epochs": 20, "lr": 0.01, "l1_lambda": 1e-4}


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    feat = {"a": rng.normal(size=(NA, F)).astype(np.float32),
            "b": rng.normal(size=(NB, F)).astype(np.float32)}
    sizes = {"a": NA, "b": NB}
    ei = {r: np.stack([rng.integers(0, sizes[r[0]], 22), rng.integers(0, sizes[r[-1]], 22)])
          for r in RELS}
    return feat, ei


@pytest.fixture(scope="module")
def setup():
    feat, ei = _graph()
    jdef = px.hetero_gcn_for_relations(["a", "b"], RELS, F, conv_channels=(8, 8), fc_channels=(8, 4))
    params = jax.tree_util.tree_map(np.asarray, jdef.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for layer in params["conv"]:
        for p in layer.values():
            p["bias"] = rng.normal(size=p["bias"].shape).astype(np.float32) * 0.1
    return feat, ei, jdef, params


def _port_model(params, types=("a", "b"), rels=RELS):
    tdef = tgnn.hetero_gcn_for_relations(list(types), rels, F, conv_channels=(8, 8), fc_channels=(8, 4))
    tdef.load_state_dict(params_from_numpy(params))
    return Model(tdef, device="cpu")


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns) and got.index.name == want.index.name
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


#: node names repeat across types: element_type picks the block
NODE_NAMES = {"a": [str(i) for i in range(NA)], "b": [str(i) for i in range(NB)]}
EDGE_NAMES = {r: [f"{r[1]}.{i}" for i in range(22)] for r in RELS}
#: names numbered globally, so that integer communities (shifted by their
#: type's pointer) name nodes of their own type
GLOBAL_NAMES = {"a": [str(i) for i in range(NA)], "b": [str(NA + i) for i in range(NB)]}

RUNS = {
    "node_a": dict(problem="node_prediction", element_type="a", names=NODE_NAMES, element="5"),
    "node_b": dict(problem="node_prediction", element_type="b", names=NODE_NAMES, element="5"),
    "edge": dict(problem="edge_prediction", element_type=("b", "r2", "a"), names=EDGE_NAMES,
                 element="r2.7"),
    "graph": dict(problem="graph_prediction", names=NODE_NAMES, element=None),
}
COMMUNITIES = {
    "shapley": {},
    "dict_names": dict(pathways={"a": [["1", "2", "3", "5"], ["4", "6"]], "b": [["0", "2", "5"]]},
                       pathway_names={"a": ["pa0", "pa1"], "b": ["pb0"]}),
    "list_names": dict(pathways=[["1", "2", "3"], ["4", "5", "6", "7"]], pathway_names=["p0", "p1"]),
    "dict_ints": dict(pathways={"a": [[0, 1, 2, 5], [3, 4]], "b": [[0, 2, 5, 7]]},
                      pathway_names={"a": ["pa0", "pa1"], "b": ["pb0"]}),
    "list_ints": dict(pathways=[[0, 1, 2], [NA, NA + 3, NA + 4]]),
}
CASES = [
    ("node_a", "shapley", 1), ("node_a", "shapley", 3), ("node_b", "shapley", 1),
    ("edge", "shapley", 1), ("edge", "shapley", 3), ("graph", "shapley", 1),
    ("node_a", "dict_names", 1), ("node_a", "dict_names", 3), ("node_b", "list_names", 1),
    ("graph", "dict_ints", 1), ("graph", "list_names", 3), ("graph", "list_ints", 1),
]


@pytest.mark.parametrize("run,mode,times", CASES)
def test_run_matches_jax(setup, run, mode, times):
    feat, ei, jdef, params = setup
    spec = dict(RUNS[run])
    names, element = spec.pop("names"), spec.pop("element")
    kw = dict(spec, **copy.deepcopy(COMMUNITIES[mode]))
    jcv, jpw = px.Explainer(feat, ei, px.Model(jdef, params), CFG, names, **kw).run(element, times=times)
    tcv, tpw = Explainer(feat, ei, _port_model(params), CFG, names, device="cpu", **kw).run(
        element, times=times)
    _assert_frames(tcv, jcv)
    if mode == "shapley":
        assert jpw is None and tpw is None
    else:
        _assert_frames(tpw, jpw)
    if times > 1:
        assert (tcv["config_value_std"] > 0).any()


@pytest.mark.parametrize("problem,etype", [
    ("node_prediction", "b"), ("edge_prediction", ("b", "r2", "a")),
])
def test_integer_hetero_communities_are_not_shifted_twice(setup, problem, etype):
    """Reference fault: ``Pathways.hetero2homo`` shifts integer communities
    in the caller's own lists, so a second ``run`` shifts them again.  The
    port shifts a copy: two runs give the same frames, which are JAX's for
    its first run, and the caller's communities are left as they were.
    Element names are global positions, so a shifted integer names its
    element."""
    feat, ei, jdef, params = setup
    if problem == "node_prediction":
        comms = {"a": [[1, 2, 3], [4, 5]], "b": [[0, 2], [1, 3, 4]]}
        cnames = {"a": ["pa0", "pa1"], "b": ["pb0", "pb1"]}
        names, element = GLOBAL_NAMES, "16"
    else:
        comms = {r: [[i for i in range(22) if i % 3 == j] for j in range(3)] for r in RELS}
        cnames = {r: [f"{r[1]}:{j}" for j in range(3)] for r in RELS}
        names = {r: [str(22 * ri + i) for i in range(22)] for ri, r in enumerate(RELS)}
        element = str(22 + 7)
    before = copy.deepcopy(comms)
    kw = dict(problem=problem, element_type=etype, pathways=comms, pathway_names=cnames)
    jcv, jpw = px.Explainer(feat, ei, px.Model(jdef, params), CFG, names,
                            **dict(kw, pathways=copy.deepcopy(comms))).run(element)
    ex = Explainer(feat, ei, _port_model(params), CFG, names, device="cpu", **kw)
    first = ex.run(element)
    second = ex.run(element)
    assert comms == before
    for got in (first, second):
        _assert_frames(got[0], jcv)
        _assert_frames(got[1], jpw)
    assert len(jpw) >= 2  # the shifted communities met the subgraph's names


def test_hetero2homo_shifts_a_copy_by_type_name():
    comms = {"drug": [[0, 2]], "gene": [[1]]}
    p = Pathways(comms, {"drug": ["d"], "gene": ["g"]})
    flat, names, types = p.hetero2homo("node_prediction", node_pointers={"gene": 0, "drug": 6})
    assert flat == [[6, 8], [1]] and names == ["d", "g"] and types.tolist() == [0, 1]
    flat2, *_ = Pathways(comms, {"drug": ["d"], "gene": ["g"]}).hetero2homo(
        "node_prediction", node_pointers={"gene": 0, "drug": 6})
    assert flat2 == flat and comms == {"drug": [[0, 2]], "gene": [[1]]}
    with pytest.raises(ValueError, match="community names"):
        Pathways(comms).hetero2homo("node_prediction", node_pointers={"gene": 0, "drug": 6})


@pytest.mark.parametrize("run", ["node_a", "edge", "graph"])
def test_types_are_matched_by_name(setup, run):
    """Reference fault: type ids are positions (``hetero_to_homo`` numbers
    types in the dicts' order, ``HeteroGNN`` in its own), so a model whose
    orders differ from the graph's computes with the wrong scopes and
    relations, silently.  The port's ``Explainer`` renumbers the graph's
    types into the model's order by name: a model built with both orders
    permuted (and names given in another order) gives JAX's frames for the
    aligned orders."""
    feat, ei, jdef, params = setup
    spec = dict(RUNS[run])
    names, element = spec.pop("names"), spec.pop("element")
    jcv, _ = px.Explainer(feat, ei, px.Model(jdef, params), CFG, names, **spec).run(element)
    permuted = _port_model(params, types=("b", "a"), rels=[RELS[2], RELS[0], RELS[1]])
    names = {k: names[k] for k in reversed(list(names))}
    tcv, _ = Explainer(feat, ei, permuted, CFG, names, device="cpu", **spec).run(element)
    _assert_frames(tcv, jcv)


def test_type_sets_must_match(setup):
    feat, ei, _, params = setup
    other = _port_model(params)
    other.model_def.node_type_names = ["a", "c"]
    with pytest.raises(ValueError, match="node types"):
        Explainer(feat, ei, other, CFG, NODE_NAMES, element_type="a", device="cpu").run("5")
    ei2 = {("a", "r9", "b") if r == RELS[0] else r: v for r, v in ei.items()}
    with pytest.raises(ValueError, match="relations"):
        Explainer(feat, ei2, _port_model(params), CFG, NODE_NAMES, element_type="a",
                  device="cpu").run("5")


def test_element_type_checks_and_cuda_default(setup):
    feat, ei, _, params = setup
    model = _port_model(params)
    with pytest.raises(AssertionError, match="not among input node types"):
        Explainer(feat, ei, model, CFG, NODE_NAMES, element_type="c", device="cpu")
    with pytest.raises(AssertionError, match="not among input edge types"):
        Explainer(feat, ei, model, CFG, EDGE_NAMES, problem="edge_prediction",
                  element_type=("a", "r9", "b"), device="cpu")
    with pytest.raises(AssertionError, match="not present"):
        Explainer(feat, ei, model, CFG, NODE_NAMES, element_type="b", device="cpu").run("12")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Explainer(feat, ei, model, CFG, NODE_NAMES, element_type="a")


def test_explain_many_refuses_hetero_models(setup):
    """``explain_many``'s hetero runners are the next slice's."""
    feat, ei, _, params = setup
    from bikg_graph_explainability_public_tpu_torch.graph import hetero_to_homo

    graph, _ = hetero_to_homo(feat, ei, device="cpu")
    with pytest.raises(NotImplementedError, match="hetero"):
        explain_many(_port_model(params), graph, [3], CFG)
