"""PyTorch port: ``Explainer.run(..., return_diagnostics=True)`` returns the
JAX package's diagnostics for the same seed, the profiling hooks of
``utils/profiling.py`` work on the CPU, and ``extract_khop_subgraph(...,
host_only=True)`` gives the device form's arrays without uploading them."""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.models.checkpoint import load_params as jload_params
from bikg_graph_explainability_public_tpu_torch.explain import explainer as texplainer
from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import load_params
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
from bikg_graph_explainability_public_tpu_torch.ops.khop import extract_khop_subgraph
from bikg_graph_explainability_public_tpu_torch.utils.profiling import (
    PhaseTimer,
    annotate,
    device_trace,
)

from fixtures import make_communities

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def toy():
    d = np.load(TOY)
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        cfg = json.load(f)
    return d["feat"], d["edge_index"], [str(x) for x in d["names"]], cfg


@pytest.mark.parametrize("problem", ["node_prediction", "edge_prediction"])
@pytest.mark.parametrize("times,mode", [(1, "shapley"), (3, "shapley"), (2, "community")])
def test_run_diagnostics_match_jax(toy, times, mode, problem):
    feat, ei, names, cfg = toy
    if problem == "edge_prediction":
        names = [str(i) for i in range(ei.shape[1])]
    kw = dict(problem=problem)
    if mode == "community":
        pathways, pathway_names = make_communities(len(names))
        kw.update(pathways=pathways, pathway_names=pathway_names)
    jm = px.Model(px.GCNNodeModel(84), jload_params(CKPT))
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    *_, want = px.Explainer(feat, ei, jm, cfg, names, **kw).run("10", times, return_diagnostics=True)
    tex = texplainer.Explainer(feat, ei, tm, cfg, names, device="cpu", **kw)
    cv, pw, got = tex.run("10", times, return_diagnostics=True)
    assert set(got) == set(want)
    assert set(got["phase_seconds"]) == set(want["phase_seconds"]) == {
        "mask_sampling", "surrogate_training"}
    assert all(v >= 0 for v in got["phase_seconds"].values())
    for key in ("num_elements", "subgraph_nodes", "subgraph_edges", "best_epoch"):
        assert got[key] == want[key], key
    assert len(got["losses"]) == times
    for a, b in zip(got["losses"], want["losses"]):
        assert a.shape == (cfg["epochs"],)
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # the frames are run's without the flag
    cv0, pw0 = tex.run("10", times)
    assert cv.equals(cv0)
    assert (pw is None and pw0 is None) or pw.equals(pw0)


def test_private_step_returns_the_diagnostics_beside_the_arrays(toy):
    feat, ei, names, cfg = toy
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    tex = texplainer.Explainer(feat, ei, tm, cfg, names, device="cpu")
    ex, diag = tex._explain("10", 2, return_diagnostics=True)
    plain = tex._explain("10", 2)
    np.testing.assert_array_equal(ex.mean, plain.mean)
    assert diag["num_elements"] == len(ex.names)
    assert [int(np.argmin(l)) for l in diag["losses"]] == diag["best_epoch"]


def test_phase_timer_accumulates_and_syncs():
    timer = PhaseTimer()
    x = torch.ones(4)
    for _ in range(2):
        with timer.phase("a", sync=x):
            time.sleep(0.01)
    with timer.phase("b", sync=torch.device("cpu")):
        pass
    with pytest.raises(ValueError):
        with timer.phase("c", sync="cpu"):
            raise ValueError("a failing phase is still timed")
    assert timer.counts == {"a": 2, "b": 1, "c": 1}
    assert timer.totals["a"] >= 0.02
    lines = timer.summary().splitlines()
    assert lines[1].split()[0] == "a" and len(lines) == 4


def test_device_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "my_region" in {e.key for e in prof.key_averages()}
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)


@pytest.mark.parametrize("query,hops,pad_mode", [(10, 2, "multiple"), (3, 2, "pow2"), (6, 3, "exact")])
def test_khop_host_only_matches_device_form(toy, query, hops, pad_mode):
    feat, ei, _, _ = toy
    g = from_arrays(feat, ei, device="cpu")
    dev = extract_khop_subgraph(g, query, hops, pad_mode=pad_mode)
    host = extract_khop_subgraph(g, query, hops, pad_mode=pad_mode, host_only=True)
    assert (host.graph.num_nodes, host.graph.num_edges, host.query) == (
        dev.graph.num_nodes, dev.graph.num_edges, dev.query)
    np.testing.assert_array_equal(host.parent_nodes, dev.parent_nodes)
    np.testing.assert_array_equal(host.parent_edge_mask, dev.parent_edge_mask)
    for name in ("x", "senders", "receivers", "node_mask", "edge_mask", "node_type", "edge_type"):
        field = getattr(host.graph, name)
        assert isinstance(field, np.ndarray), name  # nothing was uploaded
        np.testing.assert_array_equal(field, getattr(dev.graph, name).numpy())
        assert getattr(host.graph.host, name) is field
