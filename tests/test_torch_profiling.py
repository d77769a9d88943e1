"""PyTorch port: ``Explainer.run(..., return_diagnostics=True)`` returns the
JAX package's diagnostics for the same seed, the spans, counters and timer
of ``utils/profiling.py`` work on the CPU, and ``extract_khop_subgraph(...,
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
from bikg_graph_explainability_public_tpu_torch.explain import batch as tbatch
from bikg_graph_explainability_public_tpu_torch.explain import explainer as texplainer
from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models import fast_gcn as tfast
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import load_params
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
from bikg_graph_explainability_public_tpu_torch.ops.khop import extract_khop_subgraph
from bikg_graph_explainability_public_tpu_torch.utils import profiling
from bikg_graph_explainability_public_tpu_torch.utils.profiling import (
    PhaseTimer,
    device_trace,
    span,
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


def test_device_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with span("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "bikg.my_region" in {e.key for e in prof.key_averages()}
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "bikg.my_region" for e in events)


# span -> its parent in one Explainer.run request (Shapley mode, node problem)
RUN_TREE = {
    "run.request": None, "prepare_graph": "run.request", "extract": "run.request",
    "mask_sampling": "run.request", "surrogate_training": "run.request",
    "forwards": "surrogate_training", "fit": "surrogate_training",
    "fetch": "surrogate_training", "frames": "run.request",
}
GRAPH_ARRAYS = ("x", "senders", "receivers", "node_mask", "edge_mask", "node_type", "edge_type")


def _toy_explainer(toy):
    feat, ei, names, cfg = toy
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    return texplainer.Explainer(feat, ei, tm, cfg, names, device="cpu")


def test_run_request_records_its_span_tree_under_one_request(toy):
    tex = _toy_explainer(toy)
    with profiling.recording() as rec:
        tex.run("10", 2)
    spans = rec.spans
    names = [s.name for s in spans]
    assert set(names) == set(RUN_TREE) | {"sync"}
    assert names.count("frames") == 2 and names.count("run.request") == 1
    assert {s.request for s in spans} == {0}
    for s in spans:
        parent = spans[s.parent].name if s.parent is not None else None
        want = "surrogate_training" if s.name == "sync" else RUN_TREE[s.name]
        assert parent == want, s.name
        assert s.end_ns >= s.start_ns and s.self_seconds >= 0
    root = spans[0]
    assert root.name == "run.request"
    assert sum(s.self_seconds for s in spans) <= root.seconds + 1e-9
    tot = rec.totals()
    assert tot["run.request", "run.request"]["calls"] == 1
    assert tot["run.request", "frames"]["calls"] == 2
    g = from_arrays(toy[0], toy[1], device="cpu")
    want_bytes = sum(getattr(g.host, k).nbytes for k in GRAPH_ARRAYS)
    assert tot["run.request", "prepare_graph"]["upload_bytes"] == want_bytes
    masks = tot["run.request", "forwards"]["upload_bytes"]
    assert masks % 2 == 0 and masks > 0  # two repeats' bool masks


def test_span_is_one_nullcontext_and_records_nothing_with_nobody_listening(toy):
    assert profiling.recorder() is None and not torch.autograd._profiler_enabled()
    assert span("a") is span("b")
    profiling.count("upload_bytes", 5)
    with profiling.recording() as rec:
        pass
    _toy_explainer(toy).run("10", 1)
    assert rec.spans == [] and rec.totals() == {}
    assert profiling.recorder() is None


def test_recorded_spans_sit_on_their_profiler_events(toy):
    tex = _toy_explainer(toy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            tex.run("10", 2)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("bikg."):
            events.setdefault(e.name(), []).append((e.start_ns(), e.duration_ns()))
    recorded = {}
    for s in rec.spans:
        recorded.setdefault("bikg." + s.name, []).append(s)
    assert set(events) == set(recorded)
    for name, got in recorded.items():
        prof_events = sorted(events[name])
        assert len(prof_events) == len(got), name
        for s, (start, dur) in zip(sorted(got, key=lambda s: s.start_ns), prof_events):
            assert abs(s.start_ns - start) <= 1_000_000, name
            rec_dur = s.end_ns - s.start_ns
            assert abs(rec_dur - dur) <= max(0.1 * dur, 500_000), name


def test_phase_timer_records_a_sync_child_and_keeps_its_totals():
    timer = PhaseTimer()
    with profiling.recording() as rec:
        with timer.phase("a", sync="cpu"):
            time.sleep(0.01)
        with timer.phase("b"):
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [("a", None), ("sync", 0), ("b", None)]
    assert [s.request for s in rec.spans] == [0, 0, 1]
    assert timer.counts == {"a": 1, "b": 1}
    assert timer.totals["a"] >= 0.01
    assert rec.spans[0].seconds <= timer.totals["a"]


QUERIES = [10, 3, 25, 0]


def _toy_many(toy):
    model = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    return model, from_arrays(toy[0], toy[1], device="cpu")


def test_repeated_explain_many_counts_its_plan_cache_hits(toy):
    _, _, names, cfg = toy
    model, g = _toy_many(toy)
    queries = QUERIES
    totals = []
    for _ in range(2):
        with profiling.recording() as rec:
            tbatch.explain_many(model, g, queries, cfg, names=names, times=2)
        totals.append(rec.totals())
    first, again = totals
    stacks = first["many.call", "plan_build"]["calls"]
    assert stacks >= 1 and ("many.call", "plan_build") not in again
    call = first["many.call", "many.call"]
    assert call.get("plan_cache_hits", 0) == 0 and call["plan_cache_misses"] == stacks
    assert again["many.call", "many.call"]["plan_cache_hits"] == stacks
    assert first["many.call", "bucket"]["subgraphs"] == len(queries)
    assert again["many.call", "bucket"]["subgraph_cache_hits"] == len(queries)
    assert first["many.call", "plan.stack"]["stack_bytes"] > 0
    upload = first["many.call", "plan.upload"]
    assert upload["uploads"] >= 6 * stacks and upload["upload_bytes"] > 0
    for t in totals:
        assert t["many.call", "forwards"]["calls"] == 2 * stacks
        assert t["many.call", "fetch_and_assembly"]["fetch_bytes"] > 0
        assert t["many.frames", "many.frames"]["calls"] == 1


def test_timed_explain_many_syncs_inside_its_phases(toy):
    _, _, names, cfg = toy
    model, g = _toy_many(toy)
    timer = PhaseTimer()
    with profiling.recording() as rec:
        tbatch._explain_many(model, g, QUERIES, cfg, names=names, times=2, timer=timer)
    synced = {rec.spans[s.parent].name for s in rec.spans if s.name == "sync"}
    assert synced == {"plan_build", "mask_draw", "forwards", "kernel_weights_and_training"}
    stacks = timer.counts["plan_build"]
    assert timer.counts["forwards"] == 2 * stacks
    assert rec.totals()["many.call", "sync"]["calls"] == stacks + 3 * 2 * stacks


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


@pytest.mark.parametrize("ell", [False, True])
def test_only_unrestricted_requests_build_the_engines_structures(toy, monkeypatch, ell):
    """A node query, served by its plan, builds neither the neighbour table
    nor the dense adjacency; a graph problem builds the one its tier reads,
    once, and adds its bytes to the masks' under ``forwards``."""
    if ell:
        monkeypatch.setattr(tfast, "DENSE_THRESHOLD", 0)
    feat, ei, names, cfg = toy
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    node = texplainer.Explainer(feat, ei, tm, cfg, names, device="cpu")
    graph = texplainer.Explainer(feat, ei, tm, cfg, names, problem="graph_prediction",
                                 device="cpu")
    with profiling.recording() as rec:
        node.run("10", 2)
    fwd = rec.totals()["run.request", "forwards"]
    assert fwd.get("neighbor_table_builds", 0) == fwd.get("dense_adjacency_builds", 0) == 0
    with profiling.recording() as rec:
        graph.run(None, 2)
    fwd = rec.totals()["run.request", "forwards"]
    engine = tm._fast_cache[1]
    assert engine.mode == ("ell" if ell else "dense")
    assert fwd.get("neighbor_table_builds", 0) == int(ell)
    assert fwd.get("dense_adjacency_builds", 0) == int(not ell)
    if ell:
        built = sum(a.nbytes for a in (engine.table.nbr, engine.table.valid, engine.table.eid))
    else:
        built = engine.adj.nbytes
    n_pad = tm._fast_cache[0].n_pad
    masks = 2 * cfg["interpret_samples"] * cfg["epochs"] * n_pad  # two repeats' bool masks
    assert fwd["upload_bytes"] == masks + built
