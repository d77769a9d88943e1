"""The harness finds every piece of a cell by its name, and a cell made of
new files alone runs with no edit to a file that is there."""

from __future__ import annotations

import json
import os
import shutil

from bench_port import run
from bench_port.registry import Registry

from conftest import CHECKOUT, tiny_graph_block


def test_every_piece_of_every_cell_is_found():
    reg = Registry()
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        traffic = reg.traffic(w["traffic"])
        assert set(reg.limits(w["name"])) == {"names_mismatch", "score_gap", "score_gap_p99"}
        assert hasattr(reg.driver(traffic["entry"]), "Driver")
        fam = cfg["model"]["family"]
        assert hasattr(reg.family(fam), "program_model")
        assert hasattr(reg.reference_family(fam), "query_outputs")
        e2e = {m["name"] for m in reg.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = reg.metrics_of(w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)
    for kind in ("end_to_end", "per_layer"):
        for m in reg.bench[kind]:
            reader = reg.metric(m["name"])
            assert reader.UNIT == m["unit"] and callable(reader.read)
            if kind == "per_layer":
                assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


DUMMY_METRIC = '''"""Calls in the window (a test's metric)."""

UNIT = "calls"
LAYER = "device"
MOVES = "explanations_per_s"


def read(rec):
    return rec.get("calls")
'''


def test_a_cell_of_new_files_runs(package_copy, tmp_path):
    with open(os.path.join(CHECKOUT, "bench_port/configs/gcn16-hetionet-genes.json")) as f:
        cfg = json.load(f)
    cfg["graph"] = tiny_graph_block(cfg["graph"])
    (package_copy / "configs" / "dummy-genes.json").write_text(json.dumps(cfg))
    traffic = {"entry": "explain_many", "mode": "shapley", "genes_seed": 5,
               "queries_per_call": 4, "times": 1,
               "warmup_calls": 1, "explain": {"seed": 3, "interpret_samples": 4, "epochs": 5},
               "check_answers": 2, "trace_seconds": 0}
    (package_copy / "traffic" / "many-dummy.json").write_text(json.dumps(traffic))
    (package_copy / "metrics" / "dummy_calls.many.py").write_text(DUMMY_METRIC)
    (package_copy / "checks" / "dummy-genes.many-dummy.json").write_text(
        json.dumps({"names_mismatch": 0, "score_gap": 1e-3, "score_gap_p99": 1e-3}))
    cell = "dummy-genes.many-dummy"
    bench = {
        "configs": [{"name": "dummy-genes", "file": "bench_port/configs/dummy-genes.json"}],
        "workloads": [{"name": cell, "config": "dummy-genes", "traffic": "many-dummy",
                       "chips": 1}],
        "end_to_end": [{"name": "explanations_per_s", "unit": "expl/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "dummy_calls.many", "unit": "calls", "layer": "device",
                       "moves": "explanations_per_s", "workloads": [cell]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(root=str(package_copy), benchmark=str(tmp_path / "BENCHMARK.json"))
    for trace in (False, True):
        result, _ = run.run_cell(reg, cell, 2**31 + 11, 0.0, trace, "cpu")
        assert result["correct"], result
        want = {"dummy_calls.many"} if trace else {"explanations_per_s", "setup_s"}
        assert set(result["metrics"]) == want
    assert result["metrics"]["dummy_calls.many"]["value"] == 1


def test_no_timed_call_is_served_from_the_launch_plan_cache(tiny_bench, monkeypatch):
    from bikg_graph_explainability_public_tpu_torch.explain import batch

    hits = []
    get = batch._plan_cache_get

    def counting(*args):
        entry = get(*args)
        hits.append(entry is not None)
        return entry
    monkeypatch.setattr(batch, "_plan_cache_get", counting)
    cell = next(w["name"] for w in tiny_bench.bench["workloads"]
                if tiny_bench.traffic(w["traffic"])["entry"] == "explain_many")
    result, _ = run.run_cell(tiny_bench, cell, 2**31 + 13, 1.0, False, "cpu")
    assert result["correct"] and hits and not any(hits)


TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy_family")


def test_a_family_that_is_not_gcn_is_added_by_files_alone(package_copy, tmp_path, monkeypatch):
    """A GraphConv family, its reference, configuration, traffic and limits
    added as files to a copy of the harness: its cell runs correct, and
    reports a whole-step share only once its operation count is added too."""
    from bench_port.metrics import _peaks

    family = "toy_graph_conv"
    for folder in ("families", "reference"):
        shutil.copy(os.path.join(TOY, folder, family + ".py"), package_copy / folder)
    with open(os.path.join(CHECKOUT, "bench_port/configs/gcn16-hetionet-genes.json")) as f:
        cfg = json.load(f)
    cfg["graph"] = tiny_graph_block(cfg["graph"])
    cfg["model"]["family"] = family
    (package_copy / "configs" / "toy-genes.json").write_text(json.dumps(cfg))
    traffic = json.loads((package_copy / "traffic" / "run-shapley.json").read_text())
    traffic.update(cycle=4, times=1, warmup_rounds=0, check_answers=3)
    (package_copy / "traffic" / "run-toy.json").write_text(json.dumps(traffic))
    cell = "toy-genes.run-toy"
    (package_copy / "checks" / f"{cell}.json").write_text(
        (package_copy / "checks" / "gcn16-hetionet-genes.run-shapley.json").read_text())
    bench = {
        "configs": [{"name": "toy-genes", "file": "bench_port/configs/toy-genes.json"}],
        "workloads": [{"name": cell, "config": "toy-genes", "traffic": "run-toy", "chips": 1}],
        "end_to_end": [{"name": "explain_p50_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": n, "unit": u, "layer": "whole step", "moves": "explain_p50_s",
                       "workloads": [cell]}
                      for n, u in (("mfu_pct.run", "%"), ("launches_per_expl.run", "launches"))],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(root=str(package_copy), benchmark=str(tmp_path / "BENCHMARK.json"))
    # a stand-in peak for the CPU, so that only the count decides whether the share is read
    monkeypatch.setitem(_peaks.FP32_FLOPS, "cpu", 1e12)
    result, checks = run.run_cell(reg, cell, 2**31 + 17, 0.0, True, "cpu")
    assert result["correct"] and result["failed"] == 0, checks
    assert set(result["metrics"]) == {"launches_per_expl.run"}
    shutil.copy(os.path.join(TOY, f"_opcount_{family}.py"), package_copy / "metrics")
    result, checks = run.run_cell(reg, cell, 2**31 + 17, 0.0, True, "cpu")
    assert result["correct"], checks
    assert set(result["metrics"]) == {"launches_per_expl.run", "mfu_pct.run"}
    assert result["metrics"]["mfu_pct.run"]["value"] > 0
