"""Shared fixtures of the benchmark's own tests, and the ``card`` marker:
a test that needs a CUDA card skips inside its ``card`` fixture where there
is none, never while the module is imported."""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.dirname(HERE)
CHECKOUT = os.path.dirname(PACKAGE)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_graph_block(block: dict) -> dict:
    """A configuration's graph block cut to a size a CPU test runs in
    seconds (the generator and everything else unchanged)."""
    out = dict(block)
    out.update(genes=300, pathways={"count": 20, "memberships": 300, "size_mean": 15.0,
                                    "size_sigma": 1.0},
               relations=[dict(r, edges=e) for r, e in zip(block["relations"], (600, 250, 900))])
    return out


@pytest.fixture
def tiny_bench(tmp_path):
    """A ``BENCHMARK.json`` whose configurations are the real ones on a
    300-gene graph, and the registry over it."""
    from bench_port.registry import Registry

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(CHECKOUT, c["file"])) as f:
            cfg = json.load(f)
        cfg["graph"] = tiny_graph_block(cfg["graph"])
        c["file"] = f"tiny-{c['name']}.json"
        with open(tmp_path / c["file"], "w") as f:
            json.dump(cfg, f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return Registry(benchmark=str(tmp_path / "BENCHMARK.json"))


@pytest.fixture
def package_copy(tmp_path):
    """A copy of this package's files, for tests that add files to it."""
    dst = tmp_path / "bench_port"
    shutil.copytree(PACKAGE, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst
