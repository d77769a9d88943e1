"""The plain reference agrees with the program on the CPU at a toy size:
each family's forward, and every cell's whole run."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from bench_port import graphgen, run
from bench_port.reference import explain as rx
from bench_port.registry import Registry

from conftest import CHECKOUT, tiny_graph_block

CELLS = [w["name"] for w in Registry().bench["workloads"]]
FAMILIES = ["gcn16-hetionet-genes", "hgcn16-hetionet-genes3"]


@pytest.mark.parametrize("config", FAMILIES)
def test_family_forward_matches_the_program(config):
    with open(os.path.join(CHECKOUT, f"bench_port/configs/{config}.json")) as f:
        cfg = json.load(f)
    reg = Registry()
    fam = reg.family(cfg["model"]["family"])
    ref = reg.reference_family(cfg["model"]["family"])
    gg = graphgen.generate(tiny_graph_block(cfg["graph"]))
    edges, etype = gg.merged_edges(), fam.edge_types(gg, cfg["model"])
    params = run.make_weights(fam.param_specs(cfg["model"]), 2**31 + 3, "cpu")
    model = fam.program_model(cfg["model"], params, "cpu")
    ptr, col = graphgen.in_neighbour_csr(gg.n, edges)
    query = int(np.argmax(np.bincount(edges[1], minlength=gg.n)))
    sub = rx.subgraph(graphgen.khop_nodes(ptr, col, query, 2), edges, etype, query)
    x = torch.as_tensor(gg.x[sub.nodes])
    masks = (torch.rand(16, sub.nodes.size, generator=torch.Generator().manual_seed(0)) < 0.5)
    want = ref.query_outputs(params, x, sub, masks.float(), rx.Precision(False))
    snd, rcv = torch.as_tensor(sub.snd), torch.as_tensor(sub.rcv)
    mf = masks.float()
    ew = mf[:, snd] * mf[:, rcv]
    types = (torch.zeros(sub.nodes.size, dtype=torch.long), torch.as_tensor(sub.etype))
    with torch.no_grad():
        out = model.model_def(x, snd, rcv, ew, *(types if model._typed else ()))
    np.testing.assert_allclose(out[:, sub.query, 0].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_is_correct(tiny_bench, cell):
    result, checks = run.run_cell(tiny_bench, cell, 2**31 + 7, 0.5, False, "cpu")
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
