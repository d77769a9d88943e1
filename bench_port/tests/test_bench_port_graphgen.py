"""The generated gene graph has Hetionet's published counts, exactly, and
the subgraph classes are the counts a breadth-first search gives."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from bench_port import graphgen, strata

from conftest import CHECKOUT

with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
    CONFIGS = json.load(f)["configs"]


def _config(entry):
    with open(os.path.join(CHECKOUT, entry["file"])) as f:
        return json.load(f)


@pytest.mark.parametrize("entry", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_counts_are_hetionets(entry):
    cfg = _config(entry)
    gg = graphgen.generate(cfg["graph"])
    assert gg.n == 20945 and gg.x.shape == (20945, 84)
    want = {"interacts": 2 * 147164, "covaries": 2 * 61690, "regulates": 265672}
    assert {r: gg.edges[r].shape[1] for r in gg.relations} == want
    for r in gg.relations:
        e = gg.edges[r]
        assert (e[0] != e[1]).all()
        assert np.unique(e[0] * gg.n + e[1]).size == e.shape[1]
    assert len(gg.pathways) == 1822
    assert sum(p.size for p in gg.pathways) == 84372
    assert all(p.size >= 1 and np.unique(p).size == p.size for p in gg.pathways)


def test_undirected_relations_hold_both_directions():
    cfg = _config(CONFIGS[0])
    gg = graphgen.generate(dict(cfg["graph"], genes=500, relations=[
        {"name": "a", "edges": 900, "directed": False},
        {"name": "b", "edges": 700, "directed": True}],
        pathways={"count": 10, "memberships": 60, "size_mean": 6.0, "size_sigma": 1.0}))
    a = gg.edges["a"]
    fwd = set(zip(a[0].tolist(), a[1].tolist()))
    assert fwd == {(v, u) for u, v in fwd}
    assert gg.edges["b"].shape[1] == 700


def test_same_seed_same_graph():
    block = _config(CONFIGS[0])["graph"]
    small = dict(block, genes=400, relations=[dict(r, edges=300) for r in block["relations"]],
                 pathways={"count": 12, "memberships": 90, "size_mean": 7.5, "size_sigma": 1.0})
    g1, g2 = graphgen.generate(small), graphgen.generate(small)
    assert np.array_equal(g1.x, g2.x)
    assert all(np.array_equal(g1.edges[r], g2.edges[r]) for r in g1.relations)
    assert all(np.array_equal(a, b) for a, b in zip(g1.pathways, g2.pathways))


# a 6-node graph: 0 -> 1 -> 2 -> 3, 4 -> 2, 5 -> 4, 1 -> 0 (edges point at their receiver)
SIX = np.array([[0, 1, 2, 4, 5, 1], [1, 2, 3, 2, 4, 0]])


def test_khop_and_classes_on_six_nodes():
    ptr, col = graphgen.in_neighbour_csr(6, SIX)
    # genes reaching 3 within two hops: 3, 2 (one hop), 1 and 4 (two hops)
    assert graphgen.khop_nodes(ptr, col, 3, 2).tolist() == [1, 2, 3, 4]
    assert graphgen.khop_nodes(ptr, col, 0, 2).tolist() == [0, 1]
    nodes, edges = strata.subgraph_sizes(6, SIX, 2, "cpu")
    assert nodes.tolist() == [2, 2, 5, 4, 2, 1]
    # edges among each set: gene 3's {1,2,3,4}: 1->2, 2->3, 4->2
    assert edges.tolist() == [2, 2, 5, 3, 1, 0]
    assert strata.classes_of(nodes, edges)[3] == (8, 8)


def test_quota_and_schedule_keep_the_mix():
    classes = [(8, 8)] * 50 + [(16, 32)] * 30 + [(32, 64)] * 20
    mix = strata.quota(classes, 10)
    assert mix == {(8, 8): 5, (16, 32): 3, (32, 64): 2}
    sched = strata.Schedule(classes, mix, 7, 2**31 + 5)
    other = strata.Schedule(classes, mix, 7, 2**31 + 6)
    seen = []
    for _ in range(3):
        r, o = sched.next_round(), other.next_round()
        assert sorted(classes[g] for g in r) == sorted(c for c, k in mix.items() for _ in range(k))
        assert sorted(r) == sorted(o) and r != o  # the same genes, in another order
        seen += r
    assert len(set(seen)) == len(seen)
