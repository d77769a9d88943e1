"""PyTorch port: ``explain_many`` (the multi-query path) gives the JAX
package's frames for the same seed on the repo's 36-node fixture (same
index order, ties allowed, ``rtol=1e-4, atol=1e-6``), and its pieces (the
device mask draw, the folded keys, the stack, the KernelSHAP weights and the
surrogate fit, batched over queries) agree with their JAX counterparts."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.explain import batch as jbatch
from bikg_graph_explainability_public_tpu.models.checkpoint import load_params as jload_params
from bikg_graph_explainability_public_tpu.utils import prng as jprng
from bikg_graph_explainability_public_tpu_torch.explain import batch as tbatch
from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import load_params
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
from bikg_graph_explainability_public_tpu_torch.utils import prng as tprng
from bikg_graph_explainability_public_tpu_torch.utils.profiling import PhaseTimer

from fixtures import make_communities

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
#: the same float32 forwards in another order, then 50 Adam steps
TOL = dict(rtol=1e-4, atol=1e-6)
QUERIES = [10, 3, 25]  # three size buckets: (8, 16), (8, 8), (16, 16)


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    """Same columns, dtypes and values within TOL; the same index order,
    except that scores within TOL of each other may come in either order."""
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    assert got.index.name == want.index.name
    assert sorted(got.index) == sorted(want.index)
    np.testing.assert_allclose(got.loc[want.index].to_numpy(), want.to_numpy(), **TOL)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


def _assert_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _assert_frames(g[0], w[0])
            _assert_frames(g[1], w[1])
        else:
            _assert_frames(g, w)


@pytest.fixture(scope="module")
def toy():
    d = np.load(TOY)
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        cfg = json.load(f)
    feat, ei = d["feat"], d["edge_index"]
    return dict(
        feat=feat, ei=ei, names=[str(x) for x in d["names"]], cfg=cfg,
        jg=px.from_arrays(feat, ei), tg=from_arrays(feat, ei, device="cpu"),
        jm=px.Model(px.GCNNodeModel(84), jload_params(CKPT)),
        tm=Model(GCNNodeModel(84), load_params(CKPT), device="cpu"),
    )


# ---------------------------------------------------------------------------
# keys and the device draw
# ---------------------------------------------------------------------------


#: (seed, folded datum) of each stacked key; the last sets the high bit of
#: both words
KEYSETS = {
    "three": ((0, 0), (7, 3), (2**31 - 1, 2**32 - 1)),
    "five": ((1, 0), (1, 1), (5, 2**31), (123, 9), (2**31 - 1, 2**32 - 1)),
}


def _keys(keyset: str):
    """Raw uint32 key data ``[K, 2]``, and its words as the int64 stack a
    launch plan uploads."""
    kd = np.stack([
        np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(s), d)))
        for s, d in KEYSETS[keyset]
    ])
    assert kd.dtype == np.uint32 and (kd >= 2**31).any()
    return kd, torch.from_numpy(kd.astype(np.int64))


@pytest.mark.parametrize("keyset", sorted(KEYSETS))
#: M*N not a multiple of 8 in all but the full-budget shape
@pytest.mark.parametrize("m,n,p", [(40, 37, 0.5), (7, 13, 0.5), (1000, 33, 0.5), (9, 11, 0.3)])
def test_device_draw_matches_jax_bernoulli(keyset, m, n, p):
    kd, keys = _keys(keyset)
    got = tprng.bernoulli_tensor(keys, p, m, n)
    assert got.dtype == torch.bool and got.shape == (len(kd), m, n)
    for i in range(len(kd)):
        want = np.asarray(jax.random.bernoulli(jax.random.wrap_key_data(kd[i]), p, (m, n)))
        np.testing.assert_array_equal(got[i].numpy(), want)
        host = tprng.uniform(kd[i], m * n, 0.0, 1.0).reshape(m, n) < p
        np.testing.assert_array_equal(got[i].numpy(), host)


@pytest.mark.parametrize("data", [0, 1, 2**32 - 1])
def test_fold_in_and_uniform_tensor_match_the_host_forms(data):
    kd, keys = _keys("three")
    folded = tprng.fold_in_tensor(keys, data).numpy()
    for i in range(3):
        np.testing.assert_array_equal(folded[i], tprng.fold_in(kd[i], data))
    u = tprng.uniform_tensor(tprng.fold_in_tensor(keys, data), 37, -1.0, 1.0).numpy()
    for i in range(3):
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.wrap_key_data(kd[i]), data), (37,), jnp.float32,
            -1.0, 1.0))
        np.testing.assert_array_equal(u[i].view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize(
    "seed,times,pos", [(1, 1, (0, 1, 2)), (3, 3, (4, 0, 9)), (2**31 - 1, 2, (7,))]
)
def test_folded_keys_match_jax(seed, times, pos):
    got = tbatch._folded_keys_cached(seed, times, pos)
    want = jbatch._folded_keys_cached(seed, times, pos)
    assert got.dtype == np.uint32 and got.shape == (times, len(pos), 2)
    np.testing.assert_array_equal(got, want)
    assert not got.flags.writeable  # one memoised array serves every caller


# ---------------------------------------------------------------------------
# the stack, the masks, the kernel weights and the surrogate fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("problem", ["node_prediction", "edge_prediction", "graph_prediction"])
def test_stack_matches_jax(toy, problem):
    seeds = tbatch._seed_nodes(toy["tg"], QUERIES, problem)
    assert seeds == jbatch._seed_nodes(toy["jg"], QUERIES, problem)
    dense = problem == "node_prediction"
    full = problem == "graph_prediction"
    got = tbatch._Stack(toy["tg"], seeds, 2, need_edges=not dense, full_graph=full)
    want = jbatch._Stack(toy["jg"], seeds, 2, need_edges=not dense, typed=False, full_graph=full)
    assert (got.n_pad, got.e_pad, got.qn) == (want.n_pad, want.e_pad, want.qn)
    for name in ("xs", "snds", "rcvs", "evalid", "qidx", "nvalid", "evalid_count"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    if dense:
        np.testing.assert_array_equal(got.adjs, want.adjs)
    else:
        assert got.adjs is None
    for a, b in zip(got.parent_nodes + got.parent_edges, want.parent_nodes + want.parent_edges):
        np.testing.assert_array_equal(a, b)
    # an untyped stack keeps no type ids and no per-relation stacks
    assert got.ntype is None and got.etype is None
    assert got.adjs_r is None and got.scopes is None


@pytest.mark.parametrize("width", [37, 8, 1])
def test_packed_masks_unpack_on_the_device(width):
    rng = np.random.default_rng(width)
    masks = rng.random((3, 10, width)) < 0.5
    packed = torch.from_numpy(np.packbits(masks, axis=-1))
    if -(-width // 8) != width:
        np.testing.assert_array_equal(tbatch._masks_in(packed, width).numpy(), masks)
    # genuine 0/1 uint8 rows are cast, not read as packed bytes
    raw = torch.from_numpy(masks.astype(np.uint8))
    np.testing.assert_array_equal(tbatch._masks_in(raw, width).numpy(), masks)
    np.testing.assert_array_equal(tbatch._masks_in(torch.from_numpy(masks), width).numpy(), masks)


def _surrogate_inputs():
    """Three queries of different element counts and real batch sizes, laid
    out as community stacks are: [epochs, bs] with all-False pad rows."""
    rng = np.random.default_rng(11)
    epochs, bs, width = 6, 8, 16
    n_el = np.array([16, 11, 5], np.int64)
    bs_real = np.array([8, 6, 3], np.int64)
    masks = np.zeros((3, epochs, bs, width), bool)
    for q in range(3):
        masks[q, :, : bs_real[q], : n_el[q]] = rng.random((epochs, bs_real[q], n_el[q])) < 0.5
    masks = masks.reshape(3, epochs * bs, width)
    outputs = rng.normal(size=(3, epochs * bs)).astype(np.float32)
    keys = np.stack([jprng.repeat_split_key_data(s, 1)[0, 1] for s in (1, 2, 3)])
    col_valid = np.arange(width)[None, :] < n_el[:, None]
    return masks, outputs, keys, n_el, bs_real, col_valid, epochs


def test_kernel_weights_match_jax_over_queries():
    masks, _, _, n_el, _, _, _ = _surrogate_inputs()
    n_el_j = jnp.asarray(n_el, jnp.int32)
    want = np.asarray(jax.vmap(jbatch._kernel_weights)(jnp.asarray(masks), n_el_j))
    got = tbatch._kernel_weights(torch.from_numpy(masks), torch.from_numpy(n_el)).numpy()
    assert (got[~masks.any(-1)] == 0).all()  # pad rows weigh nothing
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("lr,l1,wd", [(0.01, 1e-4, 1e-2), (0.05, 1e-2, 0.0)])
def test_train_matches_jax_over_queries(lr, l1, wd):
    masks, outputs, keys, n_el, bs_real, col_valid, epochs = _surrogate_inputs()
    n_el_j = jnp.asarray(n_el, jnp.int32)
    kern = np.array(jax.vmap(jbatch._kernel_weights)(jnp.asarray(masks), n_el_j))

    def one(m, y, k, key, ne, cv, bsr):
        return jbatch._train(m, y, k, key, ne, cv, epochs, bsr, lr, l1, wd)

    want = np.asarray(jax.vmap(one)(
        jnp.asarray(masks), jnp.asarray(outputs), jnp.asarray(kern), jnp.asarray(keys),
        n_el_j, jnp.asarray(col_valid), jnp.asarray(bs_real, jnp.int32),
    ))
    got = tbatch._train(
        torch.from_numpy(masks), torch.from_numpy(outputs), torch.from_numpy(kern),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(n_el),
        torch.from_numpy(col_valid),
        epochs, torch.from_numpy(bs_real), lr, l1, wd,
    ).numpy()
    assert (got[~col_valid] == 0).all()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# explain_many end to end against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("times,size_buckets", [(1, True), (3, True), (1, False), (3, False)])
def test_shapley_mode_matches_jax(toy, times, size_buckets):
    kw = dict(names=toy["names"], times=times, size_buckets=size_buckets)
    want = jbatch.explain_many(toy["jm"], toy["jg"], QUERIES, toy["cfg"], **kw)
    got = tbatch.explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], **kw)
    _assert_results(got, want)
    if times > 1:
        assert all((df["config_value_std"] > 0).any() for df in got)


def _overlapping_communities(n: int):
    """40 communities of 3 random elements each, overlapping: the queries'
    subgraphs meet different numbers of them, so their community batches
    differ in size."""
    rng = np.random.default_rng(40)
    pathways = [[str(int(v)) for v in rng.choice(n, 3, replace=False)] for _ in range(40)]
    return pathways, [f"c{i}" for i in range(40)]


@pytest.mark.parametrize("communities", ["disjoint", "overlapping"])
@pytest.mark.parametrize("times", [1, 2])
def test_community_mode_matches_jax(toy, times, communities):
    """Overlapping communities give the queries of one size bucket
    (six in (16, 32)) batches of different sizes, padded in the stack."""
    if communities == "disjoint":
        (pathways, pathway_names), queries = make_communities(len(toy["names"])), QUERIES
    else:
        pathways, pathway_names = _overlapping_communities(len(toy["names"]))
        queries = [15, 16, 17, 18, 20, 23, 3]
    kw = dict(names=toy["names"], times=times, pathways=pathways, pathway_names=pathway_names)
    want = jbatch.explain_many(toy["jm"], toy["jg"], queries, toy["cfg"], **kw)
    got = tbatch.explain_many(toy["tm"], toy["tg"], queries, toy["cfg"], **kw)
    _assert_results(got, want)


@pytest.mark.parametrize("problem,queries", [
    ("edge_prediction", QUERIES), ("graph_prediction", [0, 1]),
])
def test_edge_and_graph_problems_match_jax(toy, problem, queries):
    names = toy["names"]
    if problem == "edge_prediction":
        names = [str(i) for i in range(toy["ei"].shape[1])]
    kw = dict(names=names, problem=problem)
    want = jbatch.explain_many(toy["jm"], toy["jg"], queries, toy["cfg"], **kw)
    got = tbatch.explain_many(toy["tm"], toy["tg"], queries, toy["cfg"], **kw)
    _assert_results(got, want)
    if problem == "graph_prediction":
        assert len(got[0]) == 36


def test_array_form_is_what_the_frames_show(toy):
    pathways, pathway_names = make_communities(len(toy["names"]))
    kw = dict(names=toy["names"], times=2, pathways=pathways, pathway_names=pathway_names)
    exs = tbatch._explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], **kw)
    frames = tbatch.explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], **kw)
    for ex, (cv, pw) in zip(exs, frames):
        order = np.argsort(-ex.mean, kind="stable")
        assert [ex.names[i] for i in order] == list(cv.index)
        np.testing.assert_array_equal(ex.mean[order], cv["config_value_mean"].to_numpy())
        np.testing.assert_array_equal(ex.std[order], cv["config_value_std"].to_numpy())
        assert list(ex.pathway_names) == list(pw.index)
        np.testing.assert_array_equal(ex.pathway_scores, pw["score"].to_numpy())


# ---------------------------------------------------------------------------
# caches, determinism, refusals
# ---------------------------------------------------------------------------


def test_deterministic_and_plan_cache_hit(toy):
    kw = dict(names=toy["names"], times=2)
    first = tbatch._explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], **kw)
    timer = PhaseTimer()
    plans = list(tbatch._PLAN_CACHE.values())
    again = tbatch._explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], timer=timer, **kw)
    assert "plan_build" not in timer.counts  # every bucket's plan was a hit
    assert list(tbatch._PLAN_CACHE.values()) == plans
    assert timer.counts["forwards"] == 3 * 2  # 3 buckets x 2 repeats
    for a, b in zip(first, again):
        assert a.names == b.names
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)
    # a fresh graph object misses the cache and still gives the same arrays
    g2 = from_arrays(toy["feat"], toy["ei"], device="cpu")
    timer = PhaseTimer()
    fresh = tbatch._explain_many(toy["tm"], g2, QUERIES, toy["cfg"], timer=timer, **kw)
    assert timer.counts["plan_build"] == 3
    for a, b in zip(first, fresh):
        np.testing.assert_array_equal(a.mean, b.mean)


def test_in_place_mutation_of_cached_pathways_is_recomputed(toy):
    pathways, pathway_names = make_communities(len(toy["names"]))
    kw = dict(names=toy["names"], pathway_names=pathway_names)
    before = tbatch.explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], pathways=pathways, **kw)
    # move an element of query 10's subgraph to another community
    moved = before[0][0].index[0]
    src = next(i for i, p in enumerate(pathways) if moved in p)
    pathways[src].remove(moved)
    pathways[(src + 1) % len(pathways)].append(moved)
    after = tbatch.explain_many(toy["tm"], toy["tg"], QUERIES, toy["cfg"], pathways=pathways, **kw)
    fresh_list = [list(p) for p in pathways]
    fresh = tbatch.explain_many(
        toy["tm"], toy["tg"], QUERIES, toy["cfg"], pathways=fresh_list, **kw
    )
    for (a_cv, a_pw), (f_cv, f_pw) in zip(after, fresh):
        pd.testing.assert_frame_equal(a_cv, f_cv)
        pd.testing.assert_frame_equal(a_pw, f_pw)
    assert not after[0][1].equals(before[0][1])


def test_mesh_and_hetero_models_are_not_ported(toy):
    """``mesh=`` takes a ``torch.distributed`` DeviceMesh and refuses
    anything else with ``TypeError`` before any work (a mesh runs in
    ``tests/test_torch_parallel.py``).  Hetero models are served
    (``tests/test_torch_hetero_batch_explain.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tbatch.explain_many(toy["tm"], toy["tg"], [10], toy["cfg"], mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tbatch._explain_many(toy["tm"], toy["tg"], [10, 3], toy["cfg"], mesh=object())
