"""Shared machinery of ``tests/test_torch_parallel*.py``: the seeded
inputs (JAX draws the parameters and the masks, as ``tests/test_parallel.py``
does), the JAX package's results on its 8 virtual devices (computed once, on
first use), and the rank side: every case a spawned rank runs, with no JAX.

This module imports JAX only inside the parent-side helpers, so the spawned
ranks, which import it to find the case functions, import no JAX.
"""

from __future__ import annotations

import json
import os
import traceback
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bikg_graph_explainability_public_tpu_torch import parallel as tpar
from bikg_graph_explainability_public_tpu_torch.explain.batch import explain_many
from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
from bikg_graph_explainability_public_tpu_torch.graph import from_arrays, hetero_to_homo
from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import (
    load_params,
    params_from_numpy,
)
from bikg_graph_explainability_public_tpu_torch.models.gnn import (
    GCNNodeModel,
    hetero_gat_for_relations,
    hetero_gcn_for_relations,
    sage_node_model,
)
from bikg_graph_explainability_public_tpu_torch.parallel import mesh as tmesh

from fixtures import make_communities, make_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
WORLDS = [2, 4]
#: test_parallel.py's tolerances, and test_torch_batch_explain.py's for
#: explain_many against JAX
FN_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-7)
FRAME_TOL = dict(rtol=1e-3, atol=1e-5)
HETERO_TOL = dict(rtol=1e-4, atol=1e-5)
MANY_TOL = dict(rtol=1e-4, atol=1e-6)
QUERIES = [10, 3, 25]  # Q = 3: padded to 4 on 2 and on 4 ranks
CFG_ONE = {"seed": 3, "interpret_samples": 10, "epochs": 10, "lr": 0.01, "l1_lambda": 1e-4}
CFG_TWO = {"seed": 3, "interpret_samples": 8, "epochs": 8, "lr": 0.01, "l1_lambda": 1e-4}
HETERO_RELS = [("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a")]
HETERO_CASES = {"node": ("node_prediction", 7), "edge": ("edge_prediction", 3),
                "graph": ("graph_prediction", None)}
MANY_CASES = {"shapley": (False, True), "shapley_one_stack": (False, False),
              "community": (True, True)}


def config():
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# parent side: the seeded inputs (JAX draws the parameters and the masks, as
# test_parallel.py does) and the JAX results
# ---------------------------------------------------------------------------


def _jax():
    import jax

    import bikg_graph_explainability_public_tpu as jpx

    return jax, jpx


def _init(mdef, seed):
    """JAX's initial parameters, with the conv layers' biases (0 there)
    drawn from U(-0.1, 0.1), so that a bias added off its place shows."""
    jax, _ = _jax()
    tree = jax.tree_util.tree_map(np.array, mdef.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1000)

    def draw(node):
        if "bias" in node:
            node["bias"] = rng.uniform(-0.1, 0.1, node["bias"].shape).astype(np.float32)
        for v in node.values():
            if isinstance(v, dict):
                draw(v)

    for layer in tree["conv"]:
        draw(layer)
    return tree


def build_inputs() -> dict:
    jax, jpx = _jax()
    from bikg_graph_explainability_public_tpu.explain.masks import MaskSampler

    inp = {}
    feat, ei, _ = make_graph(n=24, f=16, e=60, seed=40)
    n_pad = jpx.from_arrays(feat, ei).n_pad

    def sample(k):
        sampler = MaskSampler(24, n_pad, {"interpret_samples": 8, "epochs": 8}, None)
        return np.asarray(sampler.sample(jax.random.PRNGKey(k))[0])

    def w0(k):
        return np.asarray(jpx.init_surrogate_weights(jax.random.PRNGKey(k), n_pad, 24))

    inp["dp"] = dict(
        feat=feat, ei=ei, conv=(8,), params=_init(jpx.GCNNodeModel(16, (8,), (8, 8)), 0),
        masks1=sample(1), masks2=sample(2), masks7=sample(7), w3=w0(3), w8=w0(8),
    )
    rng = np.random.default_rng(0)
    inp["pgs"] = dict(
        feats=rng.normal(size=(40, 6)).astype(np.float32),
        snd=rng.integers(0, 40, 64).astype(np.int64), rcv=rng.integers(0, 40, 64).astype(np.int64),
        ew=rng.random(64).astype(np.float32),
    )
    for key, seed, pseed, n, e, conv in (
        ("pgcn", 41, 4, 24, 64, (8, 8)), ("halo_fwd", 42, 5, 40, 120, (8, 8)),
        ("halo_query", 43, 6, 40, 120, (8, 8)), ("halo_edge", 60, 60, 40, 120, (8, 8)),
        ("halo_graph", 61, 61, 40, 120, (8, 8)), ("sm_node", 50, 7, 40, 120, (8,)),
        ("sm_edge_graph", 62, 8, 40, 120, (8,)),
    ):
        feat, ei, _ = make_graph(n=n, f=16, e=e, seed=seed)
        inp[key] = dict(feat=feat, ei=ei, e=e, conv=conv,
                        params=_init(jpx.GCNNodeModel(16, conv, (8, 8)), pseed))
    n_pad, e_pad = 40, 120
    inp["halo_query"]["masks"] = np.random.default_rng(3).random((6, n_pad)) > 0.3
    inp["halo_edge"]["masks"] = np.random.default_rng(4).random((6, e_pad)) > 0.3
    inp["halo_graph"]["masks"] = np.random.default_rng(5).random((6, n_pad)) > 0.3
    for key, n, e, f, seed, fseed in (("halo_gs", 48, 128, 6, 7, 1), ("halo_gs_native", 56, 200, 5,
                                                                      11, 11)):
        rng = np.random.default_rng(seed)
        snd, rcv = rng.integers(0, n, e).astype(np.int64), rng.integers(0, n, e).astype(np.int64)
        if key == "halo_gs":
            rng = np.random.default_rng(fseed)
        inp[key] = dict(n=n, snd=snd, rcv=rcv, feats=rng.normal(size=(n, f)).astype(np.float32),
                        ew=rng.random(e).astype(np.float32))
    for case, (problem, query) in HETERO_CASES.items():
        feat, ei, rng = _hetero_graph(70)
        g, _ = jpx.hetero_to_homo(feat, ei)
        width = g.e_pad if "edge" in problem else g.n_pad
        mdef = jpx.hetero_gcn_for_relations(["a", "b"], HETERO_RELS, 8, conv_channels=(6, 6),
                                            fc_channels=(6, 6))
        inp[f"hetero_{case}"] = dict(feat=feat, ei=ei, params=_init(mdef, 70),
                                     masks=rng.random((6, width)) > 0.3)
    return inp


def _hetero_graph(seed):
    """test_parallel.py's TestHaloHetero graph, and its generator after it."""
    rng = np.random.default_rng(seed)
    feat = {t: rng.normal(size=(20, 8)).astype(np.float32) for t in ("a", "b")}
    ei = {r: np.stack([rng.integers(0, 20, 30), rng.integers(0, 20, 30)]) for r in HETERO_RELS}
    return feat, ei, rng


class JaxRefs:
    """The JAX package's results on its 8-device mesh, computed once."""

    def __init__(self, inp):
        self.inp, self._cache = inp, {}

    def __call__(self, name):
        if name not in self._cache:
            self._cache[name] = getattr(self, "_" + name)()
        return self._cache[name]

    def _parts(self):
        jax, jpx = _jax()
        from bikg_graph_explainability_public_tpu.parallel import halo, mesh, sharding

        return jax, jpx, halo, mesh.make_mesh(8), sharding

    def _model(self, key):
        _, jpx = _jax()
        d = self.inp[key]
        mdef = jpx.GCNNodeModel(16, conv_channels=d["conv"], fc_channels=(8, 8))
        graph = jpx.from_arrays(d["feat"], d["ei"], edge_budget=d.get("e"))
        return mdef, d["params"], graph

    def _sharded_outputs(self):
        _, jpx, _, m8, sh = self._parts()
        mdef, params, g = self._model("dp")
        return np.asarray(sh.sharded_query_outputs(
            jpx.Model(mdef, params), g, self.inp["dp"]["masks1"], "node_prediction", 3, m8))

    def _step(self, masks, w0, placed):
        jax, jpx, *_ = self._parts()
        import jax.numpy as jnp
        from bikg_graph_explainability_public_tpu.parallel.sharding import explain_training_step

        mdef, params, g = self._model("dp")
        step = explain_training_step(jpx.Model(mdef, params), g, "node_prediction", 3, 24)
        z = jnp.zeros_like(w0)
        w, _, _, _, loss = jax.jit(step)(jnp.asarray(w0), z, z, jnp.float32(0), placed(masks))
        return np.asarray(w), float(loss)

    def _training_step(self):
        jax, _, _, m8, sh = self._parts()
        d = self.inp["dp"]
        return self._step(d["masks2"], d["w3"], lambda m: sh.shard_batch(jax.numpy.asarray(m), m8))

    def _multihost_step(self):
        jax, *_ = self._parts()
        from bikg_graph_explainability_public_tpu.parallel.mesh import (
            hierarchical_batch_sharding, make_multihost_mesh)

        d, mh = self.inp["dp"], make_multihost_mesh(hosts=2)
        return self._step(d["masks7"], d["w8"],
                          lambda m: jax.device_put(m, hierarchical_batch_sharding(mh)))

    def _pgs(self):
        import jax.numpy as jnp
        from bikg_graph_explainability_public_tpu.parallel.edge_partition import (
            partitioned_gather_sum)

        *_, m8, _ = self._parts()
        d = self.inp["pgs"]
        return np.asarray(partitioned_gather_sum(
            jnp.asarray(d["ew"]), jnp.asarray(d["feats"]), jnp.asarray(d["snd"].astype(np.int32)),
            jnp.asarray(d["rcv"].astype(np.int32)), m8))

    def _pgcn(self):
        from bikg_graph_explainability_public_tpu.parallel.edge_partition import (
            partitioned_gcn_forward)

        *_, m8, _ = self._parts()
        mdef, params, g = self._model("pgcn")
        return np.asarray(partitioned_gcn_forward(
            mdef, params, g.x, g.senders, g.receivers, g.edge_mask.astype(np.float32), m8))

    def _tp(self):
        _, jpx, _, _, sh = self._parts()
        from bikg_graph_explainability_public_tpu.parallel.mesh import make_mesh

        mdef, params, g = self._model("dp")
        tp = sh.shard_params_model_axis(params, make_mesh(8, ("data", "model"), (4, 2)))
        return np.asarray(jpx.Model(mdef, tp).infer(g))

    def _gather_sum(self, key, native_plan):
        import jax.numpy as jnp
        from bikg_graph_explainability_public_tpu.runtime import native

        _, _, halo, m8, _ = self._parts()
        d = self.inp[key]
        orig = native.build_halo_plan
        if not native_plan:
            native.build_halo_plan = lambda *a, **k: None
        try:
            part = halo.build_halo_partition(d["snd"], d["rcv"], d["n"], 8)
        finally:
            native.build_halo_plan = orig
        got = halo.halo_gather_sum(jnp.asarray(d["ew"]), halo.pad_nodes(d["feats"], part), part, m8)
        return np.asarray(got)[: d["n"]]

    def _halo_gs(self):
        return self._gather_sum("halo_gs", native_plan=True)

    def _halo_gs_native(self):
        return [self._gather_sum("halo_gs_native", p) for p in (True, False)]

    def _halo_outputs(self, key, problem, query):
        _, _, halo, m8, _ = self._parts()
        import jax.numpy as jnp

        mdef, params, g = self._model(key)
        snd, rcv = np.asarray(g.senders)[: g.num_edges], np.asarray(g.receivers)[: g.num_edges]
        part = halo.build_halo_partition(snd, rcv, 40, 8)
        x = halo.pad_nodes(np.asarray(g.x), part)
        if key == "halo_fwd":
            ew = jnp.ones((g.num_edges,), jnp.float32)
            return np.asarray(halo.halo_gcn_forward(mdef, params, x, ew, part, m8))[:40]
        masks = jnp.asarray(self.inp[key]["masks"])
        if "edge" not in problem:
            masks = jnp.zeros((6, part.n_total), bool).at[:, : g.n_pad].set(masks)
        return np.asarray(halo.halo_masked_outputs(
            mdef, params, x, masks, part, m8, problem=problem, query=query,
            num_nodes=g.num_nodes))

    def _halo_fwd(self):
        return self._halo_outputs("halo_fwd", None, None)

    def _halo_query(self):
        return self._halo_outputs("halo_query", "node_prediction", 11)

    def _halo_edge(self):
        return self._halo_outputs("halo_edge", "edge_prediction", 9)

    def _halo_graph(self):
        return self._halo_outputs("halo_graph", "graph_prediction", None)

    def _explainer(self, key, problem, names, element, cfg):
        _, jpx, *_ = self._parts()
        from bikg_graph_explainability_public_tpu.parallel import ShardedModel
        from bikg_graph_explainability_public_tpu.parallel.mesh import make_mesh

        mdef, params, _ = self._model(key)
        d = self.inp[key]
        cv, _ = jpx.Explainer(d["feat"], d["ei"], ShardedModel(mdef, params, make_mesh(8)), cfg,
                              names, problem=problem).run(element, times=1)
        return cv

    def _sm_node(self):
        return self._explainer("sm_node", "node_prediction", [str(i) for i in range(40)], "7",
                               CFG_ONE)

    def _sm_edge(self):
        return self._explainer("sm_edge_graph", "edge_prediction", [str(i) for i in range(120)],
                               "3", CFG_TWO)

    def _sm_graph(self):
        return self._explainer("sm_edge_graph", "graph_prediction", [str(i) for i in range(40)],
                               None, CFG_TWO)

    def _hetero(self, case):
        _, jpx, _, m8, _ = self._parts()
        from bikg_graph_explainability_public_tpu.parallel import ShardedModel

        d = self.inp[f"hetero_{case}"]
        problem, query = HETERO_CASES[case]
        g, _ = jpx.hetero_to_homo(d["feat"], d["ei"])
        mdef = jpx.hetero_gcn_for_relations(["a", "b"], HETERO_RELS, 8, conv_channels=(6, 6),
                                            fc_channels=(6, 6))
        return np.asarray(ShardedModel(mdef, d["params"], m8).perturbed_query_outputs(
            g, d["masks"], problem, query))

    def _hetero_node(self):
        return self._hetero("node")

    def _hetero_edge(self):
        return self._hetero("edge")

    def _hetero_graph(self):
        return self._hetero("graph")

    def _many(self, case):
        _, jpx, _, m8, _ = self._parts()
        from bikg_graph_explainability_public_tpu.models.checkpoint import load_params as jload

        community, buckets = MANY_CASES[case]
        toy = np.load(TOY)
        kw = many_kwargs(toy, community, buckets)
        return jpx.explain_many(jpx.Model(jpx.GCNNodeModel(84), jload(CKPT)),
                                jpx.from_arrays(toy["feat"], toy["edge_index"]), QUERIES,
                                config(), mesh=m8, **kw)

    def _many_shapley(self):
        return self._many("shapley")

    def _many_shapley_one_stack(self):
        return self._many("shapley_one_stack")

    def _many_community(self):
        return self._many("community")


def many_kwargs(toy, community: bool, buckets: bool) -> dict:
    names = [str(x) for x in toy["names"]]
    kw = dict(names=names, size_buckets=buckets)
    if community:
        kw["pathways"], kw["pathway_names"] = make_communities(len(names))
    return kw


# ---------------------------------------------------------------------------
# rank side: every case of one world size, run by every rank of one spawn
# (no JAX here)
# ---------------------------------------------------------------------------


def _gcn(d) -> Model:
    mdef = GCNNodeModel(16, conv_channels=d["conv"], fc_channels=(8, 8))
    return Model(mdef, params_from_numpy(d["params"]), device="cpu")


def _graph(d):
    return from_arrays(d["feat"], d["ei"], edge_budget=d.get("e"), device="cpu")


def _same_on_every_rank(obj) -> bool:
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return all(o == objs[0] for o in objs)


def _refusal(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _r_sharded_outputs(inp, mesh, world):
    d = inp["dp"]
    model, g = _gcn(d), _graph(d)
    got = tpar.sharded_query_outputs(model, g, d["masks1"], "node_prediction", 3, mesh)
    refused = _refusal(lambda: tpar.sharded_query_outputs(
        model, g, d["masks1"][: 3 * world + 1], "node_prediction", 3, mesh), ValueError)
    return dict(got=got.numpy(), same=_same_on_every_rank(got.numpy().tobytes()), refused=refused)


def _step(d, mesh, masks, w0, axes):
    model, g = _gcn(d), _graph(d)
    step = tpar.explain_training_step(model, g, "node_prediction", 3, 24, mesh=mesh, axes=axes)
    w0 = torch.from_numpy(w0)
    z = torch.zeros_like(w0)
    w, m, v, t, loss = step(w0, z, z, torch.tensor(0.0), tpar.shard_batch(masks, mesh, axes))
    return dict(w=w.numpy(), loss=float(loss), t=float(t),
                same=_same_on_every_rank((w.numpy().tobytes(), float(loss))))


def _r_training_step(inp, mesh, world):
    d = inp["dp"]
    return _step(d, mesh, d["masks2"], d["w3"], ("data",))


def _r_multihost_step(inp, mesh, world):
    d = inp["dp"]
    mh = tmesh.make_multihost_mesh(hosts=2, device="cpu")
    return _step(d, mh, d["masks7"], d["w8"], ("host", "data"))


def _r_multihost_shapes(inp, mesh, world):
    m = tmesh.make_multihost_mesh(hosts=2, device="cpu")
    m3 = tmesh.make_multihost_mesh(("host", "data", "model"), hosts=2,
                                   inner_shape=(1, world // 2), device="cpu")
    return dict(
        names=m.mesh_dim_names, shape=tuple(m.shape), names3=m3.mesh_dim_names,
        shape3=tuple(m3.shape), refused=_refusal(
            lambda: tmesh.make_multihost_mesh(hosts=3, device="cpu"), ValueError),
        placements=[repr(p) for p in (tmesh.batch_sharding(m), tmesh.hierarchical_batch_sharding(m),
                                      tmesh.replicated(m))],
    )


def _r_pgs(inp, mesh, world):
    d = {k: torch.from_numpy(v) for k, v in inp["pgs"].items()}
    got = tpar.partitioned_gather_sum(d["ew"], d["feats"], d["snd"], d["rcv"], mesh)
    refused = _refusal(lambda: tpar.partition_edges((d["ew"][:63],), mesh), ValueError)
    return dict(got=got.numpy(), refused=refused)


def _r_pgcn(inp, mesh, world):
    d = inp["pgcn"]
    model, g = _gcn(d), _graph(d)
    got = tpar.partitioned_gcn_forward(
        model, g.x, g.senders, g.receivers, g.edge_mask.to(torch.float32), mesh)
    return dict(got=got.numpy())


def _r_tp(inp, mesh, world):
    d = inp["dp"]
    tp_mesh = tpar.make_mesh(world, ("data", "model"), (world // 2, 2), device="cpu")
    model, g = _gcn(d), _graph(d)
    tpar.shard_params_model_axis(model, tp_mesh)
    blocks = {k: tuple(v.shape) for k, v in model.model_def.state_dict().items()}
    got = model.infer(g)
    fast = _refusal(lambda: model.perturbed_query_outputs(g, d["masks1"][:4], "node_prediction", 3),
                    ValueError)
    many = _refusal(lambda: explain_many(model, g, [3], CFG_TWO), ValueError)
    sage = Model(sage_node_model(16, conv_channels=(8,), fc_channels=(8, 8),
                                 generator=torch.Generator().manual_seed(5)), device="cpu")
    sage_want = sage.infer(g)
    tpar.shard_params_model_axis(sage, tp_mesh)
    sage_got = sage.infer(g)
    return dict(got=got.numpy(), blocks=blocks, fast=fast, many=many,
                sage=(sage_got.numpy(), sage_want.numpy()))


def _r_halo_gs(inp, mesh, world, key="halo_gs"):
    d = inp[key]
    part = tpar.build_halo_partition(d["snd"], d["rcv"], d["n"], world)
    me, nl = mesh.get_local_rank("data"), part.n_local
    x = tpar.pad_nodes(d["feats"], part)[me * nl : (me + 1) * nl]
    local = tpar.halo_gather_sum(torch.from_numpy(d["ew"]), x, part, mesh)
    return dict(got=tpar.gather_nodes(local, mesh)[: d["n"]].numpy(), local_rows=local.shape[0],
                n_local=nl)


def _r_halo_gs_native(inp, mesh, world):
    return _r_halo_gs(inp, mesh, world, "halo_gs_native")


def _halo_setup(d, mesh, world):
    model, g = _gcn(d), _graph(d)
    part = tpar.build_halo_partition(g.host.senders[: g.num_edges],
                                     g.host.receivers[: g.num_edges], 40, world)
    me, nl = mesh.get_local_rank("data"), part.n_local
    rows = slice(me * nl, (me + 1) * nl)
    return model, g, part, tpar.pad_nodes(g.x, part)[rows], rows


def _r_halo_fwd(inp, mesh, world):
    model, g, part, x, _ = _halo_setup(inp["halo_fwd"], mesh, world)
    out = tpar.halo_gcn_forward(model, x, torch.ones(g.num_edges), part, mesh)
    return dict(got=tpar.gather_nodes(out, mesh)[:40].numpy())


def _halo_masked(inp, mesh, world, key, problem, query):
    d = inp[key]
    model, g, part, x, rows = _halo_setup(d, mesh, world)
    masks = torch.from_numpy(d["masks"])
    if "edge" not in problem:
        masks = tpar.pad_nodes(masks.T, part).T[:, rows]
    if problem == "node_prediction":
        got = tpar.halo_masked_query_outputs(model, x, masks, part, mesh, query)
    else:
        got = tpar.halo_masked_outputs(model, x, masks, part, mesh, problem=problem, query=query,
                                       num_nodes=g.num_nodes)
    return dict(got=got.numpy(), same=_same_on_every_rank(got.numpy().tobytes()))


def _r_halo_query(inp, mesh, world):
    return _halo_masked(inp, mesh, world, "halo_query", "node_prediction", 11)


def _r_halo_edge(inp, mesh, world):
    return _halo_masked(inp, mesh, world, "halo_edge", "edge_prediction", 9)


def _r_halo_graph(inp, mesh, world):
    return _halo_masked(inp, mesh, world, "halo_graph", "graph_prediction", None)


def _sharded_frames(d, mesh, problem, names, element, cfg):
    mdef = GCNNodeModel(16, conv_channels=d["conv"], fc_channels=(8, 8))
    model = tpar.ShardedModel(mdef, params_from_numpy(d["params"]), mesh)
    cv, _ = Explainer(d["feat"], d["ei"], model, cfg, names, problem=problem,
                      device="cpu").run(element, times=1)
    return dict(got=cv, same=_same_on_every_rank(cv.to_json()))


def _r_sm_node(inp, mesh, world):
    return _sharded_frames(inp["sm_node"], mesh, "node_prediction", [str(i) for i in range(40)],
                           "7", CFG_ONE)


def _r_sm_edge(inp, mesh, world):
    return _sharded_frames(inp["sm_edge_graph"], mesh, "edge_prediction",
                           [str(i) for i in range(120)], "3", CFG_TWO)


def _r_sm_graph(inp, mesh, world):
    return _sharded_frames(inp["sm_edge_graph"], mesh, "graph_prediction",
                           [str(i) for i in range(40)], None, CFG_TWO)


def _r_sm_refuse(inp, mesh, world):
    feat, ei, _ = make_graph(n=16, f=8, e=40, seed=63)
    g = from_arrays(feat, ei, device="cpu")
    mdef = hetero_gat_for_relations(["a"], [("a", "r", "a")], 8, conv_channels=(4,),
                                    fc_channels=(4, 4), generator=torch.Generator().manual_seed(9))
    masks = torch.ones((4, g.n_pad), dtype=torch.bool)
    sharded = tpar.ShardedModel(mdef, None, mesh)
    refused = _refusal(lambda: sharded.perturbed_query_outputs(g, masks, "node_prediction", 0),
                       NotImplementedError)
    opted = tpar.ShardedModel(mdef, None, mesh, allow_replicated_fallback=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = opted.perturbed_query_outputs(g, masks, "node_prediction", 0)
    want = Model(mdef, device="cpu").perturbed_query_outputs(g, masks, "node_prediction", 0)
    return dict(refused=refused, warned=[str(w.message) for w in caught],
                fallback=(got.numpy(), want.numpy()))


def _hetero_case(inp, mesh, world, case):
    d = inp[f"hetero_{case}"]
    problem, query = HETERO_CASES[case]
    g, _ = hetero_to_homo(d["feat"], d["ei"], device="cpu")
    mdef = hetero_gcn_for_relations(["a", "b"], HETERO_RELS, 8, conv_channels=(6, 6),
                                    fc_channels=(6, 6))
    model = tpar.ShardedModel(mdef, params_from_numpy(d["params"]), mesh)
    got = model.perturbed_query_outputs(g, d["masks"], problem, query, chunk_size=4)
    return dict(got=got.numpy())


def _r_hetero_node(inp, mesh, world):
    return _hetero_case(inp, mesh, world, "node")


def _r_hetero_edge(inp, mesh, world):
    return _hetero_case(inp, mesh, world, "edge")


def _r_hetero_graph(inp, mesh, world):
    return _hetero_case(inp, mesh, world, "graph")


def _many_case(inp, mesh, world, case):
    community, buckets = MANY_CASES[case]
    toy = np.load(TOY)
    tg = from_arrays(toy["feat"], toy["edge_index"], device="cpu")
    tm = Model(GCNNodeModel(84), load_params(CKPT), device="cpu")
    kw = many_kwargs(toy, community, buckets)
    got = explain_many(tm, tg, QUERIES, config(), mesh=mesh, **kw)
    again = explain_many(tm, tg, QUERIES, config(), mesh=mesh, **kw)  # the plan cache's hit
    want = explain_many(tm, tg, QUERIES, config(), **kw)
    frames = [f for out in got for f in (out if isinstance(out, tuple) else (out,))]
    return dict(got=got, again=again, want=want,
                same=_same_on_every_rank([f.to_json() for f in frames]))


def _r_many_shapley(inp, mesh, world):
    return _many_case(inp, mesh, world, "shapley")


def _r_many_shapley_one_stack(inp, mesh, world):
    return _many_case(inp, mesh, world, "shapley_one_stack")


def _r_many_community(inp, mesh, world):
    return _many_case(inp, mesh, world, "community")


def _r_group(inp, mesh, world):
    return dict(
        again=tmesh.initialize_distributed(device="cpu"), world=dist.get_world_size(),
        rank=dist.get_rank(), backend=dist.get_backend(), mesh_type=mesh.device_type,
        refused=_refusal(lambda: tpar.make_mesh(world + 1, device="cpu"), ValueError),
    )


RANK_CASES = {name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("_r_")}


def _rank_cases(inp, names):
    """The cases ``names`` on this rank (one rank of a spawned group); a
    case that raises records its traceback."""
    mesh = tpar.make_mesh(device="cpu")
    world = dist.get_world_size()
    out = {}
    for name in names:
        try:
            out[name] = RANK_CASES[name](inp, mesh, world)
        except Exception:  # recorded: the test of this case fails with it
            out[name] = {"error": traceback.format_exc()}
    return out


class RankResults:
    """``results(world, case)``: rank 0's result of ``case``; the cases of
    one world size run in one spawn (120 s deadline), on first use."""

    def __init__(self, inp, names):
        self.inp, self.names, self._cache = inp, tuple(names), {}

    def __call__(self, world: int, name: str) -> dict:
        if world not in self._cache:
            self._cache[world] = tpar.spawn(_rank_cases, world, self.inp, self.names,
                                            device="cpu", timeout=120)
        res = self._cache[world][name]
        if "error" in res:
            pytest.fail(f"rank 0 of {world} raised in {name}:\n{res['error']}")
        return res

