"""PyTorch port: ``parallel/`` on ``torch.distributed`` against the JAX
package's ``parallel/`` on the same seeded numpy inputs: the mesh and the
group, data and tensor sharding, edge partitioning, the halo plan and the
homogeneous halo forwards, ``explain_many(mesh=)``, the CLI's
``--mesh-devices``, ``spawn``'s deadline and the signatures.  The hetero
halo and ``ShardedModel`` are in ``test_torch_parallel_halo.py``; together
they port every test of ``tests/test_parallel.py`` and the halo-plan test of
``tests/test_runtime.py``.

The port runs SPMD at world sizes 2 and 4 on gloo (``device="cpu"``); each
world size's cases run in ONE ``parallel.spawn`` (a module-scoped fixture,
one thread a rank, a 120 s deadline that kills every rank), and the JAX side
runs on its 8 virtual CPU devices (``torch_parallel_cases.py``).
Tolerances are ``test_parallel.py``'s own.  ``explain_many(mesh=)`` is held
equal to the port's ``mesh=None`` frames (``assert_frame_equal``: the mesh
changes which rank runs a query's rows, not their arithmetic) and against
JAX's ``explain_many(mesh=make_mesh(8))`` at ``test_torch_batch_explain.py``'s
``rtol=1e-4, atol=1e-6``.
"""

from __future__ import annotations

import inspect
import os
import time

import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

from bikg_graph_explainability_public_tpu_torch import cli as tcli
from bikg_graph_explainability_public_tpu_torch import parallel as tpar
from bikg_graph_explainability_public_tpu_torch.models.checkpoint import (
    gcn_params_to_torch_state_dict,
    load_params,
)
from bikg_graph_explainability_public_tpu_torch.parallel import halo as thalo
from bikg_graph_explainability_public_tpu_torch.parallel import mesh as tmesh
from bikg_graph_explainability_public_tpu_torch.parallel import sharding as tsharding
from bikg_graph_explainability_public_tpu_torch.runtime import native as tnative

from fixtures import make_graph
from torch_parallel_cases import (
    CKPT, FN_TOL, MANY_CASES, MANY_TOL, QUERIES, STEP_TOL, TOY, WORLDS, JaxRefs, RankResults,
    build_inputs,
)

CASES = (
    "sharded_outputs", "training_step", "pgs", "pgcn", "tp", "halo_gs", "halo_gs_native",
    "halo_fwd", "halo_query", "halo_edge", "halo_graph", "multihost_shapes", "multihost_step",
    "group", *(f"many_{c}" for c in MANY_CASES),
)


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


@pytest.fixture(scope="module")
def jref(inputs):
    return JaxRefs(inputs)


@pytest.fixture(scope="module")
def ranks(inputs):
    return RankResults(inputs, CASES)


# ---------------------------------------------------------------------------
# TestDataParallel, TestEdgePartition, TestTensorParallel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_outputs_match_single_device(ranks, jref, world):
    res = ranks(world, "sharded_outputs")
    np.testing.assert_allclose(res["got"], jref("sharded_outputs"), **FN_TOL)
    assert res["same"]
    assert "does not split" in res["refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_training_step_shard_invariant(ranks, jref, world):
    res = ranks(world, "training_step")
    w, loss = jref("training_step")
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(res["w"], w, **STEP_TOL)
    assert res["t"] == 1.0 and res["same"]


@pytest.mark.parametrize("world", WORLDS)
def test_partitioned_gather_sum_matches(ranks, jref, world):
    res = ranks(world, "pgs")
    np.testing.assert_allclose(res["got"], jref("pgs"), **FN_TOL)
    assert "pad with weight-0 edges" in res["refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_partitioned_gcn_forward_matches_single_chip(ranks, jref, world):
    np.testing.assert_allclose(ranks(world, "pgcn")["got"], jref("pgcn"), **FN_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_model_axis_sharded_forward_matches(ranks, jref, world):
    """(data, model) = (world / 2, 2): the row blocks and their gathered
    columns give JAX's tensor-parallel forward; the readers of whole
    weights refuse the model; a SAGE stack keeps its convs' Linears whole."""
    res = ranks(world, "tp")
    np.testing.assert_allclose(res["got"], jref("tp"), **FN_TOL)
    assert res["blocks"]["conv.0.weight"] == (4, 16) and res["blocks"]["conv.0.bias"] == (4,)
    assert res["blocks"]["fc.1.weight"] == (1, 8)  # 1 row does not split
    assert "FastBatchedGCN" in res["fast"] and "explain_many" in res["many"]
    np.testing.assert_allclose(*res["sage"], **FN_TOL)


# ---------------------------------------------------------------------------
# TestHaloPartition, the halo plan, TestHaloEdgeGraphProblems, TestHaloHetero
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_halo_gather_sum_matches(ranks, jref, world):
    res = ranks(world, "halo_gs")
    np.testing.assert_allclose(res["got"], jref("halo_gs"), **FN_TOL)
    assert res["local_rows"] == res["n_local"]  # a block per rank comes back


@pytest.mark.parametrize("world", WORLDS)
def test_halo_gcn_forward_matches_single_chip(ranks, jref, world):
    np.testing.assert_allclose(ranks(world, "halo_fwd")["got"], jref("halo_fwd"), **FN_TOL)


@pytest.mark.parametrize("world", WORLDS + [8])
def test_halo_volume_is_bounded_by_boundary(world):
    """The exchanged rows per pair never exceed an owner's row count."""
    rng = np.random.default_rng(7)
    snd, rcv = rng.integers(0, 48, 128), rng.integers(0, 48, 128)
    part = tpar.build_halo_partition(snd, rcv, 48, world)
    assert part.halo <= part.n_local + 8
    assert part.send_idx.shape == (world, world, part.halo)
    assert part.n_total == world * part.n_local >= 48


@pytest.mark.parametrize("world", WORLDS)
def test_halo_masked_query_outputs_match(ranks, jref, world):
    res = ranks(world, "halo_query")
    np.testing.assert_allclose(res["got"], jref("halo_query"), **FN_TOL)
    assert res["same"]


@pytest.mark.parametrize("world", WORLDS)
def test_native_plan_matches_numpy_semantics(ranks, jref, world):
    """tests/test_runtime.py's halo-plan test: JAX's native and numpy
    planners order boundary rows their own way; the port's plan gives the
    same aggregation as both."""
    got = ranks(world, "halo_gs_native")["got"]
    for want in jref("halo_gs_native"):
        np.testing.assert_allclose(got, want, **FN_TOL)


@pytest.mark.parametrize("n,e,d", [(48, 128, 8), (56, 200, 8), (40, 120, 4), (40, 120, 2),
                                   (37, 300, 3), (100, 1000, 1), (10, 0, 2)])
def test_build_halo_plan_equals_jax_numpy_planner(monkeypatch, n, e, d):
    """Array for array: the port's sorted send lists are the numpy
    planner's ``np.unique`` order (JAX's native planner is switched off
    inside the test)."""
    from bikg_graph_explainability_public_tpu.parallel import halo as jhalo
    from bikg_graph_explainability_public_tpu.runtime import native as jnative

    rng = np.random.default_rng(n + e + d)
    snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
    monkeypatch.setattr(jnative, "build_halo_plan", lambda *a, **k: None)
    want = jhalo.build_halo_partition(snd, rcv, n, d)
    got = tpar.build_halo_partition(snd, rcv, n, d)
    assert (got.n_local, got.halo) == (want.n_local, want.halo)
    for field in ("send_idx", "edge_slot", "edge_rcv", "edge_id", "edge_valid"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    plan = tnative.build_halo_plan(d * got.n_local, snd, rcv, got.n_local, d)
    assert plan[1] == got.edge_slot.shape[1]


def test_edge_mask_from_node_mask_matches_jax():
    from bikg_graph_explainability_public_tpu.runtime import native as jnative

    _, ei, _ = make_graph(n=20, f=4, e=60, seed=4)
    nm = np.random.default_rng(0).random(20) > 0.5
    got = tnative.edge_mask_from_node_mask(ei[0], ei[1], nm)
    np.testing.assert_array_equal(got, jnative.edge_mask_from_node_mask(ei[0], ei[1], nm))
    np.testing.assert_array_equal(got, nm[ei[0]] & nm[ei[1]])


@pytest.mark.parametrize("world", WORLDS)
def test_halo_edge_problem_matches(ranks, jref, world):
    res = ranks(world, "halo_edge")
    np.testing.assert_allclose(res["got"], jref("halo_edge"), **FN_TOL)
    assert res["same"]


@pytest.mark.parametrize("world", WORLDS)
def test_halo_graph_problem_matches(ranks, jref, world):
    res = ranks(world, "halo_graph")
    np.testing.assert_allclose(res["got"], jref("halo_graph"), **FN_TOL)
    assert res["same"]


# ---------------------------------------------------------------------------
# explain_many(mesh=)
# ---------------------------------------------------------------------------


def _frames(results):
    return [f for out in results for f in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("case", list(MANY_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_explain_many_mesh_matches_no_mesh_and_jax(ranks, jref, world, case):
    """Q = 3 queries over 2 and 4 ranks (padded by the last query): the
    frames equal the port's ``mesh=None`` frames exactly (and a second,
    plan-cached call's), and JAX's ``explain_many(mesh=make_mesh(8))``
    within ``rtol=1e-4, atol=1e-6``, on every rank alike."""
    res = ranks(world, f"many_{case}")
    got, again, want = _frames(res["got"]), _frames(res["again"]), _frames(res["want"])
    assert len(got) == len(want) == len(_frames(jref(f"many_{case}"))) >= len(QUERIES)
    for g, a, w, j in zip(got, again, want, _frames(jref(f"many_{case}"))):
        pd.testing.assert_frame_equal(g, w)
        pd.testing.assert_frame_equal(a, w)
        assert list(g.columns) == list(j.columns) and sorted(g.index) == sorted(j.index)
        np.testing.assert_allclose(g.loc[j.index].to_numpy(), j.to_numpy(), **MANY_TOL)
    assert res["same"]


# ---------------------------------------------------------------------------
# TestMultiHost, the group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_make_multihost_mesh_shapes(ranks, world):
    res = ranks(world, "multihost_shapes")
    assert res["names"] == ("host", "data") and res["shape"] == (2, world // 2)
    assert res["names3"] == ("host", "data", "model") and res["shape3"] == (2, 1, world // 2)
    assert "fold" in res["refused"]
    assert res["placements"] == ["(Replicate(), Shard(dim=0))", "(Shard(dim=0), Shard(dim=0))",
                                 "(Replicate(), Replicate())"]


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_batch_matches_single_device(ranks, jref, world):
    """The training step with the batch split over (host, data) jointly."""
    res = ranks(world, "multihost_step")
    w, loss = jref("multihost_step")
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(res["w"], w, **STEP_TOL)
    assert res["same"]


def test_initialize_distributed_single_process_noop(monkeypatch):
    """No coordinator and no launcher environment: nothing starts."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.initialize_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tpar.make_mesh(device="cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_group_is_joined_once_on_gloo(ranks, world):
    res = ranks(world, "group")
    assert res["again"] is True and res["world"] == world and res["rank"] == 0
    assert res["backend"] == "gloo" and res["mesh_type"] == "cpu"
    assert "launch" in res["refused"]


def _raise_on_rank_1():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 failed on purpose")
    time.sleep(600)  # rank 0 would run on for ever


def _hang_on_rank_1():
    if dist.get_rank() == 1:
        time.sleep(600)


@pytest.mark.parametrize("fault", ["raises", "hangs"])
def test_a_failing_rank_fails_the_spawn_within_its_deadline(fault):
    """Every rank is killed and ``spawn`` raises: at once when a rank
    raises, at the deadline when one hangs."""
    t0 = time.monotonic()
    if fault == "raises":
        with pytest.raises(Exception, match="rank 1 failed on purpose"):
            tpar.spawn(_raise_on_rank_1, 2, device="cpu", timeout=120)
        assert time.monotonic() - t0 < 100
    else:
        with pytest.raises(TimeoutError):
            tpar.spawn(_hang_on_rank_1, 2, device="cpu", timeout=5)
        assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# the CLI's --mesh-devices
# ---------------------------------------------------------------------------


def _cli_rank(argv, store):
    """A CLI run in a group of its own: the spawned group is left, and the
    CLI joins one from the launcher's environment (as under torchrun) and
    must leave it destroyed."""
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()
    os.environ.update(COORDINATOR_ADDRESS=f"file://{store}", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    code = tcli.main(argv)
    return dict(code=code, destroyed=not dist.is_initialized())


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_mesh")
    toy = np.load(TOY)
    np.savez(d / "homo.npz", feat=toy["feat"], edge_index=toy["edge_index"], names=toy["names"])
    state = gcn_params_to_torch_state_dict(load_params(CKPT))
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state.items()}},
               d / "homo.pth.tar")
    return d


def test_cli_mesh_devices_writes_the_same_csvs(cli_files, tmp_path):
    """``explain-batch --mesh-devices 2 --device cpu`` in two ranks writes
    (rank 0 only) the CSVs of a run without a mesh."""
    elements = "10,3,25"
    base = ["explain-batch", "--graph", str(cli_files / "homo.npz"), "--checkpoint",
            str(cli_files / "homo.pth.tar"), "--elements", elements, "--device", "cpu"]
    assert tcli.main(base + ["--out", str(tmp_path / "plain.csv")]) == 0
    res = tpar.spawn(_cli_rank, 2, base + ["--mesh-devices", "2", "--out",
                                           str(tmp_path / "mesh.csv")],
                     str(tmp_path / "cli_store"), device="cpu", timeout=120)
    assert res == dict(code=0, destroyed=True)
    for el in elements.split(","):
        want = pd.read_csv(tmp_path / f"plain_{el}.csv", index_col=0)
        got = pd.read_csv(tmp_path / f"mesh_{el}.csv", index_col=0)
        pd.testing.assert_frame_equal(got, want)


def test_cli_mesh_devices_without_ranks_names_torchrun(cli_files, monkeypatch, capsys):
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["explain-batch", "--graph", str(cli_files / "homo.npz"), "--checkpoint",
                   str(cli_files / "homo.pth.tar"), "--elements", "10", "--device", "cpu",
                   "--mesh-devices", "2"])
    assert e.value.code == 2
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the signatures: JAX's names and order, with the recorded departures
# ---------------------------------------------------------------------------

_MODEL = dict(drop=("model_def", "params"), prepend=("model",))
#: name -> departure (the parallel package's docstring table)
DEPARTURES = {
    "halo_masked_outputs": _MODEL, "halo_masked_outputs_hetero": _MODEL,
    "halo_masked_query_outputs": _MODEL, "halo_gcn_forward": _MODEL,
    "partitioned_gcn_forward": _MODEL,
    "shard_params_model_axis": dict(drop=("params",), prepend=("model",)),
    "explain_training_step": dict(append=("mesh", "axes")),
    "make_mesh": dict(append=("device",)), "make_multihost_mesh": dict(append=("device",)),
    "initialize_distributed": dict(append=("device",)),
    "ShardedModel.__init__": dict(append=("device",)),
}
JAX_PARALLEL = ("mesh", "sharding", "edge_partition", "halo", "sharded_model")


def _jax_parallel_callables():
    import importlib

    out = {}
    for mod in JAX_PARALLEL:
        m = importlib.import_module(f"bikg_graph_explainability_public_tpu.parallel.{mod}")
        for name, obj in vars(m).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != m.__name__:
                continue
            if inspect.isclass(obj):
                for meth, fn in vars(obj).items():
                    if inspect.isfunction(fn) and (meth == "__init__" or not meth.startswith("_")):
                        out[f"{name}.{meth}"] = (mod, fn)
            elif inspect.isfunction(obj):
                out[name] = (mod, obj)
    return out


@pytest.mark.parametrize("name", sorted(_jax_parallel_callables()))
def test_parallel_signatures_follow_jax(name):
    mod, jfn = _jax_parallel_callables()[name]
    tmod = {"mesh": tmesh, "sharding": tsharding, "halo": thalo}.get(mod)
    if tmod is None:
        import importlib

        tmod = importlib.import_module(f"bikg_graph_explainability_public_tpu_torch.parallel.{mod}")
    obj = tmod
    for part in name.split("."):
        obj = getattr(obj, part)

    def params(fn, keyword_only=False):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if (p.kind == p.KEYWORD_ONLY) == keyword_only]

    want = params(jfn)
    dep = DEPARTURES.get(name, {})
    want = list(dep.get("prepend", ())) + [p for p in want if p not in dep.get("drop", ())]
    got, got_kw = params(obj), params(obj, keyword_only=True)
    if name == "ShardedModel.__init__":
        want += list(dep["append"])
    else:
        assert got_kw == list(dep.get("append", ())), name
    assert got == want, name
    for p in inspect.signature(jfn).parameters.values():
        if p.name in got and p.default is not p.empty:
            assert inspect.signature(obj).parameters[p.name].default == p.default, (name, p.name)
