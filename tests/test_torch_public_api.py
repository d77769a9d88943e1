"""PyTorch port: the package's public surface.

``import bikg_graph_explainability_public_tpu_torch as px`` exports the JAX
package's ``__all__`` (none of its names is left unported), without importing
pandas or jax and without building a kernel; the reference-named facades
(``compat``), ``version``, checkpoint IO, ``set_seed``, the approximate
kernel and ``Graph``'s methods agree with the JAX package's; the CLI's
``version``, ``explain`` and ``explain-batch`` write the JAX CLI's CSVs on
the same files; the examples run."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bikg_graph_explainability_public_tpu as jpx
from bikg_graph_explainability_public_tpu import cli as jcli
from bikg_graph_explainability_public_tpu.models import checkpoint as jckpt
import bikg_graph_explainability_public_tpu_torch as px
from bikg_graph_explainability_public_tpu_torch import cli as tcli
from bikg_graph_explainability_public_tpu_torch.models import checkpoint as tckpt

from fixtures import make_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "bikg_graph_explainability_public_tpu_torch"
CKPT = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
TOY = os.path.join(ROOT, "test_data", "toy_graph_36n.npz")
TOL = dict(rtol=1e-4, atol=1e-6)
#: in the JAX package's ``__all__`` but not in the port's: none
UNPORTED: set = set()


def test_all_is_the_jax_packages_minus_the_unported():
    assert set(px.__all__) == set(jpx.__all__) - UNPORTED
    assert not UNPORTED and px.__all__ == jpx.__all__
    assert len(px.__all__) == len(set(px.__all__))
    for name in px.__all__:
        assert getattr(px, name) is not None, name
    assert not any(hasattr(px, name) for name in UNPORTED)
    assert px.__version__ == px.VERSION == jpx.VERSION


def test_import_loads_no_pandas_no_jax_and_builds_nothing():
    code = (
        f"import sys, {PKG} as px\n"
        f"from {PKG}.ops import cuda_build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('pandas', 'jax', 'jaxlib', 'bikg_graph_explainability_public_tpu'))\n"
        "assert not bad, bad\n"
        "assert not any(lib.built for lib in cuda_build._LIBRARIES.values())\n"
        "assert px.Explainer and px.explain_many and px.Model\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# compat, version, checkpoints, the small functions
# ---------------------------------------------------------------------------


def test_data_facade_matches_jax():
    feat, ei, _ = make_graph(10, 4, 20)
    d, jd = px.Data(feat, ei, device="cpu"), jpx.Data(feat, ei)
    g, jg = d.to_graph(), jd.to_graph()
    for name in ("x", "senders", "receivers", "node_mask", "edge_mask", "node_type", "edge_type"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    for problem in ("node_prediction", "edge_prediction"):
        assert d.element_size(problem) == jd.element_size(problem)
    hfeat = {"a": feat[:6], "b": feat[6:]}
    hei = {("a", "r", "b"): np.array([[0, 1], [2, 3]])}
    (hg, info), (jhg, jinfo) = (px.Data(hfeat, hei, device="cpu").preprocess_hetero_graph(),
                                jpx.Data(hfeat, hei).preprocess_hetero_graph())
    assert dataclasses.asdict(info) == dataclasses.asdict(jinfo)
    np.testing.assert_array_equal(hg.node_type.numpy(), np.asarray(jhg.node_type))
    assert hg.typed and jhg.typed and not g.typed


def test_kernel_facade_matches_jax():
    mask = np.random.default_rng(0).random((20, 8)) > 0.5
    for normalized in (True, False):
        got = px.Kernel(mask, device="cpu").compute(normalized).numpy()
        want = np.asarray(jpx.Kernel(mask).compute(normalized))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_mask_facade_matches_jax():
    feat, ei, names = make_graph(12, 4, 30)
    params = {"seed": 1, "interpret_samples": 10, "epochs": 5}
    pathways = [names[:4], names[4:9]]
    for pw in (None, pathways):
        got = px.Mask(feat, ei, pw, params, "node_prediction")
        want = jpx.Mask(feat, ei, pw, params, "node_prediction")
        for key in (None, 7):
            tkey = None if key is None else px.set_seed(key)
            jkey = None if key is None else jax.random.PRNGKey(key)
            (m, rows, bs), (jm, jrows, jbs) = got.mask_generator(tkey), want.mask_generator(jkey)
            np.testing.assert_array_equal(m, np.asarray(jm))
            assert bs == jbs and (rows is None) == (jrows is None)
            if rows is not None:
                np.testing.assert_array_equal(rows, np.asarray(jrows))


def test_linear_regression_facade_matches_jax():
    lr, jlr = px.LinearRegression(6, width=8), jpx.LinearRegression(6, width=8)
    w = lr.init(px.set_seed(3))
    jw = jlr.init(jax.random.PRNGKey(3))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    mask = np.random.default_rng(1).random((5, 8)) > 0.5
    np.testing.assert_allclose(lr.apply(w, mask).numpy(), np.asarray(jlr.apply(jw, jnp.asarray(mask))),
                               rtol=1e-6)
    with pytest.raises(AssertionError):
        px.LinearRegression(6.0)


def test_set_seed_and_version_match_jax():
    for seed in (100, 0, 2**31 - 1):
        key = px.set_seed(seed)
        assert key.dtype == np.uint32
        np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jpx.set_seed(seed))))
    np.testing.assert_array_equal(px.set_seed(), np.asarray(jpx.set_seed()))
    from bikg_graph_explainability_public_tpu_torch.version import get_git_hash

    assert px.get_version() == jpx.get_version() == px.VERSION
    assert px.get_version(with_git_hash=True).startswith(px.VERSION + "-")
    assert isinstance(get_git_hash(), str) and get_git_hash()


@pytest.mark.parametrize("n,valid", [(12, None), (40, 33), (1500, None)])
def test_approximate_shap_kernel_parity_matches_jax(n, valid):
    mask = np.random.default_rng(n).random((64, n)) < 0.5
    mask[0] = False  # k = 0 weighs nothing
    got = px.approximate_shap_kernel_parity(torch.from_numpy(mask), valid).numpy()
    want = np.asarray(jpx.approximate_shap_kernel_parity(jnp.asarray(mask), valid))
    assert got[0] == 0 and got.max() == 1.0
    # log C(1000, k) is a difference of lgammas near 5900, where one float32
    # ulp is 4.9e-4: the two lgammas may differ by an ulp (the tolerance
    # ROADMAP records for shap_kernel near n = 1000)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7)


def test_checkpoint_roundtrips_match_jax(tmp_path):
    model = px.GCNNodeModel(6, conv_channels=(4, 3), fc_channels=(3, 4),
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1)  # non-zero biases
    sd = model.state_dict()
    # the port's archive is the JAX package's tree, and back
    tckpt.save_params(str(tmp_path / "port.npz"), sd)
    tree = jckpt.load_params(str(tmp_path / "port.npz"))
    assert np.asarray(tree["conv"][1]["weight"]).shape == (3, 4)
    jckpt.save_params(str(tmp_path / "jax.npz"), tree)
    back = tckpt.load_params(str(tmp_path / "jax.npz"))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    # a JAX-style tree saves as the same archive
    tckpt.save_params(str(tmp_path / "tree.npz"), tree)
    for k, v in tckpt.load_params(str(tmp_path / "tree.npz")).items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    # the torch key layout
    got = tckpt.gcn_params_to_torch_state_dict(sd)
    want = jckpt.gcn_params_to_torch_state_dict(tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_graph_edge_index_and_with_features():
    feat, ei, _ = make_graph(9, 3, 14)
    g, jg = px.from_arrays(feat, ei, device="cpu"), jpx.from_arrays(feat, ei)
    np.testing.assert_array_equal(g.edge_index().numpy(), np.asarray(jg.edge_index()))
    assert g.edge_index().shape == (2, g.e_pad)
    x2 = torch.arange(g.n_pad * 3, dtype=torch.float32).reshape(g.n_pad, 3)
    g2 = g.with_features(x2)
    assert g2.x is x2 and g2.senders is g.senders and g2.num_nodes == g.num_nodes
    np.testing.assert_array_equal(g2.host.x, x2.numpy())  # the host view follows
    np.testing.assert_array_equal(g2.host.senders, g.host.senders)
    np.testing.assert_array_equal(g.host.x[:9], feat)  # the original is unchanged


def test_config_keeps_the_reference_fields_and_refuses_a_mesh():
    """``mesh_shape`` and ``matmul_precision`` load from a reference
    configuration; a mesh is not ported, so setting one raises, as
    ``explain_many(mesh=)`` does."""
    cfg = px.ExplainerConfig.from_dict({"epochs": 3, "matmul_precision": "highest"})
    assert cfg.matmul_precision == "highest" and cfg.mesh_shape is None
    with pytest.raises(NotImplementedError, match="mesh"):
        px.ExplainerConfig.from_dict({"mesh_shape": (2, 1)})


# ---------------------------------------------------------------------------
# the CLI, against the JAX CLI on the same files
# ---------------------------------------------------------------------------

CFG = {"seed": 1, "interpret_samples": 10, "epochs": 20, "lr": 0.01, "l1_lambda": 1e-4}
HRELS = [("a", "r1", "b"), ("b", "r2", "a")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The graphs (homogeneous with node and edge names, heterogeneous in
    the model's type order), the checkpoints (torch.save of state dicts in
    the reference's layout), the config and the communities."""
    d = tmp_path_factory.mktemp("cli")
    toy = np.load(TOY)
    ne = toy["edge_index"].shape[1]
    np.savez(d / "homo.npz", feat=toy["feat"], edge_index=toy["edge_index"], names=toy["names"],
             edge_names=np.array([f"e{i}" for i in range(ne)]))
    sd = jckpt.gcn_params_to_torch_state_dict(jckpt.load_params(CKPT))
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               d / "homo.pth.tar")
    rng = np.random.default_rng(12)
    arrays = {"feat__a": rng.normal(size=(14, 6)).astype(np.float32),
              "feat__b": rng.normal(size=(12, 6)).astype(np.float32),
              "names__a": np.array([f"a{i}" for i in range(14)]),
              "names__b": np.array([f"b{i}" for i in range(12)])}
    sizes = {"a": 14, "b": 12}
    for r in HRELS:
        arrays["edge_index__" + "__".join(r)] = np.stack(
            [rng.integers(0, sizes[r[0]], 30), rng.integers(0, sizes[r[-1]], 30)])
    np.savez(d / "hetero.npz", **arrays)
    hsd = {}
    for r in HRELS:
        key = "conv.0.convs." + "__".join(r)
        hsd[key + ".lin.weight"] = rng.normal(size=(8, 6)) * 0.5
        hsd[key + ".bias"] = rng.normal(size=(8,)) * 0.3
    hsd.update({"fc.0.weight": rng.normal(size=(4, 8)) * 0.5, "fc.0.bias": rng.normal(size=(4,)),
                "fc.2.weight": rng.normal(size=(1, 4)), "fc.2.bias": rng.normal(size=(1,))})
    torch.save({"model": {k: torch.tensor(v, dtype=torch.float32) for k, v in hsd.items()}},
               d / "hetero.pth.tar")
    (d / "cfg.json").write_text(json.dumps(CFG))
    names = [str(x) for x in toy["names"]]
    (d / "pw.json").write_text(json.dumps({
        "pathways": [names[i::4] for i in range(4)], "names": ["w", "x", "y", "z"]}))
    return d


def _assert_csv(got_path, want_path):
    got = pd.read_csv(got_path, index_col=0)
    want = pd.read_csv(want_path, index_col=0)
    assert list(got.columns) == list(want.columns) and len(got)
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


def _run_both(files, tmp_path, argv):
    """The JAX CLI and the port's (``--device cpu``) on the same arguments,
    writing under ``tmp_path/jax`` and ``tmp_path/port``."""
    out = {}
    for who, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        (tmp_path / who).mkdir()
        args = [a.format(d=files, out=tmp_path / who) for a in argv]
        assert main(args + extra) == 0
        out[who] = tmp_path / who
    return out["port"], out["jax"]


EXPLAIN_CASES = {
    "homo_node_communities": ["--graph", "{d}/homo.npz", "--checkpoint", "{d}/homo.pth.tar",
                              "--element", "10", "--pathways", "{d}/pw.json"],
    "homo_edge": ["--graph", "{d}/homo.npz", "--checkpoint", "{d}/homo.pth.tar",
                  "--element", "e7", "--problem", "edge_prediction"],
    "hetero_node": ["--graph", "{d}/hetero.npz", "--checkpoint", "{d}/hetero.pth.tar",
                    "--element", "b4", "--times", "2"],
}


@pytest.mark.parametrize("case", sorted(EXPLAIN_CASES))
def test_cli_explain_matches_jax(files, tmp_path, case):
    argv = ["explain", *EXPLAIN_CASES[case], "--config", "{d}/cfg.json", "--out", "{out}/s.csv"]
    port, jax_out = _run_both(files, tmp_path, argv)
    _assert_csv(port / "s.csv", jax_out / "s.csv")
    if case == "homo_node_communities":
        _assert_csv(port / "s_pathways.csv", jax_out / "s_pathways.csv")


BATCH_CASES = {
    "homo_node": (["--graph", "{d}/homo.npz", "--checkpoint", "{d}/homo.pth.tar",
                   "--elements", "10,3,25", "--times", "2"], ["10", "3", "25"]),
    "homo_edge": (["--graph", "{d}/homo.npz", "--checkpoint", "{d}/homo.pth.tar",
                   "--elements", "e7,e30", "--problem", "edge_prediction"], ["e7", "e30"]),
    "hetero_node": (["--graph", "{d}/hetero.npz", "--checkpoint", "{d}/hetero.pth.tar",
                     "--elements", "a3,b4,b9"], ["a3", "b4", "b9"]),
    "homo_node_communities": (["--graph", "{d}/homo.npz", "--checkpoint", "{d}/homo.pth.tar",
                               "--elements", "10,3", "--pathways", "{d}/pw.json"], ["10", "3"]),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_cli_explain_batch_matches_jax(files, tmp_path, case):
    args, elements = BATCH_CASES[case]
    argv = ["explain-batch", *args, "--config", "{d}/cfg.json", "--out", "{out}/s.csv"]
    port, jax_out = _run_both(files, tmp_path, argv)
    for el in elements:
        _assert_csv(port / f"s_{el}.csv", jax_out / f"s_{el}.csv")
        if "communities" in case:
            _assert_csv(port / f"s_{el}_pathways.csv", jax_out / f"s_{el}_pathways.csv")


def test_cli_version(capsys):
    assert tcli.main(["version"]) == 0
    assert capsys.readouterr().out.strip().startswith(px.VERSION + "-")


def test_cli_refusals_and_the_default_device(files, tmp_path, capsys):
    common = ["--checkpoint", str(files / "homo.pth.tar"), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        tcli.main(["explain", "--graph", str(tmp_path / "nope.npz"), "--element", "1", *common])
    assert e.value.code == 2 and "not found" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        tcli.main(["explain-batch", "--graph", str(files / "hetero.npz"), "--elements", "a1",
                   "--checkpoint", str(files / "hetero.pth.tar"), "--device", "cpu",
                   "--problem", "edge_prediction"])
    assert e.value.code == 2 and "edge_names" in capsys.readouterr().err
    # a hetero graph whose relations are not the model's
    d = dict(np.load(files / "hetero.npz"))
    d["edge_index__b__r9__a"] = d.pop("edge_index__b__r2__a")
    np.savez(tmp_path / "other.npz", **d)
    with pytest.raises(SystemExit) as e:
        tcli.main(["explain-batch", "--graph", str(tmp_path / "other.npz"), "--elements", "a1",
                   "--checkpoint", str(files / "hetero.pth.tar"), "--device", "cpu"])
    assert e.value.code == 2 and "relations" in capsys.readouterr().err
    # the card unless asked: no quiet fallback to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(["explain-batch", "--graph", str(files / "homo.npz"), "--elements", "3",
                       "--checkpoint", str(files / "homo.pth.tar")])


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def test_toy_example_runs():
    from bikg_graph_explainability_public_tpu_torch.examples import toy_example

    node_df, pathway_df = toy_example.main(["--device", "cpu"])
    assert sorted(node_df.index) == ["0", "1", "2", "3", "4"]
    assert sorted(pathway_df.index) == ["solo", "trio"]
    assert np.isfinite(node_df.to_numpy()).all() and (node_df["config_value_std"] > 0).any()


def test_toy_example_hetero_runs():
    from bikg_graph_explainability_public_tpu_torch.examples import toy_example_hetero

    cv, pw, many = toy_example_hetero.main(["--device", "cpu"])
    assert "g1" in cv.index and sorted(pw.index) == ["pathway-A", "pathway-B"]
    assert len(many) == 3 and all(np.isfinite(df.to_numpy()).all() for df in many)
