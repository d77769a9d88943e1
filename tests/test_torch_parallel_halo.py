"""PyTorch port: the hetero halo and ``ShardedModel`` (the whole
``Explainer`` on every rank) against the JAX package's on the same seeded
numpy inputs, at world sizes 2 and 4 on gloo, each world size in one
``parallel.spawn``; the JAX side on its 8 virtual CPU devices.  The rest of
``parallel/`` is held in ``test_torch_parallel.py`` (see its docstring).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from torch_parallel_cases import (
    FN_TOL, FRAME_TOL, HETERO_CASES, HETERO_TOL, WORLDS, JaxRefs, RankResults, build_inputs,
)

CASES = ("sm_node", "sm_edge", "sm_graph", "sm_refuse", *(f"hetero_{c}" for c in HETERO_CASES))


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


@pytest.fixture(scope="module")
def jref(inputs):
    return JaxRefs(inputs)


@pytest.fixture(scope="module")
def ranks(inputs):
    return RankResults(inputs, CASES)


@pytest.mark.parametrize("case", list(HETERO_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_hetero_sharded_matches_single_device(ranks, jref, world, case):
    """The hetero halo (relation-scoped degrees, self-loops and biases,
    one exchange a layer) against JAX's, chunks of 4 with a padded tail."""
    got = ranks(world, f"hetero_{case}")["got"]
    np.testing.assert_allclose(got, jref(f"hetero_{case}"), **HETERO_TOL)


# ---------------------------------------------------------------------------
# TestShardedModel: the whole Explainer on every rank
# ---------------------------------------------------------------------------


def _assert_cv(got: pd.DataFrame, want: pd.DataFrame):
    assert set(got.index) == set(want.index)
    a = want["config_value_mean"].sort_index()
    b = got["config_value_mean"].sort_index()
    np.testing.assert_allclose(b.to_numpy(), a.to_numpy(), **FRAME_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_explainer_end_to_end_matches_single_device(ranks, jref, world):
    res = ranks(world, "sm_node")
    _assert_cv(res["got"], jref("sm_node"))
    assert res["same"]  # every rank returns the same frame


@pytest.mark.parametrize("problem", ["edge", "graph"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_model_edge_and_graph_explainer(ranks, jref, world, problem):
    res = ranks(world, f"sm_{problem}")
    _assert_cv(res["got"], jref(f"sm_{problem}"))
    assert res["same"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_model_refuses_unsupported_model(ranks, world):
    """No silent replicated fall-back: a hetero GAT raises; the opt-in
    warns and gives the adapter's outputs."""
    res = ranks(world, "sm_refuse")
    assert "replicated" in res["refused"]
    assert any("replicated fall-back" in w for w in res["warned"])
    np.testing.assert_allclose(*res["fallback"], **FN_TOL)
