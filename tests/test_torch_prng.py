"""PyTorch port: PRNG keys, surrogate init and mask draws are bit-exact with
the JAX package for the same seed."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from bikg_graph_explainability_public_tpu.explain import masks as jmasks
from bikg_graph_explainability_public_tpu.explain import wlm as jwlm
from bikg_graph_explainability_public_tpu.utils import prng as jprng
from bikg_graph_explainability_public_tpu_torch.explain import masks as tmasks
from bikg_graph_explainability_public_tpu_torch.explain import wlm as twlm
from bikg_graph_explainability_public_tpu_torch.utils import prng as tprng

from fixtures import make_communities

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


@pytest.mark.parametrize("times", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_repeat_split_key_data_bit_exact(seed, times):
    want = jprng.repeat_split_key_data(seed, times)
    got = tprng.repeat_split_key_data(seed, times)
    assert got.dtype == np.uint32 and got.shape == (times, 2, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,data", [(0, 0), (1, 5), (42, 2**32 - 1), (2**31 - 1, 17)])
def test_fold_in_and_split_bit_exact(seed, data):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(tprng.root_key(seed), jax.random.key_data(key))
    folded = jax.random.fold_in(key, data)
    np.testing.assert_array_equal(
        tprng.fold_in(tprng.root_key(seed), data), jax.random.key_data(folded)
    )
    for num in (2, 5):
        np.testing.assert_array_equal(
            tprng.split(tprng.fold_in(tprng.root_key(seed), data), num),
            jax.random.key_data(jax.random.split(folded, num)),
        )


@pytest.mark.parametrize("width,num_valid", [(8, 8), (40, 36), (1000, 999), (5000, 4200)])
@pytest.mark.parametrize("seed", [1, 3])
def test_init_uniform_bit_exact(seed, width, num_valid):
    kd = jprng.repeat_split_key_data(seed, 2)
    for t in range(2):
        want = np.asarray(
            jwlm.init_surrogate_weights(
                jax.random.wrap_key_data(kd[t, 1]), width, num_valid
            )
        )
        got = twlm.init_surrogate_weights(kd[t, 1], width, num_valid).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _params(samples, epochs, seed=1):
    return {"seed": seed, "interpret_samples": samples, "epochs": epochs}


@pytest.mark.parametrize("times", [1, 3])
@pytest.mark.parametrize("elements,width,samples,epochs", [
    (8, 8, 20, 50), (27, 32, 10, 7), (300, 512, 20, 5),
])
def test_shapley_masks_bit_exact(elements, width, samples, epochs, times):
    params = _params(samples, epochs)
    kd = tprng.repeat_split_key_data(params["seed"], times)
    js = jmasks.MaskSampler(elements, width, params, None)
    ts = tmasks.MaskSampler(elements, width, params, None)
    for t in range(times):
        jm, jtags, jb = js.sample(kd[t, 0])
        tm, ttags, tb = ts.sample(kd[t, 0])
        assert tb == jb and (ttags is None) == (jtags is None)
        np.testing.assert_array_equal(tm, np.asarray(jm))


@pytest.mark.parametrize("times", [1, 3])
@pytest.mark.parametrize("n,k", [(36, 4), (36, 9), (200, 6)])
def test_community_masks_bit_exact(n, k, times):
    pathways, _ = make_communities(n, k)
    inds = [[int(v) for v in c] for c in pathways]
    params = _params(20, 10, seed=4)
    kd = tprng.repeat_split_key_data(params["seed"], times)
    js = jmasks.MaskSampler(n, n, params, inds)
    ts = tmasks.MaskSampler(n, n, params, inds)
    for t in range(times):
        jm, jtags, jb = js.sample(kd[t, 0])
        tm, ttags, tb = ts.sample(kd[t, 0])
        assert tb == jb
        np.testing.assert_array_equal(tm, np.asarray(jm))
        if jtags is None:
            assert ttags is None
        else:
            np.testing.assert_array_equal(ttags, np.asarray(jtags))
