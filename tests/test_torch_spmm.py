"""PyTorch port: the static separable ELL gather-sum (kernel 2.3).

On the CPU the wrapper runs the kernel's plain PyTorch version; that is what
is held here against the JAX package's v7 Pallas kernel in interpret mode
and against a float64 numpy loop.  The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bikg_graph_explainability_public_tpu.ops import ell as jell
from bikg_graph_explainability_public_tpu.ops import spmm as jspmm
from bikg_graph_explainability_public_tpu.ops.spmm_pallas import (
    gather_sum_static as j_gather_sum_static,
)
from bikg_graph_explainability_public_tpu_torch.ops import ell as tell
from bikg_graph_explainability_public_tpu_torch.ops import spmm as tspmm
from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda

#: float32 sums in another order only
TOL = dict(rtol=1e-5, atol=1e-5)

N, DEAD_ROWS, DEAD_SRCS = 96, 9, 7


def _edges(k, seed):
    """Random edges over N rows: the last DEAD_ROWS rows receive none (degree
    0) and the last DEAD_SRCS rows are never a source; no row overflows K."""
    rng = np.random.default_rng(seed)
    e = N * k // 2
    src = rng.integers(0, N - DEAD_SRCS, e)
    dst = rng.integers(0, N - DEAD_ROWS, e)
    keep = (src != dst) & (np.bincount(dst, minlength=N)[dst] <= k)
    return src[keep], dst[keep], np.arange(int(keep.sum()), dtype=np.int32)


def _tables(k, seed):
    src, dst, eid = _edges(k, seed)
    jt = jell.build_neighbor_table_edges(N, src, dst, eid, k=k)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=k, device="cpu")
    return jt, tt


def _inputs(b, f, dtype, scale, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, b * f)).astype(np.float32)
    feats[N - DEAD_SRCS:] = np.nan  # rows that no valid slot names
    ft = torch.from_numpy(feats).to(dtype)
    ps = rng.standard_normal((N, b)).astype(np.float32) if scale else None
    return ft, ps


def _oracle(tt, feats_t, b, ps):
    """float64 loop over rows and valid slots."""
    x = feats_t.float().numpy().astype(np.float64)
    nbr, deg = tt.nbr.numpy(), tt.deg.numpy()
    out = np.zeros_like(x)
    for v in range(N):
        for j in range(deg[v]):
            out[v] += x[nbr[v, j]]
    if ps is not None:
        out = (out.reshape(N, b, -1) * ps[:, :, None]).reshape(N, -1)
    return out


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("b,f", [(1, 4), (16, 3), (48, 2)])
def test_plain_matches_oracle(b, f, k, dtype, scale):
    _, tt = _tables(k, seed=k)
    feats, ps = _inputs(b, f, dtype, scale, seed=b + k)
    got = spmm_cuda.gather_sum_static(tt, feats, b, None if ps is None else torch.from_numpy(ps))
    assert got.dtype == torch.float32 and got.shape == (N, b * f)
    assert torch.isfinite(got).all()  # the NaN rows never reach the sum
    deg0 = tt.deg.numpy() == 0
    assert deg0.sum() >= DEAD_ROWS and (got.numpy()[deg0] == 0).all()
    np.testing.assert_allclose(got.numpy(), _oracle(tt, feats, b, ps), **TOL)


@pytest.mark.parametrize("b,f,k,dtype,scale", [
    (1, 128, 8, torch.float32, True),
    (16, 8, 16, torch.bfloat16, True),
    (48, 8, 32, torch.float32, False),
])
def test_plain_matches_jax_v7_interpret(b, f, k, dtype, scale):
    jt, tt = _tables(k, seed=100 + k)
    feats, ps = _inputs(b, f, dtype, scale, seed=b)
    jfeats = jnp.asarray(feats.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )
    want = np.asarray(j_gather_sum_static(
        jt, jfeats, b=b, interpret=True, post_scale=None if ps is None else jnp.asarray(ps)
    ))
    got = spmm_cuda.gather_sum_static(tt, feats, b, None if ps is None else torch.from_numpy(ps))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_separable_matches_jax_v7_interpret():
    """The separable entry at b*F = 512, the JAX side on its Pallas path."""
    b, f = 16, 32
    jt, tt = _tables(16, seed=7)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((N, b * f)).astype(np.float32)
    a_bn = rng.random((b, N)).astype(np.float32)
    want = np.asarray(jspmm.gather_sum_batched_separable(
        jnp.asarray(a_bn), jnp.asarray(feats), None, None, N, b, table=jt, backend="pallas",
    ))
    got = tspmm.gather_sum_batched_separable(
        torch.from_numpy(a_bn), torch.from_numpy(feats), b, table=tt
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("b,f", [(1, 8), (16, 4), (48, 2)])
def test_separable_matches_jax_xla(b, f, post, dtype):
    """Against the JAX entry's XLA path (segment-sum over the edge list)."""
    src, dst, eid = _edges(16, seed=b)
    jt = jell.build_neighbor_table_edges(N, src, dst, eid)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, device="cpu")
    rng = np.random.default_rng(f)
    feats = rng.standard_normal((N, b * f)).astype(np.float32)
    a_bn = rng.random((b, N)).astype(np.float32)
    post_bn = rng.random((b, N)).astype(np.float32) if post else None
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jspmm.gather_sum_batched_separable(
        jnp.asarray(a_bn), jnp.asarray(feats).astype(jd), jnp.asarray(src), jnp.asarray(dst), N, b,
        backend="xla", indices_are_sorted=False,
        post_a_bn=None if post_bn is None else jnp.asarray(post_bn),
    )).astype(np.float32)
    got = tspmm.gather_sum_batched_separable(
        torch.from_numpy(a_bn), torch.from_numpy(feats).to(dtype), b, table=tt,
        post_a_bn=None if post_bn is None else torch.from_numpy(post_bn),
    )
    assert got.dtype == torch.float32
    # bf16: both sides round the pre- and post-scales to bf16 alike
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_prefix_violation_raises():
    _, tt = _tables(8, seed=1)
    valid = tt.valid.clone()
    row = int(np.nonzero(tt.deg.numpy() >= 2)[0][0])
    valid[row, 0] = 0.0  # a valid slot now follows an invalid one
    holed = tell.NeighborTable(nbr=tt.nbr, valid=valid, eid=tt.eid)
    feats = torch.zeros((N, 4))
    with pytest.raises(ValueError, match="prefix"):
        spmm_cuda.gather_sum_static(holed, feats, 1)


def test_wrapper_checks_inputs():
    _, tt = _tables(8, seed=2)
    with pytest.raises(ValueError):  # float16 is not a kernel type
        spmm_cuda.gather_sum_static(tt, torch.zeros((N, 8), dtype=torch.float16), 1)
    with pytest.raises(ValueError):  # width not a multiple of b
        spmm_cuda.gather_sum_static(tt, torch.zeros((N, 9)), 2)
    with pytest.raises(ValueError):  # post_scale of the wrong shape
        spmm_cuda.gather_sum_static(tt, torch.zeros((N, 8)), 2, post_scale=torch.zeros((N, 3)))
    with pytest.raises(ValueError):  # fewer source rows than the table names
        spmm_cuda.gather_sum_static(tt, torch.zeros((tt.n_src - 1, 8)), 1)
    with pytest.raises(ValueError):  # neither the CPU nor the table's device
        spmm_cuda.gather_sum_static(tt, torch.zeros((N, 8), device="meta"), 1)


def test_cpu_tensors_never_build_or_launch_the_kernel():
    _, tt = _tables(8, seed=3)
    before = spmm_cuda.GATHER_SUM_STATIC.launches
    spmm_cuda.gather_sum_static(tt, torch.ones((N, 8)), 2, post_scale=torch.ones((N, 2)))
    assert spmm_cuda.GATHER_SUM_STATIC.launches == before
    assert not spmm_cuda.GATHER_SUM_STATIC.library.built
