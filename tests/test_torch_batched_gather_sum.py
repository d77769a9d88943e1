"""PyTorch port: the weighted ELL gather-sum (kernel 2.4).

On the CPU the wrapper runs the kernel's plain PyTorch version; that is what
is held here against a float64 numpy loop, against the JAX package's v7
weighted Pallas kernel in interpret mode and against the JAX entry's XLA
segment-sum, through both of its weight layouts: slot-major ``w_slot [N, K,
B]`` (the JAX signature) and sample-major ``w_sample [B, N, K]`` (the
engine's coefficients as made, which the kernel reads without a copy).  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bikg_graph_explainability_public_tpu.ops import ell as jell
from bikg_graph_explainability_public_tpu.ops import spmm as jspmm
from bikg_graph_explainability_public_tpu.ops.spmm_pallas import (
    batched_gather_sum as j_batched_gather_sum,
)
from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
from bikg_graph_explainability_public_tpu_torch.models import fast_gcn
from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
from bikg_graph_explainability_public_tpu_torch.ops import ell as tell
from bikg_graph_explainability_public_tpu_torch.ops import spmm as tspmm
from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda

#: float32 sums in another order only (each term is one product)
TOL = dict(rtol=1e-5, atol=1e-5)

N, DEAD_ROWS, DEAD_SRCS = 96, 9, 7


def _edges(k, seed):
    """Random edges over N rows without self-loops: the last DEAD_ROWS rows
    receive none (degree 0) and the last DEAD_SRCS rows are never a source;
    no row overflows K."""
    rng = np.random.default_rng(seed)
    e = N * k // 2
    src = rng.integers(0, N - DEAD_SRCS, e)
    dst = rng.integers(0, N - DEAD_ROWS, e)
    keep = (src != dst) & (np.bincount(dst, minlength=N)[dst] <= k)
    return src[keep], dst[keep], np.arange(int(keep.sum()), dtype=np.int32)


def _weights(e, b, seed):
    """Per-edge per-sample weights [E, B], a third of them exactly zero (the
    masked edges)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((e, b)).astype(np.float32)
    w[rng.random((e, b)) < 1 / 3] = 0.0
    return w


def _feats(b, f, seed, nan_rows=True):
    x = np.random.default_rng(seed).standard_normal((N, b * f)).astype(np.float32)
    if nan_rows:
        x[N - DEAD_SRCS:] = np.nan  # rows that no valid slot names
    return x


def _oracle(tt, x, b, w_slot):
    """float64 loop over rows and valid slots."""
    x = x.astype(np.float64).reshape(N, b, -1)
    nbr, deg = tt.nbr.numpy(), tt.deg.numpy()
    out = np.zeros_like(x)
    for v in range(N):
        for j in range(deg[v]):
            out[v] += w_slot[v, j, :, None].astype(np.float64) * x[nbr[v, j]]
    return out.reshape(N, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("b,f", [(1, 4), (16, 3), (48, 2)])
def test_plain_matches_oracle(b, f, k, dtype):
    src, dst, eid = _edges(k, seed=k)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=k, device="cpu")
    ew = torch.from_numpy(_weights(src.size, b, seed=b + k))
    feats = torch.from_numpy(_feats(b, f, seed=b * k)).to(dtype)
    got = spmm_cuda.batched_gather_sum(tt, ew, feats, b)
    assert got.dtype == torch.float32 and got.shape == (N, b * f)
    assert torch.isfinite(got).all()  # the NaN rows never reach the sum
    deg0 = tt.deg.numpy() == 0
    assert deg0.sum() >= DEAD_ROWS and (got.numpy()[deg0] == 0).all()
    w_slot = spmm_cuda.slot_weights(tt, ew).numpy()
    np.testing.assert_allclose(got.numpy(), _oracle(tt, feats.float().numpy(), b, w_slot), **TOL)
    # the same through pre-built slot weights
    again = spmm_cuda.batched_gather_sum(tt, None, feats, b, w_slot=torch.from_numpy(w_slot))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_zero_weight_keeps_the_product():
    """A valid slot of weight 0 adds 0 * x, as the JAX XLA path does: a NaN
    in a source row that a valid slot names reaches the sum."""
    src, dst, eid = _edges(8, seed=3)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=8, device="cpu")
    feats = torch.from_numpy(_feats(2, 4, seed=3, nan_rows=False))
    feats[int(src[0])] = float("nan")
    ew = torch.zeros((src.size, 2))
    got = spmm_cuda.batched_gather_sum(tt, ew, feats, 2)
    named = (tt.nbr == int(src[0])) & (tt.valid > 0)
    rows = named.any(dim=1)
    assert torch.isnan(got[rows]).all() and (got[~rows] == 0).all()


@pytest.mark.parametrize("b,f,k,dtype", [
    (1, 128, 8, torch.float32),
    (16, 8, 16, torch.bfloat16),
    (4, 32, 32, torch.float32),
])
def test_plain_matches_jax_v7w_interpret(b, f, k, dtype):
    """W = b*F = 128: the JAX side on its weighted v7 Pallas kernel."""
    src, dst, eid = _edges(k, seed=100 + k)
    jt = jell.build_neighbor_table_edges(N, src, dst, eid, k=k)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=k, device="cpu")
    ew = _weights(src.size, b, seed=b)
    feats = torch.from_numpy(_feats(b, f, seed=f)).to(dtype)
    jfeats = jnp.asarray(feats.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )
    want = np.asarray(j_batched_gather_sum(jt, jnp.asarray(ew), jfeats, b=b, interpret=True))
    got = spmm_cuda.batched_gather_sum(tt, torch.from_numpy(ew), feats, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_weighted_entry_matches_jax_pallas_with_slot_weights():
    """The engine's call: pre-built [N, K, B] slot weights at b*F = 512."""
    b, f = 16, 32
    src, dst, eid = _edges(16, seed=7)
    jt = jell.build_neighbor_table_edges(N, src, dst, eid, k=16)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=16, device="cpu")
    feats = _feats(b, f, seed=7, nan_rows=False)
    w_slot = spmm_cuda.slot_weights(tt, torch.from_numpy(_weights(src.size, b, seed=7)))
    want = np.asarray(jspmm.weighted_gather_sum_batched(
        None, jnp.asarray(feats), None, None, N, b, table=jt, backend="pallas",
        w_slot=jnp.asarray(w_slot.numpy()),
    ))
    got = tspmm.weighted_gather_sum_batched(None, torch.from_numpy(feats), b, table=tt, w_slot=w_slot)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f", [(1, 8), (16, 4), (48, 2)])
def test_weighted_entry_matches_jax_xla(b, f, dtype):
    """Against the JAX entry's XLA path (segment-sum over the edge list)."""
    src, dst, eid = _edges(16, seed=b)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, device="cpu")
    ew = _weights(src.size, b, seed=f)
    feats = _feats(b, f, seed=b + f, nan_rows=False)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jspmm.weighted_gather_sum_batched(
        jnp.asarray(ew), jnp.asarray(feats).astype(jd), jnp.asarray(src), jnp.asarray(dst),
        N, b, backend="xla", indices_are_sorted=False,
    )).astype(np.float32)
    got = tspmm.weighted_gather_sum_batched(
        torch.from_numpy(ew), torch.from_numpy(feats).to(dtype), b, table=tt
    )
    assert got.dtype == torch.float32
    # bf16: the JAX side rounds each product w * x to bf16 before its f32
    # sum, the port multiplies in f32; one bf16 ulp (2^-8) of a term
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_wrapper_checks_inputs():
    src, dst, eid = _edges(8, seed=2)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=8, device="cpu")
    ew = torch.zeros((src.size, 2))
    with pytest.raises(ValueError):  # float16 is not a kernel type
        spmm_cuda.batched_gather_sum(tt, ew, torch.zeros((N, 8), dtype=torch.float16), 2)
    with pytest.raises(ValueError):  # width not a multiple of b
        spmm_cuda.batched_gather_sum(tt, ew, torch.zeros((N, 9)), 2)
    with pytest.raises(ValueError):  # slot weights of the wrong shape
        spmm_cuda.batched_gather_sum(tt, None, torch.zeros((N, 8)), 2, w_slot=torch.zeros((N, 8, 3)))
    with pytest.raises(ValueError):  # slot weights of the wrong type
        spmm_cuda.batched_gather_sum(
            tt, None, torch.zeros((N, 8)), 2, w_slot=torch.zeros((N, 8, 2), dtype=torch.float64)
        )
    with pytest.raises(ValueError):  # neither weights nor slot weights
        spmm_cuda.batched_gather_sum(tt, None, torch.zeros((N, 8)), 2)
    with pytest.raises(ValueError):  # sample-major weights of the wrong shape
        spmm_cuda.batched_gather_sum(
            tt, None, torch.zeros((N, 8)), 2, w_sample=torch.zeros((N, 8, 2))
        )
    with pytest.raises(ValueError):  # sample-major weights of the wrong type
        spmm_cuda.batched_gather_sum(
            tt, None, torch.zeros((N, 8)), 2, w_sample=torch.zeros((2, N, 8), dtype=torch.float64)
        )
    with pytest.raises(ValueError):  # both layouts at once
        spmm_cuda.batched_gather_sum(
            tt, None, torch.zeros((N, 8)), 2, w_slot=torch.zeros((N, 8, 2)),
            w_sample=torch.zeros((2, N, 8)),
        )
    with pytest.raises(ValueError):  # fewer source rows than the table names
        spmm_cuda.batched_gather_sum(tt, ew, torch.zeros((tt.n_src - 1, 8)), 2)
    with pytest.raises(ValueError):  # neither the CPU nor the table's device
        spmm_cuda.batched_gather_sum(tt, ew, torch.zeros((N, 8), device="meta"), 2)


def test_cpu_tensors_never_build_or_launch_the_kernel():
    src, dst, eid = _edges(8, seed=4)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=8, device="cpu")
    kernels = (spmm_cuda.BATCHED_GATHER_SUM, spmm_cuda.SLOT_TRANSPOSE)
    before = [k.launches for k in kernels]
    spmm_cuda.batched_gather_sum(tt, torch.ones((src.size, 2)), torch.ones((N, 8)), 2)
    spmm_cuda.batched_gather_sum(tt, None, torch.ones((N, 8)), 2, w_sample=torch.ones((2, N, 8)))
    spmm_cuda.slot_transpose(torch.ones((N, 8, 2)))
    assert [k.launches for k in kernels] == before
    assert not spmm_cuda.BATCHED_GATHER_SUM.library.built


# --- sample-major weights [B, N, K] ------------------------------------------


def _sample_inputs(tt, b, f, dtype, seed):
    """Seeded numpy inputs of the sample-major entry: features with NaN in
    the rows that no valid slot names and in one row ``r0`` that valid slots
    do name, sample-major weights ``[B, N, K]`` (a third of them 0, the
    masked edges; zero on invalid slots) with every slot that names ``r0``
    weighing 0.  Returns (feats, w_bnk, the rows that name r0)."""
    rng = np.random.default_rng(seed)
    nbr, valid = tt.nbr.numpy(), tt.valid.numpy() > 0
    x = rng.standard_normal((N, b * f)).astype(np.float32)
    x[N - DEAD_SRCS:] = np.nan  # rows that no valid slot names
    r0 = int(nbr[valid][0])
    x[r0] = np.nan
    names_r0 = valid & (nbr == r0)
    w = rng.standard_normal((b, N, tt.k)).astype(np.float32)
    w[rng.random(w.shape) < 1 / 3] = 0.0
    w[:, names_r0] = 0.0  # valid slots of weight 0 over the NaN row
    w *= valid
    return torch.from_numpy(x).to(dtype), w, names_r0.any(axis=1)


# (b, K, dtype): b of 1, 16 and 48, K of 8, 16 and 32, bf16 and f32, each at
# W = b*F a multiple of 128 (the JAX entry's v7 plan)
SAMPLE_CASES = [
    (1, 8, torch.float32, 128),
    (1, 32, torch.bfloat16, 128),
    (16, 16, torch.float32, 8),
    (16, 8, torch.bfloat16, 8),
    (48, 32, torch.float32, 8),
    (48, 16, torch.bfloat16, 8),
]


@pytest.mark.parametrize("b,k,dtype,f", SAMPLE_CASES)
def test_sample_major_matches_jax_interpret(b, k, dtype, f):
    """The sample-major entry against JAX's ``batched_gather_sum`` in
    interpret mode on the slot-major copy of the same weights: rows of
    degree 0 are exact zeros, NaN in rows that no valid slot names never
    reaches the sum, and a valid slot of weight 0 over a NaN row keeps
    0 * NaN = NaN on both sides."""
    src, dst, eid = _edges(k, seed=300 + k)
    jt = jell.build_neighbor_table_edges(N, src, dst, eid, k=k)
    tt = tell.build_neighbor_table_edges(N, src, dst, eid, k=k, device="cpu")
    feats, w_bnk, named = _sample_inputs(tt, b, f, dtype, seed=b * k)
    jfeats = jnp.asarray(feats.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )
    want = np.asarray(j_batched_gather_sum(
        jt, None, jfeats, b=b, interpret=True, w_slot=jnp.asarray(w_bnk.transpose(1, 2, 0)),
    ))
    got = spmm_cuda.batched_gather_sum(tt, None, feats, b, w_sample=torch.from_numpy(w_bnk))
    assert got.dtype == torch.float32 and got.shape == (N, b * f)
    nan_rows = np.isnan(got.numpy()).any(axis=1)
    np.testing.assert_array_equal(nan_rows, named)  # 0 * NaN kept exactly there
    assert named.any() and np.isnan(got.numpy()[named]).all()
    deg0 = tt.deg.numpy() == 0
    assert deg0.sum() >= DEAD_ROWS and (got.numpy()[deg0] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)  # NaN where NaN
    # the slot-major entry on the same weights: the same plain sum, bit for bit
    again = spmm_cuda.batched_gather_sum(
        tt, None, feats, b, w_slot=torch.from_numpy(np.ascontiguousarray(w_bnk.transpose(1, 2, 0)))
    )
    torch.testing.assert_close(again, got, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("b,k", [(1, 8), (3, 16), (48, 32)])
def test_slot_transpose_plain(b, k):
    """[N, K, B] -> [B, N, K], a copy, exactly numpy's transpose."""
    w = np.random.default_rng(b + k).standard_normal((N, k, b)).astype(np.float32)
    got = spmm_cuda.slot_transpose(torch.from_numpy(w))
    assert got.is_contiguous() and got.shape == (b, N, k)
    np.testing.assert_array_equal(got.numpy(), w.transpose(2, 0, 1))
    with pytest.raises(ValueError):
        spmm_cuda.slot_transpose(torch.from_numpy(w[..., 0]))


def test_engine_feeds_its_coefficients_sample_major(monkeypatch):
    """The unrestricted edge forward hands layer 2 the layer-1 coefficients
    ``coeff [B, N, K]`` as they are made (the same storage, no [N, K, B]
    copy) through ``w_sample``."""
    rng = np.random.default_rng(5)
    n, e, b = 60, 240, 4
    feat = rng.standard_normal((n, 84)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    graph = from_arrays(feat, ei, device="cpu")
    model = GCNNodeModel(84, conv_channels=(16, 16), fc_channels=(16,))
    engine = fast_gcn.FastBatchedGCN(model, graph, mode="ell", restrict=False, device="cpu")
    masks = torch.from_numpy(rng.random((b, graph.e_pad)) > 0.3)
    seen, coeffs = [], []
    real_coeffs = engine._coeffs

    def coeffs_spy(m, is_edge):
        out = real_coeffs(m, is_edge)
        coeffs.append(out[0])
        return out

    def gather_spy(ew, feats, bb, *, table, w_slot=None, w_sample=None):
        seen.append((ew, w_slot, w_sample))
        return tspmm.weighted_gather_sum_batched(ew, feats, bb, table=table, w_slot=w_slot,
                                                 w_sample=w_sample)

    monkeypatch.setattr(engine, "_coeffs", coeffs_spy)
    monkeypatch.setattr(fast_gcn, "weighted_gather_sum_batched", gather_spy)
    engine.batch_node_outputs(masks, is_edge=True)
    assert len(seen) == 1 and len(coeffs) == 1
    ew, w_slot, w_sample = seen[0]
    assert ew is None and w_slot is None
    assert w_sample.shape == (b, graph.n_pad, engine.table.k)
    assert w_sample.data_ptr() == coeffs[0].data_ptr()
