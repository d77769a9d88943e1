"""PyTorch port: the ELL SpMM entry ``spmm_ell`` and its schedule routes
(kernels 2.3-2.8), the broadcast route of ``batched_gather_sum`` and the
table route of ``weighted_gather_sum``.

On the CPU every route runs its kernel's plain PyTorch version; that is
what is held here against the JAX package's ``spmm_ell_pallas`` in
interpret mode (same seeded numpy table; the JAX side's DMA plans and
blocked static weights are built from it) and against a float64 numpy
loop.  The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.  JAX's v5 schedule fails in interpret mode at K = 8 (its
16-slot zero-store class does not fit), so it is compared at K >= 16 only.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bikg_graph_explainability_public_tpu as px
from bikg_graph_explainability_public_tpu.ops import ell as jell
from bikg_graph_explainability_public_tpu.ops import spmm as jspmm
from bikg_graph_explainability_public_tpu.ops import spmm_pallas as jsp
from bikg_graph_explainability_public_tpu_torch import graph as tgraph
from bikg_graph_explainability_public_tpu_torch.ops import ell as tell
from bikg_graph_explainability_public_tpu_torch.ops import spmm as tspmm
from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda

#: float32 sums in another order only (each term is one product)
TOL = dict(rtol=1e-5, atol=1e-5)

N, DEAD_ROWS, DEAD_SRCS = 40, 4, 3
#: which plan family each JAX schedule reads
PLAN_MODE = {"v3": "v3", "fused": "v3", "v6": "v3", "v5": "v5", "v7": "v7"}


def _tables(k, seed, n=N):
    """The same random table on both sides: the last DEAD_ROWS rows receive
    no edge (degree 0), the last DEAD_SRCS rows are never a source, no row
    overflows K."""
    rng = np.random.default_rng(seed)
    e = n * k // 2
    src = rng.integers(0, n - DEAD_SRCS, e)
    dst = rng.integers(0, n - DEAD_ROWS, e)
    keep = (src != dst) & (np.bincount(dst, minlength=n)[dst] <= k)
    src, dst = src[keep], dst[keep]
    eid = np.arange(src.size, dtype=np.int32)
    jt = jell.build_neighbor_table_edges(n, src, dst, eid, k=k)
    tt = tell.build_neighbor_table_edges(n, src, dst, eid, k=k, device="cpu")
    return jt, tt


def _feats(n, w, seed, nan_rows=True):
    x = np.random.default_rng(seed).standard_normal((n, w)).astype(np.float32)
    if nan_rows:
        x[n - DEAD_SRCS:] = np.nan  # rows that no valid slot names
    return x


def _weights(tt, mode, b, seed):
    """Slot weights of one mode, zero on invalid slots: ``static`` [N, K],
    ``broadcast`` [N, K, 1], ``per_sample`` [N, K, b]; a third of the
    weighted modes' valid slots weigh exactly 0 (masked edges)."""
    rng = np.random.default_rng(seed)
    valid = tt.valid.numpy()
    wb = {"static": 1, "broadcast": 1, "per_sample": b}[mode]
    w = rng.standard_normal(valid.shape + (wb,)).astype(np.float32)
    if mode != "static":
        w[rng.random(w.shape) < 1 / 3] = 0.0
    w *= valid[:, :, None]
    return w[:, :, 0] if mode == "static" else w


def _blocked(w2, tr):
    """[N, K] static weights in the JAX MXU mode's [NB, TR*K] layout."""
    n, k = w2.shape
    out = np.zeros((-(-n // tr) * tr, k), np.float32)
    out[:n] = w2
    return out.reshape(-1, tr * k)


def _jax_spmm(jt, w_slot, feats, b, sched, post_scale=None):
    """``spmm_ell_pallas`` in interpret mode with the plan of ``sched``."""
    nbr, valid = np.asarray(jt.nbr), np.asarray(jt.valid)
    tr = jsp._pick_tr(jt.k, feats.shape[1] * feats.dtype.itemsize)
    plan = jsp.build_compact_plan(nbr, valid, tr, mode=PLAN_MODE[sched])
    w = jnp.asarray(_blocked(w_slot, tr) if w_slot.ndim == 2 else w_slot)
    out = jsp.spmm_ell_pallas(
        plan.src, plan.dst, plan.cnt, w, jnp.asarray(feats), k=jt.k, tr=tr, b=b,
        n=nbr.shape[0], interpret=True, sched=sched,
        post_scale=None if post_scale is None else jnp.asarray(post_scale),
    )
    return np.asarray(out)


def _oracle(tt, w_slot, feats, b):
    """float64 loop over rows and valid slots: static weights multiply,
    ``[N, K, wb]`` weights select (a slot of weight 0 adds nothing);
    ``w_slot=None`` is the unweighted valid sum."""
    x = feats.astype(np.float64).reshape(feats.shape[0], b, -1)
    nbr, deg = tt.nbr.numpy(), tt.deg.numpy()
    n = nbr.shape[0]
    out = np.zeros((n,) + x.shape[1:])
    for v in range(n):
        for j in range(deg[v]):
            if w_slot is None:
                out[v] += x[nbr[v, j]]
            elif w_slot.ndim == 2:
                out[v] += w_slot[v, j] * x[nbr[v, j]]
            else:
                for s in range(b):
                    wt = w_slot[v, j, 0 if w_slot.shape[2] == 1 else s]
                    if wt != 0:
                        out[v, s] += wt * x[nbr[v, j], s]
    return out.reshape(n, -1)


# --- every schedule against the JAX entry (interpret mode) ------------------


@pytest.mark.parametrize("sched,mode,k,dtype", [
    ("v3", "static", 8, np.float32),
    ("v3", "per_sample", 12, np.float32),
    ("v3", "broadcast", 16, np.float32),
    ("fused", "static", 12, np.float32),
    ("fused", "per_sample", 8, np.float32),
    ("fused", "broadcast", 8, jnp.bfloat16),
])
def test_weighted_schedules_match_jax(sched, mode, k, dtype):
    """Kernels 2.6 (v3) and 2.7 (fused), W = b*F = 128."""
    b, f = 4, 32
    jt, tt = _tables(k, seed=k)
    feats = _feats(N, b * f, seed=k + 1)
    w_slot = _weights(tt, mode, b, seed=k + 2)
    jfeats = jnp.asarray(feats).astype(dtype)
    want = _jax_spmm(jt, w_slot, np.asarray(jfeats), b, sched)
    tfeats = torch.from_numpy(np.asarray(jfeats.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        tfeats = tfeats.to(torch.bfloat16)
    got = spmm_cuda.spmm_ell(tt, torch.from_numpy(w_slot), tfeats, b, sched=sched)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sched,k", [("v6", 12), ("v5", 16), ("v5", 24)])
def test_valid_sum_schedules_match_jax(sched, k):
    """Kernels 2.5 (v6) and 2.8 (v5): the static weights are the table's
    validity."""
    b, f = 2, 64
    jt, tt = _tables(k, seed=20 + k)
    feats = _feats(N, b * f, seed=k)
    want = _jax_spmm(jt, tt.valid.numpy(), feats, b, sched)
    got = spmm_cuda.spmm_ell(tt, tt.valid, torch.from_numpy(feats), b, sched=sched)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["static", "per_sample"])
def test_v7_schedule_matches_jax(mode):
    """Kernels 2.3 (static, with post_scale) and 2.4 (per-sample weights)."""
    b, f, k = 4, 32, 16
    jt, tt = _tables(k, seed=31)
    feats = _feats(N, b * f, seed=32)
    if mode == "static":
        ps = np.random.default_rng(33).standard_normal((N, b)).astype(np.float32)
        want = _jax_spmm(jt, tt.valid.numpy(), feats, b, "v7", post_scale=ps)
        got = spmm_cuda.spmm_ell(
            tt, tt.valid, torch.from_numpy(feats), b, sched="v7", post_scale=torch.from_numpy(ps)
        )
    else:
        w_slot = _weights(tt, mode, b, seed=34)
        want = _jax_spmm(jt, w_slot, feats, b, "v7")
        got = spmm_cuda.spmm_ell(tt, torch.from_numpy(w_slot), torch.from_numpy(feats), b, sched="v7")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_batched_gather_sum_broadcast_matches_jax():
    """``[N, K, 1]`` weights with b > 1: the JAX entry falls back to its v3
    schedule, the port to kernel 2.6."""
    b, f, k = 4, 32, 8
    jt, tt = _tables(k, seed=41)
    feats = _feats(N, b * f, seed=42)
    w_slot = _weights(tt, "broadcast", b, seed=43)
    want = np.asarray(jsp.batched_gather_sum(
        jt, None, jnp.asarray(feats), b, interpret=True, w_slot=jnp.asarray(w_slot)
    ))
    before = {s: kern.launches for s, kern in spmm_cuda.SPMM_ELL_WEIGHTED.items()}
    got = spmm_cuda.batched_gather_sum(tt, None, torch.from_numpy(feats), b, w_slot=torch.from_numpy(w_slot))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same from per-edge weights [E, 1]
    ew = np.zeros((int(tt.eid.max()) + 1, 1), np.float32)
    valid = tt.valid.numpy() > 0
    ew[tt.eid.numpy()[valid]] = w_slot[valid]
    again = spmm_cuda.batched_gather_sum(tt, torch.from_numpy(ew), torch.from_numpy(feats), b)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    # CPU tensors: the plain version, no launch
    assert {s: kern.launches for s, kern in spmm_cuda.SPMM_ELL_WEIGHTED.items()} == before


def test_weighted_gather_sum_table_route_matches_jax():
    """Scalar per-edge weights over [N, F] features through the table
    (kernel 2.4 at b = 1) plus the self-loop term; the graph keeps its
    self-loop data edges, which the table leaves out."""
    rng = np.random.default_rng(50)
    n, e, f = 48, 200, 512
    feat = rng.standard_normal((n, 6)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei[:, :5] = np.arange(5)  # five self-loops
    jg = px.from_arrays(feat, ei)
    tg = tgraph.from_arrays(feat, ei, device="cpu")
    jt, tt = jell.build_neighbor_table(jg), tell.build_neighbor_table(tg)
    x = rng.standard_normal((jg.n_pad, f)).astype(np.float32)
    ew = rng.random(jg.e_pad).astype(np.float32) * np.asarray(jg.edge_mask)
    want = np.asarray(jspmm.weighted_gather_sum(
        jnp.asarray(ew), jnp.asarray(x), jg.senders, jg.receivers, jg.n_pad,
        table=jt, backend="pallas",
    ))
    got = tspmm.weighted_gather_sum(
        torch.from_numpy(ew), torch.from_numpy(x), tg.senders, tg.receivers, tg.n_pad, table=tt
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the index_add route without the table
    plain = tspmm.weighted_gather_sum(
        torch.from_numpy(ew), torch.from_numpy(x), tg.senders, tg.receivers, tg.n_pad
    )
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


# --- the plain versions against a float64 numpy loop -----------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 12, 16, 32])
@pytest.mark.parametrize("b,f", [(1, 4), (16, 3), (48, 2)])
@pytest.mark.parametrize("mode", ["static", "broadcast", "per_sample"])
def test_weighted_plain_matches_oracle(mode, b, f, k, dtype):
    _, tt = _tables(k, seed=k + b, n=64)
    feats = torch.from_numpy(_feats(64, b * f, seed=b * k)).to(dtype)
    w_slot = _weights(tt, mode, b, seed=f + k)
    for sched in ("v3", "fused"):
        got = spmm_cuda.spmm_ell(tt, torch.from_numpy(w_slot), feats, b, sched=sched)
        assert got.dtype == torch.float32 and got.shape == (64, b * f)
        assert torch.isfinite(got).all()  # the NaN rows never reach the sum
        deg0 = tt.deg.numpy() == 0
        assert deg0.sum() >= DEAD_ROWS and (got.numpy()[deg0] == 0).all()
        np.testing.assert_allclose(got.numpy(), _oracle(tt, w_slot, feats.float().numpy(), b), **TOL)


@pytest.mark.parametrize("k", [8, 12, 32])
@pytest.mark.parametrize("b,f", [(1, 4), (16, 3), (48, 2)])
def test_valid_sum_plain_matches_oracle(b, f, k):
    _, tt = _tables(k, seed=60 + k, n=64)
    feats = torch.from_numpy(_feats(64, b * f, seed=b + f))
    want = _oracle(tt, None, feats.numpy(), b)
    for sched in ("v6", "v5", "v7"):
        got = spmm_cuda.spmm_ell(tt, tt.valid, feats, b, sched=sched)
        assert torch.isfinite(got).all()
        assert (got.numpy()[tt.deg.numpy() == 0] == 0).all()
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_zero_weight_over_a_nan_row_select_against_multiply():
    """A valid slot of weight 0 whose source row is NaN: the select modes
    (kernels 2.6/2.7, as the TPU's v3 and fused) add nothing; the static
    mode and kernel 2.4 (v7) multiply and give NaN, as JAX's v7 and XLA
    paths do."""
    b, f, k = 2, 4, 8
    _, tt = _tables(k, seed=70, n=64)
    feats = torch.from_numpy(_feats(64, b * f, seed=70, nan_rows=False))
    nan_src = int(tt.nbr[0, 0])
    feats[nan_src] = float("nan")
    named = ((tt.nbr == nan_src) & (tt.valid > 0)).any(dim=1)
    ones = tt.valid.clone()
    ones[tt.nbr == nan_src] = 0.0  # every slot naming the NaN row weighs 0
    for sched in ("v3", "fused"):
        got = spmm_cuda.spmm_ell(tt, ones[:, :, None].expand(-1, -1, b).contiguous(), feats, b, sched=sched)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(
            got, spmm_cuda.spmm_ell(tt, ones[:, :, None].contiguous(), feats, b, sched=sched)
        )
        static = spmm_cuda.spmm_ell(tt, ones, feats, b, sched=sched)
        assert torch.isnan(static[named]).all() and torch.isfinite(static[~named]).all()
    v7 = spmm_cuda.spmm_ell(tt, ones[:, :, None].expand(-1, -1, b).contiguous(), feats, b, sched="v7")
    assert torch.isnan(v7[named]).all() and torch.isfinite(v7[~named]).all()


@pytest.mark.parametrize("sched", spmm_cuda.SCHEDS)
def test_routes_are_the_plain_versions_on_the_cpu(sched):
    """Each route of the entry is the plain version of the kernel it names."""
    b, f, k = 4, 6, 16
    _, tt = _tables(k, seed=80, n=64)
    feats = torch.from_numpy(_feats(64, b * f, seed=81))
    got = spmm_cuda.spmm_ell(tt, tt.valid, feats, b, sched=sched)
    torch.testing.assert_close(got, spmm_cuda.gather_sum_static_plain(tt, feats, b), rtol=0, atol=0)
    if sched in ("v5", "v6"):
        return
    w_slot = torch.from_numpy(_weights(tt, "per_sample", b, seed=82))
    got = spmm_cuda.spmm_ell(tt, w_slot, feats, b, sched=sched)
    plain = spmm_cuda.batched_gather_sum_plain if sched == "v7" else spmm_cuda.spmm_ell_weighted_plain
    want = plain(tt, feats, b, w_slot) if sched == "v7" else plain(tt, w_slot, feats, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- refusals and departures ------------------------------------------------


@pytest.mark.parametrize("sched", ["v3", "fused", "v5", "v6"])
def test_post_scale_only_with_v7(sched):
    """The JAX entry ignores post_scale outside v7; the port refuses it."""
    _, tt = _tables(8, seed=90, n=64)
    feats = torch.zeros((64, 8))
    with pytest.raises(ValueError, match="post_scale"):
        spmm_cuda.spmm_ell(tt, tt.valid, feats, 2, sched=sched, post_scale=torch.ones((64, 2)))


def test_entry_refuses_what_the_schedules_do_not_serve():
    _, tt = _tables(8, seed=91, n=64)
    feats = torch.zeros((64, 8))
    per_sample = torch.zeros((64, 8, 2))
    for sched in ("v5", "v6"):  # static mode only, as in JAX
        with pytest.raises(ValueError, match="static mode only"):
            spmm_cuda.spmm_ell(tt, per_sample, feats, 2, sched=sched)
    with pytest.raises(ValueError, match="per-sample"):  # v7 weighted needs wb == b
        spmm_cuda.spmm_ell(tt, torch.zeros((64, 8, 1)), feats, 2, sched="v7")
    for sched in ("v5", "v6", "v7"):  # static weights must be the validity
        with pytest.raises(ValueError, match="validity"):
            spmm_cuda.spmm_ell(tt, tt.valid * 2.0, feats, 2, sched=sched)
    with pytest.raises(ValueError, match="unknown sched"):
        spmm_cuda.spmm_ell(tt, tt.valid, feats, 2, sched="v4")
    with pytest.raises(ValueError):  # 3 weights per slot with b = 2
        spmm_cuda.spmm_ell(tt, torch.zeros((64, 8, 3)), feats, 2, sched="v3")
    with pytest.raises(ValueError):  # [N, K, 1, 1]
        spmm_cuda.spmm_ell(tt, torch.zeros((64, 8, 1, 1)), feats, 2, sched="v3")
    with pytest.raises(ValueError):  # float64 weights
        spmm_cuda.spmm_ell(tt, torch.zeros((64, 8), dtype=torch.float64), feats, 2, sched="v3")
    with pytest.raises(ValueError):
        spmm_cuda.ell_valid_sum(tt, feats, 2, sched="v3")
    with pytest.raises(ValueError):
        spmm_cuda.spmm_ell_weighted(tt, tt.valid, feats, 2, sched="v6")


@pytest.mark.parametrize("sched,mode", [("v3", "per_sample"), ("fused", "static"), ("v6", "valid")])
def test_table_with_interior_holes_is_refused(sched, mode):
    """Departure: JAX's v3 weighted mode sums any slot pattern; the port's
    kernels read the valid-prefix length ``deg`` and refuse a table whose
    valid slots are not a per-row prefix (every table the port builds is)."""
    _, tt = _tables(8, seed=92, n=64)
    valid = tt.valid.clone()
    row = int(np.nonzero(tt.deg.numpy() >= 2)[0][0])
    valid[row, 0] = 0.0  # a valid slot now follows an invalid one
    holed = tell.NeighborTable(nbr=tt.nbr, valid=valid, eid=tt.eid)
    w_slot = {"per_sample": torch.zeros((64, 8, 2)), "static": valid, "valid": valid}[mode]
    with pytest.raises(ValueError, match="prefix"):
        spmm_cuda.spmm_ell(holed, w_slot, torch.zeros((64, 8)), 2, sched=sched)


def test_cpu_tensors_never_build_or_launch_the_kernels():
    _, tt = _tables(8, seed=93, n=64)
    kernels = list(spmm_cuda.ELL_VALID_SUM.values()) + list(spmm_cuda.SPMM_ELL_WEIGHTED.values())
    before = [kern.launches for kern in kernels]
    feats = torch.ones((64, 8))
    for sched in spmm_cuda.SCHEDS:
        spmm_cuda.spmm_ell(tt, tt.valid, feats, 2, sched=sched)
    spmm_cuda.spmm_ell(tt, torch.ones((64, 8, 1)) * tt.valid[:, :, None], feats, 2, sched="fused")
    assert [kern.launches for kern in kernels] == before
    assert not spmm_cuda.SPMM_ELL_WEIGHTED["v3"].library.built
    assert not spmm_cuda.ELL_VALID_SUM["v6"].library.built
    # one CUDA function each, counted per schedule
    assert spmm_cuda.ELL_VALID_SUM["v6"] is not spmm_cuda.ELL_VALID_SUM["v5"]
    assert spmm_cuda.ELL_VALID_SUM["v6"].symbol == spmm_cuda.ELL_VALID_SUM["v5"].symbol
    assert spmm_cuda.ELL_VALID_SUM["v6"].library is spmm_cuda.GATHER_SUM_STATIC.library
