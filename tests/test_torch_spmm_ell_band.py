"""PyTorch port: the host side of the band walk (``ops/spmm_cuda.py``) that
kernels 2.3, 2.4, 2.5, 2.8 and 2.6/2.7 (and 2.9 on 2.6's static mode) run:
the band and grid plan, which weights take it, the argument lists of the C
functions, and in numpy the walk's slot tiles and its sample-major weight
reads; and kernel 2.9's entry against the ELL prototype's formula.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against its plain version; here the plan it is launched with is checked at
the ladder's production shape and at the shapes of its edge cases.
"""

from __future__ import annotations

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from bikg_graph_explainability_public_tpu_torch.ops import cuda_build
from bikg_graph_explainability_public_tpu_torch.ops import ell as tell
from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

#: an H100's SMs
SMS = 132

# (n, b, f, dtype): the production shape, a ragged last band (W = 140), W
# narrower than one band, the scalar path (F = 3), and no rows
SHAPES = [
    (100_000, 50, 128, torch.float32),
    (100_000, 50, 128, torch.bfloat16),
    (5000, 7, 20, torch.float32),
    (5000, 1, 8, torch.float32),
    (5000, 1, 8, torch.bfloat16),
    (5000, 48, 3, torch.float32),
    (5000, 48, 3, torch.bfloat16),
    (0, 50, 128, torch.float32),
]


def _vec(f, dtype):
    """What the wrapper takes for aligned pointers."""
    vec = 16 // dtype.itemsize
    return vec if f % vec == 0 else 1


@pytest.mark.parametrize("n,b,f,dtype", SHAPES)
def test_band_plan_covers_the_width_once_within_the_l2_budget(n, b, f, dtype):
    w, size = b * f, dtype.itemsize
    vec = _vec(f, dtype)
    plan = sc.band_plan(n, w, size, vec, SMS)
    # the kernel's bands: [c, min(c + band, W)) for c = 0, band, 2 band, ...
    bands = [(c, min(c + plan.band, w)) for c in range(0, w, plan.band)]
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in bands])
    np.testing.assert_array_equal(covered, np.arange(w))  # [0, W) once, in order
    assert all(hi - lo <= plan.band for lo, hi in bands)
    assert n * plan.band * size <= sc.L2_BAND_BUDGET
    if vec > 1:  # 16-byte lanes start 16-byte aligned
        assert plan.band % vec == 0
        assert all(lo * size % 16 == 0 for lo, _ in bands)
    # the kernel's own checks: a row's lanes in one warp, an item's rows fit
    lanes = plan.band // vec
    assert 1 <= lanes <= 32
    assert plan.rows == min(32 // lanes * sc.BAND_PASSES, sc.BAND_MAX_ROWS)
    assert plan.items == -(-n // plan.rows) * len(bands)
    assert plan.items + plan.grid < 2**31
    assert plan.grid == min(plan.items, SMS * sc.BAND_BLOCKS_PER_SM)
    assert (plan.grid == 0) == (n == 0)


def test_band_plan_at_the_production_shape():
    """256 bytes of each row: 64 float32 columns (25.6 MB a band of the
    100k rows), 128 bfloat16 columns; W narrower than that takes W."""
    assert sc.band_plan(100_000, 6400, 4, 4, SMS).band == 64
    assert sc.band_plan(100_000, 6400, 2, 8, SMS).band == 128
    assert sc.band_plan(5000, 8, 4, 4, SMS).band == 8
    # a larger graph halves the band to stay within the budget
    assert sc.band_plan(400_000, 6400, 4, 4, SMS).band == 32
    # an explicit band (the sweep's) is taken as it is, or refused
    assert sc.band_plan(100_000, 6400, 4, 4, SMS, band=48).band == 48
    with pytest.raises(ValueError, match="band"):
        sc.band_plan(100_000, 6400, 4, 4, SMS, band=50)


def _table(n=64, k=8, seed=3):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, n * k // 2), rng.integers(0, n - 4, n * k // 2)
    keep = (src != dst) & (np.bincount(dst, minlength=n)[dst] <= k)
    src, dst = src[keep], dst[keep]
    return tell.build_neighbor_table_edges(
        n, src, dst, np.arange(src.size, dtype=np.int32), k=k, device="cpu"
    )


def _weights(table, mode, b, seed):
    rng = np.random.default_rng(seed)
    wb = b if mode == "per_sample" else 1
    w = rng.standard_normal(tuple(table.valid.shape) + (wb,)).astype(np.float32)
    if mode != "static":
        w[rng.random(w.shape) < 1 / 3] = 0.0
    w *= table.valid.numpy()[:, :, None]
    return torch.from_numpy(w[:, :, 0].copy() if mode == "static" else w)


@pytest.mark.parametrize("mode,b,band_walk", [
    ("static", 4, True),
    ("broadcast", 4, True),
    ("per_sample", 4, False),  # the row schedule: a band would read a sector per weight
    ("per_sample", 1, True),   # one sample: one weight per slot
])
def test_which_weights_take_the_band_walk(mode, b, band_walk):
    assert sc.uses_band_walk(_weights(_table(), mode, b, seed=4), b) is band_walk


@pytest.mark.parametrize("mode", ["static", "broadcast", "per_sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_args_match_the_c_signature(mode, dtype):
    """The argument list the wrapper passes has the C function's length
    and, position by position, a value of its type."""
    b, f = 4, 8
    table = _table()
    w_slot = _weights(table, mode, b, seed=8)
    feats = torch.zeros((64, b * f), dtype=dtype)
    out = torch.empty((64, b * f))
    vec = _vec(f, dtype)
    plan = sc.band_plan(64, b * f, feats.element_size(), vec, SMS)
    counter = torch.zeros(1, dtype=torch.int32)
    args = sc._weighted_args(table, w_slot, feats, out, b, vec, plan, counter.data_ptr(), 0)
    assert len(args) == len(sc._WEIGHTED_ARGS)
    bits = {ctypes.c_int: 32, ctypes.c_int64: 64}
    for i, (arg, ctype) in enumerate(zip(args, sc._WEIGHTED_ARGS)):
        if ctype is ctypes.c_void_p:
            assert arg is None or (isinstance(arg, int) and 0 <= arg < 2**64), i
        else:
            half = 2 ** (bits[ctype] - 1)
            assert isinstance(arg, int) and -half <= arg < half, i
    # the pointers and the plan where the C function reads them; the weights
    # go as the caller made them, no copy
    assert args[0] == feats.data_ptr() and args[5] == out.data_ptr()
    assert args[4] == w_slot.data_ptr()
    assert args[10] == (b if mode == "per_sample" else 1) and args[11] == int(mode != "static")
    assert args[12:15] == (plan.band, plan.rows, plan.grid) and args[15] == counter.data_ptr()
    assert args[16] == vec


# ---------------------------------------------------------------------------
# kernels 2.3, 2.5 and 2.8 (csrc/gather_sum_static.cu) on the same walk

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "int64_t": ctypes.c_int64}


def _c_declaration(source: str, symbol: str) -> list:
    """The ctypes of the parameters of ``extern "C" int symbol(...)`` in
    ``csrc/<source>``, read from the source text."""
    with open(os.path.join(cuda_build.CSRC, source)) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" {symbol} in {source}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return [_C_TYPES[p.rsplit(" ", 1)[0]] for p in params]


#: every kernel counter of the module, by the name chip_smoke.py gives it
KERNELS = {
    "gather_sum_static": sc.GATHER_SUM_STATIC,
    "ell_valid_sum.v6": sc.ELL_VALID_SUM["v6"],
    "ell_valid_sum.v5": sc.ELL_VALID_SUM["v5"],
    "batched_gather_sum": sc.BATCHED_GATHER_SUM,
    "batched_gather_sum.transpose": sc.SLOT_TRANSPOSE,
    "spmm_ell_weighted.v3": sc.SPMM_ELL_WEIGHTED["v3"],
    "spmm_ell_weighted.fused": sc.SPMM_ELL_WEIGHTED["fused"],
    "spmm_ell_all_slots": sc.SPMM_ELL_ALL_SLOTS,
    "nonfinite_rows": sc.NONFINITE_ROWS,
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_argtypes_match_the_c_declarations(name):
    """Each wrapper's ctypes list is its C function's parameter list, type
    by type (a 32-bit int where the C side takes a pointer or an int64_t
    would cut the value)."""
    kernel = KERNELS[name]
    source = os.path.basename(kernel.library.source)
    assert kernel.argtypes == _c_declaration(source, kernel.symbol)


@pytest.mark.parametrize("kernel,scaled", [
    ("gather_sum_static", True),
    ("gather_sum_static", False),
    ("v6", False),
    ("v5", False),
    ("batched_gather_sum", True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_args_match_the_c_signature(kernel, scaled, dtype):
    """The argument list of kernels 2.3 (with and without ``post_scale``),
    2.4 (``w_bnk`` where 2.3 takes its scale), 2.5 and 2.8 has the C
    function's length and, position by position, a value of its type, with
    the band walk's plan and counter where the C function reads them."""
    k = {"gather_sum_static": sc.GATHER_SUM_STATIC,
         "batched_gather_sum": sc.BATCHED_GATHER_SUM}.get(kernel) or sc.ELL_VALID_SUM[kernel]
    b, f = 4, 8
    table = _table()
    feats = torch.zeros((64, b * f), dtype=dtype)
    out = torch.empty((64, b * f))
    if kernel == "batched_gather_sum":
        ps = torch.ones((b, 64, table.k))
    else:
        ps = torch.ones((64, b)) if scaled else None
    vec = _vec(f, dtype)
    plan = sc.band_plan(64, b * f, feats.element_size(), vec, SMS)
    counter = torch.zeros(1, dtype=torch.int32)
    args = sc._static_args(k, table, feats, out, b, ps, vec, plan, counter.data_ptr(), 0)
    assert len(args) == len(k.argtypes)
    bits = {ctypes.c_int: 32, ctypes.c_int64: 64}
    for i, (arg, ctype) in enumerate(zip(args, k.argtypes)):
        if ctype is ctypes.c_void_p:
            assert arg is None or (isinstance(arg, int) and 0 <= arg < 2**64), i
        else:
            half = 2 ** (bits[ctype] - 1)
            assert isinstance(arg, int) and -half <= arg < half, i
    assert args[:4] == (feats.data_ptr(), 0 if dtype == torch.float32 else 1,
                        table.nbr.data_ptr(), table.deg.data_ptr())
    if k.argtypes is sc._STATIC_ARGS:  # the scale's (or w_bnk's) pointer, null without one
        assert args[4] == (ps.data_ptr() if scaled else None)
        rest = args[5:]
    else:
        rest = args[4:]
    n, kk = table.nbr.shape
    assert rest == (out.data_ptr(), n, kk, b * f, f, plan.band, plan.rows, plan.grid,
                    counter.data_ptr(), vec, 0)


# (b, K, F, dtype): kernel 2.3's production shape, then the ladder's edge
# cases and the band walk's (a ragged last band, W narrower than a band,
# the scalar path) as chip_smoke.py draws them
STATIC_SHAPES = [
    (50, 32, 128, torch.float32),
    (50, 32, 128, torch.bfloat16),
    (1, 8, 128, torch.float32),
    (16, 12, 64, torch.float32),
    (48, 12, 8, torch.bfloat16),
    (48, 32, 6, torch.float32),
    (7, 16, 20, torch.float32),
    (7, 32, 20, torch.bfloat16),
    (1, 32, 8, torch.float32),
    (1, 16, 8, torch.bfloat16),
    (48, 32, 3, torch.float32),
    (48, 16, 3, torch.bfloat16),
]


@pytest.mark.parametrize("b,k,f,dtype", STATIC_SHAPES)
def test_static_band_plan(b, k, f, dtype):
    """The plan of kernels 2.3/2.5/2.8: 256 bytes of each row at the
    production shape (64 float32 / 128 bfloat16 columns, 32 rows an item,
    16 slots a tile, so rows of degree 17-32 take two tiles); everywhere an
    item's staged slots fit the warp's 512, and the scalar lanes of a band
    may span samples (each lane reads its own scale)."""
    n = 100_000 if b == 50 else 5000
    w, size = b * f, dtype.itemsize
    vec = _vec(f, dtype)
    plan = sc.band_plan(n, w, size, vec, SMS)
    if b == 50:
        assert (plan.band, plan.rows, plan.tile) == (256 // size, 32, 16)
        assert plan.tile < k  # the production table's rows above 16 slots take two tiles
    assert 1 <= plan.tile and plan.rows * plan.tile <= sc.BAND_WARP_STAGE
    assert plan.rows <= sc.BAND_MAX_ROWS
    lanes = plan.band // vec
    assert 1 <= lanes <= 32 and plan.band % vec == 0
    # 16-byte lanes lie in one sample: one scale per lane
    if vec > 1:
        assert f % vec == 0
    for c in range(0, w, plan.band):
        for lane in range(lanes):
            col = c + lane * vec
            if col < w:
                assert col // f == (col + vec - 1) // f


def _walk_model(table, feats, b, ps, tile, scale_each_tile=False):
    """The slot tiles of the walk in numpy: a row's sum is built ``tile``
    slots at a time, each tile adding to the partial sum the last one
    stored, and scaled in the row's last tile (or, with
    ``scale_each_tile``, wrongly in every tile)."""
    nbr, deg = table.nbr.numpy(), table.deg.numpy()
    x = feats.float().numpy()
    n, w = nbr.shape[0], x.shape[1]
    f = w // b
    scale = np.repeat(ps.numpy(), f, axis=1)  # [N, W]: post_scale[v, c // F]
    out = np.zeros((n, w), np.float32)
    for v in range(n):
        for j0 in range(0, max(int(deg[v]), 1), tile):
            acc = out[v].copy()
            for j in range(j0, min(int(deg[v]), j0 + tile)):
                acc += x[nbr[v, j]]
            if scale_each_tile or j0 + tile >= deg[v]:
                acc *= scale[v]
            out[v] = acc
    return out


@pytest.mark.parametrize("tile", [2, 3, 16])
def test_walk_scales_each_row_once_in_its_last_tile(tile):
    """Rows of degree above a tile: the walk's partial sums, scaled in the
    last tile only, give the plain version bit for bit; scaling every
    tile's store would not (the trap the kernel avoids)."""
    from bikg_graph_explainability_public_tpu_torch.ops.spmm_cuda import gather_sum_static_plain

    b, f = 3, 4
    table = _table(n=64, k=8, seed=5)
    deg = table.deg.numpy()
    assert (deg > tile).any() or tile == 16
    assert (deg == 0).any()
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(rng.standard_normal((64, b * f)).astype(np.float32))
    ps = torch.from_numpy(rng.standard_normal((64, b)).astype(np.float32) + 2.0)
    want = gather_sum_static_plain(table, feats, b, ps).numpy()
    np.testing.assert_array_equal(_walk_model(table, feats, b, ps, tile), want)
    if (deg > tile).any():
        wrong = _walk_model(table, feats, b, ps, tile, scale_each_tile=True)
        assert not np.allclose(wrong[deg > tile], want[deg > tile])


# ---------------------------------------------------------------------------
# kernel 2.4 (csrc/batched_gather_sum.cu) on the walk: sample-major weights


def _sample_walk_model(table, feats, b, w_bnk, band, vec, fixed_sample=None):
    """The walk's weight reads under ``kSample`` in numpy: for each band
    [c0, c0 + band) and each lane's ``vec`` columns at ``col``, the lane sums
    its row's valid slots in order with the weights of sample ``s``, read at
    the flat offset ``s * N * K + v * K + j`` of ``w_bnk``: ``s = c0 // F``
    (the item's staged run) where the band lies in one sample, else the
    lane's own ``col // F``.  ``fixed_sample`` forces ``s`` (a mutation)."""
    nbr, deg = table.nbr.numpy(), table.deg.numpy()
    x = feats.float().numpy()
    n, k = nbr.shape
    w = x.shape[1]
    f = w // b
    flat = w_bnk.numpy().reshape(-1)
    out = np.zeros((n, w), np.float32)
    for c0 in range(0, w, band):
        staged = c0 // f == (min(c0 + band, w) - 1) // f
        for col in range(c0, min(c0 + band, w), vec):
            s = c0 // f if staged else col // f
            if fixed_sample is not None:
                s = fixed_sample
            ws = flat[s * n * k:(s + 1) * n * k].reshape(n, k)
            acc = np.zeros((n, vec), np.float32)
            for j in range(k):
                take = j < deg
                # float32: the product rounded, then the sum, as the kernel
                acc[take] = acc[take] + ws[take, j, None] * x[nbr[take, j], col:col + vec]
            out[:, col:col + vec] = acc
    return out


# (b, F, dtype): bands that span samples (F below the band, or above it and
# not a multiple of it), scalar lanes (F = 3), and bands within one sample
SAMPLE_SHAPES = [
    (7, 20, torch.float32),
    (48, 3, torch.float32),
    (2, 96, torch.float32),
    (16, 8, torch.bfloat16),
    (3, 24, torch.bfloat16),
    (3, 128, torch.float32),
]


@pytest.mark.parametrize("b,f,dtype", SAMPLE_SHAPES)
def test_sample_major_walk_reads_each_lanes_sample(b, f, dtype):
    """At the band and lane width the wrapper would launch with, the model
    of the walk's sample-major weight reads gives the plain version bit for
    bit; reading sample 0's weights everywhere (the per-band offset
    ``s * N * K`` dropped) does not."""
    n = 64
    table = _table(n=n, k=8, seed=7)
    rng = np.random.default_rng(b * f)
    feats = torch.from_numpy(rng.standard_normal((n, b * f)).astype(np.float32)).to(dtype)
    w_bnk = torch.from_numpy(rng.standard_normal((b, n, 8)).astype(np.float32)) * table.valid
    vec = _vec(f, dtype)
    plan = sc.band_plan(n, b * f, dtype.itemsize, vec, SMS)
    want = sc.batched_gather_sum(table, None, feats, b, w_sample=w_bnk).numpy()
    np.testing.assert_array_equal(_sample_walk_model(table, feats, b, w_bnk, plan.band, vec), want)
    wrong = _sample_walk_model(table, feats, b, w_bnk, plan.band, vec, fixed_sample=0)
    assert not np.allclose(wrong, want)


# ---------------------------------------------------------------------------
# kernel 2.9: the ELL prototype's all-slot sum (the flag pass and the guarded
# walk on the card; tests/test_torch_spmm_ell_all_slots.py holds its parts)


def _build_ell(snd, rcv, w, n, k_round=8):
    """The prototype's table, as ``benchmarks/exp_spmm_kernels.py::build_ell``
    makes it: receiver-sorted edges, K the largest degree rounded up to
    ``k_round``, padded slots ``nbr = 0, wk = 0``."""
    deg = np.bincount(rcv, minlength=n)
    k = -(-int(deg.max()) // k_round) * k_round
    nbr = np.zeros((n, k), np.int32)
    wk = np.zeros((n, k), np.float32)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(rcv)) - starts[rcv]
    nbr[rcv, slot] = snd
    wk[rcv, slot] = w
    return nbr, wk, k


@pytest.mark.parametrize("n,e,f,case", [
    pytest.param(2000, 20000, 128, "finite", id="2000-20000-128"),
    pytest.param(500, 3000, 256, "finite", id="500-3000-256"),
    pytest.param(300, 600, 128, "finite", id="300-600-128"),
    pytest.param(300, 600, 128, "row0_inf_ninf_nan", id="300-600-128-row0_inf_ninf_nan"),
    pytest.param(300, 600, 128, "nan_behind_interior_zero",
                 id="300-600-128-nan_behind_interior_zero"),
    pytest.param(300, 600, 128, "zero_row_on_nan", id="300-600-128-zero_row_on_nan"),
    pytest.param(300, 600, 128, "negative_zero_weights", id="300-600-128-negative_zero_weights"),
    pytest.param(300, 600, 128, "finite_control", id="300-600-128-finite_control"),
])
def test_all_slots_matches_the_prototype_formula(n, e, f, case):
    """``spmm_ell_all_slots`` against ``out[v] = sum_k wk[v, k] *
    x[nbr[v, k]]`` over all K slots in float64, on the prototype's seeded
    inputs (the prototype takes no ``interpret`` flag, so its formula is the
    reference); the padded slots are summed too, so ``0 * Inf`` and
    ``0 * NaN`` give NaN.  The non-finite cases: +Inf, -Inf and NaN in row
    0, which only padded slots name; NaN in a row that only an interior
    zero-weight slot names; a row whose weights are all 0 and name a NaN
    row; ``-0.0`` weights (padding and interior) with Inf in row 0; and a
    finite control built the same way.  NaN where the formula has NaN, the
    rest within ``rtol/atol 1e-5``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, f)).astype(np.float32)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = np.sort(rng.integers(0, n, e).astype(np.int32))
    w = rng.random(e).astype(np.float32)
    nbr, wk, k = _build_ell(snd, rcv, w, n)
    assert (wk == 0).any()  # padded slots
    deg = (wk != 0).sum(axis=1)
    named = np.zeros(n, bool)
    named[nbr[wk != 0]] = True
    named[0] = True
    if case == "row0_inf_ninf_nan":
        x[0, :3] = [np.inf, -np.inf, np.nan]
    elif case == "nan_behind_interior_zero":
        v, u = int(np.flatnonzero(deg >= 3)[0]), int(np.flatnonzero(~named)[0])
        nbr[v, 1], wk[v, 1] = u, 0.0
        x[u, 5] = np.nan
    elif case == "zero_row_on_nan":
        v, u = int(np.flatnonzero(deg >= 2)[0]), int(np.flatnonzero(~named)[0])
        nbr[v, : deg[v]], wk[v] = u, 0.0
        x[u, 7] = np.nan
    elif case == "negative_zero_weights":
        wk[wk == 0] = -0.0
        wk[np.flatnonzero(deg >= 3), 1] = -0.0
        x[0, 1] = np.inf
    elif case == "finite_control":
        wk[np.flatnonzero(deg >= 3), 1] = 0.0
    with np.errstate(invalid="ignore"):
        want = (wk[:, :, None].astype(np.float64) * x[nbr].astype(np.float64)).sum(axis=1)
    got = sc.spmm_ell_all_slots(torch.from_numpy(nbr), torch.from_numpy(wk), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n, f)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
    assert nan.any() == (case not in ("finite", "finite_control"))  # -0.0 * Inf is NaN too
    np.testing.assert_allclose(got.numpy()[~nan], want[~nan], rtol=1e-5, atol=1e-5)
    if case == "nan_behind_interior_zero":
        assert np.argwhere(nan).tolist() == [[v, 5]]


def test_all_slots_table_and_refusals():
    """The table holds every slot valid (``deg = K``, no host check), and
    the entry refuses another table or weights of another shape; on the CPU
    it launches nothing."""
    nbr = torch.from_numpy(np.random.default_rng(1).integers(0, 40, (50, 8)).astype(np.int32))
    table = sc.all_slots_table(nbr)
    assert (table.deg == 8).all() and table.n_src == int(nbr.max()) + 1
    assert table.valid.shape == (50, 8) and (table.valid == 1).all()
    x, wk = torch.ones((40, 16)), torch.ones((50, 8))
    before = sc.SPMM_ELL_ALL_SLOTS.launches, sc.NONFINITE_ROWS.launches
    torch.testing.assert_close(sc.spmm_ell_all_slots(nbr, wk, x, table=table),
                               torch.full((50, 16), 8.0), rtol=0, atol=0)
    assert sc.nonfinite_rows(x).tolist() == [0] * 40
    assert (sc.SPMM_ELL_ALL_SLOTS.launches, sc.NONFINITE_ROWS.launches) == before
    with pytest.raises(ValueError):
        sc.spmm_ell_all_slots(nbr, wk, x, table=sc.all_slots_table(nbr.clone()))
    with pytest.raises(ValueError):
        sc.spmm_ell_all_slots(nbr, torch.ones((50, 7)), x)
    with pytest.raises(ValueError):  # fewer source rows than the slots name
        sc.spmm_ell_all_slots(nbr, wk, torch.ones((int(nbr.max()), 16)))
