"""PyTorch port: the host side of kernels 2.6/2.7's band walk
(``ops/spmm_cuda.py``): the band and grid plan, which weights take it, and
the argument list of the C function.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against its plain version; here the plan it is launched with is checked at
the ladder's production shape and at the shapes of its edge cases.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

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
