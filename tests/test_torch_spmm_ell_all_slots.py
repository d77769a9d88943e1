"""PyTorch port: kernel 2.9, the ELL prototype's all-slot sum
(``ops/spmm_cuda.py::spmm_ell_all_slots``, ``ops/csrc/spmm_ell_all_slots.cu``).

On the card the entry runs two launches: the flag pass ``nonfinite_rows``
and the band walk's guarded select (``kGuard`` in ``ops/csrc/ell_band.cuh``),
which sums a slot only where its weight is non-zero or its source row holds
a non-finite value, compacting each row's taken slots with one warp ballot
per 32 staged slots.  Neither runs here; these tests hold, on the CPU:

* the exactness argument: a plain model of the guarded select (the slots it
  takes, in slot order) equals the multiply of every slot bit for bit, NaN
  where NaN, on finite and non-finite inputs;
* the flag pass's bit test (exponent bits all set) against ``isfinite``;
* a numpy model of the ballot compaction against a per-row compaction, and
  two mutations of it that must fail;
* the plan and the argument lists the wrappers pass to the C functions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

#: an H100's SMs
SMS = 132

CASES = ["finite", "row0_inf_ninf_nan", "nan_behind_interior_zero", "zero_row_on_nan",
         "negative_zero_weights"]


def _inputs(case: str, n=300, k=16, f=24, seed=0):
    """The prototype's form: each row a random number of weighted slots in
    front (a tenth of them zero-weight), then padding ``nbr = 0, wk = 0``;
    ``case`` adds the non-finite
    values (or ``-0.0`` weights).  Returns numpy (nbr, wk, x)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, n)
    front = np.arange(k)[None, :] < deg[:, None]
    nbr = np.where(front, rng.integers(1, n - 1, (n, k)), 0).astype(np.int32)
    wk = np.where(front, rng.normal(size=(n, k)), 0.0).astype(np.float32)
    wk[front & (rng.random((n, k)) < 0.1)] = 0.0  # interior zeros
    x = rng.normal(size=(n, f)).astype(np.float32)
    if case == "row0_inf_ninf_nan":
        x[0, :3] = [np.inf, -np.inf, np.nan]
    elif case == "nan_behind_interior_zero":
        v = int(np.flatnonzero(deg >= 3)[0])
        nbr[v, 1], wk[v, 1] = n - 1, 0.0  # row n - 1: no other slot names it
        x[n - 1, 5] = np.nan
    elif case == "zero_row_on_nan":
        v = int(np.flatnonzero(deg >= 2)[0])
        nbr[v, : deg[v]], wk[v, :] = n - 1, 0.0  # every weight 0, the front on the NaN row
        x[n - 1, 7] = np.nan
    elif case == "negative_zero_weights":
        wk[~front] = -0.0
        wk[front & (rng.random((n, k)) < 0.2)] = -0.0
        x[0, 1] = np.inf
    return nbr, wk, x


def _formula(nbr, wk, x):
    """The prototype's sum over all K slots in float64."""
    with np.errstate(invalid="ignore"):
        return (wk[:, :, None].astype(np.float64) * x[nbr].astype(np.float64)).sum(axis=1)


def guarded_select(nbr: torch.Tensor, wk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The walk's guarded select in plain PyTorch: in slot order, a slot adds
    ``w * x`` where its weight is non-zero or its source row holds a
    non-finite value; every other slot is skipped (not summed)."""
    bad = sc.nonfinite_rows_plain(x).bool()
    acc = torch.zeros((nbr.shape[0], x.shape[1]), dtype=torch.float32)
    for j in range(nbr.shape[1]):
        u = nbr[:, j].long()
        take = (wk[:, j] != 0) | bad[u]
        acc = torch.where(take[:, None], acc + wk[:, j, None] * x[u].float(), acc)
    return acc


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit as 2.9 means it: NaN at the same places, ``torch.equal``
    elsewhere (zeros of either sign equal)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guarded_select_is_the_multiply_bit_for_bit(case, dtype):
    """Skipping exactly the zero-weight slots over finite rows leaves the
    all-slot multiply (the plain version, ``0 * NaN`` kept) unchanged, bit
    for bit, NaN where NaN; and the entry's NaN entries are the float64
    formula's."""
    nbr, wk, x = _inputs(case)
    nbr_t, wk_t = torch.from_numpy(nbr), torch.from_numpy(wk)
    x_t = torch.from_numpy(x).to(dtype)
    table = sc.all_slots_table(nbr_t)
    multiply = sc.spmm_ell_weighted_plain(table, wk_t, x_t, 1)
    model = guarded_select(nbr_t, wk_t, x_t)
    assert _same(model, multiply)
    skipped = (wk == 0) & ~sc.nonfinite_rows_plain(x_t).numpy().astype(bool)[nbr]
    assert skipped.any()  # the model does skip slots
    want = _formula(nbr, wk, x_t.float().numpy())
    got = sc.spmm_ell_all_slots(nbr_t, wk_t, x_t, table=table).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if case != "finite":
        assert np.isnan(want).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nonfinite_rows_bit_test(dtype):
    """The flag pass's test, exponent bits all set (0x7f800000 for float32,
    0x7f80 for bfloat16), read in numpy on the raw bits of special values,
    is ``~isfinite``; the plain version flags the rows that hold one."""
    vals = [0.0, -0.0, 1.0, -2.5, 1e-40, -1e-45, 3.0e38, -3.0e38, float("inf"), float("-inf"),
            float("nan")]
    t = torch.tensor(vals, dtype=torch.float32).to(dtype)
    if dtype == torch.float32:
        bits = t.view(torch.int32).numpy().astype(np.uint32)
        test = (bits & 0x7F800000) == 0x7F800000
    else:
        bits = t.view(torch.int16).numpy().astype(np.uint16)
        test = (bits & 0x7F80) == 0x7F80
    np.testing.assert_array_equal(test, ~torch.isfinite(t).numpy())
    x = torch.zeros((len(vals), 5), dtype=dtype)
    x[:, 3] = t
    np.testing.assert_array_equal(sc.nonfinite_rows(x).numpy(), test.astype(np.uint8))
    assert sc.nonfinite_rows(x).dtype == torch.uint8


def _ballot_compaction(take, kt, nrows, carry_run=True, lane_rank=True):
    """The warp's compaction of one staged tile in numpy, as the kernel runs
    it: ``take [512]`` over staged positions ``i = lane + 32 t`` (row
    ``i // kt``); per step t one ballot; each lane's ``run`` restarts where a
    row's run starts (``off == 0``), a taken lane is stored at its row's base
    plus ``guard_place``'s rank, and the row's count is written where its run
    ends.  ``carry_run`` / ``lane_rank`` False are mutations."""
    staged = np.full(512, -1)
    cnt = np.full(nrows, -1)
    run = np.zeros(32, np.int64)
    for t in range(16):
        bal = sum(1 << lane for lane in range(32) if take[lane + 32 * t])
        for lane in range(32):
            i = lane + 32 * t
            g0 = lane & ~(kt - 1) if kt < 32 else 0
            off = 0 if kt < 32 else (32 * t) & (kt - 1)
            if off == 0 or not carry_run:
                run[lane] = 0
            m = bal & (((1 << kt) - 1) << g0) if kt < 32 else bal
            below = m & ((1 << (lane if lane_rank else g0)) - 1)
            rank, total = run[lane] + bin(below).count("1"), run[lane] + bin(m).count("1")
            r = i // kt
            if take[i]:
                staged[r * kt + rank] = i - r * kt
            if lane == g0 and off + 32 >= kt and r < nrows:
                cnt[r] = total
            run[lane] = total
    return staged, cnt


@pytest.mark.parametrize("rows", [256, 128, 32, 16, 8, 1, 160, 96])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_ballot_compaction_keeps_the_taken_slots_in_order(rows, density):
    """For every power-of-two tile the guarded walk can stage (kt = the
    power of two at or below 512 / rows), the ballot compaction puts each
    row's taken slots, in slot order, at the front of its run and their
    count in ``cnt``; dropping the count carried across ballots (kt > 32)
    or a lane's place among the lanes below it fails."""
    kt = 1 << (512 // rows).bit_length() - 1
    nrows = min(rows, 512 // kt)
    assert kt & (kt - 1) == 0 and rows * kt <= 512
    rng = np.random.default_rng(rows)
    take = np.zeros(512, bool)
    take[: nrows * kt] = rng.random(nrows * kt) < density
    take[: nrows * kt : 7] |= density > 0  # some taken slot in most rows
    staged, cnt = _ballot_compaction(take, kt, nrows)
    for r in range(nrows):
        want = np.flatnonzero(take[r * kt:(r + 1) * kt])
        assert cnt[r] == len(want)
        np.testing.assert_array_equal(staged[r * kt:r * kt + cnt[r]], want)
    if 0 < density < 1:
        wrong = _ballot_compaction(take, kt, nrows, lane_rank=False)
        assert not np.array_equal(wrong[0], staged)
        if kt > 32:
            wrong = _ballot_compaction(take, kt, nrows, carry_run=False)
            assert not np.array_equal(wrong[1], cnt)


# (N, F, dtype, vec): the prototype's shape, bf16, scalar lanes (F = 3, and
# F = 96 misaligned), a ragged band (F = 96), the widest band's rows
GUARD_SHAPES = [
    (100_000, 128, torch.float32, 4),
    (5000, 128, torch.bfloat16, 8),
    (5000, 3, torch.float32, 1),
    (5000, 3, torch.bfloat16, 1),
    (5000, 96, torch.float32, 4),
    (5000, 96, torch.float32, 1),
]


@pytest.mark.parametrize("n,f,dtype,vec", GUARD_SHAPES)
def test_guard_plan(n, f, dtype, vec):
    """The guarded walk's plan: at most :data:`GUARD_MAX_ROWS` rows an item
    (the kernel keeps their counts in the upper half of the warp's degree
    slots); its tile is the power of two at or below 512 / rows; at the
    prototype's shape two 64-column bands of 32 rows, 16 slots a tile, so
    a row's K = 32 slots take two tiles."""
    plan = sc.band_plan(n, f, dtype.itemsize, vec, SMS, max_rows=sc.GUARD_MAX_ROWS)
    assert 1 <= plan.rows <= sc.GUARD_MAX_ROWS == sc.BAND_MAX_ROWS // 2
    kt = 1 << (512 // plan.rows).bit_length() - 1
    assert 1 <= kt and plan.rows * kt <= 512
    if n == 100_000:
        assert (plan.band, plan.rows, kt, -(-f // plan.band)) == (64, 32, 16, 2)
    # without the cap the scalar lanes' items would exceed it
    if vec == 1 and f == 3:
        assert sc.band_plan(n, f, dtype.itemsize, vec, SMS).rows > sc.GUARD_MAX_ROWS


def _check_types(args, argtypes):
    assert len(args) == len(argtypes)
    bits = {ctypes.c_int: 32, ctypes.c_int64: 64}
    for i, (arg, ctype) in enumerate(zip(args, argtypes)):
        if ctype is ctypes.c_void_p:
            assert isinstance(arg, int) and 0 <= arg < 2**64, i
        else:
            half = 2 ** (bits[ctype] - 1)
            assert isinstance(arg, int) and -half <= arg < half, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,misalign", [(128, False), (3, False), (96, True)])
def test_guard_and_flag_args_match_the_c_signatures(dtype, f, misalign):
    """The argument lists of the walk and the flag pass have their C
    functions' lengths and, position by position, a value of its type; the
    flag pass takes 16-byte lanes only where F and the pointer allow."""
    n, k = 64, 8
    nbr = torch.from_numpy(np.random.default_rng(2).integers(0, n, (n, k)).astype(np.int32))
    table = sc.all_slots_table(nbr)
    wk = torch.ones((n, k))
    buf = torch.zeros(n * f + 1, dtype=dtype)
    x = buf[1:].view(n, f) if misalign else buf[:-1].view(n, f)
    bad = torch.zeros(n, dtype=torch.uint8)
    out = torch.empty((n, f))
    vec = 16 // dtype.itemsize
    vec = 1 if f % vec or x.data_ptr() % 16 else vec
    assert (vec == 1) == (f == 3 or misalign)
    plan = sc.band_plan(n, f, dtype.itemsize, vec, SMS, max_rows=sc.GUARD_MAX_ROWS)
    counter = torch.zeros(1, dtype=torch.int32)
    args = sc._guard_args(table, wk, x, bad, out, vec, plan, counter.data_ptr(), 0)
    _check_types(args, sc.SPMM_ELL_ALL_SLOTS.argtypes)
    assert args[:7] == (x.data_ptr(), 0 if dtype == torch.float32 else 1, nbr.data_ptr(),
                        table.deg.data_ptr(), wk.data_ptr(), bad.data_ptr(), out.data_ptr())
    assert args[7:] == (n, k, f, plan.band, plan.rows, plan.grid, counter.data_ptr(), vec, 0)
    flag = sc._flag_args(x, bad, 0)
    _check_types(flag, sc.NONFINITE_ROWS.argtypes)
    assert flag == (x.data_ptr(), args[1], bad.data_ptr(), n, f, vec, 0)
