#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``bikg_graph_explainability_public_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. header: card name and power limit, torch and CUDA versions; TF32 off;
2. build every hand-written CUDA kernel from the checkout's sources, one
   ``nvcc`` per source, all started together; print each kernel's
   registers and spills and the ``HGMMA`` (``wgmma``) count of the dense
   layers' library (``cuobjdump -sass``, where the toolkit or Triton has
   one);
3. each kernel against its plain PyTorch version on the card, with its
   time, the plain version's, a library call's and the least time the card
   could take: 2.3 and 2.4 (the ELL gather-sums) at the production shape
   (100k nodes / 1M edges, B=50, F=128, float32) and in the edge cases
   (2.3, 2.4, 2.5 and 2.8 run the band walk of ``ops/csrc/ell_band.cuh``,
   as 2.6/2.7 do with one weight per slot; the phase counts the production
   rows whose degree exceeds the walk's slot tile, which 2.3 scales in
   their last tile, and fails if there are none; 2.4 is held bit for bit
   through both of its weight layouts, sample-major as the engine makes
   them and slot-major through its tiled transpose, and timed in turns
   with the transpose alone and the engine's former permute);
   2.1 (with its operand launch) and 2.2 (the fused dense layers) at the
   bench's subgraph shape (2048 nodes / 16384 edges, B=250, C=128), each
   launch alone too, beside both bounds (A's nonzeros and the dense
   product) and cuBLAS (the product alone, and 2.2 like for like), then in
   seven edge cases (N = 37 to 4096);
   then the ELL SpMM entry ``spmm_ell`` and its schedule routes (the
   ladder: v7 on 2.3 and 2.4, v6 and v5 on 2.5 and 2.8, v3 and fused on 2.6
   and 2.7, with static, broadcast and per-sample weights; all but 2.6/2.7's
   per-sample mode on the band walk), the broadcast
   route of ``batched_gather_sum`` and the table route of
   ``weighted_gather_sum``, each route counted, held against its plain
   version and timed at the production shape; the L2 probe (kernel 2.6 on
   features 32, 64 and 128 columns wide, so that one band's gathers are
   served from L2); then every route held in the edge cases and in those of
   the band walk (a ragged last band, W narrower than a band, F = 3);
   then kernel 2.9 (``spmm_ell_all_slots``, the ELL prototype of the JAX
   package's benchmarks, on 2.6's static walk) at the prototype's run shape
   (100k / 1M, F = 128), counted, held against its plain version and the
   prototype's segment sum, and timed beside ``torch.sparse.mm``;
4. the node path: ``Explainer._explain`` (the arrays behind
   ``Explainer.run``) on ``node_prediction`` for the repo's trained 36-node
   fixture (Shapley and community mode) and for GCN-128x2 on a 20k-node /
   160k-edge graph (4 queries), checked against the same runs on the CPU
   (the first query of the 20k graph);
5. the edge path: the same on ``edge_prediction`` with one name per edge
   (receptive-field plans: no kernel launches);
6. the graph path: ``graph_prediction`` with GCN-128x2 on the 100k / 1M
   graph (ELL tier), counting kernel 2.3's launches; then the engine's
   set-up and forwards timed apart, the forwards profiled by operation,
   and one chunk of the engine compared with the same engine routed
   through the plain version;
7. the unrestricted ELL edge forward: 1000 edge masks through
   ``FastBatchedGCN(restrict=False)`` on the 100k / 1M graph, counting
   kernel 2.4's launches (the walk on the engine's sample-major
   coefficients, no slot transpose), timed, profiled and compared as in 6;
8. the fused dense forward: ``FastBatchedGCN(backend="pallas")`` against
   ``backend="xla"`` on the 2048 / 16384 graph, 1000 masks, counting the
   launches of kernels 2.1 (and its operand launch) and 2.2, and one
   chunk against the plain route;
9. the model families: the repo's trained GAT fixture explains the node,
   edge and graph problems, GAT-128x2 on the 20k / 160k graph 4 node and 4
   edge queries, GATv2, SAGE, GraphConv and GIN one node query each, all
   through the generic batched forward (no hand kernel), checked against
   the CPU.

Every path runs with all launch counts set to 0 just before it and read
just after.  The line before the last is ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "bikg_graph_explainability_public_tpu_torch"

#: H100 SXM device-memory rate, float32 (non-tensor-core) and dense bf16
#: tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: production shape of the ELL gather-sum (bench.py's "fullgraph" graph)
BIG_N, BIG_E, BIG_B, HIDDEN, N_FEATS = 100_000, 1_000_000, 50, 128, 84
NODE_N, NODE_E, NODE_QUERIES = 20_000, 160_000, 4
#: the bench's computational-subgraph shape (bench.py:55) and its chunk
SUB_N, SUB_E, SUB_B = 2048, 16384, 250
#: the unrestricted edge forward's query row (bench.py:577)
EDGE_QUERY = 17


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed with
    CUDA events after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_graph(n: int, e: int, seed: int):
    """``bench.py``'s random graph: N(0,1) features of width 84 and uniform
    random directed edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, N_FEATS)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)
    return feat, ei, rng


def gcn_128x2(seed: int, device):
    """GCN-128x2 (in 84, conv 128/128, fc 128/64/1) with seeded numpy
    weights, loaded through ``params_from_numpy``."""
    import numpy as np
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.checkpoint import params_from_numpy
    from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel

    rng = np.random.default_rng(seed)

    def dense(out_f, in_f):
        lim = np.sqrt(6.0 / (in_f + out_f))
        return {
            "weight": rng.uniform(-lim, lim, (out_f, in_f)).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, out_f).astype(np.float32),
        }

    tree = {
        "conv": [dense(HIDDEN, N_FEATS), dense(HIDDEN, HIDDEN)],
        "fc": [dense(64, HIDDEN), dense(1, 64)],
    }
    mdef = GCNNodeModel(N_FEATS, conv_channels=(HIDDEN, HIDDEN), fc_channels=(HIDDEN, 64))
    return Model(mdef, params_from_numpy(tree), device=device), tree


def phase_header() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(
        f"allow_tf32 before: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; both set to False"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from bikg_graph_explainability_public_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"build: {len(libs)} sources in {time.perf_counter() - t0:.2f} s wall")
    for lib in libs:
        log(f"build: {os.path.basename(lib.source)} in {lib.build_seconds:.2f} s")
        for line in ptxas_summary(lib.build_log):
            log(f"  {line}")
    sass_hgmma(cuda_build.library("masked_gcn_layer.cu"))


def _cuobjdump():
    """The toolkit's ``cuobjdump``, or Triton's bundled copy, or None."""
    import shutil

    found = shutil.which("cuobjdump")
    cands = [found] if found else []
    cands.append(os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"))
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.access(c, os.X_OK)), None)


def sass_hgmma(lib) -> None:
    """Count the ``HGMMA`` instructions (``wgmma`` in SASS) of each kernel of
    a built library; fails if the aggregation has none.  Without a
    ``cuobjdump`` it says so and checks nothing."""
    tool = _cuobjdump()
    if tool is None:
        log("HGMMA count: no cuobjdump (toolkit or Triton's copy) found; not checked")
        return
    sass = subprocess.run([tool, "-sass", lib._so_path()], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    for fn, k in counts.items():
        log(f"HGMMA count ({os.path.basename(tool)}): {k:5d} in {fn[-70:]}")
    agg = sum(k for fn, k in counts.items() if "masked_gcn_agg" in fn)
    if agg == 0:
        raise AssertionError("the aggregation kernel shows no HGMMA instruction")
    log(f"HGMMA count: {agg} in the aggregation kernels of {os.path.basename(lib.source)}")


def ptxas_summary(report: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: registers,
    shared memory and spills; and the compiler's warnings."""
    lines, name, spills = [], None, ""
    for line in report.splitlines():
        if "warning" in line:
            lines.append(line.strip()[-160:])
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name[-70:]}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return lines


def all_kernels():
    """Every kernel's launch counter, by name."""
    from bikg_graph_explainability_public_tpu_torch.ops import gcn_layer_cuda, spmm_cuda

    return {
        "gather_sum_static": spmm_cuda.GATHER_SUM_STATIC,
        "batched_gather_sum": spmm_cuda.BATCHED_GATHER_SUM,
        "batched_gather_sum.transpose": spmm_cuda.SLOT_TRANSPOSE,
        "masked_gcn_layer": gcn_layer_cuda.MASKED_GCN_LAYER,
        "masked_gcn_layer.operand": gcn_layer_cuda.OPERAND,
        "masked_gcn_layer_batched": gcn_layer_cuda.MASKED_GCN_LAYER_BATCHED,
        "masked_gcn_layer_batched.transform": gcn_layer_cuda.TRANSFORM,
        "ell_valid_sum.v6": spmm_cuda.ELL_VALID_SUM["v6"],
        "ell_valid_sum.v5": spmm_cuda.ELL_VALID_SUM["v5"],
        "spmm_ell_weighted.v3": spmm_cuda.SPMM_ELL_WEIGHTED["v3"],
        "spmm_ell_weighted.fused": spmm_cuda.SPMM_ELL_WEIGHTED["fused"],
        "spmm_ell_all_slots": spmm_cuda.SPMM_ELL_ALL_SLOTS,
    }


def reset_counts() -> None:
    for k in all_kernels().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


def _table(n, e, k, seed, device, *, dead_rows=0, dead_srcs=0):
    """Random neighbour table with ``n`` rows and ``k`` slots; the last
    ``dead_rows`` rows receive no edge and the last ``dead_srcs`` rows are
    never a source."""
    import numpy as np
    from bikg_graph_explainability_public_tpu_torch.ops.ell import build_neighbor_table_edges

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - dead_srcs, e)
    dst = rng.integers(0, n - dead_rows, e)
    keep = (src != dst) & (np.bincount(dst, minlength=n)[dst] <= k)
    src, dst = src[keep], dst[keep]
    return build_neighbor_table_edges(
        n, src, dst, np.arange(src.size, dtype=np.int32), k=k, device=device
    )


def check_kernel_case(table, b, f, dtype, scale, seed, label):
    """Kernel 2.3 against plain on one input; returns (max_abs_err, feats,
    ps, the band walk's plan, the rows of degree above its slot tile)."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc
    from bikg_graph_explainability_public_tpu_torch.ops.spmm_cuda import (
        gather_sum_static, gather_sum_static_plain,
    )

    dev = table.nbr.device
    n = table.nbr.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n, b * f), generator=gen, device=dev).to(dtype)
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    used[table.nbr[table.valid > 0]] = True
    feats[~used] = float("nan")  # rows no valid slot names
    ps = torch.randn((n, b), generator=gen, device=dev) if scale else None
    got = gather_sum_static(table, feats, b, post_scale=ps)
    want = gather_sum_static_plain(table, feats, b, post_scale=ps)
    err = hold_gather_sum(table, got, want, label)
    # the walk's plan for this call: rows of degree above its slot tile take
    # more than one tile and are scaled in the last
    _, plan = sc._plan(feats, got, b, None, sc.BAND_PASSES)
    above = int((table.deg > plan.tile).sum())
    log(
        f"kernel case {label}: N={n} K={table.k} b={b} F={f} {str(dtype)[6:]} "
        f"post_scale={scale} deg0_rows={int((table.deg == 0).sum())} "
        f"nan_rows={int((~used).sum())} band={plan.band} tile={plan.tile} "
        f"rows_above_tile={above} max_abs_err={err:.3e} ok"
    )
    return err, feats, ps, plan, above


def hold_gather_sum(table, got, want, label) -> float:
    """A gather-sum kernel's output against its plain version's: finite,
    exact zeros on rows of degree 0, and equal up to float32 summation order
    (bf16 inputs go to both sides alike); returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    deg0 = table.deg == 0
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    if deg0.any() and got[deg0].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: rows of degree 0 are not exact zeros")
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"{label}: kernel disagrees with plain, max abs err "
            f"{(got - want).abs().max().item():.3e}"
        )
    return (got - want).abs().max().item()


def phase_kernel(dev):
    """Kernel 2.3: production shape, then the edge cases; returns the
    kernel's record, the production graph and its table."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.ops.ell import build_neighbor_table
    from bikg_graph_explainability_public_tpu_torch.ops.spmm_cuda import (
        gather_sum_static, gather_sum_static_plain,
    )

    feat, ei, _ = random_graph(BIG_N, BIG_E, seed=0)
    t0 = time.perf_counter()
    graph = from_arrays(feat, ei, device=dev)
    table = build_neighbor_table(graph)
    deg = table.deg
    log(f"host: 100k/1M graph + neighbour table in {time.perf_counter() - t0:.2f} s (K={table.k})")
    err, feats, ps, plan, above = check_kernel_case(
        table, BIG_B, HIDDEN, torch.float32, True, 0, "production"
    )
    if above == 0:
        raise AssertionError(
            f"production table: no row of degree above the walk's {plan.tile}-slot tile, "
            "so the scale in a row's last tile is not exercised"
        )
    log(f"production table: {above} rows of degree above the {plan.tile}-slot tile "
        f"(max degree {int(deg.max())}); {plan.band}-column bands, {plan.rows} rows an item")

    ms = cuda_ms(lambda: gather_sum_static(table, feats, BIG_B, post_scale=ps), 20)
    plain_ms = cuda_ms(lambda: gather_sum_static_plain(table, feats, BIG_B, post_scale=ps), 3)
    # yardstick only: cuSPARSE through torch.sparse.mm on the 0/1 CSR
    # adjacency, then the post-scale; the port never calls it
    nbr, valid = table.nbr, table.valid > 0
    rows = torch.arange(BIG_N, device=dev)[:, None].expand_as(nbr)[valid]
    adj = torch.sparse_coo_tensor(
        torch.stack([rows, nbr[valid]]), torch.ones(rows.numel(), device=dev),
        (BIG_N, BIG_N),
    ).coalesce().to_sparse_csr()
    w = BIG_B * HIDDEN

    def library():
        out = torch.sparse.mm(adj, feats)
        return (out.view(BIG_N, BIG_B, HIDDEN) * ps[:, :, None]).view(BIG_N, w)

    lib_out = library()
    if not torch.allclose(lib_out, gather_sum_static_plain(table, feats, BIG_B, ps),
                          rtol=1e-4, atol=1e-4):
        raise AssertionError("library yardstick computes another function")
    del lib_out
    library_ms = cuda_ms(library, 5)

    # least bytes: each referenced feature row read once, each valid slot's
    # index once, deg and post_scale once, the output written once
    sum_deg = int(deg.sum())
    uniq_src = int(torch.unique(nbr[valid]).numel())
    bytes_min = uniq_src * w * 4 + sum_deg * 4 + BIG_N * 4 + BIG_N * BIG_B * 4 + BIG_N * w * 4
    ops = sum_deg * w + BIG_N * w  # one add per gathered element, one scale per output
    bound_ms = max(bytes_min / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_min / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    # what a gather design moves: every slot's source row once per edge
    gather_bytes = (sum_deg + BIG_N) * w * 4 + sum_deg * 4 + BIG_N * BIG_B * 4
    log(
        f"kernel timing at production shape: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
        f"{bytes_min / 1e9:.3f} GB) gather_bound_ms={gather_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
        f"({gather_bytes / 1e9:.3f} GB) effective_gather_GBps={gather_bytes / ms / 1e6:.1f}"
    )
    del feats, ps, adj

    cases = [  # (b, K, F, dtype, post_scale)
        (1, 8, 128, torch.float32, True),
        (1, 16, 128, torch.float32, False),
        (1, 32, 128, torch.bfloat16, True),
        (16, 8, 64, torch.float32, False),
        (16, 16, 64, torch.float32, True),
        (16, 16, 64, torch.bfloat16, True),
        (16, 32, 64, torch.float32, True),
        (48, 8, 6, torch.float32, True),
        (48, 16, 6, torch.bfloat16, False),
        (48, 32, 6, torch.float32, True),
        (48, 32, 8, torch.bfloat16, True),
    ]
    for i, (b, k, f, dtype, scale) in enumerate(cases):
        t = _table(5000, 5000 * k // 2, k, seed=10 + i, device=dev, dead_rows=300, dead_srcs=200)
        case_err, *_ = check_kernel_case(t, b, f, dtype, scale, 100 + i, f"edge{i}")
        err = max(err, case_err)
    return {
        "name": "gather_sum_static",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/gather_sum_static.cu",
        "replaces": "bikg_graph_explainability_public_tpu/ops/spmm_pallas.py:1074",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
        "band_columns": plan.band,
        "rows_above_tile": above,
    }, graph, table


def weighted_inputs(table, b, f, dtype, seed):
    """Kernel 2.4's inputs: features with NaN in the source rows that no
    valid slot names and in one named row ``r0``; sample-major weights
    ``w_bnk [B, N, K]``, a third of them exactly 0 (the masked edges) and
    every slot that names ``r0`` weighing 0, so that 2.4's multiply keeps
    0 * NaN on the rows that name it.  Returns (feats, w_bnk, the rows that
    name r0, the NaN rows that no valid slot names)."""
    import torch

    dev = table.nbr.device
    n, k = table.nbr.shape
    valid = table.valid > 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n, b * f), generator=gen, device=dev).to(dtype)
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    used[table.nbr[valid]] = True
    feats[~used] = float("nan")
    r0 = int(table.nbr[valid][0])
    feats[r0] = float("nan")
    names_r0 = (table.nbr == r0) & valid
    w_bnk = torch.randn((b, n, k), generator=gen, device=dev)
    w_bnk[torch.rand((b, n, k), generator=gen, device=dev) < 1 / 3] = 0.0
    w_bnk[:, names_r0] = 0.0
    w_bnk *= table.valid
    return feats, w_bnk.contiguous(), names_r0.any(dim=1), int((~used).sum())


def hold_exact(table, got, want, named_r0, label) -> None:
    """Kernel 2.4 against its plain version: bit for bit (its products are
    rounded before the sum, as the plain version's, and slots are summed in
    the same order), NaN exactly on the rows that name the NaN row through
    a slot of weight 0, exact zeros on rows of degree 0."""
    import torch

    torch.cuda.synchronize()
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        raise AssertionError(f"{label}: NaN entries differ from the plain version's")
    if not torch.equal(nan.any(dim=1), named_r0):
        raise AssertionError(f"{label}: 0 * NaN is not kept exactly on the rows that name the NaN row")
    if torch.isinf(got).any():
        raise AssertionError(f"{label}: infinite output")
    deg0 = table.deg == 0
    if deg0.any() and got[deg0].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: rows of degree 0 are not exact zeros")
    if not torch.equal(got[~nan], want[~nan]):
        raise AssertionError(
            f"{label}: kernel differs from plain, max abs err "
            f"{(got[~nan] - want[~nan]).abs().max().item():.3e} (bit for bit expected)"
        )


def check_weighted_case(table, b, f, dtype, seed, label):
    """Kernel 2.4 against its plain version on one input, through both
    entries: the sample-major weights as they are (``w_sample``) and their
    slot-major copy (``w_slot``, transposed on the card first), bit for bit.
    Returns (feats, w_bnk)."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    n, k = table.nbr.shape
    feats, w_bnk, named_r0, nan_rows = weighted_inputs(table, b, f, dtype, seed)
    w_slot = w_bnk.permute(1, 2, 0).contiguous()
    want = sc.batched_gather_sum_plain(table, feats, b, w_slot)
    got = sc.batched_gather_sum(table, None, feats, b, w_sample=w_bnk)
    hold_exact(table, got, want, named_r0, f"{label} w_sample")
    if not torch.equal(sc.slot_transpose(w_slot), w_bnk):
        raise AssertionError(f"{label}: slot_transpose differs from the sample-major weights")
    got_slot = sc.batched_gather_sum(table, None, feats, b, w_slot=w_slot)
    hold_exact(table, got_slot, want, named_r0, f"{label} w_slot")
    _, plan = sc._plan(feats, got, b, None, sc.BAND_PASSES)
    w = b * f
    spans = sum(c // f != (min(c + plan.band, w) - 1) // f for c in range(0, w, plan.band))
    log(
        f"kernel case {label}: N={n} K={k} b={b} F={f} W={w} {str(dtype)[6:]} "
        f"deg0_rows={int((table.deg == 0).sum())} nan_rows={nan_rows} "
        f"rows_keeping_0*nan={int(named_r0.sum())} "
        f"zero_weights={int(((w_bnk == 0) & (table.valid > 0)).sum())} band={plan.band} "
        f"bands_spanning_samples={spans} of {-(-w // plan.band)}; both entries bit for bit ok"
    )
    return feats, w_bnk


def in_turns(calls: dict, reps: int, rounds: int = 2) -> dict:
    """{name: [ms of each round]}: ``cuda_ms`` of every call, the calls in
    order, then reversed, and so on for ``rounds`` rounds (two versions are
    compared only within one call, in turns)."""
    names = list(calls)
    ms = {name: [] for name in names}
    for i in range(rounds):
        for name in names[::-1] if i % 2 else names:
            ms[name].append(cuda_ms(calls[name], reps))
    return ms


def phase_kernel_weighted(dev, table) -> tuple:
    """Kernel 2.4 at the production shape on 2.3's table, both entries and
    the slot transpose timed in turns with the engine's former permute, then
    the edge cases; returns the records of 2.4 and of its slot transpose."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    feats, w_bnk = check_weighted_case(table, BIG_B, HIDDEN, torch.float32, 1, "2.4 production")
    w_slot = w_bnk.permute(1, 2, 0).contiguous()
    runs = in_turns({
        "w_sample": lambda: sc.batched_gather_sum(table, None, feats, BIG_B, w_sample=w_bnk),
        "w_slot": lambda: sc.batched_gather_sum(table, None, feats, BIG_B, w_slot=w_slot),
        "transpose": lambda: sc.slot_transpose(w_slot),
        # what the engine did to its coefficients before each chunk's two layers
        "permute": lambda: w_bnk.permute(1, 2, 0).contiguous(),
    }, 20)
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    plain_ms = cuda_ms(lambda: sc.batched_gather_sum_plain(table, feats, BIG_B, w_slot), 3)
    transpose_plain_ms = cuda_ms(lambda: sc.slot_transpose_plain(w_slot), 10)
    deg = table.deg
    nbr, valid = table.nbr, table.valid > 0
    w = BIG_B * HIDDEN
    # least bytes: each referenced source row once, each valid slot's index
    # and B weights once, deg once, the output written once
    sum_deg = int(deg.sum())
    uniq_src = int(torch.unique(nbr[valid]).numel())
    bytes_min = uniq_src * w * 4 + sum_deg * (4 + BIG_B * 4) + BIG_N * 4 + BIG_N * w * 4
    ops = 2 * sum_deg * w  # a multiply and an add per gathered element
    bound_ms = max(bytes_min / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if bytes_min / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    gather_bytes = (sum_deg + BIG_N) * w * 4 + sum_deg * (4 + BIG_B * 4)
    tr_bytes = 2 * w_slot.numel() * 4  # read once, written once
    log(
        f"kernel 2.4 timing at production shape (in turns): w_sample (band walk) "
        f"ms={ms['w_sample']:.4f}; w_slot (transpose + walk) ms={ms['w_slot']:.4f}; "
        f"plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}, {bytes_min / 1e9:.3f} GB) "
        f"gather_bound_ms={gather_bytes / HBM_BYTES_PER_S * 1e3:.4f} ({gather_bytes / 1e9:.3f} GB) "
        f"effective_gather_GBps={gather_bytes / ms['w_sample'] / 1e6:.1f}"
    )
    log(
        f"slot transpose [N,K,B]->[B,N,K] ({tr_bytes / 2e6:.0f} MB): kernel ms={ms['transpose']:.4f} "
        f"plain (permute(2,0,1).contiguous()) ms={transpose_plain_ms:.4f} "
        f"bound_ms={tr_bytes / HBM_BYTES_PER_S * 1e3:.4f}; the engine's former "
        f"[B,N,K]->[N,K,B] permute ms={ms['permute']:.4f}"
    )
    del feats, w_bnk, w_slot

    cases = [  # (b, K, F, dtype)
        (1, 8, 128, torch.float32),
        (1, 16, 128, torch.bfloat16),
        (1, 32, 128, torch.float32),
        (16, 8, 64, torch.bfloat16),
        (16, 16, 64, torch.float32),
        (16, 32, 64, torch.float32),
        (48, 8, 6, torch.float32),
        (48, 16, 8, torch.bfloat16),
        (48, 32, 6, torch.float32),
        (48, 32, 8, torch.bfloat16),
        # the band walk: a ragged last band (W = 140), W narrower than a
        # band, the scalar path (F = 3), and bands that span samples where F
        # is above the band but not a multiple of it (F = 96)
        (7, 16, 20, torch.float32),
        (7, 32, 20, torch.bfloat16),
        (1, 32, 8, torch.float32),
        (1, 16, 8, torch.bfloat16),
        (48, 32, 3, torch.float32),
        (48, 16, 3, torch.bfloat16),
        (2, 32, 96, torch.float32),
        (3, 16, 96, torch.bfloat16),
    ]
    for i, (b, k, f, dtype) in enumerate(cases):
        t = _table(5000, 5000 * k // 2, k, seed=30 + i, device=dev, dead_rows=300, dead_srcs=200)
        check_weighted_case(t, b, f, dtype, 200 + i, f"2.4 edge{i}")
    common = {"route": "cuda", "source": f"{PKG}/ops/csrc/batched_gather_sum.cu", "launches": None,
              "max_abs_err": 0.0}
    rec = dict(
        common,
        name="batched_gather_sum",
        replaces="bikg_graph_explainability_public_tpu/ops/spmm_pallas.py:1074",
        ms=ms["w_sample"],
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=None,
        library_note="no PyTorch call takes per-slot, per-sample weights "
        "(torch.sparse.mm takes one weight per edge for all samples)",
        gather_bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3,
        slot_major_ms=ms["w_slot"],
        engine_permute_ms=ms["permute"],
    )
    rec_t = dict(
        common,
        name="batched_gather_sum.transpose",
        replaces="bikg_graph_explainability_public_tpu/ops/spmm_pallas.py:1499",
        ms=ms["transpose"],
        plain_ms=transpose_plain_ms,
        bound_ms=tr_bytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=transpose_plain_ms,
        library_note="w_slot.permute(2, 0, 1).contiguous(), which is also the plain version",
    )
    return rec, rec_t


def _dense_case(dev, n, e, b, c, c_in, seed):
    """Inputs of the fused layers on a random graph's dense adjacency, with
    the engine's mask scalings of 70 %-kept node masks."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models.fast_gcn import _dense_adjacency

    feat, ei, _ = random_graph(n, e, seed)
    adj = _dense_adjacency(from_arrays(feat, ei, device=dev), dev)[:n, :n].contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.rand((b, n), generator=gen, device=dev) > 0.3).float()
    dis = torch.rsqrt(1.0 + m * (m @ adj.T))
    return dict(
        adj16=adj.to(torch.bfloat16),
        s=(m * dis).contiguous(),
        self_w=(dis * dis).contiguous(),
        xw=torch.randn((n, c), generator=gen, device=dev),
        h=torch.relu(torch.randn((b, n, c_in), generator=gen, device=dev)),
        w_t=torch.randn((c_in, c), generator=gen, device=dev) / c_in ** 0.5,
        bias=0.1 * torch.randn((c,), generator=gen, device=dev),
    )


def check_dense_case(x, bias: bool, relu: bool, label: str):
    """Kernels 2.1 and 2.2 against their plain versions on one input, and
    2.1's operand launch against its plain layout (bit for bit); returns
    (err_2_1, err_2_2, err_operand)."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import gcn_layer_cuda as g

    st = g.scaled_operand(x["s"], x["xw"])
    st_want = g.scaled_operand_plain(x["s"], x["xw"])
    torch.cuda.synchronize()
    if st.shape != st_want.shape or not torch.equal(st, st_want):
        raise AssertionError(f"{label}: the scaled operand differs from its plain layout")
    err0 = 0.0  # equal bit for bit
    del st, st_want
    bi = x["bias"] if bias else None
    got = g.masked_gcn_layer(x["adj16"], x["xw"], x["s"], x["self_w"], bi, relu)
    want = g.masked_gcn_layer_plain(x["adj16"], x["xw"], x["s"], x["self_w"], bi, relu)
    torch.cuda.synchronize()
    # 2.1: identical bf16 roundings and exact bf16 products, another
    # summation order only
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"{label} 2.1: kernel disagrees with plain, max abs err "
            f"{(got - want).abs().max().item():.3e}"
        )
    err1 = (got - want).abs().max().item()
    del got, want
    got = g.masked_gcn_layer_batched(x["adj16"], x["h"], x["w_t"], x["s"], x["self_w"], bi, relu)
    want = g.masked_gcn_layer_batched_plain(x["adj16"], x["h"], x["w_t"], x["s"], x["self_w"], bi, relu)
    # 2.2: h @ W in float32 on both sides, in another order, so a term's
    # bf16 rounding may differ by one bf16 ulp (2^-8 of the term): the
    # bound is that ulp of every term, summed, plus float32 order
    hw = torch.matmul(x["h"], x["w_t"])
    scaled = (x["s"][:, :, None] * hw).to(torch.bfloat16).float().abs()
    ulp = 2.0 ** -8 * x["s"][:, :, None] * torch.matmul(x["adj16"].float(), scaled)
    diff = (got - want).abs()
    torch.cuda.synchronize()
    if not (diff <= ulp + 1e-5 * (1.0 + want.abs())).all():
        raise AssertionError(
            f"{label} 2.2: kernel disagrees with plain beyond one bf16 ulp per "
            f"term, max abs err {diff.max().item():.3e}"
        )
    err2 = diff.max().item()
    b, n, c = want.shape
    log(
        f"kernel case {label}: N={n} B={b} C_in={x['h'].shape[2]} C={c} bias={bias} "
        f"relu={relu} operand bit-exact, 2.1 max_abs_err={err1:.3e} 2.2 max_abs_err={err2:.3e} "
        f"(bf16-ulp bound max {ulp.max().item():.3e}) ok"
    )
    return err1, err2, err0


def phase_kernel_dense(dev):
    """Kernels 2.1 and 2.2 at the bench's subgraph shape, then the edge
    cases; returns their records and that of 2.1's operand launch."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import gcn_layer_cuda as g

    x = _dense_case(dev, SUB_N, SUB_E, SUB_B, HIDDEN, HIDDEN, seed=2)
    err1, err2, err0 = check_dense_case(x, True, True, "dense production")
    a, s, sw, bias, xw, h, w_t = (x[k] for k in ("adj16", "s", "self_w", "bias", "xw", "h", "w_t"))
    ms1 = cuda_ms(lambda: g.masked_gcn_layer(a, xw, s, sw, bias), 20)
    plain1 = cuda_ms(lambda: g.masked_gcn_layer_plain(a, xw, s, sw, bias), 3)
    ms2 = cuda_ms(lambda: g.masked_gcn_layer_batched(a, h, w_t, s, sw, bias), 20)
    plain2 = cuda_ms(lambda: g.masked_gcn_layer_batched_plain(a, h, w_t, s, sw, bias), 3)
    # each launch alone: 2.1's operand and aggregation, 2.2's transform
    # (which writes hw and the operand) and aggregation
    ms_op = cuda_ms(lambda: g.scaled_operand(s, xw), 20)
    plain_op = cuda_ms(lambda: g.scaled_operand_plain(s, xw), 5)
    st = g.scaled_operand(s, xw)
    agg1_ms = cuda_ms(lambda: g._aggregate(g.MASKED_GCN_LAYER, a, st, xw, s, sw, bias, True, False), 20)
    ld = g.operand_stride(SUB_N)
    hw_out = torch.empty((SUB_B, SUB_N, HIDDEN), device=dev)
    transform_ms = cuda_ms(
        lambda: g.TRANSFORM.launch(
            h.data_ptr(), w_t.data_ptr(), s.data_ptr(), hw_out.data_ptr(), st.data_ptr(),
            SUB_B, SUB_N, HIDDEN, HIDDEN, ld, 1, torch.cuda.current_stream().cuda_stream,
        ), 20,
    )
    agg2_ms = cuda_ms(
        lambda: g._aggregate(g.MASKED_GCN_LAYER_BATCHED, a, st, hw_out, s, sw, bias, True, True), 20
    )
    del hw_out, st
    # yardsticks only, never called by the port: the cuBLAS bf16 product of
    # A with the scaled operands (bf16 out, f32 accumulation) without the
    # operand's construction and the epilogue; for 2.2 also like for like,
    # the float32 h @ W and then that product
    scaled = (s[:, :, None] * xw).to(torch.bfloat16)
    lib1 = cuda_ms(lambda: torch.matmul(a, scaled), 10)
    scaled = (s[:, :, None] * torch.matmul(h, w_t)).to(torch.bfloat16)
    lib2 = cuda_ms(lambda: torch.matmul(a, scaled), 10)
    lib2_full = cuda_ms(lambda: (torch.matmul(h, w_t), torch.matmul(a, scaled)), 10)
    del scaled
    n, b, c = SUB_N, SUB_B, HIDDEN
    # the product's work on this run's data: A is sparse, so the least work
    # counts its nonzero entries; the kernels (as the TPU's) do the dense
    # product, whose bound is kept beside it
    nnz = int((a != 0).sum())
    agg_ops = 2 * nnz * b * c
    dense_ops = 2 * n * n * b * c
    tr_ops = 2 * b * n * HIDDEN * c
    bytes1 = n * n * 2 + n * c * 4 + 2 * b * n * 4 + c * 4 + b * n * c * 4
    bytes2 = n * n * 2 + b * n * HIDDEN * 4 + HIDDEN * c * 4 + 2 * b * n * 4 + c * 4 + b * n * c * 4
    records = []
    for name, src_line, ms, plain, lib, err, nbytes, f32_ops, extra in (
        ("masked_gcn_layer", "ops/pallas_gcn.py:76", ms1, plain1, lib1, err1, bytes1, 0,
         {"library_note": "torch.matmul(A, bf16 scaled operands) alone: no operand "
          "construction, no epilogue", "operand_ms": ms_op, "aggregation_ms": agg1_ms}),
        ("masked_gcn_layer_batched", "ops/pallas_gcn.py:104", ms2, plain2, lib2_full, err2, bytes2,
         tr_ops,
         {"library_note": "like for like: torch.matmul(h, W) float32, then "
          "torch.matmul(A, bf16 scaled operands); library_product_ms is the product alone",
          "library_product_ms": lib2, "transform_ms": transform_ms, "aggregation_ms": agg2_ms}),
    ):
        # the tensor cores and the float32 units can work at once: the
        # larger of the two types' times
        times = {
            "operations": max(agg_ops / BF16_OPS_PER_S, f32_ops / F32_OPS_PER_S),
            "bytes": nbytes / HBM_BYTES_PER_S,
        }
        dense_bound = max(dense_ops / BF16_OPS_PER_S, f32_ops / F32_OPS_PER_S, times["bytes"])
        bound_by = max(times, key=times.get)
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/ops/csrc/masked_gcn_layer.cu",
            "replaces": f"bikg_graph_explainability_public_tpu/{src_line}",
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": times[bound_by] * 1e3,
            "bound_by": bound_by,
            "library_ms": lib,
            "dense_bound_ms": dense_bound * 1e3,
            **extra,
        })
        log(
            f"kernel {name} timing at N={n} B={b} C={c} (A: {nnz} nonzeros): ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} ({extra['library_note']}) "
            f"data-dependent bound_ms={times[bound_by] * 1e3:.4f} ({bound_by}) "
            f"dense-product bound_ms={dense_bound * 1e3:.4f} "
            f"dense bf16 TFLOP/s={dense_ops / ms / 1e9:.1f}"
        )
    log(f"kernel 2.1's launches alone: operand {ms_op:.4f} ms, aggregation {agg1_ms:.4f} ms "
        f"({dense_ops / agg1_ms / 1e9:.1f} dense bf16 TFLOP/s); kernel 2.2's: float32 transform "
        f"{transform_ms:.4f} ms ({tr_ops / transform_ms / 1e9:.1f} TFLOP/s), aggregation "
        f"{agg2_ms:.4f} ms; cuBLAS product alone {lib1:.4f} / {lib2:.4f} ms")
    # the operand launch: xw and s read once, S^T written once
    op_bytes = n * c * 4 + b * n * 4 + b * c * ld * 2
    records.append({
        "name": "masked_gcn_layer.operand",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/masked_gcn_layer.cu",
        "replaces": "bikg_graph_explainability_public_tpu/ops/pallas_gcn.py:84",
        "launches": None,
        "max_abs_err": err0,
        "ms": ms_op,
        "plain_ms": plain_op,
        "bound_ms": op_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no one PyTorch call scales, rounds and transposes",
    })
    log(f"kernel masked_gcn_layer.operand: ms={ms_op:.4f} plain_ms={plain_op:.4f} "
        f"bound_ms={op_bytes / HBM_BYTES_PER_S * 1e3:.4f} (bytes, {op_bytes / 1e9:.3f} GB)")
    del x

    cases = [  # (N, E, B, C, C_in, bias, relu)
        (1000, 8000, 1, 16, 16, False, False),
        (300, 2400, 7, 16, 128, True, True),
        (130, 1000, 3, 128, 128, False, False),
        (2040, 16000, 5, 128, 16, True, False),
        (37, 150, 3, 16, 16, True, True),  # below one 64-row block, N % 8 != 0
        (130, 1000, 1, 16, 16, True, False),  # one 16-column tile
        (4096, 32768, 50, 128, 128, True, True),  # DENSE_CAP
    ]
    for i, (cn, ce, cb, cc, ci, cbias, crelu) in enumerate(cases):
        x = _dense_case(dev, cn, ce, cb, cc, ci, seed=40 + i)
        errs = check_dense_case(x, cbias, crelu, f"dense edge{i}")
        for rec, e in zip(records, errs):
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
        del x
    return records


def _check_against_cpu(ex_gpu, ex_cpu, label):
    import numpy as np

    if ex_gpu.names != ex_cpu.names:
        raise AssertionError(f"{label}: element names differ from the CPU run")
    if not np.isfinite(ex_gpu.mean).all() or ex_gpu.mean.shape != (len(ex_gpu.names),):
        raise AssertionError(f"{label}: scores are not finite or of the wrong shape")
    # the same float32 math on two devices; Adam over 50 steps can amplify
    # last-bit differences of the forwards
    if not np.allclose(ex_gpu.mean, ex_cpu.mean, rtol=1e-3, atol=1e-5):
        raise AssertionError(
            f"{label}: card and CPU disagree, max abs diff "
            f"{np.abs(ex_gpu.mean - ex_cpu.mean).max():.3e}"
        )
    if ex_gpu.pathway_scores is not None and not np.allclose(
        ex_gpu.pathway_scores, ex_cpu.pathway_scores, rtol=1e-3, atol=1e-5
    ):
        raise AssertionError(f"{label}: community scores disagree with the CPU run")
    return float(np.abs(ex_gpu.mean - ex_cpu.mean).max())


def phase_explanations(dev, config, problem: str) -> None:
    """The 36-node fixture (Shapley and community mode) and GCN-128x2 on
    the 20k / 160k graph (4 queries), each checked against the same run on
    the CPU (the first query of the 20k graph).  Edge problems name every
    edge and query edges; node problems name nodes and query nodes."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.checkpoint import load_params
    from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel

    path = problem.split("_")[0] + " path"
    data = np.load(os.path.join(ROOT, "test_data", "toy_graph_36n.npz"))
    feat, ei = data["feat"], data["edge_index"]
    if problem == "edge_prediction":
        names = [str(i) for i in range(ei.shape[1])]
    else:
        names = [str(x) for x in data["names"]]
    ckpt = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
    # four communities over the names, drawn as tests/fixtures.py does
    perm = np.random.default_rng(1).permutation(len(names))
    pathways = [[str(int(v)) for v in c] for c in np.array_split(perm, 4)]
    pathway_names = [f"community_{i}" for i in range(4)]
    community = dict(pathways=pathways, pathway_names=pathway_names)
    for label, kw in (("shapley", {}), ("community", community)):
        runs = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = Model(GCNNodeModel(N_FEATS), load_params(ckpt), device=d)
            t0 = time.perf_counter()
            ex = Explainer(feat, ei, model, config, names, problem=problem, device=d, **kw)
            runs[where] = ex._explain("10", times=1)
            if where == "card":
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        diff = _check_against_cpu(runs["card"], runs["cpu"], f"36n {problem} {label}")
        log(f"{path} 36n fixture {label}: {len(runs['card'].names)} elements, "
            f"wall {wall:.3f} s, max |card - cpu| {diff:.3e} ok")

    feat, ei, rng = random_graph(NODE_N, NODE_E, seed=5)
    n_el = NODE_E if problem == "edge_prediction" else NODE_N
    names = [str(i) for i in range(n_el)]
    queries = [str(int(q)) for q in rng.integers(0, n_el, NODE_QUERIES)]
    model, _ = gcn_128x2(seed=0, device=dev)
    for qi, q in enumerate(queries):
        t0 = time.perf_counter()
        ex = Explainer(feat, ei, model, config, names, problem=problem, device=dev)
        ex = ex._explain(q, times=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        msg = f"{path} 20k/160k GCN-128x2 query {q}: {len(ex.names)} elements, wall {wall:.3f} s"
        if qi == 0:
            cpu_model, _ = gcn_128x2(seed=0, device="cpu")
            ex_cpu = Explainer(feat, ei, cpu_model, config, names, problem=problem, device="cpu")
            ex_cpu = ex_cpu._explain(q, times=1)
            msg += f", max |card - cpu| {_check_against_cpu(ex, ex_cpu, 'query ' + q):.3e}"
        elif not np.isfinite(ex.mean).all():
            raise AssertionError(f"query {q}: non-finite scores")
        log(msg + " ok")


def profile_forwards(run, wall_s: float, label: str) -> None:
    """Device time by operation over one more pass of ``run()``
    (``torch.profiler``), and the device's busy share of the unprofiled
    wall time ``wall_s`` of the same pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # how long the host takes to enqueue the pass, against its wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"{label}: the host returns after {enqueue_s * 1e3:.1f} ms of a "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms pass")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only: the host ops that launched them carry the
    # same time again
    rows = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log(f"{label} profile: the profiler recorded no device time")
        return
    log(f"{label} profile: device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"(busy share {busy_ms / (wall_s * 1e3):.3f}); top operations by device time:")
    for ms, count, name in rows[:12]:
        short = name if len(name) <= 100 else f"{name[:45]} ... {name[-50:]}"
        log(f"  {ms:10.3f} ms  {count:6d} calls  {short}")
    host = sorted(
        (
            (e.self_cpu_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0
        ),
        reverse=True,
    )
    log(f"{label} profile: top host operations by self CPU time:")
    for ms, count, name in host[:6]:
        log(f"  {ms:10.3f} ms  {count:6d} calls  {name[:100]}")


def expect_counts(counts: dict, expected: dict, label: str) -> None:
    """Every kernel launched exactly as ``expected`` says (0 if unnamed)."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {want}")
    log(f"{label}: kernel launches {counts} as expected")


def phase_graph_path(dev, config, record: dict) -> int:
    """Returns kernel 2.3's launch count during the explanation; ``record``
    holds the kernel's timings at this shape from :func:`phase_kernel`."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models.fast_gcn import FastBatchedGCN
    from bikg_graph_explainability_public_tpu_torch.ops import spmm, spmm_cuda

    feat, ei, _ = random_graph(BIG_N, BIG_E, seed=0)
    names = [str(i) for i in range(BIG_N)]
    model, _ = gcn_128x2(seed=0, device=dev)
    cfg = dict(config, forward_chunk=BIG_B)
    n_masks = int(cfg["interpret_samples"]) * int(cfg["epochs"])
    expected = (n_masks // BIG_B) * (len(model.model_def.conv) - 1)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    explainer = Explainer(feat, ei, model, cfg, names, problem="graph_prediction", device=dev)
    ex = explainer._explain(None, times=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_counts(read_counts(), {"gather_sum_static": expected}, "graph path")
    if not np.isfinite(ex.mean).all() or ex.mean.shape != (BIG_N,):
        raise AssertionError("graph path: scores are not finite or of the wrong shape")
    log(f"graph path 100k/1M GCN-128x2: {n_masks} masks in chunks of {BIG_B}, "
        f"wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ok")
    log(f"graph path kernel at this shape (phase 3): {record['ms']:.4f} ms per call, "
        f"plain {record['plain_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, torch.sparse.mm {record['library_ms']:.4f} ms")

    # where the time goes: the engine's host set-up, then the same number of
    # forwards on device-resident masks, then one profiled pass over them
    t0 = time.perf_counter()
    graph = from_arrays(feat, ei, device=dev)
    engine = FastBatchedGCN(model.model_def, graph, device=dev)
    engine.table.deg  # the host-side prefix check, once per table
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    all_masks = torch.rand((n_masks, graph.n_pad), generator=gen, device=dev) < 0.5

    def run():
        return engine.query_outputs(all_masks, None, "graph_prediction", chunk_size=BIG_B)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    log(f"graph path breakdown: engine set-up (graph upload, CSR, neighbour table, "
        f"layer-1 features) {setup_s:.3f} s; {n_masks} forwards {fwd_s:.3f} s; "
        f"rest of the explanation (mask sampling, transfer, surrogate fit) "
        f"{wall - setup_s - fwd_s:.3f} s")
    profile_forwards(run, fwd_s, "graph path")
    del all_masks

    # one chunk through the engine, then the same engine with the plain version
    masks = torch.rand((BIG_B, graph.n_pad), generator=gen, device=dev) < 0.5
    got = engine.query_outputs(masks, None, "graph_prediction", chunk_size=BIG_B)
    spmm.gather_sum_static = spmm_cuda.gather_sum_static_plain
    try:
        want = engine.query_outputs(masks, None, "graph_prediction", chunk_size=BIG_B)
    finally:
        spmm.gather_sum_static = spmm_cuda.gather_sum_static
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(
            "engine chunk: kernel route and plain route differ by "
            f"{(got - want).abs().max().item():.3e}"
        )
    log(f"graph path one chunk, kernel vs plain route: max abs diff "
        f"{(got - want).abs().max().item():.3e} (rtol 1e-5, atol 1e-6) ok")
    return expected


def phase_ell_edge_forward(dev) -> int:
    """The unrestricted ELL edge forward on the 100k / 1M graph: 1000
    device-generated edge masks (70 % kept, as bench.py draws them) in
    chunks of 50, query row 17.  Returns kernel 2.4's launch count."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models.fast_gcn import FastBatchedGCN
    from bikg_graph_explainability_public_tpu_torch.ops import spmm, spmm_cuda

    feat, ei, _ = random_graph(BIG_N, BIG_E, seed=0)
    model, _ = gcn_128x2(seed=0, device=dev)
    n_masks = 1000
    expected = (n_masks // BIG_B) * (len(model.model_def.conv) - 1)
    t0 = time.perf_counter()
    graph = from_arrays(feat, ei, device=dev)
    engine = FastBatchedGCN(model.model_def, graph, restrict=False, device=dev)
    engine.table.deg  # the host-side prefix check, once per table
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(4)
    all_masks = torch.rand((n_masks, graph.e_pad), generator=gen, device=dev) > 0.3
    all_masks[:, graph.num_edges:] = False

    def run():
        return engine.query_outputs(all_masks, EDGE_QUERY, "edge_prediction", chunk_size=BIG_B)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    # the sample-major walk on the engine's coefficients as made: no slot
    # transpose, no [N, K, B] copy
    expect_counts(read_counts(), {"batched_gather_sum": expected}, "ELL edge forward")
    if out.shape != (n_masks,) or not torch.isfinite(out).all():
        raise AssertionError("ELL edge forward: outputs are not finite or of the wrong shape")
    log(f"ELL edge forward 100k/1M GCN-128x2: engine set-up (graph upload, neighbour "
        f"table, layer-1 features) {setup_s:.3f} s; {n_masks} edge-mask forwards in "
        f"chunks of {BIG_B} {fwd_s:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ok")
    profile_forwards(run, fwd_s, "ELL edge forward")

    # one chunk through the engine, then the same engine with the plain version
    masks = all_masks[:BIG_B]
    got = engine.query_outputs(masks, EDGE_QUERY, "edge_prediction", chunk_size=BIG_B)
    spmm.batched_gather_sum = (
        lambda table, ew, feats, b, w_slot=None, w_sample=None:
        spmm_cuda.batched_gather_sum_plain(
            table, feats, b, w_slot if w_sample is None else w_sample.permute(1, 2, 0))
    )
    try:
        want = engine.query_outputs(masks, EDGE_QUERY, "edge_prediction", chunk_size=BIG_B)
    finally:
        spmm.batched_gather_sum = spmm_cuda.batched_gather_sum
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(
            "ELL edge chunk: kernel route and plain route differ by "
            f"{(got - want).abs().max().item():.3e}"
        )
    log(f"ELL edge forward one chunk, kernel vs plain route: max abs diff "
        f"{(got - want).abs().max().item():.3e} (rtol 1e-5, atol 1e-6) ok")
    return expected


def phase_dense_fused(dev):
    """``backend="pallas"`` against ``"xla"`` on the bench's 2048 / 16384
    graph, ``graph_prediction``, 1000 masks in chunks of 250.  Returns the
    launch counts of kernel 2.1, its operand launch and kernel 2.2."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models import fast_gcn
    from bikg_graph_explainability_public_tpu_torch.ops import gcn_layer_cuda as g

    feat, ei, _ = random_graph(SUB_N, SUB_E, seed=2)
    model, _ = gcn_128x2(seed=0, device=dev)
    graph = from_arrays(feat, ei, device=dev)
    fused = fast_gcn.FastBatchedGCN(model.model_def, graph, backend="pallas", restrict=False, device=dev)
    plain = fast_gcn.FastBatchedGCN(model.model_def, graph, backend="xla", restrict=False, device=dev)
    if fused.mode != "dense":
        raise AssertionError(f"the {SUB_N}-node graph runs the {fused.mode} tier")
    n_masks = 1000
    chunks = n_masks // SUB_B
    gen = torch.Generator(device=dev).manual_seed(5)
    all_masks = torch.rand((n_masks, graph.n_pad), generator=gen, device=dev) > 0.3
    all_masks[:, graph.num_nodes:] = False

    def run(engine):
        return engine.query_outputs(all_masks, None, "graph_prediction", chunk_size=SUB_B)

    run(fused)  # the first call builds the bf16 adjacency
    run(plain)
    reset_counts()
    got = run(fused)
    counts = read_counts()
    expect_counts(
        counts,
        {"masked_gcn_layer": chunks, "masked_gcn_layer.operand": chunks,
         "masked_gcn_layer_batched": chunks, "masked_gcn_layer_batched.transform": chunks},
        "fused dense forward",
    )
    want = run(plain)
    # a pass is tens of ms: the best of three, the two engines in turns
    walls = {"pallas": [], "xla": []}
    for _ in range(3):
        for name, engine in (("pallas", fused), ("xla", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(engine)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    fused_s, xla_s = min(walls["pallas"]), min(walls["xla"])
    if got.shape != (n_masks,) or not torch.isfinite(got).all():
        raise AssertionError("fused dense forward: outputs are not finite or of the wrong shape")
    # the bf16 operands against float32 (tests/test_pallas_gcn.py:20)
    diff = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=5e-2, atol=6e-2):
        raise AssertionError(f"fused dense forward: backend pallas and xla differ by {diff:.3e}")
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    log(f"fused dense forward 2048/16384 GCN-128x2 graph_prediction: {n_masks} masks in "
        f"chunks of {SUB_B}, best of 3: backend pallas {fused_s:.4f} s, xla {xla_s:.4f} s "
        f"(all passes: pallas {[round(w, 4) for w in walls['pallas']]}, "
        f"xla {[round(w, 4) for w in walls['xla']]}); "
        f"max |pallas - xla| {diff:.3e} (rtol 5e-2, atol 6e-2), correlation {corr:.6f} ok")
    profile_forwards(lambda: run(fused), fused_s, "fused dense forward")

    # one chunk through the kernels, then through their plain versions
    masks = all_masks[:SUB_B]
    got = fused.query_outputs(masks, None, "graph_prediction", chunk_size=SUB_B)
    fast_gcn.masked_gcn_layer = g.masked_gcn_layer_plain
    fast_gcn.masked_gcn_layer_batched = g.masked_gcn_layer_batched_plain
    try:
        want = fused.query_outputs(masks, None, "graph_prediction", chunk_size=SUB_B)
    finally:
        fast_gcn.masked_gcn_layer = g.masked_gcn_layer
        fast_gcn.masked_gcn_layer_batched = g.masked_gcn_layer_batched
    # pooled outputs: float32 order, plus the rare one-ulp bf16 roundings of
    # 2.2's operand averaged over 2048 nodes
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise AssertionError(
            "fused dense chunk: kernel route and plain route differ by "
            f"{(got - want).abs().max().item():.3e}"
        )
    log(f"fused dense forward one chunk, kernel vs plain route: max abs diff "
        f"{(got - want).abs().max().item():.3e} (rtol 1e-4, atol 1e-5) ok")
    return (counts["masked_gcn_layer"], counts["masked_gcn_layer.operand"],
            counts["masked_gcn_layer_batched"])


LADDER_ROWS = {  # kernel row -> (counter, schedule, TPU kernel it replaces)
    "2.5": ("ell_valid_sum.v6", "v6", "ops/spmm_pallas.py:867"),
    "2.6": ("spmm_ell_weighted.v3", "v3", "ops/spmm_pallas.py:288"),
    "2.7": ("spmm_ell_weighted.fused", "fused", "ops/spmm_pallas.py:436"),
    "2.8": ("ell_valid_sum.v5", "v5", "ops/spmm_pallas.py:549"),
}


def ladder_inputs(table, b, f, dtype, seed):
    """Features with NaN in the source rows that no valid slot names and in
    one named row ``r0``; static [N, K], broadcast [N, K, 1] and per-sample
    [N, K, B] slot weights, a third of the broadcast and per-sample ones
    exactly 0 and every slot that names ``r0`` weighing 0 in those two;
    and a post-scale [N, B]."""
    import torch

    dev = table.nbr.device
    n, k = table.nbr.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = table.valid
    feats = torch.randn((n, b * f), generator=gen, device=dev).to(dtype)
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    used[table.nbr[valid > 0]] = True
    feats[~used] = float("nan")
    r0 = int(table.nbr[valid > 0][0])
    feats[r0] = float("nan")
    names_r0 = (table.nbr == r0) & (valid > 0)

    def masked(shape):
        w = torch.randn(shape, generator=gen, device=dev)
        w[torch.rand(shape, generator=gen, device=dev) < 1 / 3] = 0.0
        w[names_r0] = 0.0
        return (w * valid[:, :, None]).contiguous()

    weights = {
        "static": torch.randn((n, k), generator=gen, device=dev) * valid,
        "broadcast": masked((n, k, 1)),
        "per_sample": masked((n, k, b)),
    }
    ps = torch.randn((n, b), generator=gen, device=dev)
    return feats, weights, ps, names_r0.any(dim=1)


def hold_route(got, want, table, label, select: bool) -> float:
    """A route's output against its plain version's: the same NaN entries
    (NaN reaches a row only through the named NaN row), exact zeros on rows
    of degree 0, equal elsewhere up to float32 summation order; the select
    routes (a slot of weight 0 adds nothing) come out finite.  Returns the
    max abs error over the finite entries."""
    import torch

    torch.cuda.synchronize()
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        raise AssertionError(f"{label}: NaN entries differ from the plain version's")
    if select and nan.any():
        raise AssertionError(f"{label}: a slot of weight 0 let NaN into the sum")
    if torch.isinf(got).any():
        raise AssertionError(f"{label}: infinite output")
    deg0 = table.deg == 0
    if deg0.any() and got[deg0].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: rows of degree 0 are not exact zeros")
    g, w = got[~nan], want[~nan]
    if not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"{label}: kernel disagrees with plain, max abs err {(g - w).abs().max().item():.3e}"
        )
    return (g - w).abs().max().item() if g.numel() else 0.0


def ladder_routes(table, feats, weights, ps, b, graph=None):
    """Every route of the raw entry and its two callers, as (label,
    counters, select, call, plain): the call goes through the public
    wrappers and launches each kernel of ``counters`` once; the plain
    computes the same function with the plain versions."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm, spmm_cuda as sc

    valid = table.valid
    routes = [
        ("v7 static post_scale (2.3)", ("gather_sum_static",), False,
         lambda: sc.spmm_ell(table, valid, feats, b, sched="v7", post_scale=ps),
         lambda: sc.gather_sum_static_plain(table, feats, b, ps)),
        ("v7 per_sample (2.4)", ("batched_gather_sum", "batched_gather_sum.transpose"), False,
         lambda: sc.spmm_ell(table, weights["per_sample"], feats, b, sched="v7"),
         lambda: sc.batched_gather_sum_plain(table, feats, b, weights["per_sample"])),
    ]
    for sched in ("v6", "v5"):
        routes.append((f"{sched} static (2.{5 if sched == 'v6' else 8})", (f"ell_valid_sum.{sched}",), False,
                       lambda s=sched: sc.spmm_ell(table, valid, feats, b, sched=s),
                       lambda: sc.gather_sum_static_plain(table, feats, b)))
    for sched in ("v3", "fused"):
        for mode, w in weights.items():
            routes.append((f"{sched} {mode} (2.{6 if sched == 'v3' else 7})", (f"spmm_ell_weighted.{sched}",),
                           mode != "static",
                           lambda s=sched, w=w: sc.spmm_ell(table, w, feats, b, sched=s),
                           lambda w=w: sc.spmm_ell_weighted_plain(table, w, feats, b)))
    if b > 1:
        routes.append(("batched_gather_sum broadcast (2.6)", ("spmm_ell_weighted.v3",), True,
                       lambda: sc.batched_gather_sum(table, None, feats, b, w_slot=weights["broadcast"]),
                       lambda: sc.spmm_ell_weighted_plain(table, weights["broadcast"], feats, b)))
    if graph is not None:
        # scalar per-edge weights over [N, F]: 2.4 at b = 1 plus the self-loop term
        x1 = feats[:, : feats.shape[1] // b].contiguous()
        gen = torch.Generator(device=feats.device).manual_seed(9)
        ew = torch.rand(graph.e_pad, generator=gen, device=feats.device) * graph.edge_mask
        snd, rcv = graph.senders, graph.receivers

        def plain_wgs():
            out = sc.batched_gather_sum_plain(table, x1, 1, sc.slot_weights(table, ew[:, None]))
            loop = torch.where(snd == rcv, ew, 0.0)
            return out + x1.new_zeros(x1.shape[0]).index_add_(0, rcv, loop)[:, None] * x1

        routes.append(("weighted_gather_sum table b=1 (2.4)", ("batched_gather_sum",), False,
                       lambda: spmm.weighted_gather_sum(ew, x1, snd, rcv, x1.shape[0], table=table),
                       plain_wgs))
    return routes


def ladder_bound(table, weights, b, f, itemsize, mode) -> tuple:
    """(bound_ms, bound_by) of one route on this run's data: each source row
    that a slot of non-zero weight names read once, the valid slots' indices
    (of the slots read) and weights read once, deg once, the output written
    once; one add (valid sums) or a multiply and an add (weighted) per
    gathered element that is summed."""
    import torch

    n, k = table.nbr.shape
    w = b * f
    valid = table.valid > 0
    sum_deg = int(valid.sum())
    if mode in ("valid", "static"):
        read = valid
        wbytes = 0 if mode == "valid" else sum_deg * 4
        ops = sum_deg * w * (1 if mode == "valid" else 2)
    else:
        nz = weights[mode] != 0  # [N, K, wb]
        read = valid & nz.any(dim=2)
        wbytes = sum_deg * nz.shape[2] * 4
        ops = 2 * int(nz.sum()) * (w if nz.shape[2] == 1 else f)
    rows = int(torch.unique(table.nbr[read]).numel())
    nbytes = rows * w * itemsize + int(read.sum()) * 4 + wbytes + n * 4 + n * w * 4
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / F32_OPS_PER_S}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


#: the L2 probe's feature widths (float32 columns): at N = 100000 features
#: of 32 and 64 columns (12.8 and 25.6 MB) fit in the 50 MB L2, 128 (51 MB)
#: does not
PROBE_WIDTHS = (32, 64, 128)


def l2_probe(table, weights) -> dict:
    """Kernel 2.6 on narrow features ``[N, Wb]`` float32 (b = 1) with the
    ladder's static and broadcast weights, 20 calls each after a warm-up,
    so that a width that fits in L2 is served from it: ms per call and the
    gather rate, the summed slots' source-row bytes (slots read x Wb x 4)
    over that time.  Returns ``{(Wb, mode): (ms, GB/s)}``."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    dev = table.nbr.device
    n = table.nbr.shape[0]
    valid = table.valid > 0
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for wb in PROBE_WIDTHS:
        x = torch.randn((n, wb), generator=gen, device=dev)
        for mode in ("static", "broadcast"):
            w = weights[mode]
            read = valid if mode == "static" else valid & (w[..., 0] != 0)
            gathered = int(read.sum()) * wb * 4
            ms = cuda_ms(lambda: sc.spmm_ell_weighted(table, w, x, 1), 20)
            out[(wb, mode)] = (ms, gathered / ms / 1e6)
            log(f"L2 probe Wb={wb} {mode}: ms={ms:.4f} gathered={gathered / 1e6:.1f} MB "
                f"gather_GBps={gathered / ms / 1e6:.1f} features={n * wb * 4 / 1e6:.1f} MB; "
                f"{BIG_B * HIDDEN // wb} such bands x ms = {BIG_B * HIDDEN // wb * ms:.3f} ms")
        del x
    return out


def phase_ladder(dev, graph, table, counts_out: dict) -> list:
    """The ELL SpMM entry ``spmm_ell`` and its callers on the production
    table (100k / 1M, K = 32), B = 50, F = 128, float32: every route once
    with the counts set to 0 (each held against its plain version; the
    counts go into ``counts_out``), then each timed; then every route in the
    edge cases.  Returns the records of kernels 2.5-2.8."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    feats, weights, ps, named_r0 = ladder_inputs(table, BIG_B, HIDDEN, torch.float32, 7)
    routes = ladder_routes(table, feats, weights, ps, BIG_B, graph)
    reset_counts()
    expected, errs = {}, {}
    for label, counters, select, call, plain in routes:
        got = call()
        errs[label] = hold_route(got, plain(), table, f"ladder {label}", select)
        if "batched_gather_sum" in counters and "v7" in label and not torch.isnan(got[named_r0]).all():
            raise AssertionError("kernel 2.4 should keep 0 * NaN on the rows that name the NaN row")
        for counter in counters:
            expected[counter] = expected.get(counter, 0) + 1
        log(f"ladder route {label}: max_abs_err={errs[label]:.3e} ok")
        del got
    counts = read_counts()
    expect_counts(counts, expected, "ladder (spmm_ell, batched_gather_sum, weighted_gather_sum)")
    counts_out.update(counts)

    # timings: the routes, the plain version of each function once, and
    # torch.sparse.mm where one call computes the same function
    ms = {label: cuda_ms(call, 20) for label, _, _, call, _ in routes}
    plain = {
        "valid": cuda_ms(lambda: sc.gather_sum_static_plain(table, feats, BIG_B), 3),
        "broadcast": cuda_ms(lambda: sc.spmm_ell_weighted_plain(table, weights["broadcast"], feats, BIG_B), 3),
    }
    nbr, valid = table.nbr, table.valid > 0
    rows = torch.arange(BIG_N, device=dev)[:, None].expand_as(nbr)[valid]

    def csr(values):
        return torch.sparse_coo_tensor(
            torch.stack([rows, nbr[valid]]), values, (BIG_N, BIG_N)
        ).coalesce().to_sparse_csr()

    # the library's yardstick on finite features: cuSPARSE multiplies, so a
    # NaN row reaches the sum through any slot
    finite = torch.nan_to_num(feats, nan=0.0)
    library = {}
    for mode, values in (("valid", torch.ones(rows.numel(), device=dev)),
                         ("static", weights["static"][valid]),
                         ("broadcast", weights["broadcast"][..., 0][valid])):
        adj = csr(values)
        lib_out = torch.sparse.mm(adj, finite)
        want = (sc.gather_sum_static_plain(table, finite, BIG_B) if mode == "valid"
                else sc.spmm_ell_weighted_plain(table, weights[mode], finite, BIG_B))
        if not torch.allclose(lib_out, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"library yardstick ({mode}) computes another function")
        del lib_out, want
        library[mode] = cuda_ms(lambda: torch.sparse.mm(adj, finite), 5)
        del adj
    del finite
    bounds = {m: ladder_bound(table, weights, BIG_B, HIDDEN, 4, m)
              for m in ("valid", "static", "broadcast", "per_sample")}
    for label, _, _, _, _ in routes:
        log(f"ladder timing {label}: ms={ms[label]:.4f}")
    for m, (bms, by) in bounds.items():
        extra = "".join(f"; {what} {t[m]:.4f} ms" for what, t in
                        (("torch.sparse.mm", library), ("plain", plain)) if m in t)
        log(f"ladder bound {m} weights: {bms:.4f} ms ({by}){extra}")
    del feats, ps
    probe = l2_probe(table, weights)
    del weights

    # the edge cases: every route on small tables
    cases = [  # (b, K, F, dtype)
        (1, 8, 128, torch.float32),
        (1, 12, 128, torch.bfloat16),
        (16, 8, 64, torch.bfloat16),
        (16, 12, 64, torch.float32),
        (16, 16, 64, torch.float32),
        (16, 32, 64, torch.bfloat16),
        (48, 8, 6, torch.float32),
        (48, 12, 8, torch.bfloat16),
        (48, 16, 8, torch.float32),
        (48, 32, 6, torch.float32),
    ]
    # the band walk of 2.6/2.7 (N x W x 4 > 2^31 bytes is the production
    # shape): a ragged last band (W = 140), W narrower than one band, the
    # scalar path (F = 3), each through every route
    band_cases = [
        (7, 16, 20, torch.float32),
        (7, 32, 20, torch.bfloat16),
        (1, 32, 8, torch.float32),
        (1, 16, 8, torch.bfloat16),
        (48, 32, 3, torch.float32),
        (48, 16, 3, torch.bfloat16),
    ]
    for name, seed, group in (("edge", 60, cases), ("band", 80, band_cases)):
        for i, (b, k, f, dtype) in enumerate(group):
            t = _table(5000, 5000 * k // 2, k, seed=seed + i, device=dev, dead_rows=300, dead_srcs=200)
            x, w, p, _ = ladder_inputs(t, b, f, dtype, 5 * seed + i)
            worst = 0.0
            for label, _, select, call, plain_fn in ladder_routes(t, x, w, p, b):
                err = hold_route(call(), plain_fn(), t, f"ladder {name}{i} {label}", select)
                errs[label] = max(errs[label], err)
                worst = max(worst, err)
            log(f"ladder case {name}{i}: N=5000 K={k} b={b} F={f} W={b * f} {str(dtype)[6:]} "
                f"deg0_rows={int((t.deg == 0).sum())} every route max_abs_err={worst:.3e} ok")

    # the band the walk takes at the production shape, and the probe's
    # gather rate at that width (one band, resident in L2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    band = sc.band_plan(BIG_N, BIG_B * HIDDEN, 4, 4, sms).band
    records = []
    for row, (counter, sched, replaces) in LADDER_ROWS.items():
        valid_sum = counter.startswith("ell_valid_sum")
        mode = "valid" if valid_sum else "broadcast"
        mine = [label for label, cs, _, _, _ in routes if counter in cs and f"({row})" in label]
        main = mine[0] if valid_sum else next(lb for lb in mine if " broadcast " in lb and lb.startswith(sched))
        rec = {
            "name": f"{counter} ({row}, sched={sched!r})",
            "route": "cuda",
            "source": f"{PKG}/ops/csrc/{'gather_sum_static.cu' if valid_sum else 'spmm_ell_weighted.cu'}",
            "replaces": f"bikg_graph_explainability_public_tpu/{replaces}",
            "launches": counts[counter],
            "max_abs_err": max(errs[lb] for lb in mine),
            "ms": ms[main],
            "plain_ms": plain[mode],
            "bound_ms": bounds[mode][0],
            "bound_by": bounds[mode][1],
            "library_ms": library[mode],
            "measured_route": main,
        }
        if not valid_sum:
            for m in ("static", "per_sample"):
                lb = next(lb for lb in mine if f" {m} " in lb and lb.startswith(sched))
                rec[f"{m}_ms"] = ms[lb]
                rec[f"{m}_bound_ms"] = bounds[m][0]
            rec["static_library_ms"] = library["static"]
            rec["l2_gather_GBps"] = probe[(band, "static")][1]
        rec["band_columns"] = band
        records.append(rec)
    return records


#: the ELL prototype's run shape (benchmarks/exp_spmm_pallas_run.py:15-22)
PROTO_N, PROTO_E, PROTO_F = 100_000, 1_000_000, 128


def build_ell(snd, rcv, w, n, k_round=8):
    """The ELL prototype's table (``benchmarks/exp_spmm_kernels.py::build_ell``):
    receiver-sorted edges into ``nbr, wk [N, K]``, K the largest degree
    rounded up to ``k_round``; padded slots hold ``nbr = 0, wk = 0``."""
    import numpy as np

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


def phase_all_slots(dev) -> dict:
    """Kernel 2.9, the ELL prototype's all-slot sum, at its run shape (100k
    nodes, 1M receiver-sorted edges, F = 128, float32, seed 0): one call of
    ``spmm_ell_all_slots`` with the counts set to 0, held against the plain
    version and against the prototype's reference (a segment sum over the
    edges), then timed beside ``torch.sparse.mm`` on the CSR of ``wk``.
    Returns the kernel's record."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(PROTO_N, PROTO_F)).astype(np.float32)
    snd = rng.integers(0, PROTO_N, PROTO_E).astype(np.int32)
    rcv = np.sort(rng.integers(0, PROTO_N, PROTO_E).astype(np.int32))
    w_np = rng.random(PROTO_E).astype(np.float32)
    nbr_np, wk_np, k = build_ell(snd, rcv, w_np, PROTO_N)
    x = torch.from_numpy(x_np).to(dev)
    nbr = torch.from_numpy(nbr_np).to(dev)
    wk = torch.from_numpy(wk_np).to(dev)
    table = sc.all_slots_table(nbr)

    reset_counts()
    got = sc.spmm_ell_all_slots(nbr, wk, x, table=table)
    counts = read_counts()
    expect_counts(counts, {"spmm_ell_all_slots": 1}, "kernel 2.9 (ELL prototype's run)")
    want = sc.spmm_ell_weighted_plain(table, wk, x, 1)
    err = hold_gather_sum(table, got, want, "2.9 prototype shape")
    # the prototype's own reference: the weighted segment sum over the edges
    ref = torch.zeros_like(got).index_add_(
        0, torch.from_numpy(rcv).to(dev).long(),
        torch.from_numpy(w_np).to(dev)[:, None] * x[torch.from_numpy(snd).to(dev).long()],
    )
    ref_err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"2.9: differs from the segment sum over the edges by {ref_err:.3e}")

    ms = cuda_ms(lambda: sc.spmm_ell_all_slots(nbr, wk, x, table=table), 20)
    plain_ms = cuda_ms(lambda: sc.spmm_ell_weighted_plain(table, wk, x, 1), 3)
    # yardstick only: cuSPARSE through torch.sparse.mm on the CSR of wk's
    # nonzero slots (the padded slots weigh 0)
    nz = wk != 0
    rows = torch.arange(PROTO_N, device=dev)[:, None].expand_as(nbr)[nz]
    adj = torch.sparse_coo_tensor(
        torch.stack([rows, nbr[nz].long()]), wk[nz], (PROTO_N, PROTO_N)
    ).coalesce().to_sparse_csr()
    if not torch.allclose(torch.sparse.mm(adj, x), want, rtol=1e-4, atol=1e-4):
        raise AssertionError("2.9: library yardstick computes another function")
    library_ms = cuda_ms(lambda: torch.sparse.mm(adj, x), 20)
    # where its time goes: the padded slots all name row 0, so their gathers
    # hit one segment of each band in L2; the same sum with each padded slot
    # naming its own row (weight 0 all the same: the same function on finite
    # features) shows what that costs
    pad = wk == 0
    own = torch.arange(PROTO_N, dtype=torch.int32, device=dev)[:, None].expand_as(nbr)
    spread = torch.where(pad, own, nbr).contiguous()
    spread_table = sc.all_slots_table(spread)
    spread_out = sc.spmm_ell_all_slots(spread, wk, x, table=spread_table)
    if not torch.allclose(spread_out, want, rtol=1e-5, atol=1e-5):
        raise AssertionError("2.9: the spread padding changes the sum")
    del spread_out
    spread_ms = cuda_ms(lambda: sc.spmm_ell_all_slots(spread, wk, x, table=spread_table), 20)
    log(f"kernel 2.9: {int(pad.sum())} of {pad.numel()} slots are padding on row 0; "
        f"the same sum with the padding spread over the rows' own indices takes "
        f"{spread_ms:.4f} ms")
    # least bytes: each source row that a slot names read once, every slot's
    # index and weight once (all K are summed), the output written once;
    # a multiply and an add per slot and column
    uniq = int(torch.unique(nbr).numel())
    nbytes = uniq * PROTO_F * 4 + PROTO_N * k * 8 + PROTO_N * PROTO_F * 4
    ops = 2 * PROTO_N * k * PROTO_F
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / F32_OPS_PER_S}
    bound_by = max(t, key=t.get)
    log(f"kernel 2.9 at the prototype's shape N={PROTO_N} E={PROTO_E} K={k} F={PROTO_F}: "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={t[bound_by] * 1e3:.4f} ({bound_by}, {nbytes / 1e9:.3f} GB) "
        f"max_abs_err={err:.3e} (plain), {ref_err:.3e} (segment sum) ok")
    return {
        "name": "spmm_ell_all_slots (2.9)",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/spmm_ell_weighted.cu",
        "replaces": "benchmarks/exp_spmm_pallas_proto.py:21",
        "launches": counts["spmm_ell_all_slots"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": t[bound_by] * 1e3,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_note": "torch.sparse.mm on the CSR of wk's nonzero slots",
        "padded_slots": int(pad.sum()),
        "spread_padding_ms": spread_ms,
    }


def phase_model_families(dev, config) -> None:
    """The homogeneous model families through the generic batched forward:
    the trained GAT fixture on the node, edge and graph problems; GAT-128x2
    (seeded weights) on the 20k / 160k graph, 4 node and 4 edge queries;
    GATv2, SAGE, GraphConv and GIN at conv (128, 128), one node query each.
    The first query of each model, and every fixture run, is checked
    against the same run on the CPU."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
    from bikg_graph_explainability_public_tpu_torch.models import gnn
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.torch_import import (
        gat_node_model_params, load_state_dict,
    )

    def explain(make, feat, ei, names, problem, element, check: bool, label: str):
        t0 = time.perf_counter()
        ex = Explainer(feat, ei, Model(make(), device=dev), config, names, problem=problem, device=dev)
        ex = ex._explain(element, times=1)
        torch.cuda.synchronize()
        msg = f"{label}: {len(ex.names)} elements, wall {time.perf_counter() - t0:.3f} s"
        if check:
            cpu = Explainer(feat, ei, Model(make(), device="cpu"), config, names, problem=problem,
                            device="cpu")._explain(element, times=1)
            msg += f", max |card - cpu| {_check_against_cpu(ex, cpu, label):.3e}"
        elif not np.isfinite(ex.mean).all():
            raise AssertionError(f"{label}: non-finite scores")
        log(msg + " ok")

    sd = load_state_dict(os.path.join(ROOT, "test_data", "gat_homo_1hop_36n_own.pth.tar"))

    def fixture():
        mdef = gnn.gat_node_model(N_FEATS, conv_channels=(16,), fc_channels=(16, 16, 32))
        mdef.load_state_dict(gat_node_model_params(sd))
        return mdef

    data = np.load(os.path.join(ROOT, "test_data", "toy_graph_36n.npz"))
    feat, ei = data["feat"], data["edge_index"]
    node_names = [str(x) for x in data["names"]]
    edge_names = [str(i) for i in range(ei.shape[1])]
    for problem, names, element in (("node_prediction", node_names, "10"),
                                    ("edge_prediction", edge_names, "10"),
                                    ("graph_prediction", node_names, None)):
        explain(fixture, feat, ei, names, problem, element, True, f"GAT fixture 36n {problem}")

    feat, ei, rng = random_graph(NODE_N, NODE_E, seed=5)
    families = {
        "GAT-128x2": lambda g: gnn.gat_node_model(
            N_FEATS, conv_channels=(HIDDEN, HIDDEN), heads=1, fc_channels=(HIDDEN, 64), generator=g),
        "GATv2-128x2": lambda g: gnn.gatv2_node_model(
            N_FEATS, conv_channels=(HIDDEN, HIDDEN), fc_channels=(HIDDEN, 64), generator=g),
        "SAGE-128x2": lambda g: gnn.sage_node_model(
            N_FEATS, conv_channels=(HIDDEN, HIDDEN), fc_channels=(HIDDEN, 64), generator=g),
        "GraphConv-128x2": lambda g: gnn.graph_conv_node_model(
            N_FEATS, conv_channels=(HIDDEN, HIDDEN), fc_channels=(HIDDEN, 64), generator=g),
        "GIN-128x2": lambda g: gnn.gin_node_model(
            N_FEATS, conv_channels=(HIDDEN, HIDDEN), mlp_hidden=HIDDEN, fc_channels=(HIDDEN, 64),
            generator=g),
    }
    for name, factory in families.items():
        def make(factory=factory):
            return factory(torch.Generator().manual_seed(0))
        problems = ("node_prediction", "edge_prediction") if name == "GAT-128x2" else ("node_prediction",)
        for problem in problems:
            n_el = NODE_E if problem == "edge_prediction" else NODE_N
            names = [str(i) for i in range(n_el)]
            queries = rng.integers(0, n_el, NODE_QUERIES if name == "GAT-128x2" else 1)
            for qi, q in enumerate(queries):
                explain(make, feat, ei, names, problem, str(int(q)), qi == 0,
                        f"{problem.split('_')[0]} path 20k/160k {name} query {int(q)}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    with open(os.path.join(ROOT, "config", "configs.json")) as f:
        config = json.load(f)

    t_start = time.perf_counter()
    card = phase_header()
    phase_build()
    rec_23, graph, table = phase_kernel(dev)
    rec_24, rec_tr = phase_kernel_weighted(dev, table)
    rec_21, rec_22, rec_op = phase_kernel_dense(dev)
    ladder_counts = {}
    ladder = phase_ladder(dev, graph, table, ladder_counts)
    rec_tr["launches"] = ladder_counts["batched_gather_sum.transpose"]
    del graph, table
    rec_29 = phase_all_slots(dev)
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    reset_counts()
    phase_explanations(dev, config, "node_prediction")
    expect_counts(read_counts(), {}, "node path (dense tier, query plans)")
    reset_counts()
    phase_explanations(dev, config, "edge_prediction")
    expect_counts(read_counts(), {}, "edge path (dense tier, edge query plans)")
    rec_23["launches"] = phase_graph_path(dev, config, rec_23)
    rec_24["launches"] = phase_ell_edge_forward(dev)
    rec_21["launches"], rec_op["launches"], rec_22["launches"] = phase_dense_fused(dev)
    reset_counts()
    phase_model_families(dev, config)
    expect_counts(read_counts(), {}, "model families (generic forward, segment operations)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [rec_21, rec_op, rec_22, rec_23, rec_24, rec_tr] + ladder + [rec_29]}),
          flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
