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
   package's benchmarks: its flag pass ``nonfinite_rows``, then the band
   walk's guarded select) at the prototype's run shape (100k / 1M, F =
   128), counted, held bit for bit against 2.6's static walk on the same
   table (also with Inf and NaN in the features), against its plain version
   and the prototype's segment sum, checked for host synchronisation, held
   in six edge cases (bf16, F = 3, F = 96 with 16-byte and scalar lanes,
   K = 8), and timed (the entry, each launch, 2.6's static walk) beside
   ``torch.sparse.mm``;
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
   the CPU;
10. the hetero node and edge paths: ``Explainer``'s arrays on dict inputs
   with a ``HeteroGNN`` of GCNConvs (conv (128,), fc (128, 64), seeded
   weights) on bench.py's hetero explanation graph (2 x 4000 nodes, 3 x
   24,000 edges): 4 node queries of type a and 4 edge queries of relation
   (a, r1, b), in Shapley mode and in community mode (32 communities a
   type or relation), then the repo's hetero toy example (9 nodes) in both
   modes, every run held against the same run on the CPU
   (receptive-field plans: no kernel launches);
11. the hetero ELL tier (``FastBatchedHeteroGCN``) on bench.py's
   full-graph hetero workload (2 x 50,000 nodes, 3 x 333,333 edges, conv
   (128, 128)): ``graph_prediction`` through ``Explainer`` (1000 masks in
   chunks of 48), counting kernel 2.3's launches (one a relation and chunk
   in layer 2), with its set-up / forwards / rest split and a profile;
   the unrestricted edge forward (1000 edge masks, query row 17), counting
   kernel 2.4's; one chunk of each held against the plain route; then both
   kernels on each relation's type-scoped table (50,000 output rows over
   100,000 or 50,000 source rows, B = 48), held against their plain
   versions and timed beside them, their bounds and, for 2.3,
   ``torch.sparse.mm``, and in three edge cases (K = 12 and 20, rows of
   degree 0, more or fewer source rows than output rows);
12. the multi-query path (``explain/batch.py::_explain_many``, the arrays
   behind ``explain_many``; no hand kernel): the 36-node fixture in
   Shapley mode, community mode, an edge and a graph problem, each held
   against the CPU; then bench.py's workload (20k / 160k, GCN-128, 16
   queries) in Shapley and community mode: explanations/s (best of 3
   after a warm-up), the size buckets, a phase split, the device's busy
   share in one traced call (the card's activity only, its trace written
   under ``build/traces/``), peak memory, a launch-plan cache hit, and
   every query held against the CPU;
13. hetero ``explain_many`` through the public import (``px``; its array
   form ``batch._explain_many``; no hand kernel): bench.py's hetero
   workload (2 x 4000 nodes, 3 x 24,000 edges, a hetero GCN, 16 queries)
   on the hetero_dense formulation in Shapley and community mode:
   explanations/s, the phase split, the busy share (the card's activity
   only), peak memory, stacks and buckets; then the typed coo route (4
   edge queries of (a, r1, b) and a graph problem); every query held
   against the CPU (the graph problem at a reduced budget); one
   ``px.Explainer`` call;
14. the last model families (no hand kernel): on bench.py's hetero
   explanation graph, a HeteroGNN of GATConvs (conv (128,), fc (128, 64),
   seeded weights) explains 4 node queries of type a in Shapley and in
   community mode on ``FastBatchedHeteroGAT``'s plans (asserted), 1 edge
   query of (a, r1, b) through the generic forward and 4 node queries
   through ``explain_many`` (the typed coo route); a HeteroGNN of
   SAGEConvs 1 node query; ``RGCNNodeModel`` (3 relations, conv (128,
   128)) 2 node queries on the 20k / 160k graph with seeded edge types;
   then ``import_any`` on the three models' state dicts in PyG's layout,
   a forward each held against the factory's model.  The first query of
   each model and the ``explain_many`` call are held against the CPU;
15. the distributed path (``parallel/``, no hand kernel) at world size 1:
   ``initialize_distributed`` on a file store in a temporary directory and
   ``make_mesh(1)`` on the card, so NCCL (no ``NCCL_SOCKET_IFNAME`` is
   needed: one rank's bootstrap finds ``lo``), every sharded call held
   against its unsharded counterpart: (a) 2 node queries of GCN-128x2 on
   the 20k / 160k graph through ``Explainer`` with a ``ShardedModel``
   against ``Model`` (``rtol=1e-3, atol=1e-5``, both walls); (b)
   ``halo_masked_outputs`` on the graph problem of the 100k / 1M graph at
   B = 16 (its ``[E, B, C]`` messages are 8.2 GB a layer) against
   ``FastBatchedGCN``'s ELL tier on the same masks (``rtol=1e-4,
   atol=1e-5``), the time a mask of each and the peak memory; (c) a hetero
   node query (bench.py's hetero explanation graph, a HeteroGNN of
   GCNConvs) through ``ShardedModel``'s hetero halo against ``Model``; (d)
   ``explain_many(mesh=)`` on bench.py's 20k / 160k workload (16 queries,
   Shapley) bit for bit against ``mesh=None``, first and hot walls; (e)
   ``sharded_query_outputs`` and one ``explain_training_step`` against the
   unsharded calls.  Every kernel's launch count on the sharded calls is 0;
   only (b)'s unsharded reference launches 2.3 (3 calls, one each).  The
   group is destroyed at the end of the phase.

The node path (4) also prints ``Explainer._explain``'s diagnostics (its
phase split) for each 20k / 160k query.

Every path runs with all launch counts set to 0 just before it and read
just after; each prints the script's elapsed seconds when it is done.  The line before the last is ``{"kernels": [...]}``; the last
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


def gcn_128x2(seed: int, device, n_conv: int = 2):
    """GCN-128x2 (in 84, conv 128/128, fc 128/64/1) with seeded numpy
    weights, loaded through ``params_from_numpy``; ``n_conv=1`` gives
    ``bench.py``'s explanation model (conv 128, fc 128/64/1)."""
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
        "conv": [dense(HIDDEN, N_FEATS)] + [dense(HIDDEN, HIDDEN) for _ in range(n_conv - 1)],
        "fc": [dense(64, HIDDEN), dense(1, 64)],
    }
    mdef = GCNNodeModel(N_FEATS, conv_channels=(HIDDEN,) * n_conv, fc_channels=(HIDDEN, 64))
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
        "nonfinite_rows": spmm_cuda.NONFINITE_ROWS,
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


def check_kernel_case(table, b, f, dtype, scale, seed, label, n_src=None):
    """Kernel 2.3 against plain on one input, with ``n_src`` source rows
    (default: the table's rows); returns (max_abs_err, feats, ps, the band
    walk's plan, the rows of degree above its slot tile)."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc
    from bikg_graph_explainability_public_tpu_torch.ops.spmm_cuda import (
        gather_sum_static, gather_sum_static_plain,
    )

    dev = table.nbr.device
    n = table.nbr.shape[0]
    n_src = n if n_src is None else n_src
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n_src, b * f), generator=gen, device=dev).to(dtype)
    used = torch.zeros(n_src, dtype=torch.bool, device=dev)
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
        f"kernel case {label}: N={n} N_src={n_src} K={table.k} b={b} F={f} {str(dtype)[6:]} "
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


def weighted_inputs(table, b, f, dtype, seed, n_src=None):
    """Kernel 2.4's inputs: features over ``n_src`` source rows (default:
    the table's rows) with NaN in the rows that no valid slot names and in
    one named row ``r0``; sample-major weights ``w_bnk [B, N, K]``, a third
    of them exactly 0 (the masked edges) and every slot that names ``r0``
    weighing 0, so that 2.4's multiply keeps 0 * NaN on the rows that name
    it.  Returns (feats, w_bnk, the rows that name r0, the NaN rows that no
    valid slot names)."""
    import torch

    dev = table.nbr.device
    n, k = table.nbr.shape
    n_src = n if n_src is None else n_src
    valid = table.valid > 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n_src, b * f), generator=gen, device=dev).to(dtype)
    used = torch.zeros(n_src, dtype=torch.bool, device=dev)
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


def check_weighted_case(table, b, f, dtype, seed, label, n_src=None):
    """Kernel 2.4 against its plain version on one input (``n_src`` source
    rows, default the table's), through both entries: the sample-major
    weights as they are (``w_sample``) and their slot-major copy
    (``w_slot``, transposed on the card first), bit for bit.  Returns
    (feats, w_bnk)."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    n, k = table.nbr.shape
    feats, w_bnk, named_r0, nan_rows = weighted_inputs(table, b, f, dtype, seed, n_src)
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
        f"kernel case {label}: N={n} N_src={feats.shape[0]} K={k} b={b} F={f} W={w} "
        f"{str(dtype)[6:]} deg0_rows={int((table.deg == 0).sum())} nan_rows={nan_rows} "
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
            f"{label}: the run and its reference disagree, max abs diff "
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
        ex, diag = ex._explain(q, times=1, return_diagnostics=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = ", ".join(f"{k} {v:.4f} s" for k, v in diag["phase_seconds"].items())
        msg = (f"{path} 20k/160k GCN-128x2 query {q}: {len(ex.names)} elements "
               f"(subgraph {diag['subgraph_nodes']} nodes / {diag['subgraph_edges']} edges), "
               f"wall {wall:.3f} s; diagnostics: {phases}, best epoch {diag['best_epoch'][0]}")
        if qi == 0:
            cpu_model, _ = gcn_128x2(seed=0, device="cpu")
            ex_cpu = Explainer(feat, ei, cpu_model, config, names, problem=problem, device="cpu")
            ex_cpu = ex_cpu._explain(q, times=1)
            msg += f", max |card - cpu| {_check_against_cpu(ex, ex_cpu, 'query ' + q):.3e}"
        elif not np.isfinite(ex.mean).all():
            raise AssertionError(f"query {q}: non-finite scores")
        log(msg + " ok")


#: bench.py's explanation workload (bench.py:439-483): the 20k / 160k graph
#: (pad_mode "exact"), 16 queries, its CFG_FULL; community mode on seed 7
#: with 32 communities
EXPLAIN_Q, EXPLAIN_K = 16, 32
CFG_FULL = {"seed": 1, "interpret_samples": 20, "epochs": 50, "lr": 0.01, "l1_lambda": 1e-4}


def _hold_many(got, want, label) -> float:
    """Every query's explanation from the card against the CPU's."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} explanations, the CPU gave {len(want)}")
    return max(
        _check_against_cpu(g, w, f"{label} query {i}") for i, (g, w) in enumerate(zip(got, want))
    )


def _identical(got, want, label) -> None:
    """Two calls' explanations bit for bit (two hot calls run one plan, as
    do ``explain_many`` with and without a one-rank mesh)."""
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        same = g.names == w.names and np.array_equal(g.mean, w.mean) and np.array_equal(g.std, w.std)
        if g.pathway_scores is not None:
            same = same and np.array_equal(g.pathway_scores, w.pathway_scores)
        if not same:
            raise AssertionError(f"{label} query {i}: the two calls differ")


def phase_explain_many(dev, config) -> None:
    """The multi-query path ``explain/batch.py::_explain_many`` (the array
    form of ``explain_many``; no pandas here): the 36-node fixture in
    Shapley mode (queries 10, 3, 25, three repeats), community mode, one
    edge and one graph problem, each held against the same call on the CPU;
    then bench.py's workload in Shapley and community mode: one warm-up
    call, the best of 3, explanations/s, the buckets, the phase split of
    the first and of a later call (which must hit the launch-plan cache and
    give the last timed call's arrays bit for bit), the device's busy share
    in one traced call, peak memory, and every query of the first and of
    the last timed call held against the same call on the CPU."""
    from collections import Counter

    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain import batch
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.checkpoint import load_params
    from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel
    from bikg_graph_explainability_public_tpu_torch.utils.padding import round_up_pow2
    from bikg_graph_explainability_public_tpu_torch.utils.profiling import PhaseTimer
    from torch.profiler import ProfilerActivity, profile

    data = np.load(os.path.join(ROOT, "test_data", "toy_graph_36n.npz"))
    feat, ei = data["feat"], data["edge_index"]
    names = [str(x) for x in data["names"]]
    edge_names = [str(i) for i in range(ei.shape[1])]
    ckpt = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
    perm = np.random.default_rng(1).permutation(len(names))
    pathways = [[str(int(v)) for v in c] for c in np.array_split(perm, 4)]
    community = dict(pathways=pathways, pathway_names=[f"community_{i}" for i in range(4)])
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Model(GCNNodeModel(N_FEATS), load_params(ckpt), device=d)
        g = from_arrays(feat, ei, device=d)
        runs[where] = [
            batch._explain_many(model, g, [10, 3, 25], config, names, times=3),
            batch._explain_many(model, g, [10, 3, 25], config, names, **community),
            batch._explain_many(model, g, [10, 3, 25], config, edge_names, problem="edge_prediction"),
            batch._explain_many(model, g, [0], config, names, problem="graph_prediction"),
        ]
    labels = ("shapley times=3", "community", "edge_prediction", "graph_prediction")
    for label, got, want in zip(labels, runs["card"], runs["cpu"]):
        diff = _hold_many(got, want, f"explain_many 36n {label}")
        log(f"explain_many 36n fixture {label}: {len(got)} queries, max |card - cpu| {diff:.3e} ok")

    for mode, seed in (("shapley", 5), ("community", 7)):
        feat, ei, rng = random_graph(NODE_N, NODE_E, seed=seed)
        kw = {}
        if mode == "community":
            names = [str(i) for i in range(NODE_N)]
            perm = rng.permutation(NODE_N)
            kw = dict(
                names=names,
                pathways=[[names[j] for j in perm[i::EXPLAIN_K]] for i in range(EXPLAIN_K)],
                pathway_names=[f"pw{i}" for i in range(EXPLAIN_K)],
            )
        queries = [int(q) for q in rng.integers(0, NODE_N, EXPLAIN_Q)]
        model, _ = gcn_128x2(seed=0, device=dev, n_conv=1)
        g = from_arrays(feat, ei, pad_mode="exact", device=dev)
        label = f"explain_many {mode} 20k/160k GCN-128 Q={EXPLAIN_Q}"

        def call(timer=None):
            out = batch._explain_many(model, g, queries, CFG_FULL, timer=timer, **kw)
            torch.cuda.synchronize()
            return out

        first_timer = PhaseTimer()
        t0 = time.perf_counter()
        first = call(first_timer)
        first_wall = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            timed = call()
            walls.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        best = min(walls)
        hot_timer = PhaseTimer()
        _identical(call(hot_timer), timed, label)
        if "plan_build" in hot_timer.counts:
            raise AssertionError(f"{label}: a later call missed the launch-plan cache")
        buckets = Counter(
            (round_up_pow2(s.graph.num_nodes), max(round_up_pow2(s.graph.num_edges), 8))
            for s in (batch._subgraph_cached(g, q, 2) for q in queries)
        )
        log(f"{label}: {EXPLAIN_Q / best:.2f} explanations/s (best of 3: {best:.4f} s; "
            f"all {', '.join(f'{w:.4f}' for w in walls)}); first call {first_wall:.3f} s; "
            f"peak {peak_gb:.3f} GB")
        log(f"{label}: buckets (n_pad, e_pad): queries "
            + ", ".join(f"{k}: {v}" for k, v in sorted(buckets.items())))
        for name, timer in (("first call", first_timer), ("later call (plan cache hit)", hot_timer)):
            log(f"{label} phases, {name} (device synchronised at each phase's exit): "
                + ", ".join(f"{k} {v:.4f} s x{timer.counts[k]}" for k, v in timer.totals.items()))
        t_prof = time.perf_counter()
        # the card's activity only: recording the host's too cost seconds
        # of post-processing a call
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            traced_wall = time.perf_counter() - t0
        os.makedirs(os.path.join(ROOT, "build", "traces"), exist_ok=True)
        prof.export_chrome_trace(os.path.join(ROOT, "build", "traces", f"explain_many_{mode}.json"))
        log(f"{label}: the traced call took {traced_wall * 1e3:.1f} ms; its device time "
            f"against the best unprofiled call's wall:")
        log_device_profile(prof, best, label, traced_wall)
        log(f"{label}: the traced call, its trace file and its tables took "
            f"{time.perf_counter() - t_prof:.2f} s of host time")

        cpu_model, _ = gcn_128x2(seed=0, device="cpu", n_conv=1)
        cpu_g = from_arrays(feat, ei, pad_mode="exact", device="cpu")
        t0 = time.perf_counter()
        cpu = batch._explain_many(cpu_model, cpu_g, queries, CFG_FULL, **kw)
        cpu_wall = time.perf_counter() - t0
        diff = _hold_many(first, cpu, label + " first call")
        diff_timed = _hold_many(timed, cpu, label + " last timed call")
        log(f"{label}: every query of the first and of the last timed call held against the "
            f"CPU's call ({cpu_wall:.2f} s on the host), max |card - cpu| {diff:.3e} and "
            f"{diff_timed:.3e} ok")


#: operations listed from a device profile
PROFILE_TOP = 12


def log_device_profile(prof, wall_s: float, label: str, traced_wall_s=None) -> None:
    """Device time by operation from a finished ``torch.profiler`` run, and
    the device's busy share of ``wall_s``, the unprofiled wall time of the
    same work (or the traced pass's own wall time); with ``traced_wall_s``,
    also its share of the traced pass's own wall time."""
    from torch.autograd import DeviceType

    # one aggregation of the events serves both tables: each call of
    # key_averages() walks every event again
    events = prof.key_averages()
    # device-side events only: the host ops that launched them carry the
    # same time again
    rows = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log(f"{label} profile: the profiler recorded no device time")
        return
    traced = "" if traced_wall_s is None else (
        f"; of the traced call's own {traced_wall_s * 1e3:.1f} ms wall, busy share "
        f"{busy_ms / (traced_wall_s * 1e3):.3f}")
    log(f"{label} profile: device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"(busy share {busy_ms / (wall_s * 1e3):.3f}){traced}; top operations by device time:")
    for ms, count, name in rows[:PROFILE_TOP]:
        short = name if len(name) <= 100 else f"{name[:45]} ... {name[-50:]}"
        log(f"  {ms:10.3f} ms  {count:6d} calls  {short}")
    host = sorted(
        (
            (e.self_cpu_time_total / 1e3, e.count, e.key)
            for e in events
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0
        ),
        reverse=True,
    )
    if host:  # none where only the card's activity was recorded
        log(f"{label} profile: top host operations by self CPU time:")
    for ms, count, name in host[:6]:
        log(f"  {ms:10.3f} ms  {count:6d} calls  {name[:100]}")


def profile_forwards(run, wall_s: float, label: str) -> None:
    """Device time by operation over one more pass of ``run()``
    (``torch.profiler``), and the device's busy share of the unprofiled
    wall time ``wall_s`` of the same pass."""
    import torch
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
    log_device_profile(prof, wall_s, label)


def expect_delta(before: dict, expected: dict, label: str) -> None:
    """:func:`expect_counts` on the launches made since ``before`` (a
    :func:`read_counts`)."""
    now = read_counts()
    expect_counts({k: now[k] - before[k] for k in now}, expected, label)


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


def hold_guard(got, static, plain, label) -> None:
    """Kernel 2.9 against 2.6's static walk on the same table: bit for bit
    (``torch.equal`` where not NaN, so zeros of either sign are equal, and
    NaN at the same places), and NaN exactly where the plain version (the
    multiply, ``0 * NaN`` kept) has it."""
    import torch

    torch.cuda.synchronize()
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(plain)):
        raise AssertionError(f"{label}: NaN entries differ from the plain version's")
    if not torch.equal(nan, torch.isnan(static)):
        raise AssertionError(f"{label}: NaN entries differ from 2.6's static walk")
    if not torch.equal(got[~nan], static[~nan]):
        raise AssertionError(
            f"{label}: differs from 2.6's static walk by "
            f"{(got[~nan] - static[~nan]).abs().max().item():.3e} (bit for bit expected)"
        )


def guard_case(dev, n, k, f, dtype, seed, label, misalign=False) -> None:
    """Kernel 2.9 on a random table of the prototype's form: each row a
    random number of weighted slots in front, the rest padding ``nbr = 0,
    wk = 0`` (some ``-0.0``), a tenth of the front slots zero-weight
    (interior zeros); ``x`` with Inf, -Inf and NaN in row 0 and a NaN in a
    row that only an interior zero-weight slot names.  Held by
    :func:`hold_guard`; ``misalign`` offsets ``x`` by one element (scalar
    lanes at any F)."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, n)
    front = np.arange(k)[None, :] < deg[:, None]
    # row n - 1 is named by no slot but the one below
    nbr_np = np.where(front, rng.integers(1, n - 1, (n, k)), 0).astype(np.int32)
    wk_np = np.where(front, rng.normal(size=(n, k)), 0.0).astype(np.float32)
    wk_np[front & (rng.random((n, k)) < 0.1)] = 0.0
    wk_np[~front & (rng.random((n, k)) < 0.5)] = -0.0
    # a row named only by one interior zero-weight slot, NaN in column f // 2
    v = int(np.flatnonzero(deg >= 3)[0])
    u = n - 1
    nbr_np[v, 1], wk_np[v, 1] = u, 0.0
    x_np = rng.normal(size=(n, f)).astype(np.float32)
    x_np[0, 0], x_np[0, (1 % f)], x_np[0, (2 % f)] = np.inf, -np.inf, np.nan
    x_np[u, f // 2] = np.nan
    x = torch.from_numpy(x_np).to(dev, dtype)
    if misalign:
        buf = torch.empty(n * f + 1, dtype=dtype, device=dev)
        buf[1:].copy_(x.view(-1))
        x = buf[1:].view(n, f)
    nbr, wk = torch.from_numpy(nbr_np).to(dev), torch.from_numpy(wk_np).to(dev)
    table = sc.all_slots_table(nbr)
    got = sc.spmm_ell_all_slots(nbr, wk, x, table=table)
    hold_guard(got, sc.spmm_ell_weighted(table, wk, x, 1),
               sc.spmm_ell_weighted_plain(table, wk, x, 1), label)
    if not bool(torch.isnan(got[v, f // 2])):
        raise AssertionError(f"{label}: the interior zero-weight slot's 0 * NaN is lost")
    vec = 1 if x.data_ptr() % 16 or f % (16 // x.element_size()) else 16 // x.element_size()
    log(f"{label}: N={n} K={k} F={f} {str(dtype).split('.')[-1]} vec={vec} "
        f"NaN entries {int(torch.isnan(got).sum())}, bit for bit with 2.6's static walk ok")


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


def proto_inputs(dev):
    """The prototype's run inputs, seed 0: (x, nbr, wk, K, snd, rcv, w) with
    the edge lists as numpy arrays."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(PROTO_N, PROTO_F)).astype(np.float32)
    snd = rng.integers(0, PROTO_N, PROTO_E).astype(np.int32)
    rcv = np.sort(rng.integers(0, PROTO_N, PROTO_E).astype(np.int32))
    w_np = rng.random(PROTO_E).astype(np.float32)
    nbr_np, wk_np, k = build_ell(snd, rcv, w_np, PROTO_N)
    x = torch.from_numpy(x_np).to(dev)
    return (x, torch.from_numpy(nbr_np).to(dev), torch.from_numpy(wk_np).to(dev), k, snd, rcv,
            w_np)


def phase_all_slots(dev, card: str) -> tuple:
    """Kernel 2.9, the ELL prototype's all-slot sum, at its run shape (100k
    nodes, 1M receiver-sorted edges, F = 128, float32, seed 0): one call of
    ``spmm_ell_all_slots`` (the flag pass, then the guarded walk) with the
    counts set to 0, held bit for bit against 2.6's static walk on the same
    table and against the plain version and the prototype's segment sum;
    again with Inf and NaN in row 0 (which only padded slots name) and with a
    NaN row that only an interior zero-weight slot names; one call under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation);
    then the edge cases (bf16, F = 3, F = 96 with scalar lanes, K = 8).  The
    entry, the flag pass and the walk are timed apart, in turns with 2.6's
    static walk on the same table (2.9's former route), the same with its
    padding spread over the rows, and ``torch.sparse.mm``.  Returns the
    records of 2.9 and of its flag pass."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    x, nbr, wk, k, snd, rcv, w_np = proto_inputs(dev)
    table = sc.all_slots_table(nbr)
    table.deg  # the table's one host check, before the counted call

    reset_counts()
    got = sc.spmm_ell_all_slots(nbr, wk, x, table=table)
    counts = read_counts()
    expect_counts(counts, {"spmm_ell_all_slots": 1, "nonfinite_rows": 1},
                  "kernel 2.9 (ELL prototype's run)")
    want = sc.spmm_ell_weighted_plain(table, wk, x, 1)
    err = hold_gather_sum(table, got, want, "2.9 prototype shape")
    hold_guard(got, sc.spmm_ell_weighted(table, wk, x, 1), want, "2.9 prototype shape")
    # the prototype's own reference: the weighted segment sum over the edges
    ref = torch.zeros_like(got).index_add_(
        0, torch.from_numpy(rcv).to(dev).long(),
        torch.from_numpy(w_np).to(dev)[:, None] * x[torch.from_numpy(snd).to(dev).long()],
    )
    ref_err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"2.9: differs from the segment sum over the edges by {ref_err:.3e}")
    bad = sc.nonfinite_rows(x)
    if not torch.equal(bad, sc.nonfinite_rows_plain(x)) or bad.any():
        raise AssertionError("2.9 flag pass: differs from its plain version on finite x")
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sc.spmm_ell_all_slots(nbr, wk, x, table=table)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(again, got):
        raise AssertionError("2.9: a second call differs")
    log("kernel 2.9: bit for bit with 2.6's static walk; no host synchronisation in the entry")

    # non-finite features: Inf, -Inf and NaN in row 0, which only the
    # padded slots (weight 0) name, so every padded row comes out NaN there
    x0 = x.clone()
    x0[0, :3] = torch.tensor([float("inf"), float("-inf"), float("nan")], device=dev)
    bad0 = sc.nonfinite_rows(x0)
    if not torch.equal(bad0, sc.nonfinite_rows_plain(x0)) or int(bad0.sum()) != 1:
        raise AssertionError("2.9 flag pass: row 0 not flagged alone")
    got0 = sc.spmm_ell_all_slots(nbr, wk, x0, table=table)
    hold_guard(got0, sc.spmm_ell_weighted(table, wk, x0, 1),
               sc.spmm_ell_weighted_plain(table, wk, x0, 1), "2.9 Inf/NaN in row 0")
    padded_rows = int((wk == 0).any(dim=1).sum())
    if int(torch.isnan(got0[:, :3]).all(dim=1).sum()) != padded_rows:
        raise AssertionError("2.9: the padded rows do not all keep 0 * Inf/NaN")
    # a NaN row that only an interior zero-weight slot names
    front = (wk != 0).sum(dim=1)
    v = int(torch.nonzero(front >= 3)[0])
    named = torch.zeros(PROTO_N, dtype=torch.bool, device=dev)
    named[nbr[wk != 0].long()] = True
    named[0] = True
    u = int(torch.nonzero(~named)[0])
    nbr1, wk1, x1 = nbr.clone(), wk.clone(), x.clone()
    nbr1[v, 1], wk1[v, 1], x1[u, 5] = u, 0.0, float("nan")
    table1 = sc.all_slots_table(nbr1)
    got1 = sc.spmm_ell_all_slots(nbr1, wk1, x1, table=table1)
    hold_guard(got1, sc.spmm_ell_weighted(table1, wk1, x1, 1),
               sc.spmm_ell_weighted_plain(table1, wk1, x1, 1), "2.9 NaN behind an interior zero")
    if int(torch.isnan(got1).sum()) != 1 or not bool(torch.isnan(got1[v, 5])):
        raise AssertionError("2.9: NaN behind an interior zero-weight slot not at its place alone")
    log(f"kernel 2.9: Inf/NaN in row 0 -> NaN on {padded_rows} padded rows; NaN row {u} behind "
        f"row {v}'s interior zero-weight slot -> NaN at ({v}, 5) alone; bit for bit ok")
    del x0, got0, nbr1, wk1, x1, got1, table1
    for args in ((5000, 32, 128, torch.bfloat16, 31, "2.9 bf16 F=128"),
                 (5000, 16, 3, torch.float32, 32, "2.9 F=3"),
                 (5000, 16, 3, torch.bfloat16, 33, "2.9 bf16 F=3"),
                 (5000, 32, 96, torch.float32, 34, "2.9 F=96"),
                 (5000, 8, 128, torch.float32, 36, "2.9 K=8")):
        guard_case(dev, *args)
    guard_case(dev, 5000, 32, 96, torch.float32, 35, "2.9 F=96 scalar lanes", misalign=True)

    # timings, in turns: the entry, its two launches, 2.6's static walk on
    # the same table (2.9's former route), the same with each padded slot
    # naming its own row (weight 0 all the same: the same function on finite
    # features), and cuSPARSE through torch.sparse.mm on the CSR of wk's
    # nonzero slots (a yardstick only)
    pad = wk == 0
    own = torch.arange(PROTO_N, dtype=torch.int32, device=dev)[:, None].expand_as(nbr)
    spread = torch.where(pad, own, nbr).contiguous()
    spread_table = sc.all_slots_table(spread)
    if not torch.allclose(sc.spmm_ell_weighted(spread_table, wk, x, 1), want, rtol=1e-5, atol=1e-5):
        raise AssertionError("2.9: the spread padding changes the sum")
    nz = ~pad
    rows = torch.arange(PROTO_N, device=dev)[:, None].expand_as(nbr)[nz]
    adj = torch.sparse_coo_tensor(
        torch.stack([rows, nbr[nz].long()]), wk[nz], (PROTO_N, PROTO_N)
    ).coalesce().to_sparse_csr()
    if not torch.allclose(torch.sparse.mm(adj, x), want, rtol=1e-4, atol=1e-4):
        raise AssertionError("2.9: library yardstick computes another function")
    runs = in_turns({
        "entry": lambda: sc.spmm_ell_all_slots(nbr, wk, x, table=table),
        "flag pass": lambda: sc.nonfinite_rows(x),
        "walk": lambda: sc._guard_launch(sc.SPMM_ELL_ALL_SLOTS, table, wk, x, bad),
        "2.6 static walk": lambda: sc.spmm_ell_weighted(table, wk, x, 1),
        "2.6 static walk, padding spread": lambda: sc.spmm_ell_weighted(spread_table, wk, x, 1),
        "torch.sparse.mm": lambda: torch.sparse.mm(adj, x),
    }, 20)
    ms = {name: float(np.mean(v)) for name, v in runs.items()}
    plain_ms = cuda_ms(lambda: sc.spmm_ell_weighted_plain(table, wk, x, 1), 3)
    flag_plain_ms = cuda_ms(lambda: sc.nonfinite_rows_plain(x), 20)
    # least bytes: each source row that a slot names read once, every slot's
    # index and weight once (all K are looked at), the output written once;
    # a multiply and an add per slot and column
    uniq = int(torch.unique(nbr).numel())
    nbytes = uniq * PROTO_F * 4 + PROTO_N * k * 8 + PROTO_N * PROTO_F * 4
    ops = 2 * PROTO_N * k * PROTO_F
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / F32_OPS_PER_S}
    bound_by = max(t, key=t.get)
    # the flag pass: x read once, one byte a row written; a test per element
    flag_bytes = x.numel() * 4 + PROTO_N
    tf = {"bytes": flag_bytes / HBM_BYTES_PER_S, "operations": x.numel() / F32_OPS_PER_S}
    flag_bound_by = max(tf, key=tf.get)
    log(f"kernel 2.9 at the prototype's shape N={PROTO_N} E={PROTO_E} K={k} F={PROTO_F} "
        f"({int(pad.sum())} of {pad.numel()} slots padding on row 0), {card}: "
        + " ".join(f"{name}={v:.4f} ms {[round(r, 4) for r in runs[name]]};"
                   for name, v in ms.items())
        + f" plain_ms={plain_ms:.4f} bound_ms={t[bound_by] * 1e3:.4f} ({bound_by}, "
        f"{nbytes / 1e9:.3f} GB); flag pass plain_ms={flag_plain_ms:.4f} "
        f"bound_ms={tf[flag_bound_by] * 1e3:.4f}; max_abs_err={err:.3e} (plain), "
        f"{ref_err:.3e} (segment sum) ok")
    rec = {
        "name": "spmm_ell_all_slots (2.9)",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/spmm_ell_all_slots.cu",
        "replaces": "benchmarks/exp_spmm_pallas_proto.py:21",
        "launches": counts["spmm_ell_all_slots"],
        "max_abs_err": err,
        "ms": ms["entry"],
        "plain_ms": plain_ms,
        "bound_ms": t[bound_by] * 1e3,
        "bound_by": bound_by,
        "library_ms": ms["torch.sparse.mm"],
        "library_note": "torch.sparse.mm on the CSR of wk's nonzero slots",
        "ms_note": "the entry: the flag pass, then the guarded walk",
        "walk_ms": ms["walk"],
        "static_walk_ms": ms["2.6 static walk"],
        "spread_padding_ms": ms["2.6 static walk, padding spread"],
        "padded_slots": int(pad.sum()),
    }
    rec_flag = {
        "name": "nonfinite_rows (2.9 flag pass)",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/spmm_ell_all_slots.cu",
        "replaces": "benchmarks/exp_spmm_pallas_proto.py:21",
        "launches": counts["nonfinite_rows"],
        "max_abs_err": 0.0,
        "ms": ms["flag pass"],
        "plain_ms": flag_plain_ms,
        "bound_ms": tf[flag_bound_by] * 1e3,
        "bound_by": flag_bound_by,
        "library_ms": None,
    }
    return rec, rec_flag


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


#: bench.py's hetero graphs (bench.py:486-580): node types a and b with
#: N(0,1) features of width 32, three relations of uniform random edges;
#: (nodes per type, edges per relation, seed) of the explanation workload
#: and of the full-graph forwards
HETERO_F = 32
HETERO_RELS = (("a", "r1", "b"), ("b", "r2", "a"), ("a", "r3", "a"))
HETERO_SMALL = (4000, 24_000, 9)
HETERO_BIG = (BIG_N // 2, BIG_E // 3, 11)


def hetero_graph(n_per_type: int, e_per_rel: int, seed: int):
    """bench.py's hetero graph: dicts of features and edge indices, and the
    generator after the draws."""
    import numpy as np

    rng = np.random.default_rng(seed)
    feat = {t: rng.normal(size=(n_per_type, HETERO_F)).astype(np.float32) for t in ("a", "b")}
    ei = {
        r: np.stack([rng.integers(0, n_per_type, e_per_rel), rng.integers(0, n_per_type, e_per_rel)])
        for r in HETERO_RELS
    }
    return feat, ei, rng


def _seeded_biases(mdef, g) -> None:
    """The conv layers' biases drawn from U(-0.1, 0.1) by ``g`` (the
    layers' own are 0, which would hide a bias off its relation's scope)."""
    import torch

    with torch.no_grad():
        for name, p in mdef.named_parameters():
            if name.startswith("conv.") and name.endswith("bias"):
                p.uniform_(-0.1, 0.1, generator=g)


def hetero_model(node_types, relations, in_features, conv, fc, seed: int, device, factory=None):
    """A HeteroGNN of GCNConvs (or of ``factory``'s convs, a
    ``hetero_*_for_relations``) with weights and biases drawn from a seeded
    ``torch.Generator`` (the same on every device)."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.gnn import hetero_gcn_for_relations

    g = torch.Generator().manual_seed(seed)
    mdef = (factory or hetero_gcn_for_relations)(node_types, relations, in_features,
                                                 conv_channels=conv, fc_channels=fc, generator=g)
    _seeded_biases(mdef, g)
    return Model(mdef, device=device)


def phase_hetero_explanations(dev, config) -> None:
    """``Explainer.run``'s arrays on heterogeneous dict inputs: bench.py's
    hetero explanation graph (2 x 4000 nodes, 3 x 24,000 edges, seed 9)
    with conv (128,), fc (128, 64): 4 node queries of type a and 4 edge
    queries of relation (a, r1, b), each in Shapley mode and in community
    mode (32 communities a type, or a relation), then the repo's hetero toy
    example (9 nodes; examples/toy_example_hetero.py) in both modes, every
    run held against the same run on the CPU.  Node and edge queries run
    on receptive-field plans: no kernel."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer

    n_per, e_per, seed = HETERO_SMALL
    feat, ei, rng = hetero_graph(n_per, e_per, seed)
    node_names = {t: [f"{t}{i}" for i in range(n_per)] for t in ("a", "b")}
    edge_names = {r: [f"{r[1]}_{i}" for i in range(e_per)] for r in HETERO_RELS}
    perm = np.random.default_rng(7)
    node_comms = {t: [[v[j] for j in perm.permutation(n_per)[i::32]] for i in range(32)]
                  for t, v in node_names.items()}
    edge_comms = {r: [[v[j] for j in perm.permutation(e_per)[i::32]] for i in range(32)]
                  for r, v in edge_names.items()}

    def comm_names(comms):
        return {k: [f"{k}_community_{i}" for i in range(len(c))] for k, c in comms.items()}

    kinds = (
        ("node", "node_prediction", node_names, "a", [f"a{int(q)}" for q in rng.integers(0, n_per, 4)],
         node_comms),
        ("edge", "edge_prediction", edge_names, HETERO_RELS[0],
         [f"r1_{int(q)}" for q in rng.integers(0, e_per, 4)], edge_comms),
    )
    model = hetero_model(["a", "b"], HETERO_RELS, HETERO_F, (HIDDEN,), (HIDDEN, 64), seed, dev)
    cpu_model = hetero_model(["a", "b"], HETERO_RELS, HETERO_F, (HIDDEN,), (HIDDEN, 64), seed, "cpu")
    for kind, problem, names, etype, queries, comms in kinds:
        for mode, kw in (("shapley", {}), ("community", dict(pathways=comms, pathway_names=comm_names(comms)))):
            for q in queries:
                t0 = time.perf_counter()
                ex = Explainer(feat, ei, model, config, names, problem=problem, element_type=etype,
                               device=dev, **kw)
                ex, diag = ex._explain(q, times=1, return_diagnostics=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                phases = ", ".join(f"{k} {v:.4f} s" for k, v in diag["phase_seconds"].items())
                cpu = Explainer(feat, ei, cpu_model, config, names, problem=problem,
                                element_type=etype, device="cpu", **kw)._explain(q, times=1)
                diff = _check_against_cpu(ex, cpu, f"hetero {kind} {mode} {q}")
                log(f"hetero {kind} path 8000/72k conv (128,) {mode} query {q}: "
                    f"{len(ex.names)} elements (subgraph {diag['subgraph_nodes']} nodes / "
                    f"{diag['subgraph_edges']} edges), wall {wall:.3f} s; diagnostics: {phases}, "
                    f"max |card - cpu| {diff:.3e} ok")

    # examples/toy_example_hetero.py:28-47, with seeded weights
    toy = np.random.default_rng(0)
    feat = {"gene": toy.normal(size=(6, 8)).astype(np.float32),
            "drug": toy.normal(size=(3, 8)).astype(np.float32)}
    rels = [("gene", "interacts", "gene"), ("drug", "targets", "gene")]
    ei = {rels[0]: np.array([[0, 1, 2, 3, 4, 5, 1, 2], [1, 0, 3, 2, 5, 4, 2, 1]]),
          rels[1]: np.array([[0, 1, 2, 0], [0, 2, 4, 5]])}
    names = {"gene": [f"g{i}" for i in range(6)], "drug": [f"d{i}" for i in range(3)]}
    comms = dict(pathways={"gene": [["g0", "g1", "g2"], ["g3", "g4", "g5"]]},
                 pathway_names={"gene": ["pathway-A", "pathway-B"]})
    cfg = dict(config, interpret_samples=10, epochs=25)
    for mode, kw in (("shapley", {}), ("community", comms)):
        runs = {}
        for where, d in (("card", dev), ("cpu", "cpu")):
            m = hetero_model(["gene", "drug"], rels, 8, (8,), (8, 8), 0, d)
            runs[where] = Explainer(feat, ei, m, cfg, names, problem="node_prediction",
                                    element_type="gene", device=d, **kw)._explain("g1", times=3)
        diff = _check_against_cpu(runs["card"], runs["cpu"], f"hetero toy {mode}")
        log(f"hetero toy example (9 nodes, 12 edges) {mode}, gene g1, times 3: "
            f"{len(runs['card'].names)} elements, max |card - cpu| {diff:.3e} ok")


#: the graph problem's masks a forward step on the typed coo route (its
#: per-edge messages, [chunk, 131072, 128] float32 a relation, stay near
#: 3.4 GB), and the reduced budget its CPU hold runs at (in chunks of 10)
HETERO_GRAPH_CHUNK = 50
HETERO_GRAPH_HOLD = dict(interpret_samples=4, epochs=10)


def phase_hetero_explain_many(dev) -> None:
    """``explain_many`` for a hetero GCN through the public import (``px``;
    its array form ``batch._explain_many``): bench.py's hetero workload
    (bench.py:486-519: 2 x 4000 nodes, 3 x 24,000 edges, seed 9, conv
    (128,), fc (128, 64), 16 queries of type a drawn after the graph) under
    ``CFG_FULL`` on the hetero_dense formulation, in Shapley mode and in
    community mode (32 communities a type, as the hetero node path builds
    them): a warm call, a call timed with ``PhaseTimer``, the best of 3
    untimed calls (explanations/s), a profiled call (its busy share against
    its own wall and against the best untimed wall), peak memory, stacks and
    buckets; then the typed coo route: 4 edge queries of (a, r1, b) and one
    ``graph_prediction`` call.  Every query is held against the same call on
    the CPU; the graph problem at a reduced budget (printed).  Each step
    prints its seconds.  ``px.Explainer`` is called once through the public
    import.  No hand kernel runs here."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bikg_graph_explainability_public_tpu_torch as px
    from bikg_graph_explainability_public_tpu_torch.explain import batch
    from bikg_graph_explainability_public_tpu_torch.utils.padding import round_up_pow2
    from bikg_graph_explainability_public_tpu_torch.utils.profiling import PhaseTimer

    n_per, e_per, seed = HETERO_SMALL
    feat, ei, rng = hetero_graph(n_per, e_per, seed)
    queries = [int(q) for q in rng.integers(0, n_per, EXPLAIN_Q)]
    edge_queries = [int(q) for q in rng.integers(0, e_per, 4)]  # relation (a, r1, b)
    node_names = {t: [f"{t}{i}" for i in range(n_per)] for t in ("a", "b")}
    flat_names, _ = px.hetero_names_to_homo(node_names)
    perm = np.random.default_rng(7)
    comms = {t: [[v[j] for j in perm.permutation(n_per)[i::32]] for i in range(32)]
             for t, v in node_names.items()}
    comm_names = {t: [f"{t}_community_{i}" for i in range(32)] for t in comms}
    pathways, pathway_names, _ = px.Pathways(comms, comm_names).hetero2homo("node_prediction")
    edge_names = [f"e{i}" for i in range(len(HETERO_RELS) * e_per)]
    models, graphs = {}, {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        models[where] = hetero_model(["a", "b"], HETERO_RELS, HETERO_F, (HIDDEN,), (HIDDEN, 64),
                                     seed, d)
        graphs[where], _ = px.hetero_to_homo(feat, ei, device=d)
    label0 = f"hetero explain_many {2 * n_per}/{3 * e_per} conv ({HIDDEN},)"

    def call(where, qs, cfg=CFG_FULL, timer=None, **kw):
        out = batch._explain_many(models[where], graphs[where], qs, cfg, timer=timer, **kw)
        if where == "card":
            torch.cuda.synchronize()
        return out

    n_hops = models["card"].model_def.num_hops + 1
    buckets = Counter(
        (round_up_pow2(s.graph.num_nodes), max(round_up_pow2(s.graph.num_edges), 8))
        for s in (batch._subgraph_cached(graphs["card"], q, n_hops) for q in queries)
    )
    t_phase = time.perf_counter()
    for mode, kw in (("shapley", dict(names=flat_names)),
                     ("community", dict(names=flat_names, pathways=pathways,
                                        pathway_names=pathway_names))):
        label = f"{label0} {mode} Q={EXPLAIN_Q}"
        t0 = time.perf_counter()
        first = call("card", queries, **kw)
        first_wall = time.perf_counter() - t0
        timer = PhaseTimer()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        call("card", queries, timer=timer, **kw)
        timed_wall = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            untimed = call("card", queries, **kw)
            walls.append(time.perf_counter() - t0)
            _identical(untimed, first, label)
        wall = min(walls)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the card's activity only
            t0 = time.perf_counter()
            call("card", queries, **kw)
            traced_wall = time.perf_counter() - t0
        log(f"{label}: {EXPLAIN_Q / wall:.2f} explanations/s (best of 3 untimed hot calls: "
            f"{', '.join(f'{w:.4f}' for w in walls)} s); "
            f"warm-up call {first_wall:.3f} s; the call under PhaseTimer {timed_wall:.4f} s "
            f"({EXPLAIN_Q / timed_wall:.2f} explanations/s); peak {peak_gb:.3f} GB; "
            f"{len(buckets)} stacks, buckets (n_pad, e_pad): queries "
            + ", ".join(f"{k}: {v}" for k, v in sorted(buckets.items())))
        log(f"{label} phases (device synchronised at each phase's exit): "
            + ", ".join(f"{k} {v:.4f} s x{timer.counts[k]}" for k, v in timer.totals.items()))
        log_device_profile(prof, wall, label, traced_wall)
        log(f"{label}: the profiled call and its tables took "
            f"{time.perf_counter() - t_prof:.2f} s of host time")
        t0 = time.perf_counter()
        cpu = call("cpu", queries, **kw)
        diff = _hold_many(first, cpu, label)
        log(f"{label}: all {EXPLAIN_Q} queries held against the CPU's call "
            f"({time.perf_counter() - t0:.2f} s on the host), max |card - cpu| {diff:.3e} ok "
            f"({time.perf_counter() - t_phase:.1f} s into the phase)")

    # the typed coo route: edge queries of (a, r1, b), then the graph problem
    label = f"{label0} typed coo edge_prediction (a, r1, b) Q=4"
    kw = dict(names=edge_names, problem="edge_prediction")
    call("card", edge_queries, **kw)
    t0 = time.perf_counter()
    got = call("card", edge_queries, **kw)
    wall = time.perf_counter() - t0
    diff = _hold_many(got, call("cpu", edge_queries, **kw), label)
    log(f"{label}: hot call {wall:.4f} s ({4 / wall:.2f} explanations/s), "
        f"{[len(x.names) for x in got]} elements, every query held against the CPU, "
        f"max |card - cpu| {diff:.3e} ok ({time.perf_counter() - t_phase:.1f} s into the phase)")
    label = f"{label0} typed coo graph_prediction"
    kw = dict(names=flat_names, problem="graph_prediction", chunk=HETERO_GRAPH_CHUNK)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = call("card", [0], **kw)
    wall = time.perf_counter() - t0
    if len(got[0].names) != 2 * n_per or not np.isfinite(got[0].mean).all():
        raise AssertionError(f"{label}: {len(got[0].names)} elements or scores not finite")
    log(f"{label}: one call of CFG_FULL ({wall:.3f} s, chunk {HETERO_GRAPH_CHUNK}, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB), {len(got[0].names)} elements")
    cfg = dict(CFG_FULL, **HETERO_GRAPH_HOLD)
    kw["chunk"] = 10
    diff = _hold_many(call("card", [0], cfg, **kw), call("cpu", [0], cfg, **kw), label)
    log(f"{label}: held against the CPU at the reduced budget {HETERO_GRAPH_HOLD} in chunks "
        f"of 10 (the full budget's CPU run is too slow for this script), max |card - cpu| "
        f"{diff:.3e} ok ({time.perf_counter() - t_phase:.1f} s into the phase)")

    # the public surface: px imports here without pandas, and its Explainer runs
    ex = px.Explainer(feat, ei, models["card"], CFG_FULL, node_names, element_type="a",
                      device=dev)._explain(f"a{queries[0]}")
    if not np.isfinite(ex.mean).all():
        raise AssertionError("px.Explainer: scores are not finite")
    log(f"px.Explainer through the public import: a{queries[0]}, {len(ex.names)} elements ok")


def _pyg_layout(state: dict, hetero: bool) -> dict:
    """A port model's state dict as the PyG checkpoint it came from, numpy:
    ``conv.{i}`` -> ``conv.{2i}`` (``conv.{2i}.convs.`` for a HeteroConv
    stack), ``fc.{j}`` -> ``fc.{2j}``."""
    out = {}
    for k, v in state.items():
        group, idx, rest = k.split(".", 2)
        inner = "convs." if hetero and group == "conv" else ""
        out[f"{group}.{2 * int(idx)}.{inner}{rest}"] = v.detach().cpu().numpy()
    return out


def phase_remaining_families(dev, config) -> None:
    """The last model families, at full width (conv (128,), fc (128, 64),
    seeded weights and biases): on bench.py's hetero explanation graph (2 x
    4000 nodes, 3 x 24,000 edges, seed 9) a HeteroGNN of GATConvs explains
    4 node queries of type a in Shapley mode and in community mode (32
    communities a type) on ``FastBatchedHeteroGAT``'s plans (the adapter
    must have picked that engine), 1 edge query of (a, r1, b) through the
    generic forward, and 4 node queries through ``explain_many`` (the typed
    coo route, ``CFG_FULL``); a HeteroGNN of SAGEConvs 1 node query; then
    ``RGCNNodeModel`` (3 relations, conv (128, 128)) 2 node queries on the
    20k / 160k graph with seeded edge types; last ``import_any`` on
    in-memory PyG-layout state dicts of the three models, one forward each
    held against the factory's model.  The first query of each model (of
    each GAT mode) and the ``explain_many`` call are held against the same
    run on the CPU.  No hand kernel runs here."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain import batch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays, hetero_to_homo
    from bikg_graph_explainability_public_tpu_torch.graph import hetero_names_to_homo
    from bikg_graph_explainability_public_tpu_torch.models import gnn
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.fast_hetero import FastBatchedHeteroGAT
    from bikg_graph_explainability_public_tpu_torch.models.torch_import import import_any

    t_phase = time.perf_counter()

    def peak(label: str) -> None:
        """The card's peak memory since the last call, then reset."""
        log(f"{label}: peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    n_per, e_per, seed = HETERO_SMALL
    feat, ei, rng = hetero_graph(n_per, e_per, seed)
    node_names = {t: [f"{t}{i}" for i in range(n_per)] for t in ("a", "b")}
    edge_names = {r: [f"{r[1]}_{i}" for i in range(e_per)] for r in HETERO_RELS}
    perm = np.random.default_rng(7)
    comms = {t: [[v[j] for j in perm.permutation(n_per)[i::32]] for i in range(32)]
             for t, v in node_names.items()}
    comm_names = {t: [f"{t}_community_{i}" for i in range(32)] for t in comms}
    queries = [int(q) for q in rng.integers(0, n_per, 4)]
    edge_query = f"r1_{int(rng.integers(0, e_per))}"
    models = {}
    for family, factory in (("GAT", gnn.hetero_gat_for_relations),
                            ("SAGE", gnn.hetero_sage_for_relations)):
        for where, d in (("card", dev), ("cpu", "cpu")):
            models[family, where] = hetero_model(["a", "b"], HETERO_RELS, HETERO_F, (HIDDEN,),
                                                 (HIDDEN, 64), seed, d, factory=factory)

    def explain(key, feat, ei, names, element, check, label, **kw):
        t0 = time.perf_counter()
        ex = Explainer(feat, ei, models[key, "card"], config, names, device=dev, **kw)
        ex = ex._explain(element, times=1)
        torch.cuda.synchronize()
        msg = f"{label}: {len(ex.names)} elements, wall {time.perf_counter() - t0:.3f} s"
        if check:
            cpu = Explainer(feat, ei, models[key, "cpu"], config, names, device="cpu",
                            **kw)._explain(element, times=1)
            msg += f", max |card - cpu| {_check_against_cpu(ex, cpu, label):.3e}"
        elif not np.isfinite(ex.mean).all():
            raise AssertionError(f"{label}: non-finite scores")
        log(f"{msg} ok ({time.perf_counter() - t_phase:.1f} s into the phase)")

    graph_label = f"{2 * n_per}/{3 * e_per} conv ({HIDDEN},)"
    for mode, kw in (("shapley", {}), ("community", dict(pathways=comms, pathway_names=comm_names))):
        for qi, q in enumerate(queries):
            explain("GAT", feat, ei, node_names, f"a{q}", qi == 0,
                    f"hetero GAT node path {graph_label} {mode} query a{q}", element_type="a", **kw)
            engine = models["GAT", "card"]._fast_cache[1]
            if not isinstance(engine, FastBatchedHeteroGAT):
                raise AssertionError(f"hetero GAT node query a{q} ran on {type(engine).__name__}")
    explain("GAT", feat, ei, edge_names, edge_query, True,
            f"hetero GAT edge path {graph_label} query {edge_query} (generic forward)",
            problem="edge_prediction", element_type=HETERO_RELS[0])
    explain("SAGE", feat, ei, node_names, f"a{queries[0]}", True,
            f"hetero SAGE node path {graph_label} query a{queries[0]}", element_type="a")
    peak("hetero GAT and SAGE queries (card and CPU runs)")

    # hetero GAT explain_many: node problems take the typed coo route
    flat_names, _ = hetero_names_to_homo(node_names)
    graphs = {w: hetero_to_homo(feat, ei, device=d)[0] for w, d in (("card", dev), ("cpu", "cpu"))}
    t0 = time.perf_counter()
    got = batch._explain_many(models["GAT", "card"], graphs["card"], queries, CFG_FULL,
                              names=flat_names)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff = _hold_many(got, batch._explain_many(models["GAT", "cpu"], graphs["cpu"], queries,
                                               CFG_FULL, names=flat_names), "hetero GAT explain_many")
    log(f"hetero GAT explain_many {graph_label} Q={len(queries)} (typed coo, CFG_FULL): wall "
        f"{wall:.3f} s ({len(queries) / wall:.2f} explanations/s, the first call), "
        f"{[len(x.names) for x in got]} elements, held against the CPU's call "
        f"({time.perf_counter() - t0:.2f} s on the host), max |card - cpu| {diff:.3e} ok "
        f"({time.perf_counter() - t_phase:.1f} s into the phase)")
    peak("hetero GAT explain_many")

    # RGCN on the 20k / 160k graph with seeded edge types
    rfeat, rei, rrng = random_graph(NODE_N, NODE_E, seed=5)
    etypes = np.random.default_rng(13).integers(0, len(HETERO_RELS), NODE_E)
    rnames = [str(i) for i in range(NODE_N)]

    def rgcn(d):
        g = torch.Generator().manual_seed(3)
        mdef = gnn.RGCNNodeModel(N_FEATS, len(HETERO_RELS), conv_channels=(HIDDEN, HIDDEN),
                                 fc_channels=(HIDDEN, 64), generator=g)
        _seeded_biases(mdef, g)
        return Model(mdef, device=d)

    models["RGCN", "card"], models["RGCN", "cpu"] = rgcn(dev), rgcn("cpu")
    for qi, q in enumerate(rrng.integers(0, NODE_N, 2)):
        explain("RGCN", rfeat, rei, rnames, str(int(q)), qi == 0,
                f"RGCN node path 20k/160k conv ({HIDDEN}, {HIDDEN}) 3 relations query {int(q)}",
                edge_types=etypes)
    peak("RGCN queries")

    # import_any on the three models' PyG-layout state dicts
    for family in ("GAT", "SAGE", "RGCN"):
        built = models[family, "card"]
        mdef, params = import_any(_pyg_layout(built.model_def.state_dict(), family != "RGCN"))
        imported = Model(mdef, params, device=dev)
        if family == "RGCN":
            g = from_arrays(rfeat, rei, edge_type=etypes, device=dev)
            want, got = built.infer(g), imported.infer(g)
        else:
            g, _ = hetero_to_homo(feat, ei, device=dev)
            g_imp, _ = hetero_to_homo(feat, {r: ei[r] for r in mdef.relations}, device=dev)
            want, got = built.infer(g), imported.infer(g_imp)
        n = g.num_nodes
        err = float((got[:n] - want[:n]).abs().max())
        if not torch.allclose(got[:n], want[:n], rtol=1e-4, atol=1e-5):
            raise AssertionError(f"import_any {family}: forward differs from the factory's by {err:.3e}")
        log(f"import_any {family} ({type(mdef).__name__}, {len(params)} tensors): forward on "
            f"{n} nodes held against the factory's model, max abs diff {err:.3e} ok")
    peak("import_any forwards")


def scoped_kernel_timing(table, n_src, b, label) -> dict:
    """Kernels 2.3 and 2.4 on one relation's type-scoped table at the ELL
    tier's chunk width (``[n_src, b * 128]`` features, ``d1 - d0`` output
    rows): each held against its plain version, then timed beside its
    plain version and its bound from this table's data."""
    import torch
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    err, feats, ps, plan, _ = check_kernel_case(table, b, HIDDEN, torch.float32, True, 5, f"{label} 2.3",
                                               n_src=n_src)
    n = table.nbr.shape[0]
    w = b * HIDDEN
    deg, nbr, valid = table.deg, table.nbr, table.valid > 0
    sum_deg = int(deg.sum())
    uniq = int(torch.unique(nbr[valid]).numel())
    out = {"err_23": err}
    out["ms_23"] = cuda_ms(lambda: sc.gather_sum_static(table, feats, b, post_scale=ps), 10)
    out["plain_23"] = cuda_ms(lambda: sc.gather_sum_static_plain(table, feats, b, post_scale=ps), 2)
    bytes_23 = uniq * w * 4 + sum_deg * 4 + n * 4 + n * b * 4 + n * w * 4
    out["bound_23"] = max(bytes_23 / HBM_BYTES_PER_S, (sum_deg + n) * w / F32_OPS_PER_S) * 1e3
    # yardstick only: cuSPARSE on the scoped 0/1 CSR [n, n_src], then the
    # post-scale; NaN rows zeroed first (the sparse product reads no row
    # twice, but 0 * NaN would not be 0 in a dense fallback)
    rows = torch.arange(n, device=feats.device)[:, None].expand_as(nbr)[valid]
    adj = torch.sparse_coo_tensor(torch.stack([rows, nbr[valid].long()]),
                                  torch.ones(rows.numel(), device=feats.device),
                                  (n, n_src)).coalesce().to_sparse_csr()
    clean = torch.nan_to_num(feats, nan=0.0)

    def library():
        return (torch.sparse.mm(adj, clean).view(n, b, HIDDEN) * ps[:, :, None]).view(n, w)

    if not torch.allclose(library(), sc.gather_sum_static_plain(table, clean, b, ps), rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{label}: library yardstick computes another function")
    out["library_23"] = cuda_ms(library, 5)
    del feats, ps, adj, clean
    feats, w_bnk = check_weighted_case(table, b, HIDDEN, torch.float32, 6, f"{label} 2.4", n_src=n_src)
    out["ms_24"] = cuda_ms(lambda: sc.batched_gather_sum(table, None, feats, b, w_sample=w_bnk), 10)
    w_slot = w_bnk.permute(1, 2, 0)
    out["plain_24"] = cuda_ms(lambda: sc.batched_gather_sum_plain(table, feats, b, w_slot), 2)
    bytes_24 = uniq * w * 4 + sum_deg * (4 + b * 4) + n * 4 + n * w * 4
    out["bound_24"] = max(bytes_24 / HBM_BYTES_PER_S, 2 * sum_deg * w / F32_OPS_PER_S) * 1e3
    log(f"{label}: N_out={n} N_src={n_src} K={table.k} sum_deg={sum_deg} band={plan.band}; "
        f"2.3 ms={out['ms_23']:.4f} plain_ms={out['plain_23']:.4f} bound_ms={out['bound_23']:.4f} "
        f"library_ms={out['library_23']:.4f} (torch.sparse.mm + scale); "
        f"2.4 ms={out['ms_24']:.4f} plain_ms={out['plain_24']:.4f} bound_ms={out['bound_24']:.4f} (bytes)")
    return out


def phase_hetero_ell(dev, config, rec_23: dict, rec_24: dict) -> tuple:
    """The hetero ELL tier on bench.py's full-graph hetero workload (2 x
    50,000 nodes, 3 x 333,333 edges, seed 11) with conv (128, 128), fc
    (128, 64): ``Explainer._explain`` on ``graph_prediction`` (1000 masks,
    chunks of ``_ELL_CHUNK``), counting kernel 2.3's launches (one a
    relation and chunk in layer 2, and in layer 1 too where its gather is
    over budget); its set-up / forwards / rest split and a profile; then
    the unrestricted edge forward (1000 edge masks, 70 % kept, query row
    17), counting kernel 2.4's; one chunk of each against the plain route;
    and both kernels on each relation's type-scoped table, held against
    their plain versions and timed, with edge cases (K = 12, rows of degree
    0, more source rows than output rows).  Adds the scoped timings to the
    records; returns the launch counts of 2.3 and 2.4."""
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer, align_types
    from bikg_graph_explainability_public_tpu_torch.graph import hetero_to_homo
    from bikg_graph_explainability_public_tpu_torch.models.fast_hetero import FastBatchedHeteroGCN
    from bikg_graph_explainability_public_tpu_torch.ops import spmm, spmm_cuda
    from bikg_graph_explainability_public_tpu_torch.ops.ell import build_neighbor_table_edges

    n_per, e_per, seed = HETERO_BIG
    feat, ei, _ = hetero_graph(n_per, e_per, seed)
    names = {t: [f"{t}{i}" for i in range(n_per)] for t in ("a", "b")}
    model = hetero_model(["a", "b"], HETERO_RELS, HETERO_F, (HIDDEN, HIDDEN), (HIDDEN, 64), seed, dev)
    n_layers = len(model.model_def.conv)
    n_masks = int(config["interpret_samples"]) * int(config["epochs"])
    chunk = FastBatchedHeteroGCN._ELL_CHUNK
    n_chunks = -(-n_masks // chunk)
    nrel = len(HETERO_RELS)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    ex = Explainer(feat, ei, model, config, names, problem="graph_prediction", device=dev)._explain(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    fused = model._fast_cache[1]._ell.nbr_all is not None
    model._fast_cache = (None, None)
    launches_23 = n_chunks * nrel * (n_layers - 1 + (0 if fused else 1))
    expect_counts(counts, {"gather_sum_static": launches_23}, "hetero graph path")
    if not np.isfinite(ex.mean).all() or ex.mean.shape != (2 * n_per,):
        raise AssertionError("hetero graph path: scores are not finite or of the wrong shape")
    log(f"hetero graph path 100k/1M conv (128, 128): {n_masks} masks in {n_chunks} chunks of "
        f"{chunk}, layer 1 {'fused product' if fused else 'kernel 2.3 (over budget)'}, "
        f"wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ok")

    # where the time goes: the host set-up, the forwards on device masks,
    # one profiled pass
    t0 = time.perf_counter()
    graph, info = hetero_to_homo(feat, ei, device=dev)
    graph = align_types(graph, info, model.model_def)
    engine = FastBatchedHeteroGCN(model.model_def, graph, restrict=False, device=dev)
    ell = engine._ell_setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"hetero ELL tier: relation ranges (lo, hi, d0, d1) {ell.ranges}, K {[t.k for t in ell.tables]}, "
        f"fused layer-1 gather {tuple(ell.g0_all.shape) if fused else None}")
    gen = torch.Generator(device=dev).manual_seed(3)
    all_masks = torch.rand((n_masks, graph.n_pad), generator=gen, device=dev) < 0.5

    def run():
        return engine.query_outputs(all_masks, None, "graph_prediction")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    log(f"hetero graph path breakdown: set-up (homogenise, upload, tables, layer-1 gather) "
        f"{setup_s:.3f} s; {n_masks} forwards {fwd_s:.3f} s; rest of the explanation "
        f"(mask sampling, transfer, surrogate fit) {wall - setup_s - fwd_s:.3f} s")
    profile_forwards(run, fwd_s, "hetero graph path")
    del all_masks

    masks = torch.rand((chunk, graph.n_pad), generator=gen, device=dev) < 0.5
    got = engine.query_outputs(masks, None, "graph_prediction")
    spmm.gather_sum_static = spmm_cuda.gather_sum_static_plain
    try:
        want = engine.query_outputs(masks, None, "graph_prediction")
    finally:
        spmm.gather_sum_static = spmm_cuda.gather_sum_static
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"hetero graph chunk: kernel and plain routes differ by "
                             f"{(got - want).abs().max().item():.3e}")
    log(f"hetero graph path one chunk, kernel vs plain route: max abs diff "
        f"{(got - want).abs().max().item():.3e} (rtol 1e-5, atol 1e-6) ok")

    # the unrestricted edge forward
    all_masks = torch.rand((n_masks, graph.e_pad), generator=gen, device=dev) > 0.3
    all_masks[:, graph.num_edges:] = False

    def run_edge():
        return engine.query_outputs(all_masks, EDGE_QUERY, "edge_prediction")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = run_edge()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches_24 = n_chunks * nrel * (n_layers - 1)
    expect_counts(read_counts(), {"batched_gather_sum": launches_24}, "hetero ELL edge forward")
    if out is None or out.shape != (n_masks,) or not torch.isfinite(out).all():
        raise AssertionError("hetero ELL edge forward: outputs are missing, not finite or misshapen")
    log(f"hetero ELL edge forward 100k/1M conv (128, 128): {n_masks} edge-mask forwards in "
        f"{n_chunks} chunks of {chunk} {fwd_s:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ok")
    profile_forwards(run_edge, fwd_s, "hetero ELL edge forward")
    masks = all_masks[:chunk]
    del all_masks
    got = engine.query_outputs(masks, EDGE_QUERY, "edge_prediction")
    spmm.batched_gather_sum = (
        lambda table, ew, feats, b, w_slot=None, w_sample=None:
        spmm_cuda.batched_gather_sum_plain(
            table, feats, b, w_slot if w_sample is None else w_sample.permute(1, 2, 0))
    )
    try:
        want = engine.query_outputs(masks, EDGE_QUERY, "edge_prediction")
    finally:
        spmm.batched_gather_sum = spmm_cuda.batched_gather_sum
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"hetero edge chunk: kernel and plain routes differ by "
                             f"{(got - want).abs().max().item():.3e}")
    log(f"hetero ELL edge forward one chunk, kernel vs plain route: max abs diff "
        f"{(got - want).abs().max().item():.3e} (rtol 1e-5, atol 1e-6) ok")
    del masks, got, want

    # both kernels at the type-scoped shapes of every relation
    timings = []
    for ri, (rel, (lo, hi, d0, d1)) in enumerate(zip(HETERO_RELS, ell.ranges)):
        timings.append(scoped_kernel_timing(ell.tables[ri], hi - lo, chunk,
                                            f"scoped kernels {'__'.join(rel)}"))
    del engine, ell
    # edge cases: K not a multiple of 8, rows of degree 0, sources beyond
    # the output rows
    rng = np.random.default_rng(12)
    for i, (n_out, n_src, k, b, f) in enumerate(((3000, 7000, 12, 16, 64), (3000, 7000, 12, 48, 3),
                                                 (5000, 2000, 20, 7, 20))):
        src = rng.integers(0, n_src - 100, n_out * k // 2)
        dst = rng.integers(0, n_out - 200, n_out * k // 2)
        keep = np.bincount(dst, minlength=n_out)[dst] <= k
        t = build_neighbor_table_edges(n_out, src[keep], dst[keep],
                                       np.arange(int(keep.sum()), dtype=np.int32), k=k, device=dev)
        err, *_ = check_kernel_case(t, b, f, torch.float32, True, 300 + i, f"scoped edge{i} 2.3",
                                    n_src=n_src)
        rec_23["max_abs_err"] = max(rec_23["max_abs_err"], err)
        check_weighted_case(t, b, f, torch.float32, 310 + i, f"scoped edge{i} 2.4", n_src=n_src)
    rec_23["max_abs_err"] = max([rec_23["max_abs_err"]] + [t["err_23"] for t in timings])
    for rec, key in ((rec_23, "23"), (rec_24, "24")):
        rec["scoped_ms"] = [t[f"ms_{key}"] for t in timings]
        rec["scoped_plain_ms"] = [t[f"plain_{key}"] for t in timings]
        rec["scoped_bound_ms"] = [t[f"bound_{key}"] for t in timings]
    rec_23["scoped_library_ms"] = [t["library_23"] for t in timings]
    return launches_23, launches_24


#: the masks of phase 15's halo graph problem: its [E, B, C] messages on
#: the 100k / 1M graph, 1M x 16 x 128 float32, are 8.2 GB a layer
HALO_B = 16


def phase_distributed(dev, config) -> int:
    """Phase 15: ``parallel/`` at world size 1 on the card, over NCCL
    (``initialize_distributed`` on a file store, ``make_mesh(1)``), every
    sharded call held against its unsharded counterpart; returns the
    launches of kernel 2.3 made by (b)'s unsharded reference, the only
    kernel launches of the phase."""
    import tempfile

    import torch
    import torch.distributed as dist
    from bikg_graph_explainability_public_tpu_torch import parallel as tpar
    from bikg_graph_explainability_public_tpu_torch.parallel.mesh import initialize_distributed

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            mesh = tpar.make_mesh(1)
            init_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            # NCCL makes its communicator at the first collective
            dist.all_reduce(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            log(f"distributed: {dist.get_backend()} group of {dist.get_world_size()}, mesh "
                f"{mesh.device_type} {tuple(mesh.shape)} {mesh.mesh_dim_names}, "
                f"{init_s:.2f} s; the first collective (the communicator) "
                f"{time.perf_counter() - t0:.2f} s")
            return _distributed_cases(dev, config, mesh)
        finally:
            dist.destroy_process_group()


def _distributed_cases(dev, config, mesh) -> int:
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch import parallel as tpar
    from bikg_graph_explainability_public_tpu_torch.explain import batch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models.fast_gcn import FastBatchedGCN

    def explain(model, feat, ei, names, q, **kw):
        t0 = time.perf_counter()
        ex = Explainer(feat, ei, model, config, names, device=dev, **kw)._explain(q, times=1)
        torch.cuda.synchronize()
        return ex, time.perf_counter() - t0

    # (a) node queries through the Explainer, ShardedModel against Model
    feat, ei, rng = random_graph(NODE_N, NODE_E, seed=5)
    names = [str(i) for i in range(NODE_N)]
    model, _ = gcn_128x2(seed=0, device=dev)
    sharded = tpar.ShardedModel(model.model_def, None, mesh)
    for q in (str(int(q)) for q in rng.integers(0, NODE_N, 2)):
        before = read_counts()
        got, wall = explain(sharded, feat, ei, names, q)
        expect_delta(before, {}, f"distributed (a) ShardedModel query {q}")
        want, plain_wall = explain(model, feat, ei, names, q)
        diff = _check_against_cpu(got, want, f"distributed (a) query {q}")
        log(f"distributed (a) 20k/160k GCN-128x2 node query {q} through ShardedModel: "
            f"{len(got.names)} elements, wall {wall:.3f} s (Model {plain_wall:.3f} s), "
            f"max |sharded - unsharded| {diff:.3e} (rtol 1e-3, atol 1e-5) ok")

    # (b) the halo graph problem on the 100k / 1M graph against the ELL tier
    feat, ei, _ = random_graph(BIG_N, BIG_E, seed=0)
    g = from_arrays(feat, ei, device=dev)
    model, _ = gcn_128x2(seed=0, device=dev)
    t0 = time.perf_counter()
    e = g.num_edges
    part = tpar.build_halo_partition(g.host.senders[:e], g.host.receivers[:e], g.n_pad, 1)
    plan_s = time.perf_counter() - t0
    x = tpar.pad_nodes(g.x, part)
    gen = torch.Generator(device=dev).manual_seed(3)
    masks = torch.rand((HALO_B, g.n_pad), generator=gen, device=dev) < 0.5
    m_loc = tpar.pad_nodes(masks.T, part).T

    def halo():
        out = tpar.halo_masked_outputs(model, x, m_loc, part, mesh, problem="graph_prediction",
                                       num_nodes=g.num_nodes)
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    before = read_counts()
    t0 = time.perf_counter()
    got = halo()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(2):
        halo()
    halo_s = (time.perf_counter() - t0) / 2
    expect_delta(before, {}, "distributed (b) halo graph problem")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    engine = FastBatchedGCN(model.model_def, g, device=dev)

    def ell():
        out = engine.query_outputs(masks, None, "graph_prediction", chunk_size=HALO_B)
        torch.cuda.synchronize()
        return out

    before = read_counts()
    want = ell()
    t0 = time.perf_counter()
    for _ in range(2):
        ell()
    ell_s = (time.perf_counter() - t0) / 2
    # layer 2 of each of the 3 calls: one chunk, one launch
    ref_launches = 3 * (len(model.model_def.conv) - 1)
    expect_delta(before, {"gather_sum_static": ref_launches},
                 "distributed (b) unsharded reference (FastBatchedGCN, ELL tier)")
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise AssertionError(
            f"distributed (b): halo and ELL tier differ by {(got - want).abs().max().item():.3e}")
    log(f"distributed (b) halo_masked_outputs graph problem, 100k/1M GCN-128x2, B={HALO_B}: "
        f"{halo_s * 1e3 / HALO_B:.3f} ms a mask ({halo_s:.4f} s a call; first call "
        f"{first_s:.3f} s; plan {plan_s:.3f} s on the host), FastBatchedGCN's ELL tier "
        f"{ell_s * 1e3 / HALO_B:.3f} ms a mask, ratio {halo_s / ell_s:.2f}; peak "
        f"{peak_gb:.2f} GB; max |halo - ELL| {(got - want).abs().max().item():.3e} "
        f"(rtol 1e-4, atol 1e-5) ok")
    del engine, x, m_loc, part, g

    # (c) a hetero node query through ShardedModel's hetero halo
    n_per, e_per, seed = HETERO_SMALL
    feat, ei, rng = hetero_graph(n_per, e_per, seed)
    names = {t: [f"{t}{i}" for i in range(n_per)] for t in ("a", "b")}
    model = hetero_model(["a", "b"], HETERO_RELS, HETERO_F, (HIDDEN,), (HIDDEN, 64), seed, dev)
    sharded = tpar.ShardedModel(model.model_def, None, mesh)
    q = f"a{int(rng.integers(0, n_per))}"
    before = read_counts()
    got, wall = explain(sharded, feat, ei, names, q, element_type="a")
    expect_delta(before, {}, "distributed (c) hetero ShardedModel")
    want, plain_wall = explain(model, feat, ei, names, q, element_type="a")
    diff = _check_against_cpu(got, want, f"distributed (c) hetero query {q}")
    log(f"distributed (c) hetero 8000/72k conv (128,) node query {q} through ShardedModel: "
        f"{len(got.names)} elements, wall {wall:.3f} s (Model {plain_wall:.3f} s), "
        f"max |sharded - unsharded| {diff:.3e} ok")

    # (d) explain_many over the mesh against mesh=None
    feat, ei, rng = random_graph(NODE_N, NODE_E, seed=5)
    queries = [int(q) for q in rng.integers(0, NODE_N, EXPLAIN_Q)]
    model, _ = gcn_128x2(seed=0, device=dev, n_conv=1)
    g = from_arrays(feat, ei, pad_mode="exact", device=dev)
    walls = {}
    runs = {}
    before = read_counts()
    for label, kw in (("mesh", dict(mesh=mesh)), ("no mesh", {})):
        for call in ("first", "hot"):
            t0 = time.perf_counter()
            runs[label] = batch._explain_many(model, g, queries, CFG_FULL, **kw)
            torch.cuda.synchronize()
            walls[label, call] = time.perf_counter() - t0
    expect_delta(before, {}, "distributed (d) explain_many")
    _identical(runs["mesh"], runs["no mesh"], "distributed (d) explain_many(mesh=)")
    log(f"distributed (d) explain_many 20k/160k GCN-128 Q={EXPLAIN_Q} Shapley: mesh=mesh "
        f"first {walls['mesh', 'first']:.3f} s, hot {walls['mesh', 'hot']:.4f} s; mesh=None "
        f"first {walls['no mesh', 'first']:.3f} s, hot {walls['no mesh', 'hot']:.4f} s; "
        f"every query bit for bit ok")

    # (e) the data-parallel forwards and one training step
    model, _ = gcn_128x2(seed=0, device=dev)
    g = from_arrays(feat, ei, device=dev)
    q = queries[0]
    masks = torch.rand((64, g.n_pad), generator=gen, device=dev) < 0.5
    before = read_counts()
    got = tpar.sharded_query_outputs(model, g, masks, "node_prediction", q, mesh)
    want = model.perturbed_query_outputs(g, masks, "node_prediction", q, chunk_size=64)
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError("distributed (e): sharded_query_outputs differs from the model's")
    w0 = torch.rand((g.n_pad,), generator=gen, device=dev) * 0.01
    z = torch.zeros_like(w0)
    t = torch.zeros((), device=dev)
    outs = [
        tpar.explain_training_step(model, g, "node_prediction", q, NODE_N, mesh=m)(
            w0, z, z, t, tpar.shard_batch(masks, mesh) if m is not None else masks)
        for m in (mesh, None)
    ]
    expect_delta(before, {}, "distributed (e) sharded_query_outputs, training step")
    for a, b in zip(*outs):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
            raise AssertionError("distributed (e): the training step differs from the unsharded")
    w_diff = (outs[0][0] - outs[1][0]).abs().max().item()
    log(f"distributed (e) sharded_query_outputs (64 masks, query {q}) and explain_training_step "
        f"held against the unsharded calls: max |diff| {(got - want).abs().max().item():.3e} / "
        f"{w_diff:.3e}, loss {outs[0][4].item():.6f} ok")
    return ref_launches


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

    def done(label: str) -> None:
        log(f"{label} done at {time.perf_counter() - t_start:.1f} s")

    card = phase_header()
    phase_build()
    done("build")
    rec_23, graph, table = phase_kernel(dev)
    rec_24, rec_tr = phase_kernel_weighted(dev, table)
    rec_21, rec_22, rec_op = phase_kernel_dense(dev)
    ladder_counts = {}
    ladder = phase_ladder(dev, graph, table, ladder_counts)
    rec_tr["launches"] = ladder_counts["batched_gather_sum.transpose"]
    del graph, table
    rec_29, rec_flag = phase_all_slots(dev, card)
    done("kernel checks")

    reset_counts()
    phase_explanations(dev, config, "node_prediction")
    expect_counts(read_counts(), {}, "node path (dense tier, query plans)")
    reset_counts()
    phase_explanations(dev, config, "edge_prediction")
    expect_counts(read_counts(), {}, "edge path (dense tier, edge query plans)")
    done("node and edge paths")
    rec_23["launches"] = phase_graph_path(dev, config, rec_23)
    rec_24["launches"] = phase_ell_edge_forward(dev)
    rec_21["launches"], rec_op["launches"], rec_22["launches"] = phase_dense_fused(dev)
    done("graph path, ELL edge forward and fused dense forward")
    reset_counts()
    phase_model_families(dev, config)
    expect_counts(read_counts(), {}, "model families (generic forward, segment operations)")
    done("model families")
    reset_counts()
    phase_hetero_explanations(dev, config)
    expect_counts(read_counts(), {}, "hetero node and edge paths (query plans)")
    done("hetero node and edge paths")
    hetero_23, hetero_24 = phase_hetero_ell(dev, config, rec_23, rec_24)
    rec_23["launches"] += hetero_23
    rec_24["launches"] += hetero_24
    done("hetero ELL tier")
    reset_counts()
    phase_explain_many(dev, config)
    expect_counts(read_counts(), {}, "explain_many (dense and coo formulations, plain torch)")
    done("explain_many")
    reset_counts()
    phase_hetero_explain_many(dev)
    expect_counts(read_counts(), {}, "hetero explain_many (hetero_dense and typed coo, plain torch)")
    done("hetero explain_many")
    reset_counts()
    phase_remaining_families(dev, config)
    expect_counts(read_counts(), {}, "hetero GAT / SAGE and RGCN (plans, generic forward, typed coo)")
    done("hetero GAT / SAGE and RGCN")
    reset_counts()
    ref_23 = phase_distributed(dev, config)
    expect_counts(read_counts(), {"gather_sum_static": ref_23},
                  "distributed path (0 on the sharded calls; 2.3 only in (b)'s reference)")
    done("distributed (world size 1, NCCL)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    records = [rec_21, rec_op, rec_22, rec_23, rec_24, rec_tr] + ladder + [rec_29, rec_flag]
    print(json.dumps({"kernels": records}), flush=True)
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
