#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``bikg_graph_explainability_public_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. header: card name and power limit, torch and CUDA versions; TF32 off;
2. build the hand-written CUDA kernel from the checkout's sources;
3. the kernel against its plain PyTorch version on the card, at the
   production shape (100k nodes / 1M edges, B=50, F=128, float32) and in
   the edge cases, with its time, the plain version's, a library call's and
   the least time the card could take;
4. the node path: ``Explainer._explain`` (the arrays behind
   ``Explainer.run``) on ``node_prediction`` for the repo's trained 36-node
   fixture (Shapley and community mode) and for GCN-128x2 on a 20k-node /
   160k-edge graph (4 queries), checked against the same runs on the CPU
   (the first query of the 20k graph);
5. the graph path: ``graph_prediction`` with GCN-128x2 on the 100k / 1M
   graph (ELL tier), counting the kernel's launches; then the engine's
   set-up and forwards timed apart, the forwards profiled by operation,
   and one chunk of the engine compared with the same engine routed
   through the plain version.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout,
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "bikg_graph_explainability_public_tpu_torch"

#: H100 SXM device-memory rate and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: production shape of the ELL gather-sum (bench.py's "fullgraph" graph)
BIG_N, BIG_E, BIG_B, HIDDEN, N_FEATS = 100_000, 1_000_000, 50, 128, 84
NODE_N, NODE_E, NODE_QUERIES = 20_000, 160_000, 4


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
    from bikg_graph_explainability_public_tpu_torch.ops.spmm_cuda import KERNEL

    KERNEL.library()
    log(f"build: gather_sum_static in {KERNEL.build_seconds:.2f} s")
    log(KERNEL.build_log.strip())


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
    """Kernel against plain on one input; returns (max_abs_err, feats, ps)."""
    import torch
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
    torch.cuda.synchronize()
    deg0 = table.deg == 0
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    if deg0.any() and got[deg0].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: rows of degree 0 are not exact zeros")
    # f32: only the order of the sum may differ; bf16 inputs go to both sides
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"{label}: kernel disagrees with plain, max abs err "
            f"{(got - want).abs().max().item():.3e}"
        )
    err = (got - want).abs().max().item()
    log(
        f"kernel case {label}: N={n} K={table.k} b={b} F={f} {str(dtype)[6:]} "
        f"post_scale={scale} deg0_rows={int(deg0.sum())} "
        f"nan_rows={int((~used).sum())} max_abs_err={err:.3e} ok"
    )
    return err, feats, ps


def phase_kernel(dev) -> dict:
    """Production shape, then the edge cases; returns the kernel's record."""
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
    err, feats, ps = check_kernel_case(
        table, BIG_B, HIDDEN, torch.float32, True, 0, "production"
    )

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
        case_err, _, _ = check_kernel_case(t, b, f, dtype, scale, 100 + i, f"edge{i}")
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
    }


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


def phase_node_path(dev, config) -> None:
    import numpy as np
    import torch
    from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer
    from bikg_graph_explainability_public_tpu_torch.models.adapter import Model
    from bikg_graph_explainability_public_tpu_torch.models.checkpoint import load_params
    from bikg_graph_explainability_public_tpu_torch.models.gnn import GCNNodeModel

    data = np.load(os.path.join(ROOT, "test_data", "toy_graph_36n.npz"))
    feat, ei = data["feat"], data["edge_index"]
    names = [str(x) for x in data["names"]]
    ckpt = os.path.join(ROOT, "test_data", "gcn_homo_36n_own.npz")
    # four communities over the names, drawn as tests/fixtures.py does
    perm = np.random.default_rng(1).permutation(len(names))
    pathways = [[str(int(v)) for v in c] for c in np.array_split(perm, 4)]
    pathway_names = [f"community_{i}" for i in range(4)]
    community = dict(pathways=pathways, pathway_names=pathway_names)
    for label, kw in (("shapley", {}), ("community", community)):
        runs = {}
        for d in (dev, torch.device("cpu")):
            model = Model(GCNNodeModel(N_FEATS), load_params(ckpt), device=d)
            t0 = time.perf_counter()
            ex = Explainer(feat, ei, model, config, names, device=d, **kw)
            runs[d.type] = ex._explain("10", times=1)
            if d.type == "cuda":
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        diff = _check_against_cpu(runs["cuda"], runs["cpu"], f"36n {label}")
        log(f"node path 36n fixture {label}: {len(runs['cuda'].names)} elements, "
            f"wall {wall:.3f} s, max |card - cpu| {diff:.3e} ok")

    feat, ei, rng = random_graph(NODE_N, NODE_E, seed=5)
    names = [str(i) for i in range(NODE_N)]
    queries = [str(int(q)) for q in rng.integers(0, NODE_N, NODE_QUERIES)]
    model, tree = gcn_128x2(seed=0, device=dev)
    for qi, q in enumerate(queries):
        t0 = time.perf_counter()
        ex = Explainer(feat, ei, model, config, names, device=dev)._explain(q, times=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        msg = f"node path 20k/160k GCN-128x2 query {q}: {len(ex.names)} elements, wall {wall:.3f} s"
        if qi == 0:
            cpu_model, _ = gcn_128x2(seed=0, device="cpu")
            ex_cpu = Explainer(feat, ei, cpu_model, config, names, device="cpu")
            ex_cpu = ex_cpu._explain(q, times=1)
            msg += f", max |card - cpu| {_check_against_cpu(ex, ex_cpu, 'query ' + q):.3e}"
        elif not np.isfinite(ex.mean).all():
            raise AssertionError(f"query {q}: non-finite scores")
        log(msg + " ok")


def profile_forwards(engine, masks, wall_s: float) -> None:
    """Device time by operation over one pass of the graph path's forwards
    (``torch.profiler``), and the device's busy share of the unprofiled
    wall time ``wall_s`` of the same pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.query_outputs(masks, None, "graph_prediction", chunk_size=BIG_B)
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
        log("graph path profile: the profiler recorded no device time")
        return
    log(f"graph path profile: device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"(busy share {busy_ms / (wall_s * 1e3):.3f}); top operations by device time:")
    for ms, count, name in rows[:12]:
        short = name if len(name) <= 100 else f"{name[:45]} ... {name[-50:]}"
        log(f"  {ms:10.3f} ms  {count:6d} calls  {short}")


def phase_graph_path(dev, config, record: dict) -> int:
    """Returns the kernel's launch count during the explanation; ``record``
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
    spmm_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    explainer = Explainer(feat, ei, model, cfg, names, problem="graph_prediction", device=dev)
    ex = explainer._explain(None, times=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm_cuda.KERNEL.launches
    if launches != expected:
        raise AssertionError(
            f"graph path launched the kernel {launches} times, expected {expected}"
        )
    if not np.isfinite(ex.mean).all() or ex.mean.shape != (BIG_N,):
        raise AssertionError("graph path: scores are not finite or of the wrong shape")
    log(f"graph path 100k/1M GCN-128x2: {n_masks} masks in chunks of {BIG_B}, "
        f"wall {wall:.3f} s, kernel launches {launches} (expected {expected}), "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ok")
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
    t0 = time.perf_counter()
    engine.query_outputs(all_masks, None, "graph_prediction", chunk_size=BIG_B)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    log(f"graph path breakdown: engine set-up (graph upload, CSR, neighbour table, "
        f"layer-1 features) {setup_s:.3f} s; {n_masks} forwards {fwd_s:.3f} s; "
        f"rest of the explanation (mask sampling, transfer, surrogate fit) "
        f"{wall - setup_s - fwd_s:.3f} s")
    profile_forwards(engine, all_masks, fwd_s)
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
    return launches


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
    phase_header()
    phase_build()
    record = phase_kernel(dev)
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda

    spmm_cuda.KERNEL.launches = 0
    phase_node_path(dev, config)
    log(f"node path kernel launches: {spmm_cuda.KERNEL.launches} (dense tier: none expected)")
    record["launches"] = phase_graph_path(dev, config, record)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}), flush=True)
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
