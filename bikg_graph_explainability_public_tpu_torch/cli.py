"""Command-line interface (stdlib argparse):

    python -m bikg_graph_explainability_public_tpu_torch.cli explain \
        --graph graph.npz --checkpoint model.pth.tar --element 10 \
        [--config configs.json] [--pathways pathways.json] [--times 3] \
        [--out scores.csv] [--device cuda]

    python -m bikg_graph_explainability_public_tpu_torch.cli explain-batch \
        --graph graph.npz --checkpoint model.pth.tar --elements 10,3,25 ...

    torchrun --nproc-per-node N -m bikg_graph_explainability_public_tpu_torch.cli \
        explain-batch --mesh-devices N ...   # queries split over N cards (NCCL)

    python -m bikg_graph_explainability_public_tpu_torch.cli version

Graph file (homogeneous): ``.npz`` with ``feat`` [N,F], ``edge_index``
[2,E], optional ``names`` [N] and ``edge_names`` [E] (required for
``edge_prediction``: edge queries are edge names).
Graph file (heterogeneous): ``.npz`` with per-type ``feat__<type>`` and
per-relation ``edge_index__<src>__<rel>__<dst>`` arrays, optional
``names__<type>``.
Pathways file: JSON ``{"pathways": [[...], ...], "names": [...]}``.
Checkpoint: a torch ``.pth.tar`` of any layout
:func:`.models.torch_import.import_any` reads.

``--device`` defaults to ``cuda``; nothing falls back to the CPU unless
asked.  pandas is imported only by the commands that write frames.  The
JAX package's ``bench`` command runs its own ``bench.py`` and has no
counterpart here.  ``--mesh-devices N`` needs N ranks (torchrun), one a
device; only rank 0 prints or writes files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


class GraphFile:
    """Parsed CLI graph file (homogeneous or heterogeneous ``.npz``).

    Homogeneous: arrays ``feat`` [N,F], ``edge_index`` [2,E], optional
    ``names`` [N] and ``edge_names`` [E].  Heterogeneous: per-type arrays
    ``feat__<type>`` and per-relation ``edge_index__<src>__<rel>__<dst>``,
    optional ``names__<type>``.
    """

    def __init__(self, feat, edge_index, names, edge_names, hetero):
        self.feat = feat
        self.edge_index = edge_index
        self.names = names
        self.edge_names = edge_names
        self.hetero = hetero

    def flat_names(self):
        """Homogenised node-name list (type blocks in dict order)."""
        if not self.hetero:
            return list(self.names)
        out = []
        for t in self.feat:
            out.extend(self.names[t])
        return out


def _load_graph(path: str) -> GraphFile:
    if not os.path.exists(path):
        _fail(f"graph file not found: {path}")
    data = np.load(path, allow_pickle=True)
    het_feat = {k.split("__", 1)[1]: data[k] for k in data.files if k.startswith("feat__")}
    if het_feat:
        edge_index = {}
        for k in data.files:
            if k.startswith("edge_index__"):
                rel = tuple(k.split("__")[1:])
                if len(rel) != 3:
                    _fail(f"{path}: hetero edge key {k!r} must be edge_index__<src>__<rel>__<dst>")
                edge_index[rel] = data[k]
        if not edge_index:
            _fail(f"{path} has feat__<type> arrays but no edge_index__ keys")
        names = {
            t: (
                [str(x) for x in data[f"names__{t}"]]
                if f"names__{t}" in data
                else [str(i) for i in range(het_feat[t].shape[0])]
            )
            for t in het_feat
        }
        return GraphFile(het_feat, edge_index, names, None, hetero=True)
    if "feat" not in data or "edge_index" not in data:
        _fail(
            f"{path} must contain 'feat' and 'edge_index' arrays (or "
            "hetero 'feat__<type>' / 'edge_index__<src>__<rel>__<dst>')"
        )
    feat = data["feat"]
    names = (
        [str(x) for x in data["names"]] if "names" in data
        else [str(i) for i in range(feat.shape[0])]
    )
    edge_names = [str(x) for x in data["edge_names"]] if "edge_names" in data else None
    return GraphFile(feat, data["edge_index"], names, edge_names, hetero=False)


def _load_model(checkpoint: str, device):
    """A Model from a torch checkpoint (homogeneous stacks, RGCN and
    HeteroConv stacks of GCN, SAGE or GAT convs, as
    :func:`.models.torch_import.import_any` reads them), on ``device``."""
    from .models.adapter import Model
    from .models.torch_import import import_any, load_state_dict

    if not os.path.exists(checkpoint):
        _fail(f"checkpoint not found: {checkpoint}")
    model_def, params = import_any(load_state_dict(checkpoint))
    return Model(model_def, params, device=device)


def _load_pathways(args):
    pathways = pathway_names = None
    if args.pathways:
        with open(args.pathways) as f:
            pw = json.load(f)
        pathways = pw["pathways"]
        pathway_names = pw.get("names")
    return pathways, pathway_names


def _config(args):
    from .config import DEFAULTS, load_config

    return load_config(args.config) if args.config else load_config(dict(DEFAULTS))


def cmd_explain(args: argparse.Namespace) -> int:
    """Run one explanation and print or save the DataFrames."""
    from .explain.explainer import Explainer

    gf = _load_graph(args.graph)
    cfg = _config(args)
    model = _load_model(args.checkpoint, args.device)
    pathways, pathway_names = _load_pathways(args)

    names = gf.names
    if "edge" in args.problem and not gf.hetero:
        # edge queries are EDGE names: node-length name lists would
        # mislabel every row of the output
        if gf.edge_names is None:
            _fail(
                "edge_prediction needs an 'edge_names' array in the graph "
                ".npz (edge queries are edge names, not node names)"
            )
        names = gf.edge_names

    ex = Explainer(
        gf.feat, gf.edge_index, model, cfg, names, pathways=pathways,
        pathway_names=pathway_names, problem=args.problem, device=args.device,
    )
    cv_df, pw_df = ex.run(args.element, times=args.times)
    if args.out:
        cv_df.to_csv(args.out)
        print(f"wrote {args.out}")
        if pw_df is not None:
            pw_path = args.out.rsplit(".", 1)[0] + "_pathways.csv"
            pw_df.to_csv(pw_path)
            print(f"wrote {pw_path}")
    else:
        print(cv_df.to_string())
        if pw_df is not None:
            print()
            print(pw_df.to_string())
    return 0


def cmd_explain_batch(args: argparse.Namespace) -> int:
    """Explain many queries at once: the multi-query throughput path.  A
    hetero graph's type ids are renumbered into the model's order by name
    (:func:`.explain.explainer.align_types`) before ``explain_many``, which
    takes them as positions."""
    import torch.distributed as dist

    n, mesh, started = args.mesh_devices, None, False
    if n:
        from .parallel.mesh import initialize_distributed, make_mesh

        joined = dist.is_initialized()
        initialize_distributed(device=args.device)  # torchrun's environment
        started = not joined and dist.is_initialized()
    try:
        if n:
            world = dist.get_world_size() if dist.is_initialized() else 0
            if world != n:
                _fail(
                    f"--mesh-devices {n} needs {n} ranks, one a device, and found {world}: "
                    f"launch with torchrun --nproc-per-node {n} -m "
                    f"bikg_graph_explainability_public_tpu_torch.cli explain-batch "
                    f"--mesh-devices {n} ..."
                )
            mesh = make_mesh(n, device=args.device)
        return _explain_batch(args, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _explain_batch(args: argparse.Namespace, mesh) -> int:
    from .explain.batch import explain_many
    from .explain.explainer import align_types
    from .graph import from_arrays, hetero_to_homo

    gf = _load_graph(args.graph)
    cfg = _config(args)
    model = _load_model(args.checkpoint, args.device)
    pathways, pathway_names = _load_pathways(args)

    if "edge" in args.problem and (gf.hetero or gf.edge_names is None):
        # edge queries resolve against EDGE names
        _fail(
            "edge_prediction needs an 'edge_names' array in a "
            "homogeneous graph .npz (edge queries are edge names)"
        )
    if gf.hetero:
        g, info = hetero_to_homo(gf.feat, gf.edge_index, device=args.device)
        try:
            g = align_types(g, info, model.model_def)
        except ValueError as e:
            _fail(str(e))
    else:
        g = from_arrays(gf.feat, gf.edge_index, device=args.device)
    names = gf.edge_names if "edge" in args.problem else gf.flat_names()

    name_to_idx = {n: i for i, n in enumerate(names)}
    elements = [el.strip() for el in args.elements.split(",")]
    for el in elements:
        if el not in name_to_idx:
            _fail(f"element {el!r} is not present in the graph")
    dfs = explain_many(
        model, g, [name_to_idx[el] for el in elements], cfg.to_dict(), names=names,
        times=args.times, mesh=mesh, pathways=pathways, pathway_names=pathway_names,
        problem=args.problem,
    )
    if mesh is not None and mesh.get_rank() != 0:
        return 0
    for el, out in zip(elements, dfs):
        cv_df, pw_df = out if isinstance(out, tuple) else (out, None)
        if args.out:
            stem = args.out.rsplit(".", 1)[0]
            cv_df.to_csv(f"{stem}_{el}.csv")
            print(f"wrote {stem}_{el}.csv")
            if pw_df is not None:
                pw_df.to_csv(f"{stem}_{el}_pathways.csv")
                print(f"wrote {stem}_{el}_pathways.csv")
        else:
            print(f"== element {el}")
            print(cv_df.to_string())
            if pw_df is not None:
                print(pw_df.to_string())
    return 0


def cmd_version(_args: argparse.Namespace) -> int:
    """Print the package version with its git hash."""
    from .version import get_version

    print(get_version(with_git_hash=True))
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--graph", required=True, help=".npz with feat/edge_index[/names]")
    p.add_argument("--checkpoint", required=True, help="torch .pth.tar checkpoint")
    p.add_argument("--config", help="hyperparameter JSON (reference schema)")
    p.add_argument("--pathways", help="JSON with pathways/names")
    p.add_argument(
        "--problem", default="node_prediction",
        choices=["node_prediction", "edge_prediction", "graph_prediction"],
    )
    p.add_argument("--times", type=int, default=1)
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")


def main(argv=None) -> int:
    """CLI entry point."""
    p = argparse.ArgumentParser(
        prog="bikg_graph_explainability_public_tpu_torch",
        description="community-aware GNN explainability (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    pe = sub.add_parser("explain", help="explain one node/edge/graph prediction")
    _add_common(pe)
    pe.add_argument("--element", required=True, help="element name to explain")
    pe.add_argument("--out", help="CSV output path")
    pe.set_defaults(fn=cmd_explain)

    peb = sub.add_parser("explain-batch", help="explain many elements at once (throughput path)")
    _add_common(peb)
    peb.add_argument("--elements", required=True, help="comma-separated element names")
    peb.add_argument(
        "--mesh-devices", type=int, default=0,
        help="split the query axis over this many ranks, one a device (0 = no mesh)",
    )
    peb.add_argument("--out", help="CSV output path prefix")
    peb.set_defaults(fn=cmd_explain_batch)

    pv = sub.add_parser("version", help="print version")
    pv.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
