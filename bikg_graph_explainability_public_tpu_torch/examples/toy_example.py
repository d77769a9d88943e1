"""Toy example: the reference's ``examples/toy_example-caseA.ipynb`` on the
port.  A 5-node star graph, two communities, a small GCN trained with
torch, and a community-aware explanation of node "1".

Run:  python -m bikg_graph_explainability_public_tpu_torch.examples.toy_example [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import bikg_graph_explainability_public_tpu_torch as px


def main(argv=None):
    """Train the toy GCN on ``--device`` (default: the CUDA card), explain
    node "1", print the frames and return them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a tiny star graph: node 1 is the hub, nodes 0, 2, 3, 4 point at it
    rng = np.random.default_rng(0)
    n, f = 5, 8
    feat = rng.normal(size=(n, f)).astype(np.float32)
    edge_index = np.array([[0, 2, 3, 4, 1, 1, 1, 1],
                           [1, 1, 1, 1, 0, 2, 3, 4]])
    names = [str(i) for i in range(n)]
    # two communities: {0} and {2, 3, 4} (the reference's case A layout)
    pathways = [["0"], ["2", "3", "4"]]
    pathway_names = ["solo", "trio"]

    # 2. train a small GCN node classifier (binary labels)
    model_def = px.GCNNodeModel(f, conv_channels=(8,), fc_channels=(8, 8),
                                generator=torch.Generator().manual_seed(0))
    model = px.Model(model_def, device=args.device)
    g = px.from_arrays(feat, edge_index, device=args.device)
    labels = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0], device=model.device)
    ew = g.edge_mask.float()
    opt = torch.optim.SGD(model.model_def.parameters(), lr=0.1)
    for _ in range(500):
        out = model.model_def(g.x, g.senders, g.receivers, ew)[:n, 0]
        loss = -torch.mean(
            labels * torch.log(out + 1e-7) + (1 - labels) * torch.log(1 - out + 1e-7)
        )
        opt.zero_grad()
        loss.backward()
        opt.step()
    print(f"final training loss: {loss.item():.4f}")

    # 3. explain the hub node's prediction
    config = {"seed": 1, "interpret_samples": 20, "epochs": 50, "lr": 0.01, "l1_lambda": 1e-4}
    explainer = px.Explainer(feat, edge_index, model, config, names, pathways=pathways,
                             pathway_names=pathway_names, device=args.device)
    node_df, pathway_df = explainer.run("1", times=10)
    print("\nPer-node configuration values (mean over 10 repeats):")
    print(node_df)
    print("\nCommunity scores:")
    print(pathway_df)
    return node_df, pathway_df


if __name__ == "__main__":
    main()
