"""Heterogeneous toy example: the reference's ``examples/toy_example-caseB.
ipynb`` on the port.  A two-type graph (genes, drugs), two relations,
per-relation GCN convs trained with torch, a community-aware explanation of
gene "g1", and ``explain_many`` over three genes.

Run:
    python -m bikg_graph_explainability_public_tpu_torch.examples.toy_example_hetero [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import bikg_graph_explainability_public_tpu_torch as px


def main(argv=None):
    """Train the toy hetero GCN on ``--device`` (default: the CUDA card),
    explain gene "g1" and genes g0, g2, g4 together, print and return the
    frames."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # 1. a tiny hetero graph: 6 genes + 3 drugs, two relations
    n_gene, n_drug, f = 6, 3, 8
    feat = {
        "gene": rng.normal(size=(n_gene, f)).astype(np.float32),
        "drug": rng.normal(size=(n_drug, f)).astype(np.float32),
    }
    relations = [("gene", "interacts", "gene"), ("drug", "targets", "gene")]
    edge_index = {
        relations[0]: np.array([[0, 1, 2, 3, 4, 5, 1, 2], [1, 0, 3, 2, 5, 4, 2, 1]]),
        relations[1]: np.array([[0, 1, 2, 0], [0, 2, 4, 5]]),
    }
    names = {"gene": [f"g{i}" for i in range(n_gene)], "drug": [f"d{i}" for i in range(n_drug)]}
    # communities over genes: a "pathway" pair and the rest
    pathways = {"gene": [["g0", "g1", "g2"], ["g3", "g4", "g5"]]}
    pathway_names = {"gene": ["pathway-A", "pathway-B"]}

    # 2. a per-relation GCN (HeteroConv-sum semantics), trained briefly
    model_def = px.hetero_gcn_for_relations(["gene", "drug"], relations, f, conv_channels=(8,),
                                            fc_channels=(8, 8),
                                            generator=torch.Generator().manual_seed(0))
    model = px.Model(model_def, device=args.device)
    g, _ = px.hetero_to_homo(feat, edge_index, device=args.device)
    labels = rng.integers(0, 2, n_gene + n_drug).astype(np.float32)
    labels = torch.from_numpy(labels).to(model.device)
    ew = g.edge_mask.float()
    opt = torch.optim.SGD(model.model_def.parameters(), lr=0.1)
    for _ in range(200):
        out = model.model_def(g.x, g.senders, g.receivers, ew, g.node_type, g.edge_type)
        out = out[: n_gene + n_drug, 0]
        loss = -torch.mean(
            labels * torch.log(out + 1e-7) + (1 - labels) * torch.log(1 - out + 1e-7)
        )
        opt.zero_grad()
        loss.backward()
        opt.step()
    print(f"final training loss: {loss.item():.4f}")

    # 3. explain gene g1's prediction, community-aware
    config = {"seed": 1, "interpret_samples": 10, "epochs": 25, "lr": 0.01, "l1_lambda": 1e-4}
    explainer = px.Explainer(feat, edge_index, model, config, names, pathways=pathways,
                             pathway_names=pathway_names, element_type="gene",
                             device=args.device)
    config_vals, pathway_scores = explainer.run("g1", times=3)
    print("\nPer-element configuration values (mean over 3 repeats):")
    print(config_vals)
    print("\nCommunity (pathway) scores:")
    print(pathway_scores)

    # 4. three genes at once (the graph's types are in the model's order)
    flat_names, _ = px.hetero_names_to_homo(names)
    many = px.explain_many(model, g, [0, 2, 4], config, names=flat_names)
    for q, df in zip(("g0", "g2", "g4"), many):
        print(f"\n{q}: top element {df.index[0]} ({df['config_value_mean'].iloc[0]:.4f})")
    return config_vals, pathway_scores, many


if __name__ == "__main__":
    main()
