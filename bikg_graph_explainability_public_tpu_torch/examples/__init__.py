"""Runnable examples: ``python -m bikg_graph_explainability_public_tpu_torch.examples.<name>``."""
