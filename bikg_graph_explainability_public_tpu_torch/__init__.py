"""bikg_graph_explainability_public_tpu_torch: community-aware GNN
explainability in PyTorch, with hand-written CUDA kernels for Hopper.

Given a trained GNN, a (possibly heterogeneous) graph and optional node or
edge communities, it explains a query node, edge or graph prediction by
perturbation sampling and a weighted linear surrogate (Configuration
Values / KernelSHAP), as the reference ``pathway_explanations`` library
does.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

The public surface is the JAX package's, minus what is not ported yet
(``RGCNNodeModel``, ``RGCNConv``, ``hetero_sage_for_relations``,
``hetero_gat_for_relations``).  Importing the package builds no kernel and
imports no pandas: kernels build at their first CUDA use, and pandas is
imported where a DataFrame is made.
"""

from .graph import (
    Graph,
    HeteroInfo,
    from_arrays,
    hetero_to_homo,
    hetero_names_to_homo,
    homo_to_hetero_features,
    element_size,
)
from .explain.explainer import Explainer, extract_index, set_seed, weight_stacking
from .explain.batch import explain_many
from .explain.kernels import shap_kernel, approximate_shap_kernel_parity
from .explain.masks import MaskSampler
from .explain.pathways import Pathways
from .explain.wlm import train_model, train_surrogate, init_surrogate_weights
from .models.adapter import Model
from .models.gnn import (
    ConvStackNodeModel,
    GCNNodeModel,
    HeteroGNN,
    gat_node_model,
    gatv2_node_model,
    gin_node_model,
    graph_conv_node_model,
    hetero_gcn_for_relations,
    sage_node_model,
)
from .models.layers import (
    GCNConv,
    GATConv,
    GATv2Conv,
    GINConv,
    GraphConv,
    Linear,
    SAGEConv,
)
from .compat import Data, Kernel, Mask, LinearRegression
from .config import ExplainerConfig, load_config
from .version import VERSION, get_version

__version__ = VERSION

__all__ = [
    "Graph",
    "HeteroInfo",
    "from_arrays",
    "hetero_to_homo",
    "hetero_names_to_homo",
    "homo_to_hetero_features",
    "element_size",
    "Explainer",
    "explain_many",
    "extract_index",
    "set_seed",
    "weight_stacking",
    "shap_kernel",
    "approximate_shap_kernel_parity",
    "MaskSampler",
    "Pathways",
    "train_model",
    "train_surrogate",
    "init_surrogate_weights",
    "Model",
    "ConvStackNodeModel",
    "GCNNodeModel",
    "HeteroGNN",
    "gat_node_model",
    "gatv2_node_model",
    "gin_node_model",
    "graph_conv_node_model",
    "sage_node_model",
    "hetero_gcn_for_relations",
    "GCNConv",
    "GATConv",
    "GATv2Conv",
    "GINConv",
    "GraphConv",
    "SAGEConv",
    "Linear",
    "Data",
    "Kernel",
    "Mask",
    "LinearRegression",
    "ExplainerConfig",
    "load_config",
    "VERSION",
    "get_version",
]
