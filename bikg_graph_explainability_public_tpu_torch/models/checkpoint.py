"""Parameter checkpoints: the JAX package's flat ``.npz`` archives and
parameter trees, as module state dicts.

Keys are dotted paths of the JAX tree (``conv.0.weight``, ``fc.2.bias``),
which are also the parameter names of :class:`.gnn.GCNNodeModel`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def params_from_numpy(tree: Any) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (``{"conv": [{"weight", "bias"}], "fc": [...]}``
    of numpy arrays) as a state dict for ``load_state_dict``."""
    return {
        k: torch.from_numpy(np.array(v, np.float32)) for k, v in _flatten(tree).items()
    }


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.npz`` saved by the JAX package's ``save_params``."""
    with np.load(path) as data:
        return {k: torch.from_numpy(np.array(data[k], np.float32)) for k in data.files}
