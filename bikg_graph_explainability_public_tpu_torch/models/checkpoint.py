"""Parameter checkpoints: the JAX package's flat ``.npz`` archives and
parameter trees, as module state dicts, and back.

Keys are dotted paths of the JAX tree (``conv.0.weight``, ``fc.2.bias``),
which are also the parameter names of :class:`.gnn.GCNNodeModel`, so a
module's ``state_dict()`` saves as the archive the JAX package reads.
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


def _host_flat(params: Any) -> Dict[str, np.ndarray]:
    """A state dict (dotted names to tensors or arrays) or a JAX-style tree
    of dicts, lists and arrays, as dotted names to numpy arrays."""
    if isinstance(params, dict) and all(
        isinstance(v, (torch.Tensor, np.ndarray)) for v in params.values()
    ):
        return {
            k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in params.items()
        }
    return _flatten(params)


def save_params(path: str, params: Any) -> None:
    """Save a state dict (or a parameter tree) to ``.npz`` with the dotted
    keys that :func:`load_params` and the JAX package's ``load_params``
    read."""
    np.savez(path, **_host_flat(params))


def gcn_params_to_torch_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """Export a :class:`.gnn.GCNNodeModel` state dict (``conv.{i}.weight``,
    ``fc.{j}.*``) to the reference's torch key layout (``conv.{2i}.lin.
    weight`` / ``conv.{2i}.bias`` / ``fc.{2j}.*``), so a model can go back
    to torch/PyG tooling."""
    sd: Dict[str, np.ndarray] = {}
    for key, v in _host_flat(params).items():
        group, idx, name = key.split(".")
        i = 2 * int(idx)
        if group == "conv":
            sd[f"conv.{i}.lin.weight" if name == "weight" else f"conv.{i}.{name}"] = v
        else:
            sd[f"fc.{i}.{name}"] = v
    return sd
