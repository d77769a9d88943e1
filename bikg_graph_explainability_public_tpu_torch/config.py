"""Explainer hyperparameters.

The reference's flat JSON hyperparameter dict (``config/configs.json``) as a
typed dataclass with central validation, plus the runtime fields the port
reads.  A plain dict works everywhere as well.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

#: Reference defaults (config/configs.json)
DEFAULTS: Dict[str, Any] = {
    "seed": 1,
    "interpret_samples": 20,
    "epochs": 50,
    "optimizer": "adam",
    "lr": 0.01,
    "lr_patience": 10,
    "l1_lambda": 1e-4,
}


def check_spmm_backend(name: str) -> None:
    """Only ``"auto"`` runs: the ELL aggregation launches the hand-written
    CUDA kernel on the card and its plain version on the CPU.  The other
    names of the JAX package are accepted by nothing yet."""
    if name not in ("xla", "pallas", "auto"):
        raise ValueError(f"unknown spmm_backend {name!r}")
    if name != "auto":
        raise NotImplementedError(
            f"spmm_backend={name!r} is not ported; only 'auto' runs"
        )


@dataclass
class ExplainerConfig:
    """Hyperparameters (mirroring the reference JSON) and runtime fields."""

    # --- reference hyperparameters -------------------------------------
    seed: int = 1
    interpret_samples: int = 20  # perturbations per epoch
    epochs: int = 50  # mask mini-batches per repeat
    optimizer: str = "adam"
    lr: float = 0.01
    lr_patience: int = 10  # kept for parity; the reference never steps it
    l1_lambda: float = 1e-4

    # --- runtime ----------------------------------------------------------
    weight_decay: float = 1e-2  # hardcoded in the reference (wlm.py:478)
    pad_mode: str = "pow2"  # subgraph capacity bucketing
    forward_chunk: Optional[int] = None  # masks per forward step
    # accepted so that configurations carry over, and read nowhere, as in
    # the JAX package (a mesh is passed to explain_many(mesh=)); the port
    # computes in float32 throughout, so matmul_precision has nothing to choose
    mesh_shape: Optional[Tuple[int, ...]] = None
    matmul_precision: str = "default"  # "default" | "highest"
    spmm_backend: str = "auto"

    def validate(self) -> "ExplainerConfig":
        """Raise on out-of-range fields (reference explainer.py:162)."""
        if not isinstance(self.optimizer, str):
            raise TypeError("Optimizer is not string")
        if self.optimizer.strip().lower() != "adam":
            raise ValueError("Optimizer choice not available. Please choose 'adam'")
        if not isinstance(self.lr, (int, float)):
            raise TypeError("Learning rate given is not numeric")
        if not isinstance(self.interpret_samples, (int, float)):
            raise TypeError("Number of perturbations in batch is not numeric")
        if not isinstance(self.epochs, (int, float)):
            raise TypeError("Number of epochs in batch is not numeric")
        if self.pad_mode not in ("pow2", "multiple", "exact"):
            raise ValueError(f"unknown pad_mode {self.pad_mode!r}")
        check_spmm_backend(self.spmm_backend)
        return self

    def to_dict(self) -> Dict[str, Any]:
        """Plain-dict view (the reference's params dict shape)."""
        return dataclasses.asdict(self)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def get(self, key: str, default=None):
        """dict.get-style access for reference-parity call sites."""
        return getattr(self, key, default)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExplainerConfig":
        """Build from a reference-style params dict, applying defaults."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).validate()

    @classmethod
    def from_json(cls, path: str) -> "ExplainerConfig":
        """Load from a configs.json file."""
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_config(path_or_dict=None) -> ExplainerConfig:
    """Load hyperparameters from a JSON path, a dict, or defaults."""
    if path_or_dict is None:
        return ExplainerConfig().validate()
    if isinstance(path_or_dict, str):
        return ExplainerConfig.from_json(path_or_dict)
    if isinstance(path_or_dict, ExplainerConfig):
        return path_or_dict.validate()
    return ExplainerConfig.from_dict(dict(path_or_dict))
