"""Reference-named API shims.

The reference exports ``Data, Explainer, Kernel, Mask, Model, Pathways,
LinearRegression`` (its package ``__init__.py``).  This module offers the
same names on top of the port's components, so users migrating from the
reference find every entry point.  New code should prefer the native APIs
(:class:`.graph.Graph`, :class:`.explain.masks.MaskSampler`,
:func:`.explain.kernels.shap_kernel`, :mod:`.explain.wlm`).

Where the JAX package takes a PRNG key, these take the port's key words: a
``[2]`` uint32 array (:func:`.utils.prng.root_key`, ``fold_in``), equal to
``jax.random.key_data`` of the same key, so the draws are the same bit for
bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .explain.kernels import shap_kernel
from .explain.masks import MaskSampler
from .explain.wlm import init_surrogate_weights
from .graph import Graph, element_size, from_arrays, hetero_to_homo
from .utils.device import resolve_device
from .utils.prng import root_key


class Data:
    """Reference ``Data`` facade (``data.py:19``): holds feat/edge_index and
    exposes the graph transformations.  ``device``: where :meth:`to_graph`
    puts the graph (``None`` means the CUDA card)."""

    def __init__(self, feat, edge_index, device=None):
        self.feat = feat
        self.edge_index = edge_index
        self.device = device

    def to_graph(self) -> Graph:
        """Build the padded Graph from the stored arrays."""
        if isinstance(self.feat, dict):
            g, _info = hetero_to_homo(self.feat, self.edge_index, device=self.device)
            return g
        return from_arrays(self.feat, self.edge_index, device=self.device)

    def preprocess_hetero_graph(self):
        """Mirror of ``data.py:39-93``: returns (graph, hetero_info), the
        typed homogeneous form plus pointer metadata (None for homo)."""
        if isinstance(self.feat, dict):
            return hetero_to_homo(self.feat, self.edge_index, device=self.device)
        return self.to_graph(), None

    def element_size(self, problem: str) -> int:
        """Node/edge count for the problem type (reference data.py:363)."""
        return element_size(self.to_graph(), problem)


class Kernel:
    """Reference ``Kernel`` facade (``kernels.py:6``): kernel weights for a
    perturbation mask, held on ``device`` (``None`` means the CUDA card)."""

    def __init__(self, mask, device=None):
        self.mask = torch.as_tensor(np.asarray(mask, bool), device=resolve_device(device))

    def compute(self, normalized: bool = True) -> torch.Tensor:
        """KernelSHAP weight per mask row (reference kernels.py:115)."""
        return shap_kernel(self.mask, normalized=normalized)


class Mask:
    """Reference ``Mask`` facade (``masks.py:10``): mask generation returning
    the batched mask set (instead of a torch DataLoader).  The sampler runs
    on the host; the graph is built on the CPU only to count its
    elements."""

    def __init__(self, feat, edge_index, pathways, params, problem):
        g = Data(feat, edge_index, device="cpu").to_graph()
        n_el = element_size(g, problem)
        width = g.e_pad if "edge" in problem else g.n_pad
        self._sampler = MaskSampler(n_el, width, dict(params), pathways)
        self._seed = int(dict(params).get("seed", 0))

    def mask_generator(self, key: Optional[np.ndarray] = None):
        """Returns (mask [M, S] bool, pathway_rows, batch_size) for the key
        words ``key`` (default: the root key of ``params['seed']``)."""
        if key is None:
            key = root_key(self._seed)
        return self._sampler.sample(key)


class LinearRegression:
    """Reference surrogate facade (``wlm.py:17-61``): a single bias-free
    linear map, as an (init, apply) pair."""

    def __init__(self, num_elements: int, width: Optional[int] = None):
        if not isinstance(num_elements, int):
            raise AssertionError("num_elements must be int")
        self.num_elements = num_elements
        self.width = width or num_elements

    def init(self, key: np.ndarray) -> torch.Tensor:
        """Initialize the surrogate weight vector from the key words
        ``key``."""
        return init_surrogate_weights(key, self.width, self.num_elements)

    @staticmethod
    def apply(weights: torch.Tensor, mask) -> torch.Tensor:
        """Surrogate forward: mask @ w (reference wlm.py:45)."""
        return torch.as_tensor(mask, device=weights.device).to(torch.float32) @ weights
