"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card.  Raises when CUDA is absent and the
    caller did not ask for the CPU explicitly: nothing falls back quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # compare equal to the tensors' own device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
