"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller names another device.  With no
device given and no GPU present they raise instead of carrying on on the
CPU, so a run never reports CPU numbers under a GPU's name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means CUDA, which must
    be present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: repro_torch runs on the GPU unless "
            "the caller passes device='cpu' (which runs every kernel's plain "
            "PyTorch version)")
    return torch.device("cuda")
