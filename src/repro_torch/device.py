"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller names another device.  With no
device given and no GPU present they raise instead of carrying on on the
CPU, so a run never reports CPU numbers under a GPU's name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "operand_device", "Device"]

Device = Optional[Union[str, torch.device]]


def resolve_device(device: Device = None) -> torch.device:
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


def operand_device(x, device: Device = None) -> torch.device:
    """The device a call on operand ``x`` runs on: ``device`` if given,
    else the device of ``x`` if it is a tensor, else CUDA (which must be
    present).  So tensors stay where they are and arrays go to the GPU
    unless the caller names another device."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)
