"""PyTorch port of the fair-square datapath (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and vocabulary (modes, routes, sites) and runs on PyTorch.  Every
Pallas TPU kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, built at first use; on CPU tensors each kernel wrapper runs the
kernel's plain PyTorch version instead.  This package never imports JAX or
``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
