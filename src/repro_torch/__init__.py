"""PyTorch and CUDA port of the SiM reproduction.

The same system as the JAX package ``repro``, module for module, with every
Pallas kernel on the ported path rewritten by hand in CUDA C++ for Hopper
(``kernels/csrc``).  Host-side code stays numpy; device code is torch.
Entry points take ``device=None`` (the current CUDA device, raising when
there is none) or an explicit ``device="cpu"``, on which every kernel runs
as its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
