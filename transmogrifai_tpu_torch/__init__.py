"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

Mirrors the JAX package's module layout (``types``, ``features``,
``stages``, ``ops``, ``preparators``, ``models``, ``evaluators``,
``workflow``, ``readers``).  Entry points run on ``cuda`` unless the
caller asks for the CPU (see :mod:`.device`).
"""
from .device import resolve_device, set_device

__all__ = ["set_device", "resolve_device"]
