"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

Mirrors the JAX package's module layout (``types``, ``features``,
``stages``, ``ops``, ``preparators``, ``models``, ``evaluators``,
``workflow``, ``readers``).  Entry points run on ``cuda`` unless the
caller asks for the CPU (see :mod:`.device`).  Importing the package
installs the feature DSL (:mod:`.dsl`: feature arithmetic, ``alias``,
``vectorize``).
"""
from .device import resolve_device, set_device
from . import dsl  # noqa: F401  installs the fluent Feature methods

__all__ = ["set_device", "resolve_device"]
