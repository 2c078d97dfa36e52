"""Device resolution for every entry point of the package.

The rule: work runs on ``cuda`` unless the caller asks for the CPU, either
per call (``device="cpu"``) or process-wide (``set_device("cpu")``, which
the tests use).  When no card is present and the caller did not ask for
the CPU, resolution raises — there is no silent fallback to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["set_device", "resolve_device"]

DeviceLike = Union[str, torch.device, None]

_default: str = "cuda"


def set_device(device: DeviceLike) -> None:
    """Set the process-wide default device (``"cuda"`` or ``"cpu"``)."""
    global _default
    _default = torch.device(device or "cuda").type


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a call runs on: ``device`` if given, else the default.
    Raises when that is CUDA and no card is available."""
    dev = torch.device(device if device is not None else _default)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or call "
            "transmogrifai_tpu_torch.set_device('cpu')) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
