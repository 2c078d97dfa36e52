"""Device resolution for every entry point of the package.

The rule: work runs on ``cuda`` unless the caller asks for the CPU, either
per call (``device="cpu"``) or process-wide (``set_device("cpu")``, which
the tests use).  When no card is present and the caller did not ask for
the CPU, resolution raises — there is no silent fallback to the CPU.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["set_device", "resolve_device", "as_device_tensor",
           "device_vector"]

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


def as_device_tensor(value, dtype: torch.dtype,
                     device: DeviceLike = None) -> torch.Tensor:
    """A tensor left where it is, or an array (a loaded artifact's numpy
    array, a JSON list) as a ``dtype`` tensor on the resolved device."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value), dtype=dtype).to(
        resolve_device(device))


def device_vector(col, device: DeviceLike = None):
    """An ``OPVector`` column (a ``FeatureColumn``) as a float32 tensor: a
    tensor column is returned as it is, a host array (a raw vector
    feature) is moved to the resolved device in one copy, its metadata
    kept.  Every stage that takes a vector on the device takes it through
    here."""
    if isinstance(col.values, torch.Tensor):
        return col
    from .types.columns import FeatureColumn

    mat = np.ascontiguousarray(col.values, dtype=np.float32)
    return FeatureColumn(col.ftype,
                         torch.from_numpy(mat).to(resolve_device(device)),
                         col.mask, col.vmeta)
