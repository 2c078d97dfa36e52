"""Per-stage kernel mix: which kernels a stage ran, under ``torch.profiler``
(the port's counterpart of ``transmogrifai_tpu.obs.hlo``).

The JAX package intercepts each XLA compilation and records the compiled
program's op mix, FLOPs and bytes accessed.  The port compiles no
programs: a stage's work is the kernels it launches.  So while a trace is
armed with capture on (``start_trace(capture_hlo=True)``), the execution
plan (``workflow/plan.py``) runs each serial stage inside
:func:`capture`: ``torch.profiler`` with the CUDA activity on the card
(CUPTI, which records every kernel of the context, the ctypes-bound
``seg_hist.cu`` too) and the CPU activity on the CPU.  The card leaves
the CPU activity out: recording every aten op as well multiplied a
traced selector train's wall on the H100 (PERF.md, the obs phase).  The
stage's ``StageProfile.hlo`` is then::

    {"programs": <device activities recorded (kernels, copies, sets)>,
     "ops": {<kernel name>: count, ...},
     "deviceSecs": <their summed device time>}

and, on the CPU, ``{"programs": <aten ops recorded>, "ops": {<aten op>:
count}}``, with no device time (the CPU is not the card).  ``flops`` and
``bytes_accessed`` are left out: CUPTI's activity records do not give
them.  The recording covers every thread of the process while the stage
runs (the selector's tree-prep prefetch thread, a pool stage of the same
layer): attribution by stage holds for serial stages, as the launch
counts' does.

One profiler runs at a time in a process.  A capture finds the profiler
held (by ``utils.profiling.profile_to`` or by an enclosing stage's
capture) and records nothing but ``{"skipped": "<holder> active"}``.  A
failure inside the capture leaves the field empty and never breaks the
stage: the kernels themselves still raise as they do untraced.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

__all__ = ["arm", "disarm", "is_armed", "capture", "exclusive",
           "summarize"]

_lock = threading.Lock()
_armed = False
#: who holds the process's one profiler: None, "capture" or "profile_to"
_holder: Optional[str] = None


def arm() -> bool:
    """Turn the capture on (``start_trace``); True once armed."""
    global _armed
    with _lock:
        _armed = True
    return True


def disarm() -> None:
    global _armed
    with _lock:
        _armed = False


def is_armed() -> bool:
    with _lock:
        return _armed


def _claim(owner: str) -> Optional[str]:
    """Take the profiler for ``owner``: None on success, else who holds
    it."""
    global _holder
    with _lock:
        if _holder is not None:
            return _holder
        _holder = owner
        return None


def _release() -> None:
    global _holder
    with _lock:
        _holder = None


@contextlib.contextmanager
def exclusive(owner: str):
    """Hold the process's one profiler for the block; raises
    ``RuntimeError`` where another holder has it."""
    held = _claim(owner)
    if held is not None:
        raise RuntimeError(
            f"{owner}: torch.profiler is already running ({held})")
    try:
        yield
    finally:
        _release()


def _activities(device) -> list:
    """The CUDA activity where ``device`` (else the package's default
    device) is the card, else the CPU activity."""
    import torch
    from torch.profiler import ProfilerActivity

    from .. import device as _device

    dev = torch.device(device if device is not None else _device._default)
    if dev.type == "cuda" and torch.cuda.is_available():
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


@contextlib.contextmanager
def capture(device=None):
    """Run the block under ``torch.profiler`` when armed; yields a dict
    that holds the block's kernel mix after it ({} when off or when the
    capture failed).  ``device`` is the stage's: the CUDA activity is
    recorded where it is the card."""
    out: Dict[str, Any] = {}
    if not _armed:
        yield out
        return
    held = _claim("capture")
    if held is not None:
        out["skipped"] = f"{held} active"
        yield out
        return
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile

        acts = _activities(device)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:  # telemetry never breaks the stage
        prof = None
    try:
        yield out
    finally:
        try:
            if prof is not None:
                prof.__exit__(None, None, None)
                out.update(summarize(
                    prof, card=ProfilerActivity.CUDA in acts))
        except Exception:  # nor does a failed read of it
            out.clear()
        finally:
            _release()


def _raw_events(prof, card: bool):
    """(name, device type, us) of the profiler's device activities and,
    off the card, of its CPU ops: kineto's own records where the profiler
    exposes them (no event tree is built), else its function events.  On
    the card the CPU-side records (the runtime calls) are passed over
    without reading their names."""
    from torch.autograd import DeviceType

    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is None:
        for e in prof.events():
            yield e.name, e.device_type, e.time_range.elapsed_us()
        return
    for e in results.events():
        dtype = e.device_type()
        if dtype == DeviceType.CUDA or not card:
            yield e.name(), dtype, e.duration_ns() / 1e3


def summarize(prof, card: bool = False) -> Dict[str, Any]:
    """The kernel mix of a stopped ``torch.profiler`` session: device
    activities by name with their summed device seconds where the card
    was recorded (``card``), else aten ops by name."""
    from torch.autograd import DeviceType

    device_ops: Dict[str, int] = {}
    aten_ops: Dict[str, int] = {}
    device_us = 0.0
    for name, dtype, dur_us in _raw_events(prof, card):
        if dtype == DeviceType.CUDA:
            device_ops[name] = device_ops.get(name, 0) + 1
            device_us += float(dur_us)
        elif name.startswith("aten::"):
            aten_ops[name] = aten_ops.get(name, 0) + 1
    if device_ops:
        return {"programs": sum(device_ops.values()), "ops": device_ops,
                "deviceSecs": round(device_us / 1e6, 6)}
    if aten_ops:
        return {"programs": sum(aten_ops.values()), "ops": aten_ops}
    return {}
