"""Sweep execution policy (counterpart of ``transmogrifai_tpu.parallel``):
the single-card subset of ``elastic`` — the device-loss classifier, the
retry and quarantine ladder and the straggler watchdog.  Meshes and pods
are ROADMAP Queue A item 6.7."""
from .elastic import (  # noqa: F401
    DEVICE_LOSS_NEEDLES, ElasticContext, ElasticCounters,
    classify_sweep_error, is_device_loss, mesh_device_count,
    run_with_deadline, shrink_mesh)

__all__ = ["DEVICE_LOSS_NEEDLES", "ElasticContext", "ElasticCounters",
           "classify_sweep_error", "is_device_loss", "mesh_device_count",
           "run_with_deadline", "shrink_mesh"]
