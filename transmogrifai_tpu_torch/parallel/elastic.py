"""Elastic sweep execution on one card (counterpart of the single-device
part of ``transmogrifai_tpu.parallel.elastic``): survive a lost unit,
degrade, keep finishing.

* :func:`is_device_loss` / :func:`classify_sweep_error` — the one
  classifier every sweep-unit exception handler routes through: the
  injected ``DeviceLossError`` and the torch/CUDA messages of a card that
  is gone are device losses; everything else (out of memory included) is
  a workload failure of the candidate.
* :class:`ElasticCounters` — retries, mesh shrinks and re-packs,
  quarantined units, watchdog fires and device losses, with the JAX
  package's JSON keys.
* :class:`ElasticContext` — the per-sweep policy the
  ``SweepWorkQueue`` consults: a bounded retry of a unit after a device
  loss, the group-loss strip, the opt-in straggler watchdog (timeout ->
  degraded re-run at twice the deadline -> quarantine), the checkpoint
  flush before a risky retry, and the drain of abandoned workers.
* :func:`run_with_deadline`, :func:`mesh_device_count`,
  :func:`shrink_mesh`.

**No CPU rung.** The JAX package's ladder ends on its single-device
CPU-fallback path.  Here the ladder ends on the card the sweep started
on: a unit is retried there, up to the selector's
``elastic_max_retries``; then the unit is quarantined as ``failed:
device_loss`` (or ``failed: straggler``); where every candidate is
quarantined, the sweep raises.  Nothing moves to the CPU.  There is no
sweep mesh on one card (multi-card sweeps are ROADMAP Queue A item 6.7),
so the shrink hook changes nothing and the groups stay valid.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["is_device_loss", "classify_sweep_error", "DEVICE_LOSS_NEEDLES",
           "ElasticCounters", "ElasticContext", "shrink_mesh",
           "mesh_device_count", "run_with_deadline"]

#: message fragments that say the card or its driver is gone, as opposed
#: to a workload failure (a diverging candidate, a shape error, out of
#: memory)
DEVICE_LOSS_NEEDLES = (
    "CUDA-capable device(s) is/are busy or unavailable",
    "no CUDA-capable device is detected",
    "CUDA driver initialization failed",
    "uncorrectable ECC error encountered",
    "GPU has fallen off the bus",
    "device is lost",
    "injected device loss",
)


def is_device_loss(e: BaseException) -> bool:
    """True when ``e`` says the card died, the class a retry may
    survive, rather than the workload itself failing."""
    from ..utils.faults import DeviceLossError

    if isinstance(e, DeviceLossError):
        return True
    msg = f"{type(e).__name__}: {e}"
    return any(s in msg for s in DEVICE_LOSS_NEEDLES)


def classify_sweep_error(e: BaseException) -> str:
    """``"device_loss"`` or ``"workload"``: the routing decision of every
    sweep-unit exception handler."""
    return "device_loss" if is_device_loss(e) else "workload"


def mesh_device_count(mesh) -> int:
    """Devices a mesh spans (1 for ``None``, the single-card path)."""
    if mesh is None:
        return 1
    n = 1
    for name in mesh.axis_names:
        n *= int(mesh.shape[name])
    return n


def shrink_mesh(mesh, queue_width: int = 1):
    """The next smaller sweep mesh, or ``None`` when one device (or none)
    would remain: the signal to fit on the single card.  A mesh of more
    than two devices would shrink onto another mesh, which needs ROADMAP
    Queue A item 6.7."""
    import torch

    n = min(torch.cuda.device_count(), max(mesh_device_count(mesh) // 2, 1))
    if n <= 1:
        return None
    raise NotImplementedError(
        "shrinking a multi-card sweep mesh is not ported yet (ROADMAP "
        "Queue A item 6.7: meshes and pods)")


@dataclass
class ElasticCounters:
    """The elastic scoreboard of one sweep.  Every count is mirrored into
    the process's ledger (``utils.profiling.count_elastic``) and recorded
    as an ``elastic.<kind>`` flight event, at this one site, so that the
    events keep the order the ladder ran in (loss, retry, quarantine)."""

    retries: int = 0            # unit re-runs (device loss or watchdog)
    mesh_shrinks: int = 0       # mesh rebuilt smaller
    mesh_repacks: int = 0       # resume re-batched onto another mesh
    quarantined: int = 0        # units given up on after the retry budget
    watchdog_fires: int = 0     # per-unit deadline overruns
    device_losses: int = 0      # classified device-loss exceptions seen

    def count(self, kind: str, n: int = 1) -> None:
        setattr(self, kind, getattr(self, kind) + n)
        from ..obs.flight import record_event
        from ..utils.profiling import count_elastic

        count_elastic(kind, n)
        record_event(f"elastic.{kind}")

    def to_json(self) -> Dict[str, int]:
        return {"retries": self.retries,
                "meshShrinks": self.mesh_shrinks,
                "meshRepacks": self.mesh_repacks,
                "quarantined": self.quarantined,
                "watchdogFires": self.watchdog_fires,
                "deviceLosses": self.device_losses}


class ElasticContext:
    """Per-sweep elastic policy, consulted by ``SweepWorkQueue``.

    ``shrink`` is the owner's degrade hook; it returns True when it
    changed what the next attempt runs on (the selector's hook drains the
    tree-prep prefetch thread and returns False: one card, no mesh).
    ``unit_deadline_s`` arms the straggler watchdog (None = off)."""

    def __init__(self,
                 shrink: Optional[Callable[[], bool]] = None,
                 max_unit_retries: int = 2,
                 unit_deadline_s: Optional[float] = None,
                 max_watchdog_retries: int = 1,
                 counters: Optional[ElasticCounters] = None):
        self.shrink_cb = shrink
        self.max_unit_retries = int(max_unit_retries)
        self.unit_deadline_s = unit_deadline_s
        self.max_watchdog_retries = int(max_watchdog_retries)
        self.counters = counters or ElasticCounters()
        #: set by ``run_all`` so that a risky retry flushes the finished
        #: units first
        self.checkpoint: Any = None
        #: True after a shrink that changed something: the remaining
        #: group blocks are stripped to sequential fits
        self.groups_invalid = False
        #: watchdog-abandoned worker threads (a launched kernel cannot be
        #: interrupted), joined at the end of the sweep
        self.abandoned: list = []

    @staticmethod
    def classify(e: BaseException) -> bool:
        return is_device_loss(e)

    def _shrink_once(self) -> bool:
        if self.shrink_cb is None:
            return False
        try:
            changed = bool(self.shrink_cb())
        except Exception:   # a failing degrade hook must not mask the loss
            changed = False
        if changed:
            self.counters.count("mesh_shrinks")
            self.groups_invalid = True
        return changed

    def _flush_checkpoint(self) -> None:
        ck = self.checkpoint
        if ck is not None:
            try:
                ck.flush()
            except Exception:   # durability is best-effort mid-recovery
                pass

    def on_device_loss(self, unit_index: int, err: BaseException,
                       attempt: int) -> bool:
        """A classified device loss in unit ``unit_index`` on retry
        ``attempt``: True = re-run the unit, False = quarantine it (the
        retry budget is spent)."""
        self.counters.count("device_losses")
        self._flush_checkpoint()
        if attempt >= self.max_unit_retries:
            self.counters.count("quarantined")
            return False
        self._shrink_once()
        self.counters.count("retries")
        return True

    def on_group_device_loss(self, err: BaseException) -> None:
        """A device loss inside a batched grid-group fit: the queue strips
        the group and its members re-run as sequential fits, which counts
        as one retry."""
        self.counters.count("device_losses")
        self._flush_checkpoint()
        self._shrink_once()
        self.counters.count("retries")

    def on_watchdog_timeout(self, unit_index: int, attempt: int) -> bool:
        """Unit ``unit_index`` passed its deadline: True = degraded re-run
        (the deadline doubles an attempt), False = quarantine."""
        self.counters.count("watchdog_fires")
        self._flush_checkpoint()
        if attempt >= self.max_watchdog_retries:
            self.counters.count("quarantined")
            return False
        self._shrink_once()
        self.counters.count("retries")
        return True

    def drain(self, per_thread_timeout_s: float = 30.0) -> int:
        """Join the watchdog-abandoned workers (at most
        ``per_thread_timeout_s`` each; one still alive past it is left as
        a daemon).  Returns how many were alive when the drain began."""
        alive = [t for t in self.abandoned if t.is_alive()]
        for t in alive:
            t.join(per_thread_timeout_s)
        self.abandoned = [t for t in self.abandoned if t.is_alive()]
        return len(alive)


def run_with_deadline(fn: Callable[[], Any], deadline_s: float,
                      abandoned: Optional[list] = None) -> Tuple[Any, bool]:
    """Run ``fn`` in a daemon worker and join it for ``deadline_s``.

    Returns ``(value, timed_out)``.  On a timeout the worker runs on (its
    kernels cannot be interrupted), its result is discarded, and the
    thread goes to ``abandoned`` for :meth:`ElasticContext.drain`.  An
    exception of ``fn`` re-raises here, so the caller's device-loss
    routing sees it as without a deadline.  The worker adopts the
    caller's current span (the sweep unit's), so that what it records
    links to it."""
    from ..obs.trace import adopt_span, current_span

    box: Dict[str, Any] = {}
    parent = current_span()

    def work():
        try:
            with adopt_span(parent):
                box["val"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised to caller
            box["err"] = e

    t = threading.Thread(target=work, name="sweep-unit-watchdog",
                         daemon=True)
    t.start()
    t.join(max(float(deadline_s), 1e-3))
    if t.is_alive():
        if abandoned is not None:
            abandoned.append(t)
        return None, True
    if "err" in box:
        raise box["err"]
    return box.get("val"), False
