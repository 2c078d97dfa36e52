"""Deterministic fault injection (counterpart of
``transmogrifai_tpu.utils.faults``): named injection points on the hot
paths that tests arm with a deterministic plan — *this* chunk fails with
an IO error twice, *that* block raises.

Injection points wired in the port (each a single ``fire()`` call, one
global check when no plan is armed):

  ``reader.chunk``    before chunk ``index`` leaves a reader's
                      ``ChunkStream`` (readers/base.py); an ``io_error``
                      here exercises retry and backoff
  ``avro.block``      before Avro container block ``index`` decodes
                      (readers/avro.py ``iter_avro_blocks``)
  ``event.window``    before each finalized key-window chunk leaves the
                      streamed event fold (readers/events.py); ``index``
                      is the output chunk ordinal
  ``join.chunk``      before each streamed sort-merge join chunk
                      (readers/events.py ``stream_join``)
  ``unit.slow``       at the top of every sweep-unit attempt
  ``device.loss``     the same, and for each member of a grid-group
                      block (selector/validators.py; ``index`` is the
                      unit's queue index)
  ``sweep.checkpoint`` after each durable save of the sweep cursor
                      (workflow/checkpoint.py; ``index`` is the save
                      ordinal)
  ``checkpoint.barrier`` after each durable save of a chunked train's
                      checkpoint (workflow/checkpoint.py; ``index`` is
                      the save ordinal); the kill-and-resume tests kill
                      the process here
  ``stage.transform`` before every stage transform (stages/base.py;
                      ``tag`` is the stage's class name)
  ``rff.pass``        before each RawFeatureFilter profile pass of a
                      chunked train (index 0 ``train``, 1 ``score``)
  ``drift.window``    at each drift-window evaluation (serving/drift.py;
                      ``index`` is the windows evaluated before it)
  ``cv.fold``         as each streaming workflow-CV fold context builds
                      its matrices (workflow/streaming_cv.py; ``index``
                      is the context's ordinal)

The JAX package's other points (serving, pods) wait for the features
that own them (ROADMAP Queue A items 6.6 and 6.7).

Actions: ``io_error`` (raise OSError, the transient class the reader
retry policy handles), ``raise`` (``FaultError``, non-transient),
``slow`` (sleep ``delay_s``), ``kill`` (SIGKILL this process; subprocess
tests only), ``device_loss`` (raise ``DeviceLossError``), ``skip`` (raise
``FaultSkip``, which a skippable site catches to skip its operation).

Determinism: a spec matches by explicit call index (``at``/``every``) or
by a seeded per-point Bernoulli draw (``p`` + the plan's ``seed``) — the
same plan over the same call sequence fires the same faults.  ``times``
bounds how often a spec fires, so a retried chunk can succeed.  Each
firing is a ``fault.fired`` flight event (``obs/flight.py``) before its
action.

Arming: programmatic (``install_faults`` / the ``inject`` context
manager) or the ``TMOG_FAULTS`` env var (JSON, read at the first
``fire``)::

    TMOG_FAULTS='{"faults": [{"point": "reader.chunk",
                              "action": "io_error", "at": 0}]}'
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["FaultSpec", "FaultPlan", "FaultError", "DeviceLossError",
           "FaultSkip", "install_faults", "clear_faults", "current_plan",
           "inject", "fire", "ENV_VAR"]

ENV_VAR = "TMOG_FAULTS"

#: this process's index in a pod: always 0 here, the port runs one
#: process (pods are ROADMAP Queue A item 6.7), so a spec with
#: ``process=k`` fires only for k == 0
_PROCESS_INDEX = 0

_ACTIONS = ("io_error", "raise", "slow", "kill", "device_loss", "skip")


class FaultError(RuntimeError):
    """Raised by the ``raise`` action (non-transient by design: the retry
    policy must NOT swallow it)."""


class DeviceLossError(RuntimeError):
    """Raised by the ``device_loss`` action — the injected stand-in for a
    card dying mid-program."""


class FaultSkip(Exception):
    """Raised by the ``skip`` action; the injection SITE catches it and
    skips the guarded operation (e.g. one pod process silently skipping
    a barrier).  Deliberately not a RuntimeError so generic handlers
    never swallow it by accident."""


@dataclass
class FaultSpec:
    """One armed fault.

    ``at``: explicit call index (int or list of ints) for the point;
    ``every``: fire on every n-th call; ``p``: seeded Bernoulli per call.
    Exactly one selector should be set; ``at`` wins, then ``every``, then
    ``p``; a bare spec matches every call.  ``tag`` restricts matching to
    fires carrying the same tag (e.g. a stage class name); ``skip``
    passes over the first n otherwise-matching calls (the way to target
    "the 3rd transform of stage X" when the point's call counter is
    global).  ``times`` caps total firings (None = unlimited).

    ``process`` restricts the spec to one pod process; the port runs a
    single process (index 0), so such a spec fires only for 0.
    """

    point: str
    action: str = "io_error"
    at: Optional[Any] = None
    every: Optional[int] = None
    p: Optional[float] = None
    tag: Optional[str] = None
    skip: int = 0
    times: Optional[int] = 1
    delay_s: float = 0.05
    message: str = "injected fault"
    process: Optional[int] = None
    fired: int = field(default=0, compare=False)
    seen: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"expected one of {_ACTIONS}")

    def matches(self, index: int, tag: Optional[str], draw: float) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.tag is not None and tag != self.tag:
            return False
        if self.process is not None and self.process != _PROCESS_INDEX:
            return False
        if self.at is not None:
            ats = self.at if isinstance(self.at, (list, tuple)) else [self.at]
            hit = index in ats
        elif self.every is not None:
            hit = self.every > 0 and index % self.every == 0
        elif self.p is not None:
            hit = draw < self.p
        else:
            hit = True  # bare point spec: every matching call
        if not hit:
            return False
        if self.seen < self.skip:
            self.seen += 1
            return False
        return True

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"point": self.point, "action": self.action}
        for k in ("at", "every", "p", "tag", "times", "process"):
            if getattr(self, k) is not None:
                out[k] = getattr(self, k)
        if self.skip:
            out["skip"] = self.skip
        if self.action == "slow":
            out["delay_s"] = self.delay_s
        return out


class FaultPlan:
    """A set of armed FaultSpecs plus the per-point call counters.

    Call counters advance on EVERY fire of a point (hit or miss), so a
    spec's ``at=k`` means "the k-th time execution reaches this point"
    regardless of other specs — deterministic by construction.  The seeded
    RNG stream for ``p`` specs is per point, keyed independent of call
    interleaving across points.
    """

    def __init__(self, faults: List[FaultSpec], seed: int = 0):
        import numpy as np

        self.faults = list(faults)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._rngs: Dict[str, Any] = {}
        self._np = np
        self.log: List[Dict[str, Any]] = []  # fired faults, for assertions

    @classmethod
    def from_json(cls, doc: Any) -> "FaultPlan":
        if isinstance(doc, str):
            doc = json.loads(doc)
        if isinstance(doc, list):
            doc = {"faults": doc}
        specs = [FaultSpec(**f) for f in doc.get("faults", [])]
        return cls(specs, seed=doc.get("seed", 0))

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "faults": [f.to_json() for f in self.faults]}

    def _draw(self, point: str) -> float:
        rng = self._rngs.get(point)
        if rng is None:
            # stable per-point stream: plan seed + point-name hash
            h = sum(ord(c) * 131 ** i for i, c in enumerate(point)) % (1 << 31)
            rng = self._rngs[point] = self._np.random.default_rng(
                self.seed ^ h)
        return float(rng.random())

    def fire(self, point: str, tag: Optional[str] = None,
             index: Optional[int] = None) -> None:
        """``index`` overrides the call counter as the match key — sites
        with a natural coordinate (chunk id, block id) pass it so a spec's
        ``at=k`` means "the k-th CHUNK" even when retries replay calls."""
        with self._lock:
            calls = self._calls.get(point, 0)
            self._calls[point] = calls + 1
            if index is None:
                index = calls
            draw = self._draw(point)
            hit: Optional[FaultSpec] = None
            for spec in self.faults:
                if spec.point == point and spec.matches(index, tag, draw):
                    spec.fired += 1
                    hit = spec
                    break
            if hit is not None:
                self.log.append({"point": point, "index": index, "tag": tag,
                                 "action": hit.action})
        if hit is None:
            return
        from ..obs.flight import record_event

        record_event("fault.fired", point=point, index=index, tag=tag,
                     action=hit.action)
        where = f"{point}[{index}]" + (f" tag={tag}" if tag else "")
        if hit.action == "slow":
            time.sleep(hit.delay_s)
        elif hit.action == "io_error":
            raise OSError(f"{hit.message} ({where})")
        elif hit.action == "raise":
            raise FaultError(f"{hit.message} ({where})")
        elif hit.action == "device_loss":
            raise DeviceLossError(
                f"injected device loss: CUDA error: device unavailable "
                f"({where})")
        elif hit.action == "skip":
            raise FaultSkip(f"{hit.message} ({where})")
        elif hit.action == "kill":  # pragma: no cover - dies before report
            os.kill(os.getpid(), signal.SIGKILL)

    def calls(self, point: str) -> int:
        with self._lock:
            return self._calls.get(point, 0)


#: sentinel: "not yet initialized from the environment"
_UNSET = object()
_plan: Any = _UNSET
_plan_lock = threading.Lock()


def install_faults(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Arm ``plan`` process-wide (None disarms); returns the plan."""
    global _plan
    with _plan_lock:
        _plan = plan
    return plan


def clear_faults() -> None:
    install_faults(None)


def current_plan() -> Optional[FaultPlan]:
    """The armed plan; first call resolves the ``TMOG_FAULTS`` env var."""
    global _plan
    if _plan is _UNSET:
        with _plan_lock:
            if _plan is _UNSET:
                raw = os.environ.get(ENV_VAR)
                _plan = FaultPlan.from_json(raw) if raw else None
    return _plan


@contextlib.contextmanager
def inject(*specs: FaultSpec, seed: int = 0):
    """Arm a plan for the enclosed block (tests); restores the previous
    plan (including the not-yet-loaded env state) on exit."""
    global _plan
    with _plan_lock:
        prev = _plan
    plan = FaultPlan(list(specs), seed=seed)
    install_faults(plan)
    try:
        yield plan
    finally:
        with _plan_lock:
            _plan = prev


def fire(point: str, tag: Optional[str] = None,
         index: Optional[int] = None) -> None:
    """Injection-site hook — a single global check when nothing is armed."""
    plan = current_plan()
    if plan is not None:
        plan.fire(point, tag=tag, index=index)
