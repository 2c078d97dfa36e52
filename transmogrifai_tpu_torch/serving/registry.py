"""Model registry — versioned, hot-swappable saved workflow models
(counterpart of ``transmogrifai_tpu.serving.registry``).

Loads models through ``workflow/persistence.py`` onto a device, builds the
score function once per load, and a second one on a CPU copy of the model
for the server's host rung (``ModelEntry.host_scorer``: the saved
directory loaded again onto the CPU, or an in-memory model through a save
and load round trip; the model itself when it is on the CPU already), and
exposes an atomic get/swap surface:
scoring threads resolve a ``ModelEntry`` by name and keep that immutable
entry for the whole batch while a newer version is swapped in.  A bounded
generation history per name backs ``pin`` and ``rollback``; eviction
never drops the pinned generation or the current one.  The registry lock
is a leaf: listeners fire after it is released, and entries are built
before it is taken.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

__all__ = ["ModelEntry", "ModelRegistry"]


class ModelEntry:
    """One immutable (name, version) of a servable model: its scorer on
    the model's device and ``host_scorer``, the host rung's scorer on a
    CPU copy built here, so that a device fault is answered without a
    disk read (``host_load_s`` is what the copy took).  A model already
    on the CPU is its own copy.  A model that cannot make the save and
    load round trip (a callable the save would stub, a stage class with
    no persistence row) gets no copy: ``host_scorer`` is None,
    ``host_unavailable`` says why, and its device errors fail the batch."""

    def __init__(self, name: str, version: int, model: Any,
                 path: Optional[str] = None, device: DeviceLike = None):
        from ..local.scorer import score_function_batch

        self.name = name
        self.version = version
        self.model = model
        self.path = path
        self.loaded_at = time.time()
        #: rows -> score maps, built once per entry
        self.scorer = score_function_batch(model)
        t0 = time.perf_counter()
        host, self.host_unavailable = _cpu_copy(model, path, device)
        #: the same on the CPU copy: the host rung of the degradation ladder
        self.host_scorer = (self.scorer if host is model
                            else None if host is None
                            else score_function_batch(host))
        self.host_load_s = time.perf_counter() - t0
        if self.host_unavailable is not None:
            warnings.warn(f"{name} v{version} has no host rung: "
                          f"{self.host_unavailable}", stacklevel=3)
        self.result_features = [f.name for f in model.result_features]

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "version": self.version,
                "path": self.path, "loadedAt": self.loaded_at,
                "resultFeatures": list(self.result_features)}

    def __repr__(self):
        return f"ModelEntry({self.name!r} v{self.version})"


def _on_cpu(model: Any, device: DeviceLike) -> bool:
    """Every stage of ``model`` places its work, and holds its tensors, on
    the CPU (a stage with no device of its own runs on ``device``, else
    the default device)."""
    for stage in model.stages:
        try:
            dev = resolve_device(getattr(stage, "device", None) or device)
        except RuntimeError:   # no card and no request: not the CPU
            return False
        if dev.type != "cpu" or any(
                isinstance(v, torch.Tensor) and v.device.type != "cpu"
                for v in vars(stage).values()):
            return False
    return True


def _cpu_copy(model: Any, path: Optional[str], device: DeviceLike
              ) -> Tuple[Any, Optional[str]]:
    """(the model on the CPU, None), or (None, why there is no copy): the
    model itself when it is already there, else loaded from its saved
    directory or, for an in-memory model, through a save and load round
    trip, which a model that would not come back whole does not take."""
    from ..workflow.persistence import load_workflow_model, round_trip_problem

    if _on_cpu(model, device):
        return model, None
    if path is not None:
        return load_workflow_model(path, device="cpu"), None
    problem = round_trip_problem(model)
    if problem is not None:
        return None, problem
    with tempfile.TemporaryDirectory(prefix="tmog_host_") as tmp:
        saved = os.path.join(tmp, "model")
        try:
            model.save(saved)
        except NotImplementedError as exc:   # a nested stage with no row
            return None, str(exc)
        return load_workflow_model(saved, device="cpu"), None


class ModelRegistry:
    """Thread-safe name -> ModelEntry map with versioned atomic swaps and
    ``max_generations`` retained generations per name."""

    def __init__(self, max_generations: int = 4):
        if max_generations < 1:
            raise ValueError("max_generations must be >= 1")
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}
        self._versions: Dict[str, int] = {}
        self._swap_listeners: List[Callable[[ModelEntry], None]] = []
        self.max_generations = int(max_generations)
        self._history: Dict[str, Dict[int, ModelEntry]] = {}
        self._pinned: Dict[str, int] = {}

    # -- lifecycle ----------------------------------------------------------

    def load(self, name: str, path: str,
             device: DeviceLike = None) -> ModelEntry:
        """Load (or hot-swap) ``name`` from a saved model directory onto
        ``device`` (else the default device; no card and no request
        raises).  The load happens outside the lock."""
        from ..workflow.persistence import load_workflow_model

        return self.register(name, load_workflow_model(path, device=device),
                             path=path, device=device)

    def register(self, name: str, model: Any, path: Optional[str] = None,
                 device: DeviceLike = None) -> ModelEntry:
        """Register an in-memory model (a freshly trained one, or tests);
        ``device`` is where its stages with no device of their own run."""
        with self._lock:
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
        entry = ModelEntry(name, version, model, path=path, device=device)
        with self._lock:
            current = self._entries.get(name)
            if current is not None and current.version > entry.version:
                return current   # a concurrent newer load won
            swapped = current is not None
            self._entries[name] = entry
            self._history.setdefault(name, {})[entry.version] = entry
            self._evict_generations(name)
            listeners = list(self._swap_listeners)
        if swapped:
            self._fire(listeners, entry)
        return entry

    @staticmethod
    def _fire(listeners, entry: ModelEntry) -> None:
        for fn in listeners:
            try:
                fn(entry)
            except Exception:   # a listener must not break the swap
                pass

    def _evict_generations(self, name: str) -> None:
        """Drop the oldest generations past ``max_generations`` (lock
        held), never the current or the pinned one."""
        hist = self._history.get(name)
        if hist is None:
            return
        current = self._entries.get(name)
        protected = {self._pinned.get(name),
                     current.version if current is not None else None}
        for version in sorted(hist):
            if len(hist) <= self.max_generations:
                break
            if version not in protected:
                del hist[version]

    def evict(self, name: str) -> bool:
        """Drop every generation of ``name``, pin included; in-flight
        batches holding an entry finish unaffected."""
        with self._lock:
            self._history.pop(name, None)
            self._pinned.pop(name, None)
            return self._entries.pop(name, None) is not None

    # -- generations / pinning ----------------------------------------------

    def pin(self, name: str, version: Optional[int] = None) -> ModelEntry:
        """Pin a generation (default: the current one) as last-known-good:
        it survives eviction and is the ``rollback`` target."""
        with self._lock:
            if version is None:
                current = self._entries.get(name)
                if current is None:
                    raise KeyError(f"no model {name!r} to pin")
                version = current.version
            entry = self._history.get(name, {}).get(version)
            if entry is None:
                raise KeyError(f"no generation v{version} of {name!r} in "
                               f"the registry history")
            self._pinned[name] = version
            return entry

    def unpin(self, name: str) -> None:
        with self._lock:
            self._pinned.pop(name, None)
            self._evict_generations(name)

    def pinned(self, name: str) -> Optional[ModelEntry]:
        with self._lock:
            version = self._pinned.get(name)
            return (None if version is None
                    else self._history.get(name, {}).get(version))

    def generations(self, name: str) -> List[Dict[str, Any]]:
        with self._lock:
            hist = list(self._history.get(name, {}).values())
            pinned = self._pinned.get(name)
            current = self._entries.get(name)
        out = []
        for e in hist:
            rec = e.describe()
            rec["pinned"] = e.version == pinned
            rec["current"] = (current is not None
                              and e.version == current.version)
            out.append(rec)
        return out

    def rollback(self, name: str) -> ModelEntry:
        """Reinstate the pinned generation as current (its version id
        kept); swap listeners fire, as for a forward swap."""
        with self._lock:
            version = self._pinned.get(name)
            if version is None:
                raise KeyError(f"no pinned generation for {name!r}")
            entry = self._history[name][version]
            self._entries[name] = entry
            listeners = list(self._swap_listeners)
        self._fire(listeners, entry)
        return entry

    # -- resolution ---------------------------------------------------------

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
            have = sorted(self._entries)
        if entry is None:
            raise KeyError(f"no model {name!r} in registry "
                           f"(have: {have or 'none'})")
        return entry

    def maybe_get(self, name: str) -> Optional[ModelEntry]:
        with self._lock:
            return self._entries.get(name)

    def models(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(self._entries.values())
        return [e.describe() for e in entries]

    def on_swap(self, fn: Callable[[ModelEntry], None]) -> None:
        """Register a hot-swap listener (the server warms the incoming
        version's buckets)."""
        with self._lock:
            self._swap_listeners.append(fn)
