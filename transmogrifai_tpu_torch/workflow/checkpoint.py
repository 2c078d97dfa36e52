"""Mid-sweep checkpoint and resume of the model selector (counterpart of
the sweep half of ``transmogrifai_tpu.workflow.checkpoint``).

The durable unit is a finished sweep unit's fold metrics (host floats)
and, for successive halving, the rung state.  ``sweep.json`` in the
checkpoint directory holds the format version, the sweep's fingerprint
and the records; every save goes through ``write_json_atomic`` (a temp
file, then ``os.replace``), so a kill at any byte leaves the previous
cursor whole.  The ``sweep.checkpoint`` fault point fires after each
save; the kill-and-resume tests kill the process there.

A resume compares only the fingerprint's ``logical`` half (candidates,
validator, metric, strategy, rows); a mismatch raises
:class:`CheckpointMismatchError` with the differing keys.  The ``mesh``
half is advisory and is None on one card.

The streaming train's checkpoints (``StreamingCheckpointManager``, the
block stripes and the fit-state codec) are ROADMAP Queue A item 6.5.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ..utils import faults
from ..utils.jsonio import write_json_atomic

__all__ = ["CheckpointMismatchError", "fingerprint_diff",
           "logical_fingerprint", "mesh_record", "sweep_fingerprint",
           "SweepCheckpointManager", "SWEEP_CHECKPOINT_JSON"]

SWEEP_CHECKPOINT_JSON = "sweep.json"
#: v2: the fingerprint in a compared ``logical`` half and an advisory
#: ``mesh`` record (the JAX package's format)
SWEEP_CHECKPOINT_VERSION = 2


class CheckpointMismatchError(RuntimeError):
    """The checkpoint directory holds a checkpoint of a different run.
    Refusing to resume beats blending two runs; point the checkpoint
    elsewhere or clear it."""


def fingerprint_diff(saved: Any, current: Any, path: str = "",
                     limit: int = 12) -> List[str]:
    """Key-level diff of two fingerprint documents: ``"path: saved=X
    current=Y"`` lines, truncated after ``limit``."""
    out: List[str] = []

    def walk(a: Any, b: Any, where: str) -> None:
        if len(out) >= limit:
            return
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b)):
                walk(a.get(k, "<absent>"), b.get(k, "<absent>"),
                     f"{where}.{k}" if where else str(k))
            return
        if isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                out.append(f"{where}: saved has {len(a)} item(s), "
                           f"current has {len(b)}")
                return
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
            return
        if a != b:
            out.append(f"{where}: saved={json.dumps(a, default=str)} "
                       f"current={json.dumps(b, default=str)}")

    walk(saved, current, path)
    if len(out) >= limit:
        out.append("... (diff truncated)")
    return out


def _mismatch_message(what: str, directory: str, saved: Any,
                      current: Any, hint: str) -> str:
    lines = fingerprint_diff(saved, current) or ["<no key-level diff>"]
    return (f"{what} in {directory!r} belongs to a different run; {hint}.\n"
            f"  differing keys:\n    " + "\n    ".join(lines))


def logical_fingerprint(fp: Any) -> Any:
    """The compared part of a fingerprint: everything but its
    ``advisory`` section."""
    if isinstance(fp, dict):
        return {k: v for k, v in fp.items() if k != "advisory"}
    return fp


def mesh_record(mesh) -> Optional[Dict[str, Any]]:
    """The advisory record of the mesh a sweep ran on (None on one
    card, where there is no mesh)."""
    if mesh is None:
        return None
    shape = {name: int(mesh.shape[name]) for name in mesh.axis_names}
    n = 1
    for v in shape.values():
        n *= v
    return {"shape": shape, "devices": n}


def sweep_fingerprint(candidates, metric_name: str, validator_desc: str,
                      mesh=None, strategy: str = "full",
                      n_rows: int = 0) -> Dict[str, Any]:
    """The identity of one selector sweep: ``logical`` (the candidates'
    names and params in order, the validator, the metric, the strategy,
    the rows), compared on resume, and ``mesh``, advisory."""
    return {
        "logical": {
            "candidates": [[str(c[0]), json.dumps(c[1], sort_keys=True,
                                                  default=str)]
                           for c in candidates],
            "metric": metric_name,
            "validator": validator_desc,
            "strategy": strategy,
            "nRows": int(n_rows),
        },
        "mesh": mesh_record(mesh),
    }


class SweepCheckpointManager:
    """The mid-sweep cursor of one selector sweep.

    ``record_unit`` keeps a finished unit's fold metrics and saves every
    ``every_units`` records; ``save_rung_state`` saves at every halving
    rung boundary.  ``scoped(tag)`` is a view that namespaces unit
    indices (each halving rung runs a fresh queue, whose local indices
    would collide across rungs)."""

    def __init__(self, directory: str, fingerprint: Dict[str, Any],
                 every_units: int = 1):
        if every_units < 1:
            raise ValueError("sweep checkpoint every_units must be >= 1")
        self.directory = directory
        self.fingerprint = fingerprint
        self.every_units = int(every_units)
        self.saves = 0
        self._units: Dict[str, Dict[str, Any]] = {}
        self._rung: Optional[Dict[str, Any]] = None
        self._dirty = 0
        #: the advisory mesh record the loaded checkpoint was saved under
        self.resumed_mesh: Optional[Dict[str, Any]] = None
        self.mesh_changed = False
        os.makedirs(directory, exist_ok=True)

    def load(self) -> bool:
        """Prime the cursor from disk; True when a checkpoint was found.
        A logical mismatch raises :class:`CheckpointMismatchError`."""
        path = os.path.join(self.directory, SWEEP_CHECKPOINT_JSON)
        if not os.path.exists(path):
            return False
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != SWEEP_CHECKPOINT_VERSION:
            raise CheckpointMismatchError(
                f"sweep checkpoint format v{doc.get('version')} != "
                f"v{SWEEP_CHECKPOINT_VERSION}")
        saved = doc.get("fingerprint") or {}
        if saved.get("logical") != self.fingerprint.get("logical"):
            raise CheckpointMismatchError(_mismatch_message(
                "sweep checkpoint", self.directory,
                saved.get("logical"), self.fingerprint.get("logical"),
                "the LOGICAL sweep identity (candidates/validator/metric/"
                "strategy) changed — clear the directory or point the "
                "checkpoint elsewhere"))
        self.resumed_mesh = saved.get("mesh")
        self.mesh_changed = saved.get("mesh") != self.fingerprint.get("mesh")
        self._units = dict(doc.get("units", {}))
        self._rung = doc.get("rung")
        return True

    def restore(self, index: int, tag: str = ""):
        rec = self._units.get(f"{tag}{index}")
        if rec is None:
            return None
        return list(rec.get("foldValues", [])), rec.get("error")

    def record_unit(self, index: int, fold_vals, error: Optional[str],
                    tag: str = "") -> None:
        self._units[f"{tag}{index}"] = {
            "foldValues": [float(v) for v in fold_vals],
            "error": error}
        self._dirty += 1
        if self._dirty >= self.every_units:
            self._write()

    @property
    def restored_units(self) -> int:
        """Unit records held (after ``load``: those found on disk)."""
        return len(self._units)

    def rung_state(self) -> Optional[Dict[str, Any]]:
        return self._rung

    def save_rung_state(self, state: Dict[str, Any]) -> None:
        self._rung = state
        self._write()

    def export_doc(self) -> Dict[str, Any]:
        """The document exactly as ``_write`` persists it."""
        return {"version": SWEEP_CHECKPOINT_VERSION,
                "fingerprint": self.fingerprint,
                "units": self._units,
                "rung": self._rung}

    def _write(self) -> None:
        write_json_atomic(
            os.path.join(self.directory, SWEEP_CHECKPOINT_JSON),
            self.export_doc())
        self._dirty = 0
        self.saves += 1
        faults.fire("sweep.checkpoint", index=self.saves - 1)

    def flush(self) -> None:
        if self._dirty:
            self._write()

    def scoped(self, tag: str) -> "_ScopedSweepCheckpoint":
        return _ScopedSweepCheckpoint(self, f"{tag}:")

    def finish(self) -> None:
        """The sweep completed: remove the cursor, so that a later sweep
        in the same directory starts afresh."""
        try:
            os.unlink(os.path.join(self.directory, SWEEP_CHECKPOINT_JSON))
        except OSError:
            pass


class _ScopedSweepCheckpoint:
    """A namespaced view of a SweepCheckpointManager (a rung's cursor)."""

    def __init__(self, manager: SweepCheckpointManager, tag: str):
        self._m = manager
        self._tag = tag

    def restore(self, index: int):
        return self._m.restore(index, tag=self._tag)

    def record_unit(self, index: int, fold_vals,
                    error: Optional[str]) -> None:
        self._m.record_unit(index, fold_vals, error, tag=self._tag)

    def flush(self) -> None:
        self._m.flush()
