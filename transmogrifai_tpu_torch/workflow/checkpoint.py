"""Checkpoint and resume (counterpart of
``transmogrifai_tpu.workflow.checkpoint``): the chunked train's passes
and the model selector's sweep.

**The chunked train** (``StreamingCheckpointManager``, behind
``OpWorkflow.train(chunk_rows=k, checkpoint_dir=d)``).  The streaming fit
states are mergeable, so a pass's whole progress is {each estimator's
state, the chunks consumed}.  ``d`` holds::

  checkpoint.json   the format version, the run's fingerprint, the
                    completed passes (their fitted models as persistence
                    stage records) and the pass in flight (its cursor and
                    encoded states)
  state-<seq>.npz   every array of the document, as persistence's
                    arrays.npz keeps them

Each save writes a new ``state-<seq>.npz``, then the manifest through
``write_json_atomic`` (a temp file, then ``os.replace``); the older npz
generations go only after the rename lands, so a kill at any byte leaves
the previous checkpoint whole.  The ``checkpoint.barrier`` fault point
fires after each save; the kill-and-resume tests kill the process there.

What resumes where: the fit passes before the fused one save every
``every_chunks`` chunks, and a resume restores their states exactly and
skips the chunks already folded (read, not transformed); a completed
pass persists its models, and a resume adopts them
(``adopt_restored_model``) and never reads that pass again; the fused
fit-and-materialize pass writes full-length buffers and is not
checkpointed, so a crash there resumes from the pass boundary.

The state codec (``encode_fit_state``/``decode_fit_state``): arrays go to
the npz store, a tensor as its host array (decoded back onto the
estimator's device), the sketches through their ``to_state``/
``from_state`` hooks, a numpy generator by its bit generator's state
(the checker's sampled rows continue, they do not restart), dicts with
other than string keys as ordered item lists.

A streaming workflow-CV train's fold-tagged states
(``workflow/streaming_cv.py``) go through the same codec as a dict
marked ``__fold_tagged__`` with the ``full`` state and a state a fold;
its fold-tagged passes also keep their final states with their models
(``complete_pass(state_payloads=)``), so that a kill after such a pass
still resumes the fold validation.

The fingerprint (``compute_fingerprint``) is the reader (path, size and
mtime, or an in-memory source's shape), ``chunk_rows``, the raw features
and the DAG's stages, extended by the workflow CV's fold geometry
(``StreamingCVContext.fingerprint``: ``cv``) and a refresh's base model
(``RefreshContext.base_digest``: ``refresh``); a checkpoint of another
run raises :class:`CheckpointMismatchError` naming the keys that differ,
so a CV or refresh checkpoint never resumes into a plain train.  Success
removes the checkpoint (``finish``).

**The selector's sweep** (``SweepCheckpointManager``): the durable unit is
a finished sweep unit's fold metrics (host floats) and, for successive
halving, the rung state, in ``sweep.json``, saved the same atomic way.
The ``sweep.checkpoint`` fault point fires after each save.  A resume
compares only the fingerprint's ``logical`` half (candidates, validator,
metric, strategy, rows); the ``mesh`` half is advisory and None on one
card.

Not ported: the pod block plane's ``BlockStripeStore`` and the
manifest's pod record (ROADMAP Queue A item 6.7).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stages.base import Estimator, Model, PipelineStage
from ..utils import faults
from ..utils.jsonio import write_json_atomic
from .persistence import _ArrayStore, _load_stage, _stage_record

__all__ = ["CheckpointMismatchError", "fingerprint_diff",
           "logical_fingerprint", "mesh_record", "sweep_fingerprint",
           "SweepCheckpointManager", "SWEEP_CHECKPOINT_JSON",
           "StreamingCheckpointManager", "ResumeState",
           "compute_fingerprint", "encode_fit_state", "decode_fit_state",
           "adopt_restored_model", "CHECKPOINT_JSON", "CHECKPOINT_VERSION"]

CHECKPOINT_JSON = "checkpoint.json"
CHECKPOINT_VERSION = 1
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
        """The sweep completed: remove the cursor (and the directory,
        where nothing else is left in it), so that a later sweep there
        starts afresh."""
        try:
            os.unlink(os.path.join(self.directory, SWEEP_CHECKPOINT_JSON))
        except OSError:
            pass
        _remove_if_empty(self.directory)


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


# ---------------------------------------------------------------------------
# the streaming-fit state codec
# ---------------------------------------------------------------------------

def _stateful_types() -> Dict[str, type]:
    """The classes with ``to_state``/``from_state`` hooks, by name."""
    from ..ops.vectorizers import TextStats
    from ..utils.sketches import PearsonSketch, TopKSketch, WelfordMoments
    from ..utils.streaming_histogram import StreamingHistogram

    return {"WelfordMoments": WelfordMoments, "PearsonSketch": PearsonSketch,
            "TopKSketch": TopKSketch, "TextStats": TextStats,
            "StreamingHistogram": StreamingHistogram}


def encode_fit_state(value: Any, key: str, store: _ArrayStore) -> Any:
    """A streaming-fit state as JSON, its arrays put in ``store`` (an
    exact round trip: the resume is held to the uninterrupted fit)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return store.put(key, value)
    if isinstance(value, torch.Tensor):
        return {"__tensor__": store.put(key, value.detach().cpu().numpy())}
    types = _stateful_types()
    name = type(value).__name__
    if name in types and isinstance(value, types[name]):
        return {"__state__": name,
                "payload": encode_fit_state(value.to_state(),
                                            f"{key}.{name}", store)}
    if isinstance(value, np.random.Generator):
        return {"__rng__": {"bg": type(value.bit_generator).__name__,
                            "state": value.bit_generator.state}}
    from ..ops.vector_metadata import VectorMetadata

    if isinstance(value, VectorMetadata):
        return {"__vmeta__": value.to_json()}
    if isinstance(value, dict):
        if all(isinstance(k, str) for k in value):
            return {k: encode_fit_state(v, f"{key}.{k}", store)
                    for k, v in value.items()}
        return {"__items__": [
            [encode_fit_state(k, f"{key}.k{i}", store),
             encode_fit_state(v, f"{key}.v{i}", store)]
            for i, (k, v) in enumerate(value.items())]}
    if isinstance(value, (list, tuple)):
        return [encode_fit_state(v, f"{key}[{i}]", store)
                for i, v in enumerate(value)]
    raise TypeError(
        f"streaming-fit state at {key!r} holds a {type(value).__name__}, "
        f"which the checkpoint codec cannot persist; give the estimator "
        f"export_fit_state/import_fit_state hooks (stages/base.py) or the "
        f"type to_state/from_state")


def decode_fit_state(value: Any, arrays, device=None) -> Any:
    """The inverse of ``encode_fit_state``; tensors land on ``device``
    (resolved by ``device.py``'s rule)."""
    if isinstance(value, dict):
        if "__state__" in value:
            cls = _stateful_types()[value["__state__"]]
            return cls.from_state(decode_fit_state(value["payload"], arrays,
                                                   device))
        if "__rng__" in value:
            spec = value["__rng__"]
            bg = getattr(np.random, spec["bg"])()
            bg.state = spec["state"]
            return np.random.Generator(bg)
        if "__tensor__" in value:
            arr = np.array(arrays[value["__tensor__"]["__array__"]])
            return torch.from_numpy(arr).to(resolve_device(device))
        if "__vmeta__" in value:
            from ..ops.vector_metadata import VectorMetadata

            return VectorMetadata.from_json(value["__vmeta__"])
        if "__array__" in value:
            return arrays[value["__array__"]]
        if "__items__" in value:
            return {decode_fit_state(k, arrays, device):
                    decode_fit_state(v, arrays, device)
                    for k, v in value["__items__"]}
        return {k: decode_fit_state(v, arrays, device)
                for k, v in value.items()}
    if isinstance(value, list):
        return [decode_fit_state(v, arrays, device) for v in value]
    return value


# ---------------------------------------------------------------------------
# the run's fingerprint
# ---------------------------------------------------------------------------

def _describe_reader(reader) -> Dict[str, Any]:
    """A reader's identity: a file's path, size and mtime (CSV, JSON
    lines, Avro, Parquet), an in-memory source's shape, an event reader's
    cutoff and windows with its source's identity."""
    out: Dict[str, Any] = {"class": type(reader).__name__}
    if hasattr(reader, "key_fn") and hasattr(reader, "cutoff"):
        cutoff = reader.cutoff
        out["event"] = {
            "cutoffKind": getattr(cutoff, "kind", None),
            "cutoffMs": getattr(cutoff, "time_ms", None),
            "predictorWindowMs": reader.predictor_window_ms,
            "responseWindowMs": reader.response_window_ms,
            "conditional": getattr(reader, "target_condition",
                                   None) is not None,
        }
        source = getattr(reader, "source", None)
        if source is not None:
            from ..readers.base import Reader

            if isinstance(source, Reader):
                out["source"] = _describe_reader(source)
            elif hasattr(source, "to_dict") and hasattr(source, "columns"):
                out["source"] = {"rows": int(len(source)),
                                 "columns": [str(c) for c in source.columns]}
            elif isinstance(source, (list, tuple)):
                out["source"] = {"rows": len(source)}
        return out
    for attr in ("path", "csv_path"):
        path = getattr(reader, attr, None)
        if isinstance(path, str):
            out["path"] = path
            try:
                st = os.stat(path)
                out["size"] = st.st_size
                out["mtime"] = int(st.st_mtime)
            except OSError:
                pass
            return out
    df = getattr(reader, "df", None)
    if df is not None:
        out["rows"] = int(len(df))
        out["columns"] = [str(c) for c in df.columns]
    ds = getattr(reader, "ds", None)
    if ds is not None:
        out["rows"] = len(ds)
        out["columns"] = list(ds.names())
    recs = getattr(reader, "records", None)
    if isinstance(recs, list):
        out["rows"] = len(recs)
    return out


def compute_fingerprint(reader, raw_features, layers,
                        chunk_rows: int) -> Dict[str, Any]:
    """The identity of a chunked train: the same reader bytes, chunk
    geometry and DAG give the same passes, chunks and states, so one
    run's checkpoint is exact for the other."""
    return {
        "chunkRows": int(chunk_rows),
        "reader": _describe_reader(reader),
        "rawFeatures": sorted(f.name for f in raw_features),
        "stages": [f"{s.uid}:{type(s).__name__}:{s.get_output().name}"
                   for layer in layers for s in layer],
    }


# ---------------------------------------------------------------------------
# resume state and the manager
# ---------------------------------------------------------------------------

class ResumeState:
    """A loaded checkpoint, for the streaming fit: ``completed`` maps a
    pass index to {"rows", "label", "models": {uid: model}, "states":
    {uid: decoded final state payload}} (states only for fold-tagged
    passes);
    ``current`` is the pass in flight ({"pass", "label", "chunks_done",
    "rows_done", "states": {uid: encoded state}}) or None."""

    def __init__(self):
        self.completed: Dict[int, Dict[str, Any]] = {}
        self.current: Optional[Dict[str, Any]] = None
        self._arrays: Dict[str, np.ndarray] = {}

    def states_for(self, ests: List[Estimator]) -> Dict[str, Any]:
        """The pass in flight's states for ``ests``, each through its
        estimator's ``import_fit_state``, tensors on its device."""
        raw = (self.current or {}).get("states", {})
        out = {}
        for est in ests:
            if est.uid not in raw:
                raise CheckpointMismatchError(
                    f"checkpoint mid-pass state is missing estimator "
                    f"{est.uid}")
            out[est.uid] = est.import_fit_state(decode_fit_state(
                raw[est.uid], self._arrays, getattr(est, "device", None)))
        return out


class StreamingCheckpointManager:
    """The checkpoint directory of one chunked train.

    ``save_progress`` persists the pass in flight (its cursor and states),
    ``complete_pass`` a finished pass's models (and clears the pass in
    flight), ``finish`` removes the checkpoint once the train succeeded.
    ``saves`` counts the saves that landed."""

    def __init__(self, directory: str, fingerprint: Dict[str, Any],
                 every_chunks: int = 16):
        if every_chunks < 1:
            raise ValueError("checkpoint every_chunks must be >= 1")
        self.directory = directory
        self.fingerprint = fingerprint
        self.every_chunks = int(every_chunks)
        self.saves = 0
        self._seq = 0
        self._completed: Dict[int, Dict[str, Any]] = {}
        self._current: Optional[Dict[str, Any]] = None
        os.makedirs(directory, exist_ok=True)

    def load(self, device=None) -> Optional[ResumeState]:
        """The previous run's checkpoint, or None in a fresh directory; the
        restored models' tensors land on ``device``, and the restored
        passes ride on this manager's later saves."""
        path = os.path.join(self.directory, CHECKPOINT_JSON)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != CHECKPOINT_VERSION:
            raise CheckpointMismatchError(
                f"checkpoint format v{doc.get('version')} != "
                f"v{CHECKPOINT_VERSION}")
        saved_fp = doc.get("fingerprint")
        if logical_fingerprint(saved_fp) != logical_fingerprint(
                self.fingerprint):
            raise CheckpointMismatchError(_mismatch_message(
                "checkpoint", self.directory, logical_fingerprint(saved_fp),
                logical_fingerprint(self.fingerprint),
                "clear the directory or point checkpoint_dir elsewhere"))
        arrays: Dict[str, np.ndarray] = {}
        if doc.get("arrays"):
            with np.load(os.path.join(self.directory, doc["arrays"]),
                         allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        state = ResumeState()
        state._arrays = arrays
        dev = resolve_device(device)
        for rec in doc.get("completedPasses", []):
            models = {uid: _load_stage(srec, arrays, dev)
                      for uid, srec in rec["models"].items()}
            # final states (the fold-tagged passes'), decoded live: they
            # ride the later saves as the models do
            payloads = {uid: decode_fit_state(p, arrays, dev)
                        for uid, p in (rec.get("states") or {}).items()}
            pi = int(rec["pass"])
            state.completed[pi] = {"rows": int(rec["rows"]),
                                   "label": rec.get("label"),
                                   "models": models, "states": payloads}
            self._completed[pi] = {"pass": pi, "rows": int(rec["rows"]),
                                   "label": rec.get("label"),
                                   "live_models": models,
                                   "live_payloads": payloads}
        state.current = doc.get("current")
        self._seq = int(doc.get("seq", 0))
        return state

    def _write(self) -> None:
        """Encode the manifest and its arrays and land them atomically."""
        self._seq += 1
        store = _ArrayStore()
        doc: Dict[str, Any] = {
            "version": CHECKPOINT_VERSION,
            "fingerprint": self.fingerprint,
            "seq": self._seq,
            "completedPasses": [],
            "current": None,
        }
        for pi, rec in sorted(self._completed.items()):
            entry = {"pass": pi, "rows": rec["rows"],
                     "label": rec.get("label"),
                     "models": {uid: _stage_record(m, store)
                                for uid, m in rec["live_models"].items()}}
            if rec.get("live_payloads"):
                entry["states"] = {
                    uid: encode_fit_state(p, f"done{pi}.{uid}", store)
                    for uid, p in rec["live_payloads"].items()}
            doc["completedPasses"].append(entry)
        if self._current is not None:
            cur = dict(self._current)
            cur["states"] = {
                uid: encode_fit_state(payload, f"cur.{uid}", store)
                for uid, payload in cur.pop("live_states").items()}
            doc["current"] = cur
        npz_name = f"state-{self._seq}.npz"
        old = [n for n in sorted(os.listdir(self.directory))
               if n.startswith("state-") and n.endswith(".npz")]
        if store.arrays:
            np.savez(os.path.join(self.directory, npz_name), **store.arrays)
            doc["arrays"] = npz_name
        write_json_atomic(os.path.join(self.directory, CHECKPOINT_JSON), doc,
                          indent=None)
        for n in old:   # the older generations, only after the rename
            if n != npz_name:
                try:
                    os.unlink(os.path.join(self.directory, n))
                except OSError:
                    pass
        self.saves += 1
        faults.fire("checkpoint.barrier", index=self.saves - 1)

    def save_progress(self, pass_index: int, label: str, chunks_done: int,
                      rows_done: int, ests: List[Estimator],
                      states: Dict[str, Any]) -> None:
        """Persist the pass in flight: its cursor and each estimator's
        state through its ``export_fit_state``."""
        self._current = {
            "pass": int(pass_index), "label": label,
            "chunks_done": int(chunks_done), "rows_done": int(rows_done),
            "live_states": {est.uid: est.export_fit_state(states[est.uid])
                            for est in ests}}
        self._write()

    def complete_pass(self, pass_index: int, label: str, rows: int,
                      models: Dict[str, Model],
                      state_payloads: Optional[Dict[str, Any]] = None
                      ) -> None:
        """Persist a finished pass's fitted models; the pass in flight is
        cleared (its cursor means nothing once the pass is done).
        ``state_payloads`` (uid -> ``export_fit_state`` payload) keeps the
        final states still needed after the pass: the fold-tagged ones,
        whose fold states the CV validation reads."""
        self._completed[int(pass_index)] = {
            "pass": int(pass_index), "label": label, "rows": int(rows),
            "live_models": models,
            "live_payloads": dict(state_payloads or {})}
        self._current = None
        self._write()

    def finish(self) -> None:
        """The train succeeded: remove the checkpoint (and the directory,
        where nothing else is left in it), so that a later run there
        starts afresh."""
        for n in os.listdir(self.directory):
            if n in (CHECKPOINT_JSON, CHECKPOINT_JSON + ".tmp") or (
                    n.startswith("state-") and n.endswith(".npz")):
                try:
                    os.unlink(os.path.join(self.directory, n))
                except OSError:
                    pass
        _remove_if_empty(self.directory)


def _remove_if_empty(directory: str) -> None:
    try:
        os.rmdir(directory)
    except OSError:     # not empty, or gone
        pass


def adopt_restored_model(est: Estimator, model: PipelineStage) -> Model:
    """Wire a model restored from a checkpoint to answer for ``est``:
    ``adopt_model``'s wiring, with the restored model's fitted metadata
    kept (the estimator never ran in this process)."""
    model.uid = est.uid
    model.operation_name = est.operation_name
    model.input_features = list(est.input_features)
    model._output_feature = est._output_feature
    est.metadata = model.metadata
    return model
