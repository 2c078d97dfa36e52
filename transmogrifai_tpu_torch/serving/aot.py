"""Per-bucket scoring programs with a persisted program store (counterpart
of ``transmogrifai_tpu.serving.aot``).

The JAX package compiles one XLA executable per ``(model, shape bucket)``
and persists it, so that a fresh replica loads its programs instead of
compiling them.  Here a linear predictor's scoring (its
``AOTScoringSpec``: a few torch operations on a ``(bucket, D)`` matrix
and its parameters) becomes one program per bucket:

* **"jit"**: the spec's ``fn`` is captured with ``torch.export`` at the
  bucket's static shape on the model's device (no ``dynamic_shapes``: the
  bucket is the shape) and written through to the ``AOTStore`` as
  ``torch.export.save`` bytes;
* **"aot"**: a later process (a fresh replica) reads the same entry back
  with ``torch.export.load`` instead of exporting;
* **on a CUDA device**, ``ensure_bucket`` then captures one
  ``torch.cuda.CUDAGraph`` of the program per bucket: static input and
  parameter buffers, a warm-up run on a side stream, then the capture.
  ``predict`` copies the batch into the static input, replays the graph
  and clones the static outputs, all under the set's lock, so that the
  dispatch thread and any other caller never see each other's outputs.
  A graph cannot be persisted, so a fresh replica loads the exported
  program and captures again (milliseconds).  A capture or replay error
  raises: it never quietly runs eagerly;
* **on the CPU** (the tests) the exported or loaded module runs eagerly.

Store keys are a digest of the parameters' bytes, the bucket, the backend
(``utils.profiling.backend_name``), torch's and CUDA's versions, the
card's compute capability and the format version, so a changed model or
runtime misses and exports afresh.  Counters (``utils/compile_cache``):
``compile`` for an export, ``aotLoad``/``aotMiss`` for a store lookup;
the bucketed executor counts a ``hit`` for each warm run of a bucket (one
graph replay).  Flight events ``serve.aot_load``, ``serve.aot_miss`` and
``serve.aot_compile`` as in the JAX package.

The programs are opt-in per server (``device_programs=True``) and run only
inside :class:`device_scoring`, which the bucketed executor enters and the
host rung never does, so an open breaker cannot touch them.
"""
from __future__ import annotations

import hashlib
import io
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..obs.flight import record_event
from ..utils import compile_cache
from ..utils.compile_cache import AOT_FORMAT_VERSION, AOTStore

__all__ = ["ScoringProgramSet", "scoring_digest", "model_params_digest",
           "device_scoring", "device_scoring_active", "find_predictor",
           "program_set_for", "AOTStore"]

_tls = threading.local()


class device_scoring:
    """Marks the current thread as the device scoring path:
    ``PredictorModel.transform_columns`` routes through installed programs
    only inside it (the bucketed executor enters it; the host rung and
    offline scoring do not)."""

    def __enter__(self):
        self._prev = getattr(_tls, "active", False)
        _tls.active = True
        return self

    def __exit__(self, *exc):
        _tls.active = self._prev
        return False


def device_scoring_active() -> bool:
    return getattr(_tls, "active", False)


def model_params_digest(spec) -> str:
    """Digest of the program's identity: its family name and each
    parameter's shape, dtype and bytes (the JAX package's recipe, so that
    equal parameters give equal digests in both packages)."""
    h = hashlib.sha256()
    h.update(spec.name.encode())
    for p in spec.params:
        arr = p.detach().cpu().numpy()
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:20]


def _capability(backend: str) -> str:
    if backend == "gpu" and torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        return f"sm_{major}{minor}"
    return "none"


def _runtime(backend: str) -> Dict[str, Any]:
    return {"backend": backend, "torchVersion": torch.__version__,
            "cudaVersion": torch.version.cuda,
            "capability": _capability(backend)}


def scoring_digest(spec, bucket: int, backend: str) -> str:
    """The store key of one ``(model, bucket)`` program."""
    rt = _runtime(backend)
    h = hashlib.sha256()
    h.update(model_params_digest(spec).encode())
    h.update(f"|bucket={bucket}|backend={backend}".encode())
    h.update(f"|torch={rt['torchVersion']}|cuda={rt['cudaVersion']}"
             f"|cc={rt['capability']}".encode())
    h.update(f"|fmt={AOT_FORMAT_VERSION}".encode())
    return f"{spec.name.replace('.', '_')}-b{bucket}-{h.hexdigest()[:24]}"


class _Program(torch.nn.Module):
    """The spec's function as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, X, *params):
        return tuple(self.fn(X, *params))


class _Graph:
    """One bucket's captured graph and its static buffers."""

    __slots__ = ("graph", "x", "outs")

    def __init__(self, graph, x, outs):
        self.graph, self.x, self.outs = graph, x, outs


class ScoringProgramSet:
    """One model's per-bucket scoring programs.

    ``ensure_bucket`` loads a bucket's program from the store ("aot") or
    exports it and writes it through ("jit"), then, on the card, captures
    its graph; ``predict`` runs it for an exact-shape batch (None for a
    shape no program covers).  ``seconds`` holds each bucket's export or
    load and capture seconds, ``replays`` each bucket's warm runs."""

    def __init__(self, model, store: Optional[AOTStore] = None,
                 cache_key_prefix: str = "serving"):
        from ..utils.profiling import backend_name

        spec = model.aot_scoring_spec()
        if spec is None:
            raise ValueError(
                f"{type(model).__name__} has no AOT scoring spec")
        self.model = model
        self.spec = spec
        self.store = store
        self.cache_key_prefix = cache_key_prefix
        self.params = tuple(p.detach().contiguous() for p in spec.params)
        self.device = self.params[0].device
        self.backend = backend_name(self.device)
        self.n_features = (int(spec.n_features)
                           if spec.n_features is not None
                           else int(self.params[0].shape[-1]))
        self._programs: Dict[int, Any] = {}
        self._modes: Dict[int, str] = {}
        self._lock = threading.Lock()
        #: held across one bucket's export or load and capture: a swap's
        #: warm-up and the dispatch thread never build a bucket twice or
        #: capture at once (the capture stream is shared)
        self._build_lock = threading.Lock()
        self.seconds: Dict[int, Dict[str, float]] = {}
        self.replays: Dict[int, int] = {}

    # -- introspection ------------------------------------------------------

    @property
    def buckets(self) -> List[int]:
        with self._lock:
            return sorted(self._programs)

    @property
    def modes(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._modes)

    def cached_in_store(self, bucket: int) -> bool:
        """The store holds a valid entry for this (model, bucket)."""
        if self.store is None:
            return False
        return self.store.contains(
            scoring_digest(self.spec, bucket, self.backend),
            expect=self._expect())

    def _expect(self) -> Dict[str, Any]:
        out = _runtime(self.backend)
        out.update(program=self.spec.name, outputs=list(self.spec.outputs))
        return out

    # -- build / load -------------------------------------------------------

    def ensure_bucket(self, bucket: int, allow_load: bool = True) -> str:
        """Make ``bucket``'s program runnable; returns "aot" (loaded) or
        "jit" (exported).  A corrupted or mismatched store entry reads as
        a miss and is replaced by the write-through; a failed capture
        raises.  Concurrent callers build a bucket once: the others wait
        for it and return its mode."""
        with self._lock:
            mode = self._modes.get(bucket)
            if mode is not None:
                return mode
        with self._build_lock:
            with self._lock:
                mode = self._modes.get(bucket)
            if mode is not None:
                return mode
            return self._build(bucket, allow_load)

    def _build(self, bucket: int, allow_load: bool) -> str:
        key = scoring_digest(self.spec, bucket, self.backend)
        ledger_key = f"{self.cache_key_prefix}.aot.bucket{bucket}"
        module = None
        mode = "jit"
        t0 = time.perf_counter()
        if allow_load and self.store is not None:
            got = self.store.get(key, expect=self._expect())
            if got is not None:
                try:
                    module = torch.export.load(io.BytesIO(got[0])).module()
                    mode = "aot"
                    compile_cache.record_aot_load(ledger_key)
                    record_event("serve.aot_load", key=key, bucket=bucket)
                except Exception:
                    # unreadable here (another runtime): as a corruption
                    self.store.invalidate(key)
                    module = None
            if module is None:
                compile_cache.record_aot_miss(ledger_key)
                record_event("serve.aot_miss", key=key, bucket=bucket)
        if module is None:
            exported = torch.export.export(
                _Program(self.spec.fn), (self._example(bucket),) + self.params)
            compile_cache.record_compile(ledger_key)
            record_event("serve.aot_compile", key=key, bucket=bucket)
            if self.store is not None:
                buf = io.BytesIO()
                torch.export.save(exported, buf)
                try:
                    self.store.put(key, buf.getvalue(), self._expect())
                except OSError:   # the store is an optimisation only
                    pass
            module = exported.module()
        t1 = time.perf_counter()
        program = (self._capture(module, bucket)
                   if self.device.type == "cuda" else module)
        secs = {"export_s" if mode == "jit" else "load_s": t1 - t0,
                "capture_s": time.perf_counter() - t1}
        with self._lock:
            self._programs[bucket] = program
            self._modes[bucket] = mode
            self.seconds[bucket] = secs
            self.replays.setdefault(bucket, 0)
        return mode

    def _example(self, bucket: int) -> torch.Tensor:
        return torch.zeros((bucket, self.n_features), dtype=torch.float32,
                           device=self.device)

    def _capture(self, module, bucket: int) -> _Graph:
        """Warm ``module`` up on a side stream, then capture one graph of
        it over a static input buffer and the set's parameters; a capture
        error raises."""
        x = self._example(bucket)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            module(x, *self.params)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread-local capture: a hot swap captures while the dispatch
        # thread may be scoring the outgoing version on its own stream
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = tuple(module(x, *self.params))
        torch.cuda.synchronize(self.device)
        return _Graph(graph, x, outs)

    # -- execution ----------------------------------------------------------

    def predict(self, X: torch.Tensor):
        """The program's ``PredictionBatch`` for an exact-shape batch
        (prediction float64, as the eager path gives it), or None when no
        program covers ``X``'s shape."""
        from ..models.prediction import PredictionBatch

        if X.dim() != 2 or X.shape[1] != self.n_features:
            return None
        bucket = int(X.shape[0])
        with self._lock:
            program = self._programs.get(bucket)
            if program is None:
                return None
            if isinstance(program, _Graph):
                program.x.copy_(X)
                program.graph.replay()
                outs = tuple(o.clone() for o in program.outs)
            self.replays[bucket] += 1
        if not isinstance(program, _Graph):
            outs = tuple(program(X.to(torch.float32), *self.params))
        named = dict(zip(self.spec.outputs, outs))
        return PredictionBatch(
            prediction=named["prediction"].to(torch.float64),
            raw_prediction=named.get("rawPrediction"),
            probability=named.get("probability"))

    def release(self) -> None:
        """Drop every program (a stale version's graphs free their memory
        pools) and uninstall the set from its predictor (after a build in
        progress, which would otherwise outlive it)."""
        with self._build_lock, self._lock:
            self._programs.clear()
            self._modes.clear()
        if getattr(self.model, "_serving_programs", None) is self:
            self.model._serving_programs = None


def find_predictor(workflow_model):
    """The last predictor stage of a workflow model's stages: the one
    whose scoring the served batch runs."""
    from ..models.prediction import PredictorModel

    found = None
    for stage in getattr(workflow_model, "stages", []) or []:
        if isinstance(stage, PredictorModel):
            found = stage
    return found


def program_set_for(model, store: Optional[AOTStore] = None,
                    cache_key_prefix: str = "serving"
                    ) -> Optional[ScoringProgramSet]:
    """Build and install a program set for a workflow model (or a bare
    predictor), or None when no stage has a scoring spec (trees,
    isotonic: serving keeps the eager path).  Installing sets
    ``_serving_programs`` on the predictor stage."""
    predictor = None
    spec_fn = getattr(model, "aot_scoring_spec", None)
    if callable(spec_fn) and spec_fn() is not None:
        predictor = model
    else:
        cand = find_predictor(model)
        if cand is not None and cand.aot_scoring_spec() is not None:
            predictor = cand
    if predictor is None:
        return None
    ps = ScoringProgramSet(predictor, store=store,
                           cache_key_prefix=cache_key_prefix)
    predictor._serving_programs = ps
    return ps
