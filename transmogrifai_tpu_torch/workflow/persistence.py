"""Workflow-model persistence — one JSON document + one array bundle, in
the JAX package's format v1 (counterpart of
``transmogrifai_tpu.workflow.persistence``), so one artifact serves both
packages.

Layout (a directory):
  op-model.json   version, versionInfo, result features, stage records
  arrays.npz      every array-valued stage param, keyed "<uid>.<param>"

A stage record is the JAX package's dotted class path, the constructor
params as JSON (arrays externalized, nested stages recursed, feature-type
classes by name), the ``extra_state`` payload and the fitted metadata.
The port writes JAX class paths and reads them back through one explicit
table, ``CLASS_MAP``; a class with no row raises ``NotImplementedError``
naming the class and the ROADMAP item that ports it.  Tensors are saved
as numpy arrays with their dtypes; ``device`` is placement, not state: it
is never written, and loading places every tensor on the device
``load_workflow_model(path, device=None)`` resolves (``device.py``'s rule).
A chunked train's final streaming states (``model.fit_states``) ride in
the document as ``fitStates``, encoded by the checkpoint codec
(``workflow/checkpoint.py``) with their arrays in arrays.npz under
``fitstate.<uid>``, as the JAX package writes them; loading decodes their
tensors onto the same device.
"""
from __future__ import annotations

import inspect
import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Optional, Type

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..features.feature import Feature
from ..insights.record_insights import (RecordInsightsCorrModel,
                                        RecordInsightsLOCO)
from ..models.classification import (LinearSVCModel,
                                     LogisticRegressionModel,
                                     NaiveBayesModel)
from ..models.mlp import MLPClassificationModel
from ..models.regression import (GLMModel, IsotonicRegressionModel,
                                 LinearRegressionModel)
from ..models.trees import TreeEnsembleModel
from ..ops import (date_geo, detectors, dsl_transformers, embeddings,
                   map_vectorizers, numeric, text, vectorizers)
from ..ops.vector_metadata import VectorMetadata
from ..preparators.sanity_checker import (MinVarianceFilterModel,
                                          SanityCheckerModel)
from ..selector.combiner import SelectedCombinerModel
from ..selector.model_selector import SelectedModel
from ..stages.base import PipelineStage
from ..stages.generator import FeatureGeneratorStage
from ..types.feature_types import FeatureType, type_by_name
from ..utils.jsonio import write_json_atomic
from ..utils.version import version_info

__all__ = ["save_workflow_model", "load_workflow_model", "check_serializable",
           "round_trip_problem", "saved_stages",
           "CLASS_MAP", "MODEL_JSON", "ARRAYS_NPZ", "FORMAT_VERSION"]

MODEL_JSON = "op-model.json"
ARRAYS_NPZ = "arrays.npz"
FORMAT_VERSION = 1

#: the class-name map: each JAX class path the port reads, and the port
#: class that stands for it.  Saving writes the same paths back.
CLASS_MAP: Dict[str, Type[PipelineStage]] = {
    "transmogrifai_tpu.stages.generator.FeatureGeneratorStage":
        FeatureGeneratorStage,
    "transmogrifai_tpu.ops.vectorizers.RealVectorizerModel":
        vectorizers.RealVectorizerModel,
    "transmogrifai_tpu.ops.vectorizers.BinaryVectorizer":
        vectorizers.BinaryVectorizer,
    "transmogrifai_tpu.ops.vectorizers.OneHotVectorizerModel":
        vectorizers.OneHotVectorizerModel,
    "transmogrifai_tpu.ops.vectorizers.MultiPickListVectorizerModel":
        vectorizers.MultiPickListVectorizerModel,
    "transmogrifai_tpu.ops.vectorizers.TextHashingVectorizer":
        vectorizers.TextHashingVectorizer,
    "transmogrifai_tpu.ops.vectorizers.SmartTextVectorizerModel":
        vectorizers.SmartTextVectorizerModel,
    "transmogrifai_tpu.ops.vectorizers.VectorsCombiner":
        vectorizers.VectorsCombiner,
    "transmogrifai_tpu.ops.date_geo.DateToUnitCircleVectorizer":
        date_geo.DateToUnitCircleVectorizer,
    "transmogrifai_tpu.ops.date_geo.DateListVectorizerModel":
        date_geo.DateListVectorizerModel,
    "transmogrifai_tpu.ops.date_geo.GeolocationVectorizerModel":
        date_geo.GeolocationVectorizerModel,
    "transmogrifai_tpu.ops.map_vectorizers.NumericMapVectorizerModel":
        map_vectorizers.NumericMapVectorizerModel,
    "transmogrifai_tpu.ops.map_vectorizers.TextMapPivotVectorizerModel":
        map_vectorizers.TextMapPivotVectorizerModel,
    "transmogrifai_tpu.ops.map_vectorizers.MultiPickListMapVectorizerModel":
        map_vectorizers.MultiPickListMapVectorizerModel,
    "transmogrifai_tpu.ops.map_vectorizers.GeoMapVectorizerModel":
        map_vectorizers.GeoMapVectorizerModel,
    "transmogrifai_tpu.ops.map_vectorizers.SmartTextMapVectorizerModel":
        map_vectorizers.SmartTextMapVectorizerModel,
    "transmogrifai_tpu.preparators.sanity_checker.SanityCheckerModel":
        SanityCheckerModel,
    "transmogrifai_tpu.preparators.sanity_checker.MinVarianceFilterModel":
        MinVarianceFilterModel,
    "transmogrifai_tpu.models.classification.LogisticRegressionModel":
        LogisticRegressionModel,
    "transmogrifai_tpu.models.classification.LinearSVCModel":
        LinearSVCModel,
    "transmogrifai_tpu.models.classification.NaiveBayesModel":
        NaiveBayesModel,
    "transmogrifai_tpu.models.regression.LinearRegressionModel":
        LinearRegressionModel,
    "transmogrifai_tpu.models.regression.GLMModel": GLMModel,
    "transmogrifai_tpu.models.regression.IsotonicRegressionModel":
        IsotonicRegressionModel,
    "transmogrifai_tpu.models.trees.TreeEnsembleModel": TreeEnsembleModel,
    "transmogrifai_tpu.models.mlp.MLPClassificationModel":
        MLPClassificationModel,
    "transmogrifai_tpu.selector.model_selector.SelectedModel": SelectedModel,
    "transmogrifai_tpu.selector.combiner.SelectedCombinerModel":
        SelectedCombinerModel,
    "transmogrifai_tpu.insights.record_insights.RecordInsightsLOCO":
        RecordInsightsLOCO,
    "transmogrifai_tpu.insights.record_insights.RecordInsightsCorrModel":
        RecordInsightsCorrModel,
}
#: the stateless stages and fitted models of the feature-engineering
#: modules, each under its JAX module's path and its own name
_FEATURE_STAGES = {
    "date_geo": (date_geo, ("TimePeriodTransformer",
                            "TimePeriodMapTransformer")),
    "dsl_transformers": (dsl_transformers, (
        "MathBinaryTransformer", "MathScalarTransformer", "AliasTransformer",
        "FilterTransformer", "SubstringTransformer", "JaccardSimilarity",
        "NGramSimilarity", "ToOccurTransformer", "ExistsTransformer",
        "ReplaceTransformer", "DropIndicesByTransformer")),
    "text": (text, ("TextTokenizer", "OpNGram", "OpStopWordsRemover",
                    "OpCountVectorizerModel", "OpHashingTF",
                    "OpStringIndexerModel", "OpIndexToString",
                    "TextLenTransformer")),
    "numeric": (numeric, ("NumericBucketizer", "_BucketizerModel",
                          "_FillModel", "_ScalerModel", "ScalerTransformer",
                          "DescalerTransformer", "_PercentileModel")),
    "embeddings": (embeddings, ("OpWord2VecModel", "OpLDAModel")),
    "detectors": (detectors, (
        "MimeTypeDetector", "MimeTypeMapDetector", "LangDetector",
        "ParsePhoneNumber", "ParsePhoneDefaultCountry", "IsValidPhoneNumber",
        "IsValidPhoneDefaultCountry", "IsValidPhoneMapDefaultCountry",
        "ValidEmailTransformer", "HumanNameDetectorModel",
        "NameEntityRecognizer", "EmailToPickListMapTransformer",
        "UrlMapToPickListMapTransformer", "FilterMap")),
}
CLASS_MAP.update({f"transmogrifai_tpu.ops.{mod}.{name}": getattr(m, name)
                  for mod, (m, names) in _FEATURE_STAGES.items()
                  for name in names})
_JAX_PATH = {cls: path for path, cls in CLASS_MAP.items()}
#: the reference's alias names load as well; saving writes the paths above
CLASS_MAP["transmogrifai_tpu.ops.map_vectorizers."
          "GeolocationMapVectorizerModel"] = \
    map_vectorizers.GeolocationMapVectorizerModel

#: the ROADMAP item that ports what the map lacks, by JAX module prefix
_ROADMAP_ITEMS = (
    ("transmogrifai_tpu.models.trees",
     "ROADMAP Queue A item 3 (the rest of the tree family)"),
    ("transmogrifai_tpu.models.gbdt",
     "ROADMAP Queue A item 3 (the rest of the tree family)"),
    ("transmogrifai_tpu.",
     "ROADMAP Queue A item 6 (streaming workflow CV, refresh, tuning, "
     "observability, serving, static analysis and multi-device work)"),
)


def _roadmap_item(path: str) -> str:
    return next(item for prefix, item in _ROADMAP_ITEMS
                if path.startswith(prefix))


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

class _ArrayStore:
    def __init__(self):
        self.arrays: Dict[str, np.ndarray] = {}

    def put(self, key: str, arr: np.ndarray) -> Dict[str, str]:
        k, i = key, 0
        while k in self.arrays:
            i += 1
            k = f"{key}#{i}"
        self.arrays[k] = arr
        return {"__array__": k}


def _encode(value: Any, key: str, store: _ArrayStore) -> Any:
    if isinstance(value, torch.Tensor):
        # one device-to-host copy per array (a stacked ensemble included)
        return store.put(key, value.detach().cpu().numpy())
    if isinstance(value, np.ndarray):
        return store.put(key, value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, PipelineStage):
        return {"__stage__": _stage_record(value, store)}
    if isinstance(value, VectorMetadata):
        return {"__vmeta__": value.to_json()}
    if isinstance(value, type) and issubclass(value, FeatureType):
        return {"__ftype__": value.type_name()}
    if isinstance(value, dict):
        return {k: _encode(v, f"{key}.{k}", store) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v, f"{key}[{i}]", store) for i, v in enumerate(value)]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if callable(value):
        warnings.warn(
            f"non-serializable callable at {key!r} saved as a stub; the "
            f"loaded stage falls back to by-name column extraction or fails "
            f"if the callable is required", stacklevel=2)
        return {"__callable__": getattr(value, "__name__", "<fn>")}
    return {"__repr__": repr(value)}


def _stage_params(stage: PipelineStage) -> Dict[str, Any]:
    """Constructor params as written: ``device`` is placement, not state
    (and the JAX constructors would reject it)."""
    return {k: v for k, v in stage.get_params().items() if k != "device"}


def _stage_record(stage: PipelineStage, store: _ArrayStore) -> Dict[str, Any]:
    path = _JAX_PATH.get(type(stage))
    if path is None:
        raise NotImplementedError(
            f"{type(stage).__name__} has no row in the persistence class "
            f"map: it cannot be saved")
    rec: Dict[str, Any] = {
        "className": path,
        "uid": stage.uid,
        "operationName": stage.operation_name,
        "outputType": (stage.output_type.type_name()
                       if stage.output_type else None),
        "params": {k: _encode(v, f"{stage.uid}.{k}", store)
                   for k, v in _stage_params(stage).items()},
        "inputFeatures": [f.name for f in stage.input_features],
        "outputFeature": (stage._output_feature.name
                          if stage._output_feature else None),
    }
    extra = stage.extra_state()
    if extra:
        rec["extraState"] = {k: _encode(v, f"{stage.uid}.extra.{k}", store)
                             for k, v in extra.items()}
    if stage.metadata:
        rec["metadata"] = _encode(stage.metadata, f"{stage.uid}.meta", store)
    return rec


# ---------------------------------------------------------------------------
# the train-time serializability gate
# ---------------------------------------------------------------------------

def _find_unserializable(value: Any, path: str, out: List[str]) -> None:
    """Param paths whose values ``_encode`` would stub (callables)."""
    if (value is None or isinstance(value, (bool, int, float, str, np.generic,
                                            np.ndarray, torch.Tensor,
                                            VectorMetadata))
            or (isinstance(value, type) and issubclass(value, FeatureType))):
        return
    if isinstance(value, PipelineStage):
        out += [f"{path}.{p}" for p in _unserializable_params(value)]
    elif isinstance(value, dict):
        for k, v in value.items():
            _find_unserializable(v, f"{path}.{k}", out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _find_unserializable(v, f"{path}[{i}]", out)
    elif callable(value):
        out.append(path)


def _unserializable_params(stage: PipelineStage) -> List[str]:
    out: List[str] = []
    for name, value in _stage_params(stage).items():
        _find_unserializable(value, name, out)
    return out


def check_serializable(stages) -> None:
    """Fail at train time, naming the stage and param, when a stage
    parameter would not survive a save/load round trip (a lambda
    extractor, any callable): the format records constructor params, not
    code.  ``OpWorkflow.allow_non_serializable()`` opts out."""
    problems = [f"stage {type(s).__name__}[{s.uid}] param {p!r}"
                for s in stages for p in _unserializable_params(s)]
    if problems:
        raise ValueError(
            "workflow contains state that cannot survive a save/load round "
            "trip:\n  - " + "\n  - ".join(problems) +
            "\nUse by-name extraction / serializable params, or opt out "
            "with OpWorkflow.allow_non_serializable() to train anyway "
            "(saving will stub these values).")


def round_trip_problem(model) -> Optional[str]:
    """Why ``model`` would not come back whole from a save and load (a
    callable the save would stub, a stage class with no row in
    ``CLASS_MAP``), else None."""
    stages = saved_stages(model)
    try:
        check_serializable(stages)
    except ValueError as exc:
        return str(exc)
    unmapped = sorted({type(s).__name__ for s in stages
                       if type(s) not in _JAX_PATH})
    if unmapped:
        return ("no row in the persistence class map for "
                + ", ".join(unmapped))
    return None


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def saved_stages(model) -> List[PipelineStage]:
    """The stages a save writes, in its order: the raw generators, then
    the fitted stages in scoring-DAG order."""
    stages = [f.origin_stage for f in model.raw_features()
              if isinstance(f.origin_stage, FeatureGeneratorStage)]
    for layer in model._scoring_dag().non_generator_layers():
        stages += layer
    return stages


def save_workflow_model(model, path: str, overwrite: bool = True) -> None:
    """Write ``model`` to the directory ``path`` (replaced when
    ``overwrite``, else ``FileExistsError``)."""
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    os.makedirs(path)
    store = _ArrayStore()
    records = [_stage_record(s, store) for s in saved_stages(model)]
    rff = getattr(model, "raw_feature_filter_results", None)
    doc = {
        "version": FORMAT_VERSION,
        "versionInfo": version_info().to_json(),
        "resultFeatures": [f.name for f in model.result_features],
        "stages": records,
        # the results persist in their JSON form; a loaded model carries
        # the dict (ModelInsights takes either)
        "rawFeatureFilterResults": (rff.to_json() if hasattr(rff, "to_json")
                                    else rff),
    }
    fit_states = getattr(model, "fit_states", None)
    if fit_states:
        # each streamed estimator's final state, the warm-start capital a
        # refresh resumes from, through the checkpoint codec: its arrays
        # in the same arrays.npz under "fitstate.<uid>..."
        from .checkpoint import encode_fit_state

        doc["fitStates"] = {
            uid: encode_fit_state(payload, f"fitstate.{uid}", store)
            for uid, payload in fit_states.items()}
    # the document first and atomically: a killed save never leaves a
    # truncated op-model.json beside a complete arrays.npz
    write_json_atomic(os.path.join(path, MODEL_JSON), doc, indent=2)
    np.savez_compressed(os.path.join(path, ARRAYS_NPZ), **store.arrays)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _nested_records(value: Any):
    if isinstance(value, dict):
        if "__stage__" in value:
            yield value["__stage__"]
        else:
            for v in value.values():
                yield from _nested_records(v)
    elif isinstance(value, list):
        for v in value:
            yield from _nested_records(v)


def _unported(rec: Dict[str, Any], out: List[str]) -> None:
    """Collect every class (and tree mode) of ``rec`` and its nested
    records that the port cannot build."""
    path = rec["className"]
    name = path.rpartition(".")[2]
    cls = CLASS_MAP.get(path)
    if cls is None:
        out.append(f"{name} ({path}): {_roadmap_item(path)}")
    elif cls is TreeEnsembleModel:
        from ..models.trees import _MODES

        mode = rec["params"].get("mode")
        if mode not in _MODES:
            out.append(f"{name} mode {mode!r}: {_roadmap_item(path)}")
    for nested in _nested_records(rec["params"]):
        _unported(nested, out)


def _decode(value: Any, arrays, dev: torch.device) -> Any:
    if isinstance(value, dict):
        if "__array__" in value:
            return arrays[value["__array__"]]
        if "__stage__" in value:
            return _load_stage(value["__stage__"], arrays, dev)
        if "__vmeta__" in value:
            return VectorMetadata.from_json(value["__vmeta__"])
        if "__ftype__" in value:
            return type_by_name(value["__ftype__"])
        if "__callable__" in value or "__repr__" in value:
            return None
        return {k: _decode(v, arrays, dev) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v, arrays, dev) for v in value]
    return value


def _load_stage(rec: Dict[str, Any], arrays, dev: torch.device
                ) -> PipelineStage:
    cls = CLASS_MAP[rec["className"]]
    sig = inspect.signature(cls.__init__).parameters
    params: Dict[str, Any] = {}
    for k, v in rec["params"].items():
        value = _decode(v, arrays, dev)
        if k in sig:
            params[k] = value
        elif value is not None:
            # a JAX-only option set to something other than its default
            raise NotImplementedError(
                f"{rec['className']} param {k}={value!r} is not ported yet "
                f"({_roadmap_item(rec['className'])})")
    if "output_type" in sig and rec.get("outputType"):
        params["output_type"] = type_by_name(rec["outputType"])
    if "device" in sig:
        params["device"] = str(dev)
    params["uid"] = rec["uid"]
    stage = cls(**params)
    stage.operation_name = rec.get("operationName", stage.operation_name)
    if rec.get("extraState"):
        stage.set_extra_state({k: _decode(v, arrays, dev)
                               for k, v in rec["extraState"].items()})
    if rec.get("metadata"):
        stage.metadata = _decode(rec["metadata"], arrays, dev)
    return stage


def load_workflow_model(path: str, device: DeviceLike = None):
    """Load a saved model (either package's) with its tensors on
    ``device`` (else the default device; no card and no request raises)."""
    from .workflow import OpWorkflowModel  # cycle guard

    dev = resolve_device(device)
    with open(os.path.join(path, MODEL_JSON)) as f:
        doc = json.load(f)
    if doc.get("version", 0) > FORMAT_VERSION:
        warnings.warn(f"model format v{doc['version']} is newer than "
                      f"v{FORMAT_VERSION}")
    missing: List[str] = []
    for rec in doc["stages"]:
        _unported(rec, missing)
    if missing:
        raise NotImplementedError(
            f"cannot load {path}: these classes are not ported yet:\n  - "
            + "\n  - ".join(missing))
    arrays: Dict[str, np.ndarray] = {}
    npz_path = os.path.join(path, ARRAYS_NPZ)
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}

    features: Dict[str, Feature] = {}
    stages: List[PipelineStage] = []
    for rec in doc["stages"]:
        stage = _load_stage(rec, arrays, dev)
        if isinstance(stage, FeatureGeneratorStage):
            features[stage.name] = stage.get_output()
            continue
        stage.set_input(*[features[n] for n in rec["inputFeatures"]])
        out = stage.get_output()
        saved: Optional[str] = rec.get("outputFeature")
        if saved and saved != out.name:
            out.name = saved
        features[out.name] = out
        stages.append(stage)
    model = OpWorkflowModel([features[n] for n in doc["resultFeatures"]],
                            stages)
    model.raw_feature_filter_results = doc.get("rawFeatureFilterResults")
    if doc.get("fitStates"):
        from .checkpoint import decode_fit_state

        model.fit_states = {uid: decode_fit_state(rec, arrays, dev)
                            for uid, rec in doc["fitStates"].items()}
    return model
