"""ModelInsights: one merged document describing a trained workflow
(counterpart of ``transmogrifai_tpu.insights.model_insights``).

It merges the label summary, the SanityChecker's column statistics, the
RawFeatureFilter results, the selector's validation summary and each
vector slot's contribution to the selected predictor, grouped by the raw
feature each slot derives from; ``pretty_print`` renders the summary
tables.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["ModelInsights", "FeatureInsight", "extract_model_insights",
           "feature_importances"]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def feature_importances(stage, d: int) -> Optional[np.ndarray]:
    """Per-slot contribution of a fitted predictor: |coefficient| for
    linear models (the mean over classes for multinomial ones), the share
    of valid splits on each slot for tree ensembles; a ``SelectedModel``
    answers with its winner's.  None where neither applies."""
    from ..models.trees import TreeEnsembleModel
    from ..selector.model_selector import SelectedModel

    if isinstance(stage, SelectedModel):
        return feature_importances(stage.inner, d)
    if isinstance(stage, TreeEnsembleModel):
        feat = _host(stage.feat)
        thresh = _host(stage.thresh)
        n_bins = int(thresh.max()) if thresh.size else 0
        out = np.zeros(d, np.float64)
        valid = thresh < (np.asarray(stage.edges).shape[1] + 1
                          if stage.edges is not None else n_bins)
        np.add.at(out, feat[valid], 1.0)
        s = out.sum()
        return out / s if s else out
    coef = getattr(stage, "coef", None)
    if coef is not None:
        c = np.abs(_host(coef).astype(np.float64))
        if c.ndim == 2:
            c = c.mean(axis=0)
        if c.shape[0] == d:
            return c
    return None


@dataclasses.dataclass
class FeatureInsight:
    feature_name: str
    feature_type: str
    derived_columns: List[Dict[str, Any]]

    def to_json(self):
        return {"featureName": self.feature_name,
                "featureType": self.feature_type,
                "derivedFeatures": self.derived_columns}


@dataclasses.dataclass
class ModelInsights:
    label: Dict[str, Any]
    features: List[FeatureInsight]
    selected_model_info: Optional[Dict[str, Any]]
    training_params: Dict[str, Any]
    stage_info: List[Dict[str, Any]]
    raw_feature_filter_results: Optional[Dict[str, Any]] = None

    def to_json(self) -> dict:
        return {
            "label": self.label,
            "features": [f.to_json() for f in self.features],
            "selectedModelInfo": self.selected_model_info,
            "trainingParams": self.training_params,
            "stageInfo": self.stage_info,
            "rawFeatureFilterResults": self.raw_feature_filter_results,
        }

    def top_contributions(self, k: int) -> List[tuple]:
        """The ``k`` largest (column name, contribution) pairs."""
        contribs = [(c["columnName"], c["contribution"])
                    for f in self.features for c in f.derived_columns
                    if c.get("contribution")]
        contribs.sort(key=lambda t: -t[1])
        return contribs[:k]

    def pretty_print(self, top_k: int = 15) -> str:
        """The summary tables: the evaluated models, the selected one and
        its holdout metrics, and the top contributions."""
        lines: List[str] = []
        smi = self.selected_model_info
        if smi:
            lines.append("Evaluated %d models:" % len(smi.get(
                "validationResults", [])))
            for r in smi.get("validationResults", [])[:top_k]:
                lines.append(f"  {r['modelType']} {r['params']} -> "
                             f"{r['metricName']}={r['metricValue']:.4f}")
            lines.append(f"Selected model: {smi.get('bestModelType')} "
                         f"{smi.get('bestModelParams')}")
            if smi.get("holdoutMetrics"):
                lines.append("Holdout metrics: "
                             + json.dumps(smi["holdoutMetrics"]))
        contribs = self.top_contributions(top_k)
        if contribs:
            lines.append("Top model contributions:")
            for name, v in contribs:
                lines.append(f"  {name}: {v:.4f}")
        return "\n".join(lines) if lines else "(no insights)"


def _label_summary(model) -> Dict[str, Any]:
    resp = next((f for f in model.raw_features() if f.is_response), None)
    out: Dict[str, Any] = {"labelName": resp.name if resp else None}
    if resp and model.train_data is not None and resp.name in model.train_data:
        y = np.asarray(model.train_data[resp.name].values, np.float64)
        y = y[np.isfinite(y)]
        uniq = np.unique(y)
        out["sampleSize"] = int(y.size)
        if uniq.size <= 30:
            out["distribution"] = {str(v): int((y == v).sum()) for v in uniq}
        else:
            out["distribution"] = {
                "mean": float(y.mean()), "std": float(y.std()),
                "min": float(y.min()), "max": float(y.max())}
    return out


def extract_model_insights(model, feature=None) -> ModelInsights:
    """Insights of a fitted ``OpWorkflowModel``."""
    selected = None
    sel_summary = None
    sanity_summary = None
    for s in model.stages:
        if "model_selector_summary" in s.metadata:
            sel_summary = s.metadata["model_selector_summary"]
            selected = s
        elif hasattr(s, "predict_batch") and selected is None:
            selected = s
        if "columnStats" in s.metadata.get("summary", {}):
            sanity_summary = s.metadata["summary"]

    vmeta = None
    d = None
    if selected is not None and len(selected.input_features) >= 2:
        feats_feature = selected.input_features[-1]
        if (model.train_data is not None
                and feats_feature.name in model.train_data):
            col = model.train_data[feats_feature.name]
            vmeta = col.vmeta
            d = int(col.values.shape[1])
        origin = feats_feature.origin_stage
        if vmeta is None and origin is not None:
            vmeta = getattr(origin, "new_vmeta", None)
    if vmeta is not None and d is None:
        d = vmeta.size

    contributions = (feature_importances(selected, d)
                     if selected is not None and d else None)
    stats_by_col = {}
    if sanity_summary:
        stats_by_col = {s["name"]: s
                        for s in sanity_summary.get("columnStats", [])}

    insights: Dict[str, FeatureInsight] = {}
    for f in model.raw_features():
        if f.is_response:
            continue
        insights[f.name] = FeatureInsight(f.name, f.ftype.type_name(), [])
    if vmeta is not None:
        names = vmeta.column_names()
        for j, c in enumerate(vmeta.columns):
            parent = c.parent_feature
            if parent not in insights:
                insights[parent] = FeatureInsight(parent, c.parent_type, [])
            entry: Dict[str, Any] = {
                "columnName": names[j],
                "indicatorValue": c.indicator_value,
                "descriptorValue": c.descriptor_value,
                "contribution": (float(contributions[j])
                                 if contributions is not None
                                 and j < len(contributions) else None),
            }
            st = stats_by_col.get(names[j])
            if st:
                entry.update({k: st.get(k) for k in
                              ("mean", "variance", "min", "max", "corr_label",
                               "cramers_v", "dropped", "reasons")})
            insights[parent].derived_columns.append(entry)

    stage_info = [{"uid": s.uid, "stage": type(s).__name__,
                   "operation": s.operation_name} for s in model.stages]
    rff = model.raw_feature_filter_results
    return ModelInsights(
        label=_label_summary(model),
        features=list(insights.values()),
        selected_model_info=sel_summary,
        training_params={},
        stage_info=stage_info,
        raw_feature_filter_results=(rff.to_json()
                                    if hasattr(rff, "to_json") else rff),
    )
