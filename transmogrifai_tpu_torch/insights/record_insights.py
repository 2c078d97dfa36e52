"""Per-record explanations (counterpart of
``transmogrifai_tpu.insights.record_insights``).

``RecordInsightsLOCO`` (leave one column out): score the batch once, then
score copies of the batch with one vector slot zeroed, many slots a call
through the model's own ``predict_batch`` (any predictor: linear models,
forests, boosted trees, the MLP), on the model's device.  The score
changes are summed per raw feature (or per column) by a (slots x keys)
membership product, and each row keeps its top K keys by largest
|change|, ties in first-appearance order (the JAX package's stable sort);
only the final JSON strings are built on the host.  Slots that are zero
in every row are skipped (zeroing them changes nothing).

``RecordInsightsCorr``: the correlation (Pearson, or Spearman on ranks)
of every slot with every prediction column, fitted once; a row's
importance of slot j for prediction column c is ``corr[c, j] x
normalized(x_j)`` (minMax, zNorm or minMaxCentered), and each prediction
column keeps its top K slots by |importance| (ties by slot index; the
JAX package's ``argpartition`` picks any of a tie at the cut).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.stats import ranks
from ..stages.base import BinaryEstimator, BinaryModel, UnaryTransformer
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import TextMap

__all__ = ["RecordInsightsLOCO", "RecordInsightsCorr",
           "RecordInsightsCorrModel", "NormType", "parse_insights"]

#: elements of the zeroed-slot copies scored in one call (float32)
LOCO_CHUNK_ELEMS = 1 << 27
#: elements of the (rows, prediction columns, slots) importance block
CORR_CHUNK_ELEMS = 1 << 26


def _matrix(values, device: DeviceLike) -> torch.Tensor:
    """A vector column's values as a float32 (N, d) tensor: a device
    tensor stays where it is, a host array goes to ``device`` (else the
    default device)."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.float32)
    return torch.as_tensor(np.asarray(values, np.float32),
                           device=resolve_device(device))


def _slot_names(vmeta, d: int):
    """(column names, parent feature names) of the ``d`` slots."""
    if vmeta is not None and vmeta.size == d:
        return vmeta.column_names(), [c.parent_feature for c in vmeta.columns]
    names = [f"f_{j}" for j in range(d)]
    return names, names


class RecordInsightsLOCO(UnaryTransformer):
    """Input: the model's feature vector; output: TextMap of each row's
    per-feature insight JSON (``[change per prediction column]``)."""

    def __init__(self, model, top_k: int = 20,
                 aggregate_by_feature: bool = True,
                 device: DeviceLike = None, uid: Optional[str] = None):
        super().__init__(operation_name="recordInsightsLOCO",
                         output_type=TextMap, uid=uid)
        self.model = model            # fitted PredictorModel
        self.top_k = top_k
        self.aggregate_by_feature = aggregate_by_feature
        self.device = device
        #: slots scored in the last transform (the nonzero ones)
        self.slots_scored = 0

    def _score(self, X: torch.Tensor) -> torch.Tensor:
        batch = self.model.predict_batch(X)
        if batch.probability is not None:
            return batch.probability.to(torch.float64)
        return batch.prediction.to(torch.float64)[:, None]

    def transform_columns(self, features_col: FeatureColumn) -> FeatureColumn:
        X = _matrix(features_col.values, self.device)
        n, d = X.shape
        dev = X.device
        base = self._score(X)                               # (n, K)
        names, parents = _slot_names(features_col.vmeta, d)
        slot_keys = parents if self.aggregate_by_feature else names
        keys = list(dict.fromkeys(slot_keys))               # first appearance
        key_idx = {k: i for i, k in enumerate(keys)}
        member = torch.zeros((d, len(keys)), dtype=torch.float64, device=dev)
        member[torch.arange(d, device=dev),
               torch.as_tensor([key_idx[k] for k in slot_keys],
                               device=dev)] = 1.0
        agg = torch.zeros((n, len(keys), base.shape[1]),
                          dtype=torch.float64, device=dev)
        slots = torch.nonzero((X != 0).any(dim=0)).flatten()
        self.slots_scored = int(slots.numel())
        per_call = max(1, LOCO_CHUNK_ELEMS // max(n * d, 1))
        for a in range(0, self.slots_scored, per_call):
            S = slots[a:a + per_call]
            s = S.numel()
            Xz = X.unsqueeze(0).repeat(s, 1, 1)
            Xz[torch.arange(s, device=dev), :, S] = 0.0
            diff = (self._score(Xz.reshape(s * n, d)).reshape(s, n, -1)
                    - base)
            agg += torch.einsum("snk,sp->npk", diff, member[S])
        k = min(self.top_k, len(keys))
        order = torch.sort(-agg.abs().amax(dim=2), dim=1,
                           stable=True).indices[:, :k]
        top = torch.gather(agg, 1, order[:, :, None].expand(-1, -1,
                                                            agg.shape[2]))
        order, top = order.cpu().numpy(), top.cpu().numpy()
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = {keys[p]: json.dumps(top[i, r].tolist())
                      for r, p in enumerate(order[i])}
        return FeatureColumn(TextMap, out)


def parse_insights(row_map: Dict[str, str]) -> Dict[str, List[float]]:
    """A row's insight map with its JSON values parsed."""
    return {k: json.loads(v) for k, v in row_map.items()}


class NormType:
    """Feature scaling before the importances: minMax (x - min) / range,
    zNorm (x - mean) / std, minMaxCentered 2 (x - min) / range - 1."""

    MIN_MAX = "minMax"
    Z_NORM = "zNorm"
    MIN_MAX_CENTERED = "minMaxCentered"


def _pred_matrix(col: FeatureColumn, device: torch.device) -> torch.Tensor:
    """A prediction input as an (N, P) float64 score matrix: a
    PredictionBatch (probabilities, else the prediction), a vector, or
    row maps (``probability_*``, else ``prediction``)."""
    v = col.values
    if hasattr(v, "probability"):
        t = (v.probability if v.probability is not None
             else v.prediction[:, None])
        return torch.as_tensor(t, device=device).to(torch.float64)
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64).reshape(len(v), -1)
    arr = np.asarray(v)
    if arr.dtype == object:
        rows = []
        for m in arr:
            pk = sorted((k for k in m if k.startswith("probability_")),
                        key=lambda k: int(k.rsplit("_", 1)[1]))
            rows.append([m[k] for k in pk] if pk else [m["prediction"]])
        arr = np.asarray(rows, np.float64)
    return torch.as_tensor(arr.astype(np.float64).reshape(len(arr), -1),
                           device=device)


class RecordInsightsCorr(BinaryEstimator):
    """Correlation-based per-record insights: inputs (predictions, feature
    vector), output TextMap."""

    def __init__(self, norm_type: str = NormType.MIN_MAX,
                 correlation_type: str = "pearson", top_k: int = 20,
                 device: DeviceLike = None, uid: Optional[str] = None):
        super().__init__(operation_name="recordInsightsCorr",
                         output_type=TextMap, uid=uid)
        self.norm_type = norm_type
        self.correlation_type = correlation_type
        self.top_k = top_k
        self.device = device

    def fit_columns(self, data: Optional[ColumnarDataset],
                    pred_col: FeatureColumn, feat_col: FeatureColumn):
        X32 = _matrix(feat_col.values, self.device)
        P = _pred_matrix(pred_col, X32.device)               # (N, p)
        X = X32.to(torch.float64)                            # (N, d)
        if self.correlation_type == "spearman":
            X_c = ranks(X).to(torch.float64)
            P_c = ranks(P).to(torch.float64)
        else:
            X_c, P_c = X, P
        n = max(len(X), 1)
        Xs = X_c - X_c.mean(dim=0)
        Ps = P_c - P_c.mean(dim=0)
        xsd = Xs.std(dim=0, unbiased=False)
        psd = Ps.std(dim=0, unbiased=False)
        denom = torch.outer(psd, xsd) * n
        corr = torch.where(denom == 0, 0.0, (Ps.T @ Xs) / denom)
        if self.norm_type == NormType.Z_NORM:
            shift, scale, offset = X.mean(dim=0), X.std(dim=0,
                                                        unbiased=False), 0.0
        else:
            if len(X):
                mn = X.amin(dim=0)
                rng = X.amax(dim=0) - mn
            else:
                mn = rng = torch.zeros(X.shape[1], dtype=torch.float64)
            if self.norm_type == NormType.MIN_MAX_CENTERED:
                shift, scale, offset = mn, rng / 2.0, 1.0
            else:
                shift, scale, offset = mn, rng, 0.0
        host = [t.cpu().numpy() for t in (torch.nan_to_num(corr), shift,
                                          scale)]
        return RecordInsightsCorrModel(
            score_corr=host[0], shift=host[1], scale=host[2],
            offset=float(offset), top_k=self.top_k)


class RecordInsightsCorrModel(BinaryModel):
    def __init__(self, score_corr: np.ndarray, shift: np.ndarray,
                 scale: np.ndarray, offset: float = 0.0, top_k: int = 20,
                 uid: Optional[str] = None):
        super().__init__(operation_name="recordInsightsCorr",
                         output_type=TextMap, uid=uid)
        self.score_corr = np.asarray(score_corr, np.float64)
        self.shift = np.asarray(shift, np.float64)
        self.scale = np.asarray(scale, np.float64)
        self.offset = float(offset)
        self.top_k = top_k

    def transform_columns(self, pred_col: FeatureColumn,
                          feat_col: FeatureColumn) -> FeatureColumn:
        X = _matrix(feat_col.values, None).to(torch.float64)
        n, d = X.shape
        dev = X.device
        names, _ = _slot_names(feat_col.vmeta, d)
        corr, shift, scale = (torch.as_tensor(a, device=dev) for a in
                              (self.score_corr, self.shift, self.scale))
        p = corr.shape[0]
        kk = min(self.top_k, d)
        order = np.empty((n, p, kk), np.int64)
        val = np.empty((n, p, kk), np.float64)
        rows = max(1, CORR_CHUNK_ELEMS // max(p * d, 1))
        for a in range(0, n, rows):
            normed = torch.where(scale == 0, 0.0,
                                 (X[a:a + rows] - shift) / scale) - self.offset
            imp = corr[None, :, :] * normed[:, None, :]      # (n, p, d)
            o = torch.sort(-imp.abs(), dim=2, stable=True).indices[..., :kk]
            order[a:a + rows] = o.cpu().numpy()
            val[a:a + rows] = torch.gather(imp, 2, o).cpu().numpy()
        out = np.empty(n, dtype=object)
        for i in range(n):
            entries: dict = {}
            for c in range(p):
                for j, v in zip(order[i, c].tolist(), val[i, c].tolist()):
                    entries.setdefault(j, []).append([c, v])
            out[i] = {names[j]: json.dumps(v) for j, v in entries.items()}
        return FeatureColumn(TextMap, out)
