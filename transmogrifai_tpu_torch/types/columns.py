"""Columnar storage for feature values.

Each feature is one ``FeatureColumn`` — a batch of N values in the layout
best suited to its semantic type:

    real/integral/binary/date  -> float64 numpy values + bool mask (host)
    text (incl. subtypes)      -> object ndarray of str|None (host)
    vector                     -> (N, D) float32 torch tensor on the device
    prediction                 -> ``models.prediction.PredictionBatch``

Raw columns stay on the host; vectorizers move the data to the device, so
the assembled feature matrix, the sanity-checked matrix and the model
inputs are device tensors.  Storages the slice does not use (lists, sets,
maps, geolocation) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Sequence, Type

import numpy as np

from .feature_types import FeatureType

__all__ = ["FeatureColumn", "ColumnarDataset"]

_NUMERIC_STORAGE = ("real", "integral", "binary", "date")


@dataclasses.dataclass
class FeatureColumn:
    """A batch of N values of one semantic feature type.

    ``mask``: bool ndarray (N,) — True where the value is present; always
    set for numeric storages, None for text (None objects mark missing)
    and vectors.  ``vmeta``: per-slot provenance of an OPVector column.
    """

    ftype: Type[FeatureType]
    values: Any
    mask: Optional[np.ndarray] = None
    vmeta: Any = None

    def __post_init__(self):
        if self.ftype.storage in _NUMERIC_STORAGE and self.mask is None:
            vals = np.asarray(self.values)
            self.mask = (~np.isnan(vals) if vals.dtype.kind == "f"
                         else np.ones(len(vals), bool))

    def __len__(self) -> int:
        return len(self.values)

    @staticmethod
    def from_values(ftype: Type[FeatureType],
                    raw: Sequence[Any]) -> "FeatureColumn":
        """Build a host column from Python values or a numeric ndarray
        (None/NaN/"" = missing) — the same coercions as the JAX package."""
        st = ftype.storage
        n = len(raw)
        if (st in _NUMERIC_STORAGE and isinstance(raw, np.ndarray)
                and raw.dtype.kind in "fiub"):
            vals = raw.astype(np.float64)
            mask = (~np.isnan(vals) if raw.dtype.kind == "f"
                    else np.ones(n, dtype=bool))
            if st == "binary":
                vals = np.where(mask, vals != 0, False).astype(np.float64)
            elif st == "integral":
                vals = np.where(mask, np.trunc(np.nan_to_num(vals)), 0.0)
            else:
                vals = np.where(mask, vals, np.nan)
            return FeatureColumn(ftype, vals, mask)
        if st in ("real", "date"):
            vals = np.array([np.nan if _is_missing(v) else float(v)
                             for v in raw], dtype=np.float64)
            return FeatureColumn(ftype, vals, ~np.isnan(vals))
        if st in ("integral", "binary"):
            mask = np.array([not _is_missing(v) for v in raw], dtype=bool)
            conv = int if st == "integral" else bool
            vals = np.array([0 if _is_missing(v) else conv(v) for v in raw],
                            dtype=np.float64)
            return FeatureColumn(ftype, vals, mask)
        if st == "text":
            arr = np.empty(n, dtype=object)
            for i, v in enumerate(raw):
                arr[i] = None if _is_missing(v) else str(v)
            return FeatureColumn(ftype, arr)
        raise NotImplementedError(
            f"storage {st!r} ({ftype.type_name()}) is not ported yet "
            f"(ROADMAP Queue A)")


def _is_missing(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return isinstance(v, str) and v == ""


class ColumnarDataset:
    """An ordered {feature name -> FeatureColumn} batch — the working
    dataset that flows through the stage DAG."""

    def __init__(self, columns: Optional[Dict[str, FeatureColumn]] = None,
                 *, _validated: bool = False):
        self.columns: Dict[str, FeatureColumn] = dict(columns or {})
        if not _validated:
            lengths = {len(c) for c in self.columns.values()}
            if len(lengths) > 1:
                raise ValueError(f"ragged dataset: column lengths {lengths}")

    def __len__(self) -> int:
        for c in self.columns.values():
            return len(c)
        return 0

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> FeatureColumn:
        return self.columns[name]

    def with_columns(self, new: Dict[str, FeatureColumn]
                     ) -> "ColumnarDataset":
        """Copy-on-write append/override: untouched column buffers are
        shared by reference and ``self`` is never mutated."""
        n = len(self)
        for name, col in new.items():
            if self.columns and len(col) != n:
                raise ValueError(
                    f"column {name!r} length {len(col)} != dataset length {n}")
        merged = dict(self.columns)
        merged.update(new)
        return ColumnarDataset(merged, _validated=True)

    def select(self, names: Iterable[str]) -> "ColumnarDataset":
        return ColumnarDataset({n: self.columns[n] for n in names},
                               _validated=True)
