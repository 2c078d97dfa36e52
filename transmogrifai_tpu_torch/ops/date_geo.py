"""Date and geolocation vectorizers (counterpart of
``transmogrifai_tpu.ops.date_geo``).

 * ``extract_time_period`` — a calendar period of epoch milliseconds
 * ``DateToUnitCircleVectorizer`` — a timestamp onto (sin, cos) of each
   chosen period + null indicators (the ``date`` group)
 * ``DateListVectorizer`` — days since the first or last event, or a
   one-hot of the modal day, month or hour (the ``date_list`` group)
 * ``GeolocationVectorizer`` — (lat, lon, accuracy) filled with the mean
   + null indicators (the ``geolocation`` group)
 * ``TimePeriodTransformer`` / ``TimePeriodMapTransformer`` — a date (or
   each date of a map) to its calendar period as an integer

The arithmetic is the JAX package's float64 numpy, on the host; each
stage's block moves to its device in one copy.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..stages.base import (SequenceEstimator, SequenceModel,
                           SequenceTransformer, UnaryTransformer)
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import (Date, DateList, DateMap, Geolocation,
                                   Integral, IntegralMap, OPVector)
from .vector_metadata import (NULL_INDICATOR, VectorColumnMetadata,
                              VectorMetadata)
from .vectorizers import _host_vec_column

__all__ = ["DateToUnitCircleVectorizer", "DateListVectorizer",
           "DateListVectorizerModel", "GeolocationVectorizer",
           "GeolocationVectorizerModel", "TIME_PERIODS", "TIME_PERIOD_NAMES",
           "extract_time_period", "TimePeriodTransformer",
           "TimePeriodMapTransformer"]

_MS_PER_DAY = 86400000.0
#: period name -> its wavelength in ms
TIME_PERIODS = {
    "HourOfDay": 3600000.0 * 24,
    "DayOfWeek": _MS_PER_DAY * 7,
    "DayOfMonth": _MS_PER_DAY * 30.4375,
    "DayOfYear": _MS_PER_DAY * 365.25,
}

TIME_PERIOD_NAMES = ("DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
                     "MonthOfYear", "WeekOfMonth", "WeekOfYear")


def extract_time_period(ms: np.ndarray, period: str) -> np.ndarray:
    """A calendar period of epoch-millisecond values: DayOfMonth 1-31,
    DayOfWeek 1-7 (Monday 1), DayOfYear 1-366, HourOfDay 0-23, MonthOfYear
    1-12, WeekOfMonth 1-6, WeekOfYear 1-53, weeks aligned to the first
    day of the month or year."""
    ms = np.asarray(ms, dtype=np.int64)
    dt = ms.astype("datetime64[ms]")
    days = dt.astype("datetime64[D]")
    if period == "DayOfWeek":
        return (days.astype(np.int64) + 3) % 7 + 1  # 1970-01-01: Thursday
    if period == "HourOfDay":
        return (ms // 3_600_000) % 24
    if period == "MonthOfYear":
        return dt.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dom = (days - dt.astype("datetime64[M]").astype("datetime64[D]")
           ).astype(np.int64) + 1
    if period == "DayOfMonth":
        return dom
    if period == "WeekOfMonth":
        return (dom - 1) // 7 + 1
    doy = (days - dt.astype("datetime64[Y]").astype("datetime64[D]")
           ).astype(np.int64) + 1
    if period == "DayOfYear":
        return doy
    if period == "WeekOfYear":
        return (doy - 1) // 7 + 1
    raise ValueError(f"unknown time period {period!r}; "
                     f"one of {TIME_PERIOD_NAMES}")


def _check_period(period: str) -> None:
    if period not in TIME_PERIOD_NAMES:
        raise ValueError(f"unknown time period {period!r}")


class TimePeriodTransformer(UnaryTransformer):
    """Date -> Integral calendar period; missing stays missing."""

    input_types = (Date,)

    def __init__(self, period: str = "HourOfDay", uid: Optional[str] = None):
        super().__init__(operation_name="dateToTimePeriod",
                         output_type=Integral, uid=uid)
        _check_period(period)
        self.period = period

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        ms = np.nan_to_num(np.asarray(col.values, dtype=np.float64))
        out = extract_time_period(ms.astype(np.int64), self.period)
        return FeatureColumn(Integral, out.astype(np.float64),
                             np.asarray(col.mask).copy())


class TimePeriodMapTransformer(UnaryTransformer):
    """DateMap -> IntegralMap of each present key's calendar period."""

    input_types = (DateMap,)

    def __init__(self, period: str = "HourOfDay", uid: Optional[str] = None):
        super().__init__(operation_name="dateMapToTimePeriod",
                         output_type=IntegralMap, uid=uid)
        _check_period(period)
        self.period = period

    def transform_columns(self, col: FeatureColumn) -> FeatureColumn:
        out = np.empty(len(col), dtype=object)
        for i, d in enumerate(col.values):
            keys = [k for k, ms in (d or {}).items() if ms is not None]
            vals = extract_time_period(
                np.asarray([d[k] for k in keys], dtype=np.int64),
                self.period) if keys else np.empty(0, np.int64)
            out[i] = {k: int(v) for k, v in zip(keys, vals)}
        return FeatureColumn(IntegralMap, out)


def _clean_events(v) -> List[int]:
    """An event list with its None entries dropped."""
    return [t for t in (v or ()) if t is not None]


_DATE_LIST_PIVOTS = {
    "SinceFirst": None, "SinceLast": None,
    "ModeDay": ("DayOfWeek", 7, 1,
                ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")),
    "ModeMonth": ("MonthOfYear", 12, 1,
                  ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug",
                   "Sep", "Oct", "Nov", "Dec")),
    "ModeHour": ("HourOfDay", 24, 0,
                 tuple(f"{h:02d}" for h in range(24))),
}


class DateListVectorizer(SequenceEstimator):
    """DateList(s) -> OPVector by ``pivot``: ``SinceFirst``/``SinceLast``
    give the days between the first/last event and a reference time (one
    slot a feature); ``ModeDay``/``ModeMonth``/``ModeHour`` one-hot the
    modal day of week, month or hour.  Without ``reference_ms`` the fit
    takes the latest training event, and scoring reuses it."""

    input_types = (DateList,)

    def __init__(self, pivot: str = "SinceFirst",
                 reference_ms: Optional[int] = None, fill_value: float = 0.0,
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecDateList", output_type=OPVector,
                         uid=uid)
        if pivot not in _DATE_LIST_PIVOTS:
            raise ValueError(f"unknown pivot {pivot!r}; "
                             f"one of {sorted(_DATE_LIST_PIVOTS)}")
        self.pivot = pivot
        self.reference_ms = reference_ms
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        ref = self.reference_ms
        if ref is None:
            ref = max((max(ev) for c in cols for v in c.values
                       for ev in [_clean_events(v)] if ev), default=0)
        return DateListVectorizerModel(
            pivot=self.pivot, reference_ms=int(ref),
            fill_value=self.fill_value, track_nulls=self.track_nulls,
            device=self.device)


class DateListVectorizerModel(SequenceModel):
    input_types = (DateList,)

    def __init__(self, pivot: str = "SinceFirst", reference_ms: int = 0,
                 fill_value: float = 0.0, track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecDateList", output_type=OPVector,
                         uid=uid)
        self.pivot = pivot
        self.reference_ms = reference_ms
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        parts, meta = [], []
        for f, c in zip(self.input_features, cols):
            tname = f.ftype.type_name()
            events = [_clean_events(v) for v in c.values]
            empty = np.array([not v for v in events], bool)
            if self.pivot in ("SinceFirst", "SinceLast"):
                pick = min if self.pivot == "SinceFirst" else max
                days = np.array(
                    [(self.reference_ms - pick(v)) / _MS_PER_DAY if v
                     else self.fill_value for v in events], np.float64)
                parts.append(days[:, None])
                meta.append(VectorColumnMetadata(
                    f.name, tname, descriptor_value=self.pivot))
            else:
                period, width, lo, names = _DATE_LIST_PIVOTS[self.pivot]
                block = np.zeros((len(c), width), np.float64)
                for i, v in enumerate(events):
                    if not v:
                        continue
                    vals = extract_time_period(
                        np.asarray(v, dtype=np.int64), period) - lo
                    block[i, np.bincount(vals, minlength=width).argmax()] = 1.0
                parts.append(block)
                meta.extend(VectorColumnMetadata(f.name, tname,
                                                 indicator_value=nm)
                            for nm in names)
            if self.track_nulls:
                parts.append(empty[:, None].astype(np.float64))
                meta.append(VectorColumnMetadata(
                    f.name, tname, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.concatenate(parts, axis=1),
                                VectorMetadata("date_list_vec", meta),
                                self.device)


class DateToUnitCircleVectorizer(SequenceTransformer):
    """Timestamp (ms) -> (sin, cos) of each of ``time_periods``
    (stateless); missing dates give (0, 0) and a null indicator."""

    input_types = (Date,)

    def __init__(self, time_periods: Sequence[str] = ("HourOfDay",),
                 track_nulls: bool = True, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="dateToUnitCircle",
                         output_type=OPVector, uid=uid)
        self.time_periods = list(time_periods)
        self.track_nulls = track_nulls
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        parts, meta = [], []
        for f, c in zip(self.input_features, cols):
            ms = np.nan_to_num(np.asarray(c.values, dtype=np.float64))
            m = np.asarray(c.mask)
            tname = f.ftype.type_name()
            for period in self.time_periods:
                wl = TIME_PERIODS[period]
                theta = 2.0 * math.pi * ((ms % wl) / wl)
                parts.append(np.where(m, np.sin(theta), 0.0))
                parts.append(np.where(m, np.cos(theta), 0.0))
                meta.append(VectorColumnMetadata(
                    f.name, tname, descriptor_value=f"{period}_x"))
                meta.append(VectorColumnMetadata(
                    f.name, tname, descriptor_value=f"{period}_y"))
            if self.track_nulls:
                parts.append(~m)
                meta.append(VectorColumnMetadata(
                    f.name, tname, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.stack(parts, axis=1),
                                VectorMetadata("date_vec", meta), self.device)


class GeolocationVectorizer(SequenceEstimator):
    """(lat, lon, accuracy) -> the triple filled with the column mean + a
    null indicator."""

    input_types = (Geolocation,)

    def __init__(self, track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeo", output_type=OPVector,
                         uid=uid)
        self.track_nulls = track_nulls
        self.device = device

    def fit_columns(self, data: ColumnarDataset, *cols: FeatureColumn):
        fills = []
        for c in cols:
            m = np.asarray(c.mask)
            if m.any():
                fills.append(np.nan_to_num(
                    np.asarray(c.values, dtype=np.float64)[m].mean(axis=0)
                ).tolist())
            else:
                fills.append([0.0, 0.0, 0.0])
        return GeolocationVectorizerModel(
            fills=fills, track_nulls=self.track_nulls, device=self.device)


class GeolocationVectorizerModel(SequenceModel):
    input_types = (Geolocation,)

    def __init__(self, fills: List[List[float]], track_nulls: bool = True,
                 device: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeo", output_type=OPVector,
                         uid=uid)
        self.fills = fills
        self.track_nulls = track_nulls
        self.device = device

    def transform_columns(self, *cols: FeatureColumn) -> FeatureColumn:
        parts, meta = [], []
        for f, fill, c in zip(self.input_features, self.fills, cols):
            vals = np.nan_to_num(np.asarray(c.values, dtype=np.float64))
            m = np.asarray(c.mask)
            parts.append(np.where(m[:, None], vals,
                                  np.asarray(fill)[None, :]))
            tname = f.ftype.type_name()
            meta += [VectorColumnMetadata(f.name, tname, descriptor_value=d)
                     for d in ("lat", "lon", "accuracy")]
            if self.track_nulls:
                parts.append((~m)[:, None].astype(np.float64))
                meta.append(VectorColumnMetadata(
                    f.name, tname, grouping=f.name,
                    indicator_value=NULL_INDICATOR))
        return _host_vec_column(np.concatenate(parts, axis=1),
                                VectorMetadata("geo_vec", meta), self.device)
