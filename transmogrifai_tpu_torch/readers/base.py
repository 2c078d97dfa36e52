"""Data readers — host-side ingestion into columnar batches.

Ported: ``reader_for`` with the ``ColumnarDataset`` passthrough and the
in-memory pandas DataFrame reader (pandas imported only when a frame is
given).  File, record, event and streaming readers are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence

from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn

__all__ = ["Reader", "DataFrameReader", "reader_for"]


class Reader:
    """Produces the raw-feature dataset for a workflow."""

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        raise NotImplementedError


class DataFrameReader(Reader):
    """Wraps an in-memory pandas DataFrame; features read their column by
    name, or through their ``extract_fn`` over the frame's records."""

    def __init__(self, df):
        self.df = df

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        records = None
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            gen = f.origin_stage
            if gen.extract_fn is None:
                if f.name not in self.df.columns:
                    raise KeyError(
                        f"input data is missing raw feature column {f.name!r}")
                series = self.df[f.name]
                vals = (series.to_numpy() if series.dtype.kind in "fiub"
                        else series.tolist())
                cols[f.name] = FeatureColumn.from_values(f.ftype, vals)
            else:
                if records is None:
                    records = self.df.to_dict("records")
                cols[f.name] = gen.extract_column(records)
        return ColumnarDataset(cols)


class _PassthroughReader(Reader):
    def __init__(self, ds: ColumnarDataset):
        self.ds = ds

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        missing = [f.name for f in raw_features if f.name not in self.ds]
        if missing:
            raise ValueError(f"dataset missing raw feature columns {missing}")
        return self.ds.select([f.name for f in raw_features])


def reader_for(data) -> Reader:
    """Coerce user input to a Reader."""
    if isinstance(data, Reader):
        return data
    if isinstance(data, ColumnarDataset):
        return _PassthroughReader(data)
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(data, pd.DataFrame):
        return DataFrameReader(data)
    raise TypeError(f"cannot build a reader from {type(data)}")
