"""Data readers — host-side ingestion into columnar batches.

Ported: ``reader_for`` with the ``ColumnarDataset`` passthrough, the
records reader (a list of dicts; ``key_fn`` adds a ``key`` ID column) and
the in-memory pandas DataFrame reader (pandas imported only when a frame
is given); the CSV and JSON-lines file readers are in ``readers/files.py``,
the Avro readers in ``readers/avro.py``.  Event, streaming and Parquet
readers, chunked ingestion and the resilience policies are not ported yet
(ROADMAP Queue A item 6.3).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from ..types.feature_types import ID

__all__ = ["Reader", "DataFrameReader", "RecordsReader", "reader_for"]


class Reader:
    """Produces the raw-feature dataset for a workflow."""

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        raise NotImplementedError

    def estimate_rows(self) -> Optional[int]:
        """The row count before reading, where the source can say without a
        parse (None otherwise)."""
        return None

    def with_resilience(self, retry=None, bad_records: str = "fail",
                        quarantine_path=None, max_bad_records: int = 1000):
        raise NotImplementedError(
            "ingestion retry and the bad-record quarantine policy are not "
            "ported yet (ROADMAP Queue A item 6: readers/resilience.py)")


class RecordsReader(Reader):
    """Wraps a list of dict (or attribute) records; every feature reads
    its value through its generator (``r.get(name)`` or its extractor).
    ``key_fn`` maps a record to its entity key: the dataset then has a
    ``key`` ID column of ``str(key_fn(record))``."""

    def __init__(self, records: Sequence[Any],
                 key_fn: Optional[Callable[[Any], Any]] = None):
        self.records = list(records)
        self.key_fn = key_fn

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        cols = {f.name: f.origin_stage.extract_column(self.records)
                for f in raw_features}
        if self.key_fn is not None:
            cols["key"] = FeatureColumn.from_values(
                ID, [str(self.key_fn(r)) for r in self.records])
        return ColumnarDataset(cols)


class DataFrameReader(Reader):
    """Wraps an in-memory pandas DataFrame; features read their column by
    name, or through their ``extract_fn`` over the frame's records.
    ``key_col`` names the frame's entity-key column for the joins; as in
    the JAX package, the dataset itself does not carry it."""

    def __init__(self, df, key_col: Optional[str] = None):
        self.df = df
        self.key_col = key_col

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
    if isinstance(data, (list, tuple)):
        return RecordsReader(data)
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(data, pd.DataFrame):
        return DataFrameReader(data)
    raise TypeError(f"cannot build a reader from {type(data)}")
