"""File readers: CSV (with or without a header) and JSON lines
(counterpart of ``transmogrifai_tpu.readers.files``), with no pandas: the
standard ``csv`` and ``json`` modules parse, and the rules below give the
columns, values and null masks the JAX package's pandas-based readers
give.

CSV rules (pandas ``read_csv`` defaults):
 * a cell equal to one of pandas' default NA strings (``NA_STRINGS``: the
   empty string, ``NA``, ``N/A``, ``NaN``, ``nan``, ``null``, ``NULL``,
   ``None``, ``<NA>``, ``#N/A``, ``n/a``, ...) is missing, quoted or not,
   for numeric and text features alike;
 * quoted fields, embedded delimiters, doubled quotes and newlines inside
   quotes follow the csv module (the same dialect as pandas); blank lines
   are skipped; a short row's missing cells are missing;
 * a numeric feature's cell parses as a float (``True``/``TRUE``/``true``
   and the ``False`` forms as 1 and 0, as pandas' boolean columns give);
   pandas' own float parser may round the last bit of a float64
   differently, which the float32 feature matrix does not see;
 * a text feature keeps the cell's text: the JAX reader's chunked parse
   pins text columns to ``str`` (``_text_dtype_overrides``); its
   whole-file parse types a numeric-looking text column as numbers first
   ("01" reads "1" there, "1" beside a missing cell "1.0");
 * an absent response column reads as all missing (as a JSON-lines record
   without the key does); an absent predictor column raises ``KeyError``;
 * a feature with an extractor gets one record per row, numeric-looking
   columns as floats (``NaN`` where missing), others as text (``None``).

``ParquetReader`` and the quarantine policy raise ``NotImplementedError``.
The JAX readers' ``key_col`` is not taken: it has no effect there either.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from .base import Reader, RecordsReader

__all__ = ["CSVReader", "CSVAutoReader", "ParquetReader", "JSONLinesReader",
           "DataReaders", "NA_STRINGS"]

#: pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_BOOLS = {"True": 1.0, "TRUE": 1.0, "true": 1.0,
          "False": 0.0, "FALSE": 0.0, "false": 0.0}


def _parse_floats(cells: Sequence[str], name: str) -> np.ndarray:
    """A column's cells as float64, NaN where missing."""
    if not NA_STRINGS.isdisjoint(cells):
        cells = ["nan" if c in NA_STRINGS else c for c in cells]
    try:
        return np.fromiter(map(float, cells), np.float64, len(cells))
    except ValueError:
        pass
    out = np.full(len(cells), np.nan)   # boolean cells, or a bad one
    for i, c in enumerate(cells):
        b = _BOOLS.get(c)
        try:
            out[i] = b if b is not None else float(c)
        except ValueError:
            raise ValueError(f"column {name!r}, data row {i}: {c!r} is "
                             f"not a number") from None
    return out


def _text(cells: Sequence[str]) -> list:
    return [None if c in NA_STRINGS else c for c in cells]


def _record_values(cells: Sequence[str]) -> list:
    """A column's values for per-record extraction: floats when every
    present cell is numeric, else the text."""
    try:
        return list(_parse_floats(cells, ""))
    except ValueError:
        return _text(cells)


class CSVReader(Reader):
    """CSV with a header row, or without one and ``column_names``; with
    ``skip_initial_space`` spaces after a delimiter are skipped."""

    skip_initial_space = False

    def __init__(self, path: str, column_names: Optional[List[str]] = None,
                 has_header: bool = True):
        self.path = path
        self.column_names = column_names
        self.has_header = has_header

    def _columns(self) -> Dict[str, Sequence[str]]:
        """{column name: its cells}; a short row's missing cells are
        empty (an NA string)."""
        with open(self.path, newline="", encoding="utf-8-sig") as fh:
            reader = csv.reader(fh,
                                skipinitialspace=self.skip_initial_space)
            header = next(reader, []) if self.has_header else None
            rows = [r for r in reader
                    if len(r) > 1 or (r and r[0].strip())]
        if header is None:
            header = (list(self.column_names) if self.column_names
                      else [str(i) for i in range(max(map(len, rows),
                                                      default=0))])
        names, seen = [], {}
        for n in header:   # pandas' renaming of repeated names: a, a.1
            k = seen.get(n, 0)
            seen[n] = k + 1
            names.append(n if k == 0 else f"{n}.{k}")
        width = len(names)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(
                    f"{self.path}: data row {i} has {len(r)} fields, the "
                    f"header {width}")
            if len(r) < width:
                r += [""] * (width - len(r))
        cols = list(zip(*rows)) if rows else [()] * width
        return dict(zip(names, cols))

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        columns = self._columns()
        n = len(next(iter(columns.values()), []))
        missing = [f.name for f in raw_features
                   if f.origin_stage.extract_fn is None
                   and f.name not in columns and not f.is_response]
        if missing:
            raise KeyError(
                f"input data is missing raw feature column(s) {missing}")
        records = None
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            gen = f.origin_stage
            if gen.extract_fn is not None:
                if records is None:
                    parsed = {k: _record_values(v)
                              for k, v in columns.items()}
                    records = [{k: v[i] for k, v in parsed.items()}
                               for i in range(n)]
                cols[f.name] = gen.extract_column(records)
                continue
            cells = columns.get(f.name, ("",) * n)
            if f.ftype.storage == "text":
                cols[f.name] = FeatureColumn.from_values(f.ftype,
                                                         _text(cells))
            else:
                cols[f.name] = FeatureColumn.from_values(
                    f.ftype, _parse_floats(cells, f.name))
        return ColumnarDataset(cols)


class CSVAutoReader(CSVReader):
    """Schema-inferring CSV reader (CSVAutoReaders.scala:57): the features
    type the columns."""


class ParquetReader(Reader):
    def __init__(self, path: str):
        raise NotImplementedError(
            "ParquetReader is not ported yet (ROADMAP Queue A item 6: the "
            "rest of ingestion)")


class JSONLinesReader(Reader):
    """One JSON object a line; blank lines are skipped, a key a record
    lacks reads as missing."""

    def __init__(self, path: str):
        self.path = path

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        records, offset = [], 0
        with open(self.path, "rb") as fh:
            for line_no, line in enumerate(fh, start=1):
                s = line.strip()
                if s:
                    try:
                        records.append(json.loads(s))
                    except (ValueError, UnicodeDecodeError) as exc:
                        raise ValueError(
                            f"{self.path}: line {line_no} (byte {offset}): "
                            f"invalid JSON: {exc}") from exc
                offset += len(line)
        return RecordsReader(records).generate_dataset(raw_features)


class DataReaders:
    """Factory catalogue (DataReaders.scala:44-270), the ported readers."""

    class Simple:
        @staticmethod
        def csv(path: str, column_names: Optional[List[str]] = None,
                has_header: bool = True) -> CSVReader:
            return CSVReader(path, column_names, has_header)

        @staticmethod
        def json_lines(path: str) -> JSONLinesReader:
            return JSONLinesReader(path)
