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

``iter_chunks`` parses a bounded number of rows at a time (the
``csv`` module over the file's lines, one JSON line at a time): a chunk's
columns equal the same rows of the whole-file read, and ``bytes_read``
follows the file position.

Bad records (``Reader.with_resilience``, readers/resilience.py): a CSV
row with more fields than the header raises, or under the quarantine
policy goes to the sidecar as ``bad-line#k`` (its ordinal among the
file's bad rows, as the JAX reader's pandas ``on_bad_lines`` callback
numbers them); an invalid JSON line raises ``BadRecordError`` naming its
line and byte offset, or goes to the sidecar under that location.
``ParquetReader`` raises ``NotImplementedError`` (ROADMAP Queue A item
6.3).  The JAX readers' ``key_col`` is not taken: it has no effect there
either.
"""
from __future__ import annotations

import csv
import itertools
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..types.columns import ColumnarDataset, FeatureColumn
from .base import (ChunkStream, Reader, RecordsReader, _check_chunk_rows,
                   _stream)
from .resilience import BadRecordError

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


def _as_int(c: str) -> int:
    if not c.lstrip("+-").isdigit():
        raise ValueError(c)
    return int(c)


def infer_cells(cells: Sequence[str]) -> tuple:
    """(kind, values) of a column's cells typed as pandas' ``read_csv``
    types a column: ``"i"`` Python ints when every cell is an integer,
    ``"f"`` floats (NaN where missing) when every present cell is a
    number, ``"b"`` bools when every cell is a boolean, else ``"O"`` the
    text with NaN where missing (a boolean column with a missing cell is
    text too, as pandas gives an object column of True/False/NaN)."""
    present = [c for c in cells if c not in NA_STRINGS]
    nan = float("nan")
    if present and len(present) == len(cells):
        try:
            return "i", [_as_int(c) for c in cells]
        except ValueError:
            pass
    if present and all(c in _BOOLS for c in present):
        vals = [nan if c in NA_STRINGS else bool(_BOOLS[c]) for c in cells]
        return ("b" if len(present) == len(cells) else "O"), vals
    try:
        return "f", _parse_floats(cells, "").tolist()
    except ValueError:
        pass
    return "O", [nan if c in NA_STRINGS else c for c in cells]


def _lines(fh):
    """The lines of a text file through ``readline``, which leaves
    ``tell()`` usable (iterating the file object disables it)."""
    while True:
        line = fh.readline()
        if not line:
            return
        yield line


def _nonblank(row: List[str]) -> bool:
    return len(row) > 1 or bool(row and row[0].strip())


class CSVReader(Reader):
    """CSV with a header row, or without one and ``column_names``; with
    ``skip_initial_space`` spaces after a delimiter are skipped.
    ``iter_chunks`` parses ``chunk_rows`` rows at a time, each chunk's
    cells read as the whole file's are, and counts the bytes read up to
    the chunk's last row."""

    skip_initial_space = False

    def __init__(self, path: str, column_names: Optional[List[str]] = None,
                 has_header: bool = True):
        self.path = path
        self.column_names = column_names
        self.has_header = has_header

    def _tables(self, chunk_rows: Optional[int], pos: Optional[dict] = None):
        """({column name: its cells}, rows) per ``chunk_rows`` data rows
        (all of them at once for None); a short row's missing cells are
        empty (an NA string).  ``pos["bytes"]`` follows the file position
        after each table's last row."""
        with open(self.path, newline="", encoding="utf-8-sig") as fh:
            reader = csv.reader(_lines(fh),
                                skipinitialspace=self.skip_initial_space)
            header = next(reader, []) if self.has_header else None
            rows = filter(_nonblank, reader)
            if header is not None or self.column_names:
                rows = self._screen(rows, len(self._names(header, [])))
            names, offset = None, 0
            while True:
                batch = list(itertools.islice(rows, chunk_rows))
                if not batch and (chunk_rows is not None or names is not None):
                    return
                if pos is not None:
                    pos["bytes"] = fh.tell()
                if names is None:
                    names = self._names(header, batch)
                yield self._table(batch, names, offset), len(batch)
                offset += len(batch)
                if chunk_rows is None:
                    return

    def _screen(self, rows, width: int):
        """The rows, with those wider than the header sent to the
        quarantine sidecar under that policy (else left for ``_table`` to
        raise on)."""
        cfg = self.resilience
        if cfg is None or not cfg.quarantines:
            yield from rows
            return
        bad = 0
        for r in rows:
            if len(r) <= width:
                yield r
                continue
            cfg.handle_bad_record(self.path, f"bad-line#{bad}",
                                  f"malformed CSV row ({len(r)} fields)",
                                  record=[str(c) for c in r])
            bad += 1

    def _names(self, header, rows) -> List[str]:
        if header is None:
            header = (list(self.column_names) if self.column_names
                      else [str(i) for i in range(max(map(len, rows),
                                                      default=0))])
        names, seen = [], {}
        for n in header:   # pandas' renaming of repeated names: a, a.1
            k = seen.get(n, 0)
            seen[n] = k + 1
            names.append(n if k == 0 else f"{n}.{k}")
        return names

    def _table(self, rows: List[List[str]], names: List[str],
               offset: int) -> Dict[str, Sequence[str]]:
        width = len(names)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(
                    f"{self.path}: data row {offset + i} has {len(r)} "
                    f"fields, the header {width}")
            if len(r) < width:
                r += [""] * (width - len(r))
        cols = list(zip(*rows)) if rows else [()] * width
        return dict(zip(names, cols))

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        columns, n = next(self._tables(None))
        return self._dataset(columns, n, raw_features)

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range=None) -> ChunkStream:
        _check_chunk_rows(chunk_rows)
        pos = {"bytes": 0}
        gen = (self._dataset(columns, n, raw_features)
               for columns, n in self._tables(chunk_rows, pos))
        return _stream(gen, host_range, lambda: pos["bytes"])

    def _dataset(self, columns: Dict[str, Sequence[str]], n: int,
                 raw_features: Sequence[Feature]) -> ColumnarDataset:
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
            "ParquetReader is not ported yet (ROADMAP Queue A item 6.3: "
            "the rest of ingestion)")


class JSONLinesReader(Reader):
    """One JSON object a line; blank lines are skipped, a key a record
    lacks reads as missing.  ``iter_chunks`` holds at most ``chunk_rows``
    decoded records and counts the bytes of the lines read."""

    def __init__(self, path: str):
        self.path = path

    def _parse_line(self, raw: bytes, line_no: int, offset: int):
        """One record, or None when the bad line went to the quarantine
        sidecar; under the ``fail`` policy a bad line raises
        ``BadRecordError`` naming its line number and byte offset."""
        try:
            return json.loads(raw)
        except (ValueError, UnicodeDecodeError) as exc:
            cfg = self.resilience
            reason = f"invalid JSON: {exc}"
            location = f"line {line_no} (byte {offset})"
            if cfg is not None and cfg.quarantines:
                cfg.handle_bad_record(self.path, location, reason,
                                      record=raw.decode("utf-8", "replace"))
                return None
            raise BadRecordError(self.path, location, reason) from exc

    def _records(self, chunk_rows: Optional[int], pos: dict):
        records, offset = [], 0
        with open(self.path, "rb") as fh:
            for line_no, line in enumerate(fh, start=1):
                s = line.strip()
                if s:
                    rec = self._parse_line(s, line_no, offset)
                    if rec is not None:
                        records.append(rec)
                offset += len(line)
                if chunk_rows is not None and len(records) >= chunk_rows:
                    pos["bytes"] = offset
                    yield records
                    records = []
        pos["bytes"] = offset
        if records or chunk_rows is None:
            yield records

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        (records,) = self._records(None, {})
        return RecordsReader(records).generate_dataset(raw_features)

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range=None) -> ChunkStream:
        _check_chunk_rows(chunk_rows)
        pos = {"bytes": 0}
        gen = (RecordsReader(r).generate_dataset(raw_features)
               for r in self._records(chunk_rows, pos))
        return _stream(gen, host_range, lambda: pos["bytes"])


class DataReaders:
    """Factory catalogue (DataReaders.scala:44-270)."""

    class Aggregate:
        @staticmethod
        def records(source, key_fn, time_fn, cutoff=None,
                    predictor_window_ms=None, response_window_ms=None):
            from .aggregates import AggregateDataReader

            return AggregateDataReader(source, key_fn, time_fn, cutoff,
                                       predictor_window_ms,
                                       response_window_ms)

        @staticmethod
        def avro(path, key_fn, time_fn, cutoff=None,
                 predictor_window_ms=None, response_window_ms=None):
            """Aggregate reader over an Avro file's records
            (DataReaders.scala:108-130), decoded at the first read."""
            from .aggregates import AggregateDataReader
            from .avro import AvroReader

            return AggregateDataReader(AvroReader(path), key_fn, time_fn,
                                       cutoff, predictor_window_ms,
                                       response_window_ms)

    class Conditional:
        @staticmethod
        def records(source, key_fn, time_fn, target_condition,
                    drop_if_no_target=True, predictor_window_ms=None,
                    response_window_ms=None):
            from .aggregates import ConditionalDataReader

            return ConditionalDataReader(source, key_fn, time_fn,
                                         target_condition,
                                         drop_if_no_target,
                                         predictor_window_ms,
                                         response_window_ms)

        @staticmethod
        def avro(path, key_fn, time_fn, target_condition,
                 drop_if_no_target=True, predictor_window_ms=None,
                 response_window_ms=None):
            """Conditional reader over an Avro file's records
            (DataReaders.scala:214-248), decoded at the first read."""
            from .aggregates import ConditionalDataReader
            from .avro import AvroReader

            return ConditionalDataReader(AvroReader(path), key_fn, time_fn,
                                         target_condition, drop_if_no_target,
                                         predictor_window_ms,
                                         response_window_ms)

    @staticmethod
    def dataframe(df, key_col: Optional[str] = None):
        """Wrap an in-memory pandas DataFrame."""
        from .base import DataFrameReader

        return DataFrameReader(df, key_col)

    class Simple:
        @staticmethod
        def csv(path: str, column_names: Optional[List[str]] = None,
                has_header: bool = True) -> CSVReader:
            return CSVReader(path, column_names, has_header)

        @staticmethod
        def json_lines(path: str) -> JSONLinesReader:
            return JSONLinesReader(path)
