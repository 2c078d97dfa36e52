"""Problem-schema inference from a sample dataset (counterpart of
``transmogrifai_tpu.cli.schema``), with no pandas.

Reference: ``gen/ProblemSchema.scala:51-99`` (schema + response/id fields
-> ProblemSchema), ``gen/ProblemKind.scala:36-66`` (binary, multiclass,
regression).  The sample's columns are typed as pandas' ``read_csv`` /
``read_json`` type them (``readers/files.infer_cells`` for CSV cells;
for JSON, numeric text as numbers and all-integral numbers as integers),
then mapped to feature types by the
rules of the JAX package's ``infer_schema_from_pandas``: booleans Binary,
integers Integral (Binary when only 0 and 1 occur), floats Real, other
columns PickList up to max(50, 10% of the rows) distinct values, else
Text.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from ..readers.files import CSVReader, infer_cells
from ..types import feature_types as ft

__all__ = ["ProblemKind", "ProblemSchema", "infer_problem_kind",
           "infer_schema", "read_sample"]


class ProblemKind(enum.Enum):
    BinaryClassification = "BinaryClassification"
    MultiClassification = "MultiClassification"
    Regression = "Regression"


def _missing(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def value_kind(values: Sequence[Any]) -> str:
    """The pandas dtype kind of a column of Python values: ``"b"`` all
    booleans, ``"i"`` all integers, ``"f"`` numbers (or integers with a
    missing value), else ``"O"``."""
    present = [v for v in values if not _missing(v)]
    complete = len(present) == len(values)
    if present and all(isinstance(v, bool) for v in present):
        return "b" if complete else "O"
    if all(isinstance(v, (int, float)) and not isinstance(v, bool)
           for v in present):
        if complete and present and all(isinstance(v, int)
                                        for v in present):
            return "i"
        return "f"
    return "O"


def _json_column(values: Sequence[Any]) -> Tuple[str, list]:
    """(kind, values) of a JSON column as pandas' ``read_json`` types it:
    numeric text converts to numbers, and numbers that are all integral
    and present become integers."""
    vals = [float("nan") if v is None else v for v in values]
    present = [v for v in vals if not _missing(v)]
    if present and all(isinstance(v, str) for v in present):
        try:
            vals = [v if _missing(v) else float(v) for v in vals]
        except ValueError:
            return "O", vals
    kind = value_kind(vals)
    if kind in ("i", "f") and len(present) == len(vals) and all(
            float(v).is_integer() for v in vals):
        return "i", [int(v) for v in vals]
    return kind, vals


def _distinct(values: Sequence[Any]) -> set:
    return {v for v in values if not _missing(v)}


def _column_type(kind: str, values: Sequence[Any],
                 n_rows: int) -> Type[ft.FeatureType]:
    if kind == "b":
        return ft.Binary
    if kind == "i":
        d = _distinct(values)
        return ft.Binary if len(d) <= 2 and d <= {0, 1} else ft.Integral
    if kind == "f":
        return ft.Real
    return (ft.PickList if len(_distinct(values)) <= max(50, 0.1 * n_rows)
            else ft.Text)


def infer_problem_kind(values) -> ProblemKind:
    """The response column's problem kind (ProblemKind.scala, auto mode):
    at most 2 distinct values -> binary; non-integral floats ->
    regression; numbers with at most 30 distinct values -> multiclass,
    more -> regression; text -> multiclass.  ``values``: a sequence of
    Python values (or anything with ``tolist()``)."""
    vals = list(values.tolist() if hasattr(values, "tolist") else values)
    kind = value_kind(vals)
    present = [v for v in vals if not _missing(v)]
    nunique = len(set(present))
    if nunique <= 2:
        return ProblemKind.BinaryClassification
    if kind == "f" and any(v != int(v) for v in present):
        return ProblemKind.Regression
    if kind in ("i", "f"):
        return (ProblemKind.MultiClassification if nunique <= 30
                else ProblemKind.Regression)
    return ProblemKind.MultiClassification


def read_sample(path: str, columns: Optional[List[str]] = None
                ) -> Tuple[Dict[str, Tuple[str, list]], int]:
    """({column: (kind, values)}, rows) of a CSV (with a header, or
    headerless with ``columns``), JSON-lines or JSON-array file."""
    if path.endswith(".parquet"):
        raise NotImplementedError(
            "Parquet samples are not ported (ROADMAP Queue A item 6.3)")
    if path.endswith((".json", ".jsonl")):
        with open(path) as fh:
            if path.endswith(".jsonl"):
                records = [json.loads(line) for line in fh if line.strip()]
            else:
                records = json.load(fh)
        names: List[str] = []
        for r in records:
            names += [k for k in r if k not in names]
        return {k: _json_column([r.get(k) for r in records])
                for k in names}, len(records)
    reader = (CSVReader(path, column_names=list(columns), has_header=False)
              if columns else CSVReader(path))
    table, n = next(reader._tables(None))
    return {k: infer_cells(cells) for k, cells in table.items()}, n


def infer_schema(sample: Dict[str, Tuple[str, list]], n_rows: int
                 ) -> Dict[str, Type[ft.FeatureType]]:
    """{column: feature type} of a sample read by ``read_sample``."""
    return {name: _column_type(kind, vals, max(n_rows, 1))
            for name, (kind, vals) in sample.items()}


@dataclasses.dataclass
class ProblemSchema:
    """Everything codegen needs (gen/ProblemSchema.scala:51-60)."""

    name: str
    kind: ProblemKind
    response: str
    id_field: str
    #: column name -> semantic feature type, response/id excluded
    features: Dict[str, Type[ft.FeatureType]]
    input_path: Optional[str] = None
    #: column names for headerless CSVs
    columns: Optional[List[str]] = None
    #: the response's levels in order of first appearance when the sample
    #: holds it as text (the generated reader recodes it to 0..K-1)
    response_levels: Optional[List[str]] = None

    @classmethod
    def from_file(cls, name: str, path: str, response: str, id_field: str,
                  overrides: Optional[Dict[str, str]] = None,
                  kind: Optional[str] = None,
                  columns: Optional[List[str]] = None) -> "ProblemSchema":
        sample, n = read_sample(path, columns)
        for col in (response, id_field):
            if col not in sample:
                raise ValueError(f"column {col!r} not in {sorted(sample)}")
        schema = infer_schema(sample, n)
        if overrides:
            by_lower = {t.__name__.lower(): t for t in ft.all_feature_types()}
            for col, tname in overrides.items():
                try:
                    schema[col] = by_lower[tname.replace("_", "").lower()]
                except KeyError:
                    raise ValueError(
                        f"unknown feature type {tname!r} for column {col!r}")
        features = {c: t for c, t in schema.items()
                    if c not in (response, id_field)}
        rkind, rvals = sample[response]
        problem = (ProblemKind(kind) if kind
                   else infer_problem_kind(rvals))
        levels = None
        if rkind == "O":
            levels = list(dict.fromkeys(
                str(v) for v in rvals if not _missing(v)))
        return cls(name=name, kind=problem, response=response,
                   id_field=id_field, features=features, input_path=path,
                   columns=list(columns) if columns else None,
                   response_levels=levels)

    @property
    def feature_lines(self) -> List[str]:
        return [f'    "{c}": ft.{t.__name__},'
                for c, t in sorted(self.features.items())]
