"""The port's pandas-free file readers against the JAX package's, on the
CPU.

Files are written from a numpy seed with NA strings (pandas' defaults,
quoted and not), quoted fields holding delimiters, quotes and newlines,
empty cells, short rows, blank lines, no header, and no response column.
Compared: the columns' null masks exactly, and their values at float32
for numeric features (pandas' float parser may round the last bit of a
float64 differently from Python's) and exactly for text features.  The
JAX reader's whole-file parse types a numeric-looking text column as
numbers; the port keeps the cell text, as the JAX reader's chunked parse
(which pins text columns to ``str``) does, so that file is compared with
the chunked parse.
"""
import csv
import json

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers import CSVReader as JCSVReader
from transmogrifai_tpu.readers import JSONLinesReader as JJSONLinesReader
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.readers.files import (NA_STRINGS, CSVAutoReader,
                                                   CSVReader, DataReaders,
                                                   JSONLinesReader,
                                                   ParquetReader)

N = 60


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _features(fb, text_name="color", with_label=True):
    feats = [fb.Real("x").as_predictor(), fb.Integral("k").as_predictor(),
             fb.Binary("flag").as_predictor(),
             fb.PickList(text_name).as_predictor()]
    if with_label:
        feats.append(fb.RealNN("label").as_response())
    return feats


def _cells(seed):
    """Rows of (x, k, flag, color, label) cells as text."""
    rng = np.random.default_rng(seed)
    na = sorted(NA_STRINGS)
    rows = []
    for i in range(N):
        x = repr(float(rng.normal() * 10.0 ** rng.integers(-3, 4)))
        k = str(int(rng.integers(-5, 100)))
        flag = ["True", "False", "true", "FALSE"][i % 4]
        color = ["red", "green, dark", 'say "hi"', "two\nlines", " pad "][
            i % 5]
        if rng.random() < 0.25:
            x = na[rng.integers(len(na))]
        if rng.random() < 0.2:
            k = na[rng.integers(len(na))]
        if rng.random() < 0.2:
            color = na[rng.integers(len(na))]
        rows.append([x, k, flag, color, str(float(i % 2))])
    return rows


def _write_csv(path, rows, header):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, quoting=csv.QUOTE_MINIMAL)
        if header:
            w.writerow(header)
        for i, r in enumerate(rows):
            w.writerow(r)
            if i == 7:
                f.write("\n")   # a blank line


def _assert_same(port_ds, jax_ds, names):
    for name in names:
        p, j = port_ds[name], jax_ds[name]
        if p.ftype.storage == "text":
            assert list(p.values) == list(j.values), name
            continue
        np.testing.assert_array_equal(p.mask, np.asarray(j.mask), name)
        np.testing.assert_array_equal(
            np.asarray(p.values, np.float32)[p.mask],
            np.asarray(j.values, np.float32)[np.asarray(j.mask)], name)


HEADER = ["x", "k", "flag", "color", "label"]


class TestCSV:
    def test_header_na_strings_quotes_match_jax(self, tmp_path):
        path = str(tmp_path / "a.csv")
        _write_csv(path, _cells(1), HEADER)
        port = CSVReader(path).generate_dataset(_features(FeatureBuilder))
        jax = JCSVReader(path).generate_dataset(_features(JFB))
        assert len(port) == len(jax) == N
        _assert_same(port, jax, HEADER)
        # every NA string, quoted or not, reads as missing
        assert not port["x"].mask.all() and not port["k"].mask.all()

    def test_headerless_matches_jax(self, tmp_path):
        path = str(tmp_path / "b.csv")
        _write_csv(path, _cells(2), None)
        port = CSVReader(path, column_names=HEADER, has_header=False)
        jax = JCSVReader(path, column_names=HEADER, has_header=False)
        _assert_same(port.generate_dataset(_features(FeatureBuilder)),
                     jax.generate_dataset(_features(JFB)), HEADER)

    def test_short_rows_and_empty_cells_are_missing(self, tmp_path):
        path = str(tmp_path / "c.csv")
        with open(path, "w") as f:
            f.write("x,k,flag,color,label\n1.5,,True,,0\n2.5,3\n,,,,1\n")
        port = CSVReader(path).generate_dataset(_features(FeatureBuilder))
        jax = JCSVReader(path).generate_dataset(_features(JFB))
        _assert_same(port, jax, HEADER)
        assert port["k"].mask.tolist() == [False, True, False]

    def test_missing_response_reads_as_missing(self, tmp_path):
        path = str(tmp_path / "d.csv")
        _write_csv(path, [r[:4] for r in _cells(3)], HEADER[:4])
        port = CSVReader(path).generate_dataset(_features(FeatureBuilder))
        assert not port["label"].mask.any()
        # the JAX CSV reader raises here; the predictors agree with its
        # read of the same file without the response feature
        jax = JCSVReader(path).generate_dataset(
            _features(JFB, with_label=False))
        _assert_same(port, jax, HEADER[:4])

    def test_missing_predictor_raises(self, tmp_path):
        path = str(tmp_path / "e.csv")
        _write_csv(path, [r[1:] for r in _cells(4)], HEADER[1:])
        with pytest.raises(KeyError, match="missing raw feature"):
            CSVReader(path).generate_dataset(_features(FeatureBuilder))

    def test_numeric_looking_text_keeps_cells_as_chunked_jax(self, tmp_path):
        path = str(tmp_path / "f.csv")
        rng = np.random.default_rng(5)
        rows = [[repr(float(rng.normal())), str(i), "True",
                 ["01", "7", "NA", "3.50"][i % 4], "1.0"] for i in range(N)]
        _write_csv(path, rows, HEADER)
        port = CSVReader(path).generate_dataset(_features(FeatureBuilder))
        (jax,) = list(JCSVReader(path).iter_chunks(_features(JFB), 10 ** 6))
        _assert_same(port, jax, HEADER)
        assert list(port["color"].values[:4]) == ["01", "7", None, "3.50"]

    def test_extractor_features_get_typed_records(self, tmp_path):
        path = str(tmp_path / "g.csv")
        _write_csv(path, _cells(6), HEADER)
        port = CSVReader(path).generate_dataset([
            FeatureBuilder.Real("twice").extract(
                lambda r: None if np.isnan(r["x"]) else 2 * r["x"])
            .as_predictor()])
        plain = CSVReader(path).generate_dataset(_features(FeatureBuilder))
        m = plain["x"].mask
        np.testing.assert_array_equal(port["twice"].mask, m)
        np.testing.assert_array_equal(port["twice"].values[m],
                                      2 * plain["x"].values[m])

    def test_factories_and_what_is_not_ported(self, tmp_path):
        path = str(tmp_path / "h.csv")
        _write_csv(path, _cells(7), HEADER)
        assert isinstance(DataReaders.Simple.csv(path), CSVReader)
        assert issubclass(CSVAutoReader, CSVReader)
        # Parquet is ported (tests/test_torch_parquet.py); its factory
        # takes the JAX reader's key_col
        pr = DataReaders.Simple.parquet(path, key_col="id")
        assert isinstance(pr, ParquetReader) and pr.key_col == "id"
        with pytest.raises(ValueError, match="quarantine"):
            CSVReader(path).with_resilience(bad_records="quarantine")
        # the JAX readers' key_col has no effect there: the port does not
        # take it, so setting it fails instead of being ignored
        for make in (CSVReader, DataReaders.Simple.csv, JSONLinesReader,
                     DataReaders.Simple.json_lines):
            with pytest.raises(TypeError, match="key_col"):
                make(path, key_col="id")


class TestJSONLines:
    def _write(self, path, seed):
        rng = np.random.default_rng(seed)
        with open(path, "w") as f:
            for i in range(N):
                rec = {"x": float(rng.normal()), "k": int(rng.integers(9)),
                       "flag": bool(i % 2), "color": ["a", "b", None][i % 3],
                       "label": float(i % 2)}
                if i % 5 == 0:
                    del rec["x"]
                if i % 7 == 0:
                    rec["k"] = None
                if i % 11 == 0:
                    del rec["label"]
                f.write(json.dumps(rec) + "\n")
                if i == 3:
                    f.write("\n")

    def test_matches_jax(self, tmp_path):
        path = str(tmp_path / "a.jsonl")
        self._write(path, 8)
        port = JSONLinesReader(path).generate_dataset(
            _features(FeatureBuilder))
        jax = JJSONLinesReader(path).generate_dataset(_features(JFB))
        _assert_same(port, jax, HEADER)
        assert not port["label"].mask[0]   # a record without the response

    def test_bad_line_names_line_and_offset(self, tmp_path):
        path = str(tmp_path / "b.jsonl")
        with open(path, "w") as f:
            f.write('{"x": 1.0}\n{not json\n')
        with pytest.raises(ValueError, match=r"line 2 \(byte 11\)"):
            DataReaders.Simple.json_lines(path).generate_dataset(
                [FeatureBuilder.Real("x").as_predictor()])
