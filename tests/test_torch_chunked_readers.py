"""Chunked ingestion in the port (``iter_chunks`` of every reader,
``iter_avro_blocks`` and the ``AsyncBatcher`` prefetcher) against the
whole-file reads and the JAX package's chunked readers, on the CPU.

Every chunk's columns equal the same rows of the whole read, and the JAX
package's chunk of the same rows: values, masks and text exactly (numeric
cells through float32, as ``tests/test_torch_readers.py`` holds the
CSV parse: pandas' float parser may round a float64's last bit
differently).  The CSV carries a numeric column that is empty for whole
chunks, and quoted cells holding commas and newlines.  Avro blocks of 13
records are cut by chunks of 7 and 61 rows.  ``bytes_read`` follows the
file position: it ends at the file's size (CSV, JSON lines, Avro), grows
with every chunk, and the port's Avro positions equal the JAX package's
(its CSV reader's position is pandas' read-ahead buffer's)."""
import csv
import json
import os
import threading
import time

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers import avro as ja
from transmogrifai_tpu.readers.base import RecordsReader as JRecordsReader
from transmogrifai_tpu.readers.files import CSVReader as JCSVReader
from transmogrifai_tpu.readers.files import JSONLinesReader as JJSONL
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.readers import avro as pa
from transmogrifai_tpu_torch.readers.base import (DataFrameReader,
                                                  RecordsReader, reader_for)
from transmogrifai_tpu_torch.readers.files import CSVReader, JSONLinesReader
from transmogrifai_tpu_torch.readers.streaming import AsyncBatcher
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import (ColumnarDataset,
                                                   FeatureColumn)

N = 200
NAMES = ["x", "sparse", "k", "color", "note", "label"]
SCHEMA = {"type": "record", "name": "R", "fields": [
    {"name": "id", "type": "long"},
    {"name": "x", "type": ["null", "double"]},
    {"name": "k", "type": ["null", "long"]},
    {"name": "color", "type": ["null", "string"]},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "label", "type": ["null", "double"]}]}


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _features(fb):
    return [fb.Real("x").as_predictor(), fb.Real("sparse").as_predictor(),
            fb.Integral("k").as_predictor(),
            fb.PickList("color").as_predictor(),
            fb.Text("note").as_predictor(),
            fb.RealNN("label").as_response()]


def _rows(seed=3):
    """CSV rows: ``sparse`` empty outside rows 100..109 (so whole chunks
    of it are empty), quoted notes with commas and newlines, NA strings."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N):
        out.append([
            "NA" if i % 9 == 0 else repr(float(rng.normal())),
            repr(float(i)) if 100 <= i < 110 else "",
            "" if i % 7 == 0 else str(int(rng.integers(0, 5))),
            ["red", "green", "", "blue"][i % 4],
            f"line {i}, with a comma\nand a newline" if i % 5 == 0
            else f"n{i}",
            str(float(i % 2))])
    return out


def _write_csv(path):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(NAMES)
        w.writerows(_rows())


def _same(a, b, name):
    """Column ``a`` of the port against ``b`` (the port's whole read or
    the JAX package's chunk)."""
    av, bv = np.asarray(a.values), np.asarray(b.values)
    if a.ftype.storage in ("text", "text_list", "map"):
        assert list(av) == list(bv), name
        return
    np.testing.assert_array_equal(a.mask, np.asarray(b.mask), name)
    np.testing.assert_array_equal(av.astype(np.float32)[a.mask],
                                  bv.astype(np.float32)[np.asarray(b.mask)],
                                  name)


def _check_chunks(stream, whole, chunk_rows, names, jax_chunks=None):
    """Every chunk equals the whole read's rows (and the JAX chunk);
    returns the bytes_read seen after each chunk."""
    offset, seen = 0, []
    jax_chunks = list(jax_chunks) if jax_chunks is not None else None
    for i, chunk in enumerate(stream):
        n = len(chunk)
        assert n == min(chunk_rows, len(whole) - offset)
        for name in names:
            _same(chunk[name], whole[name].slice(offset, offset + n), name)
            if jax_chunks is not None:
                _same(chunk[name], jax_chunks[i][name], name)
        offset += n
        seen.append(stream.bytes_read)
    assert offset == len(whole)
    if jax_chunks is not None:
        assert len(jax_chunks) == len(seen)
    return seen


@pytest.mark.parametrize("chunk_rows", [7, 61])
def test_csv_chunks_equal_whole_and_jax(tmp_path, chunk_rows):
    path = str(tmp_path / "a.csv")
    _write_csv(path)
    whole = CSVReader(path).generate_dataset(_features(FeatureBuilder))
    stream = CSVReader(path).iter_chunks(_features(FeatureBuilder),
                                         chunk_rows)
    jax = JCSVReader(path).iter_chunks(_features(JFB), chunk_rows)
    seen = _check_chunks(stream, whole, chunk_rows, NAMES, jax)
    assert seen == sorted(seen) and seen[-1] == os.path.getsize(path)
    assert len(set(seen)) == len(seen)
    # a chunk inside the empty stretch of ``sparse`` reads all missing
    first = next(iter(CSVReader(path).iter_chunks(_features(FeatureBuilder),
                                                  chunk_rows)))
    assert not first["sparse"].mask.any()


@pytest.mark.parametrize("chunk_rows", [7, 61])
def test_jsonl_chunks_equal_whole_and_jax(tmp_path, chunk_rows):
    path = str(tmp_path / "a.jsonl")
    recs = [{"x": None if r[0] == "NA" else float(r[0]),
             "k": None if r[2] == "" else int(r[2]),
             "color": r[3] or None, "note": r[4], "label": float(r[5])}
            for r in _rows()]
    with open(path, "w") as fh:
        for i, r in enumerate(recs):
            fh.write(json.dumps(r) + "\n")
            if i % 50 == 0:
                fh.write("\n")            # blank lines are skipped
    names = ["x", "k", "color", "note", "label"]
    feats = [f for f in _features(FeatureBuilder) if f.name in names]
    whole = JSONLinesReader(path).generate_dataset(feats)
    stream = JSONLinesReader(path).iter_chunks(feats, chunk_rows)
    jstream = JJSONL(path).iter_chunks(
        [f for f in _features(JFB) if f.name in names], chunk_rows)
    seen = _check_chunks(stream, whole, chunk_rows, names, jstream)
    assert seen[-1] == os.path.getsize(path)
    assert seen == [jb for jb in _bytes_of(JJSONL(path).iter_chunks(
        [f for f in _features(JFB) if f.name in names], chunk_rows))]


def _bytes_of(stream):
    for _ in stream:
        yield stream.bytes_read


def _avro_records(n=N, seed=6):
    rng = np.random.default_rng(seed)
    return [{"id": i, "x": None if i % 9 == 0 else float(rng.normal()),
             "k": None if i % 7 == 0 else int(rng.integers(0, 5)),
             "color": [None, "red", "green"][i % 3],
             "tags": [f"t{j}" for j in range(i % 3)],
             "label": float(i % 2)} for i in range(n)]


def _avro_features(fb):
    return [fb.Real("x").as_predictor(), fb.Integral("k").as_predictor(),
            fb.PickList("color").as_predictor(),
            fb.TextList("tags").as_predictor(),
            fb.RealNN("label").as_response()]


@pytest.mark.parametrize("chunk_rows", [7, 61])
def test_avro_chunks_cut_across_blocks(tmp_path, chunk_rows):
    path = str(tmp_path / "a.avro")
    # blocks of 13 records: co-prime to both chunk sizes
    pa.write_avro(path, SCHEMA, _avro_records(), block_records=13)
    names = ["x", "k", "color", "tags", "label", "key"]
    reader = pa.AvroReader(path, key_field="id")
    whole = reader.generate_dataset(_avro_features(FeatureBuilder))
    stream = pa.AvroReader(path, key_field="id").iter_chunks(
        _avro_features(FeatureBuilder), chunk_rows)
    jstream = ja.AvroReader(path, key_field="id").iter_chunks(
        _avro_features(JFB), chunk_rows)
    seen = _check_chunks(stream, whole, chunk_rows, names, jstream)
    assert seen[-1] == os.path.getsize(path)
    assert seen == list(_bytes_of(ja.AvroReader(path).iter_chunks(
        _avro_features(JFB), chunk_rows)))
    # the block stream: the records and positions of the JAX package's
    got = list(pa.iter_avro_blocks(path))
    want = list(ja.iter_avro_blocks(path))
    assert [r for _, rs in got for r in rs] == [r for _, rs in want
                                                for r in rs]
    assert [len(rs) for _, rs in got] == [13] * 15 + [5]


def test_schema_csv_chunks_equal_whole(tmp_path):
    schema = {"type": "record", "name": "P", "fields": [
        {"name": "PassengerId", "type": "long"},
        {"name": "Survived", "type": ["null", "double"]},
        {"name": "Sex", "type": ["null", "string"]},
        {"name": "Age", "type": ["null", "double"]}]}
    avsc = tmp_path / "p.avsc"
    avsc.write_text(json.dumps(schema))
    rng = np.random.default_rng(5)
    lines = [f"{i + 1}, {float(i % 2)}, {['male', 'female', ''][i % 3]}, "
             f"{'' if i % 6 == 0 else f'{rng.normal(30, 9):.3f}'}"
             for i in range(120)]
    path = tmp_path / "p.csv"
    path.write_text("\n".join(lines) + "\n")

    def feats(fb):
        return [fb.RealNN("Survived").as_response(),
                fb.PickList("Sex").as_predictor(),
                fb.Real("Age").as_predictor()]

    reader = pa.AvroSchemaCSVReader(str(path), str(avsc),
                                    key_field="PassengerId")
    whole = reader.generate_dataset(feats(FeatureBuilder))
    jstream = ja.AvroSchemaCSVReader(str(path), str(avsc),
                                     key_field="PassengerId").iter_chunks(
        feats(JFB), 7)
    seen = _check_chunks(reader.iter_chunks(feats(FeatureBuilder), 7),
                         whole, 7, ["Survived", "Sex", "Age", "key"],
                         jstream)
    assert seen[-1] == os.path.getsize(path)


@pytest.mark.parametrize("chunk_rows", [7, 61])
def test_records_and_frames_chunk_as_jax(chunk_rows):
    recs = [{"x": float(i), "color": ["a", None][i % 2], "label": 1.0}
            for i in range(N)]
    names = ["x", "color", "label"]

    def feats(fb):
        return [fb.Real("x").as_predictor(),
                fb.PickList("color").as_predictor(),
                fb.RealNN("label").as_response()]

    whole = RecordsReader(recs).generate_dataset(feats(FeatureBuilder))
    _check_chunks(RecordsReader(recs).iter_chunks(feats(FeatureBuilder),
                                                  chunk_rows),
                  whole, chunk_rows, names,
                  JRecordsReader(recs).iter_chunks(feats(JFB), chunk_rows))
    # a dataset passthrough and a pandas frame slice the same rows
    _check_chunks(reader_for(whole).iter_chunks(feats(FeatureBuilder),
                                                chunk_rows),
                  whole, chunk_rows, names)
    pd = pytest.importorskip("pandas")
    frame = DataFrameReader(pd.DataFrame(recs))
    _check_chunks(frame.iter_chunks(feats(FeatureBuilder), chunk_rows),
                  frame.generate_dataset(feats(FeatureBuilder)),
                  chunk_rows, names)


def test_host_range_windows_the_stream():
    recs = [{"x": float(i)} for i in range(50)]
    feats = [FeatureBuilder.Real("x").as_predictor()]
    chunks = list(RecordsReader(recs).iter_chunks(feats, 7,
                                                  host_range=(10, 33)))
    assert [len(c) for c in chunks] == [4, 7, 7, 5]
    np.testing.assert_array_equal(
        np.concatenate([c["x"].values for c in chunks]), np.arange(10, 33))


def test_chunk_rows_must_be_positive(tmp_path):
    path = str(tmp_path / "a.csv")
    _write_csv(path)
    apath = str(tmp_path / "a.avro")
    pa.write_avro(apath, SCHEMA, _avro_records(5))
    jpath = str(tmp_path / "a.jsonl")
    with open(jpath, "w") as fh:
        fh.write('{"x": 1.0}\n')
    feats = [FeatureBuilder.Real("x").as_predictor()]
    ds = ColumnarDataset({"x": FeatureColumn.from_values(ft.Real, [1.0])})
    for reader in (CSVReader(path), JSONLinesReader(jpath),
                   pa.AvroReader(apath), RecordsReader([{"x": 1.0}]),
                   reader_for(ds)):
        for bad in (0, -3):
            with pytest.raises(ValueError, match="chunk_rows"):
                reader.iter_chunks(feats, bad)


def test_async_batcher_reraises_after_the_items_before():
    def source():
        yield 1
        yield 2
        raise OSError("disk went away")

    batcher = AsyncBatcher(source(), depth=1)
    got = []
    with pytest.raises(OSError, match="disk went away"):
        for item in batcher:
            got.append(item)
    assert got == [1, 2]
    with pytest.raises(StopIteration):
        next(batcher)


def test_async_batcher_pump_leaves_when_the_consumer_does():
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield i

    batcher = AsyncBatcher(source(), depth=2)
    assert next(batcher) == 0
    batcher.close()
    batcher._thread.join(timeout=5)
    assert not batcher._thread.is_alive()
    assert len(produced) < 10


def test_async_batcher_parses_on_its_own_thread():
    threads = []

    def source():
        for i in range(3):
            threads.append(threading.get_ident())
            time.sleep(0.01)
            yield i

    assert list(AsyncBatcher(source())) == [0, 1, 2]
    assert set(threads) == {threads[0]} != {threading.get_ident()}
