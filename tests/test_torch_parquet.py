"""``ParquetReader`` of the port against the JAX package's, on the CPU,
on Parquet files written by pyarrow under ``tmp_path``.

The JAX reader reads the frame pandas' ``to_pandas()`` gives, so the
port types each Arrow column as pandas does; one case a typing rule,
whole-file and a record batch at a time (``iter_chunks``, where each
batch is typed on its own, as ``batch.to_pandas()`` types it):
an integer column with nulls (float64 with NaN: a Text feature reads
"1.0"), an integer column without, a boolean column with nulls (objects),
timestamps (their ``str``, "NaT" for a null; a numeric feature raises
``TypeError`` in both), dictionary-encoded strings (pandas' category),
plain strings and float32.  Values and masks must be equal.  Also:
``estimate_rows`` (the footer), ``FileStreamingReader`` on a ``.parquet``
file, the CLI's schema from a Parquet sample, the ``DataReaders``
factory, and the ``ImportError`` naming pyarrow without it.
"""
import datetime
import sys

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import transmogrifai_tpu_torch as tt
from test_torch_text import JAX, PORT, assert_same_column
from transmogrifai_tpu import cli as jcli
from transmogrifai_tpu.readers import files as jfiles
from transmogrifai_tpu.readers import streaming as jstreaming
from transmogrifai_tpu_torch import cli as pcli
from transmogrifai_tpu_torch.readers import files as pfiles
from transmogrifai_tpu_torch.readers import streaming as pstreaming

N = 50
CHUNK = 16


@pytest.fixture(autouse=True)
def _cpu():
    tt.set_device("cpu")


def _table(seed=5):
    """One column a typing case; a null every few rows, except in the
    columns without nulls.  The first batch of ``int_nulls`` and
    ``bool_nulls`` holds their only nulls, so later batches type as the
    complete columns do."""
    rng = np.random.default_rng(seed)
    some = [i % 7 == 3 for i in range(N)]
    early = [i in (2, 9) for i in range(N)]
    ints = rng.integers(0, 9, N).tolist()
    stamps = [datetime.datetime(2020, 1, 1) + datetime.timedelta(
        hours=int(h)) for h in rng.integers(0, 5000, N)]
    words = [str(w) for w in rng.choice(["red", "green", "blue"], N)]
    return pa.table({
        "id": pa.array(range(N), pa.int64()),
        "int_nulls": pa.array([None if e else v
                               for e, v in zip(early, ints)], pa.int64()),
        "int_full": pa.array(ints, pa.int32()),
        "bool_nulls": pa.array([None if e else bool(v % 2)
                                for e, v in zip(early, ints)]),
        "stamps": pa.array([None if s else t for s, t in zip(some, stamps)],
                           pa.timestamp("ms")),
        "dict_text": pa.array([None if s else w for s, w in
                               zip(some, words)]).dictionary_encode(),
        "text": pa.array([None if s else w + str(i)
                          for i, (s, w) in enumerate(zip(some, words))]),
        "float32": pa.array([None if s else float(v) / 3 for s, v in
                             zip(some, ints)], pa.float32()),
        "label": pa.array([float(v % 2) for v in ints]),
    })


@pytest.fixture(scope="module")
def parquet_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pq") / "sample.parquet")
    pq.write_table(_table(), path, row_group_size=20)
    return path


def _features(pkg, specs):
    return [getattr(pkg["fb"], t)(name).as_predictor() for t, name in specs]


CASES = [
    ("int_nulls_as_integral", [("Integral", "int_nulls")]),
    ("int_nulls_as_text", [("Text", "int_nulls")]),
    ("int_full", [("Integral", "int_full"), ("Text", "int_full")]),
    ("bool_nulls", [("Binary", "bool_nulls"), ("Text", "bool_nulls")]),
    ("timestamps_as_text", [("Text", "stamps")]),
    ("dictionary_strings", [("PickList", "dict_text")]),
    ("strings", [("Text", "text")]),
    ("float32", [("Real", "float32"), ("Text", "float32")]),
]


@pytest.mark.parametrize("specs", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reader_types_as_the_jax_reader(parquet_path, specs):
    """Whole file and chunk by chunk, equal to the JAX ``ParquetReader``."""
    jr, pr = jfiles.ParquetReader(parquet_path), pfiles.ParquetReader(
        parquet_path)
    jf, pf = _features(JAX, specs), _features(PORT, specs)
    jds, pds = jr.generate_dataset(jf), pr.generate_dataset(pf)
    for f in pf:
        assert_same_column(pds[f.name], jds[f.name])
    jchunks = list(jr.iter_chunks(jf, CHUNK))
    pstream = pr.iter_chunks(pf, CHUNK)
    pchunks = list(pstream)
    # batches stop at the 20-row groups' ends, in both packages
    assert [len(c) for c in pchunks] == [len(c) for c in jchunks] == [
        16, 4, 12, 8, 8, 2]
    for jc, pc in zip(jchunks, pchunks):
        for f in pf:
            assert_same_column(pc[f.name], jc[f.name])
    assert pstream.bytes_read > 0


def test_timestamps_refuse_a_numeric_feature(parquet_path):
    """pandas gives datetime64 values, which a numeric feature cannot
    read: the JAX reader's ``float()`` raises, and so does the port."""
    with pytest.raises(TypeError):
        jfiles.ParquetReader(parquet_path).generate_dataset(
            _features(JAX, [("DateTime", "stamps")]))
    with pytest.raises(TypeError, match="timestamps"):
        pfiles.ParquetReader(parquet_path).generate_dataset(
            _features(PORT, [("DateTime", "stamps")]))


def test_estimate_rows_and_factory(parquet_path, tmp_path):
    pr = pfiles.DataReaders.Simple.parquet(parquet_path, key_col="id")
    assert isinstance(pr, pfiles.ParquetReader) and pr.key_col == "id"
    assert pr.estimate_rows() == jfiles.ParquetReader(
        parquet_path).estimate_rows() == N
    assert pr.estimate_rows_exact()
    missing = pfiles.ParquetReader(str(tmp_path / "none.parquet"))
    assert missing.estimate_rows() is None
    assert not missing.estimate_rows_exact()


def test_file_streaming_reader_reads_parquet(parquet_path, tmp_path):
    d = tmp_path / "watched"
    d.mkdir()
    pq.write_table(_table(seed=7), str(d / "a.parquet"))
    specs = [("Integral", "int_full"), ("Text", "dict_text"),
             ("Real", "float32")]
    (jb,) = list(jstreaming.FileStreamingReader(str(d)).stream(
        _features(JAX, specs)))
    (pb,) = list(pstreaming.FileStreamingReader(str(d)).stream(
        _features(PORT, specs)))
    for _, name in specs:
        assert_same_column(pb[name], jb[name])


def test_cli_schema_from_a_parquet_sample(parquet_path):
    port = pcli.ProblemSchema.from_file("S", parquet_path, "label", "id")
    jax = jcli.ProblemSchema.from_file("S", parquet_path, "label", "id")
    assert port.kind.value == jax.kind.value
    assert {k: t.__name__ for k, t in port.features.items()} == {
        k: t.__name__ for k, t in jax.features.items()}
    assert port.features["stamps"].__name__ == "DateTime"


def test_without_pyarrow_the_read_raises_naming_it(parquet_path,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    reader = pfiles.ParquetReader(parquet_path)
    feats = _features(PORT, [("Real", "float32")])
    for call in (lambda: reader.generate_dataset(feats),
                 lambda: reader.iter_chunks(feats, CHUNK),
                 reader.estimate_rows):
        with pytest.raises(ImportError, match="pyarrow"):
            call()


def test_event_source_streams_parquet_records(parquet_path):
    """A Parquet file as an event source: the record chunks the event
    fold reads equal the JAX package's ``to_pandas().to_dict("records")``
    (NaN where pandas has NaN, None where it has None or ``NaT``)."""
    from transmogrifai_tpu.readers import events as jevents
    from transmogrifai_tpu_torch.readers import events as pevents

    def same(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return a == b or (a != a and b != b)
        return a == b

    jchunks = list(jevents._iter_record_chunks(
        jfiles.ParquetReader(parquet_path), CHUNK))
    pchunks = list(pevents._iter_record_chunks(
        pfiles.ParquetReader(parquet_path), CHUNK))
    assert [len(c) for c in pchunks] == [len(c) for c in jchunks]
    for jc, pc in zip(jchunks, pchunks):
        for jr, pr in zip(jc, pc):
            assert list(pr) == list(jr)
            for k in jr:
                missing = jr[k] is None or jr[k] is pd.NaT
                assert (pr[k] is None if missing
                        else same(pr[k], jr[k])), (k, pr[k], jr[k])
