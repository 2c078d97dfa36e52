"""The port's Avro codec and readers against the JAX package's, on the CPU.

Held here, on numpy-seeded records (the reference's Avro files are not in
the repository, so every file is written here):
 * ``write_avro`` writes the JAX package's bytes exactly, for the null
   and deflate codecs, one block and many;
 * ``read_avro`` of a JAX-written file gives the JAX package's records
   exactly: every primitive, records, named-type references, enums,
   fixed, arrays, maps, unions and nulls (neither writer takes a union
   branch that names a type, so those branches hold nulls only);
 * a snappy-coded block (written by a small encoder in this file: the
   packages only decode snappy) decodes to the same records in both, and
   a bad checksum raises ``AvroBlockError`` in both;
 * ``avro_to_feature_type`` / ``schema_feature_types`` give the JAX
   package's feature types;
 * ``AvroReader(key_field=)`` and ``AvroSchemaCSVReader`` give the JAX
   package's datasets (values and null masks exactly, and the ``key``
   column); ``estimate_rows`` is the exact record count.
"""
import json
import struct
import zlib

import numpy as np
import pytest

import transmogrifai_tpu_torch as tt
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers import avro as ja
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.readers import avro as pa
from transmogrifai_tpu_torch.readers.base import DataFrameReader, RecordsReader

ENUM = {"type": "enum", "name": "Color", "symbols": ["red", "green", "blue"]}
SCHEMA = {
    "type": "record", "name": "Row", "namespace": "test.avro",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "small", "type": "int"},
        {"name": "real", "type": ["null", "double"]},
        {"name": "single", "type": "float"},
        {"name": "flag", "type": ["null", "boolean"]},
        {"name": "text", "type": ["null", "string"]},
        {"name": "raw", "type": "bytes"},
        {"name": "color", "type": ENUM},
        {"name": "color2", "type": ["null", "Color"]},
        {"name": "digest", "type": {"type": "fixed", "name": "MD", "size": 4}},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "dates", "type": {"type": "array",
                                   "items": ["null", "long"]}},
        {"name": "scores", "type": {"type": "map", "values": "double"}},
        {"name": "inner", "type": ["null", {
            "type": "record", "name": "Inner", "fields": [
                {"name": "a", "type": "int"},
                {"name": "b", "type": ["null", "string"]}]}]},
        {"name": "again", "type": "Inner"},
        {"name": "widened", "type": ["null", "double"]},
        {"name": "defaulted", "type": "string", "default": "none"},
    ]}


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = {
            "id": int(rng.integers(-2 ** 60, 2 ** 60)),
            "small": int(rng.integers(-1000, 1000)),
            "real": None if i % 5 == 0 else float(rng.normal()),
            "single": float(np.float32(rng.normal())),
            "flag": None if i % 3 == 0 else bool(i % 2),
            "text": None if i % 7 == 0 else "ü" * (i % 3) + f"t{i}",
            "raw": bytes(rng.integers(0, 256, i % 4).astype(np.uint8)),
            "color": ENUM["symbols"][i % 3],
            "color2": None,     # a writer takes no named union branch
            "digest": bytes([i % 256, 1, 2, 3]),
            "tags": [f"k{j}" for j in range(i % 4)],
            "dates": [None if j % 2 else int(j * 86_400_000)
                      for j in range(i % 3)],
            "scores": {f"s{j}": float(j) / 3 for j in range(i % 3)},
            "inner": None if i % 4 == 0 else {
                "a": i, "b": None if i % 8 == 1 else "x" * (i % 5)},
            "again": {"a": -i, "b": f"again{i}"},
            "widened": i - 50,          # an int under a double union
        }
        if i % 6:
            r["defaulted"] = f"d{i}"
        out.append(r)
    return out


@pytest.fixture(autouse=True)
def cpu():
    tt.set_device("cpu")


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("block_records", [4096, 7])
def test_write_avro_is_byte_identical(tmp_path, codec, block_records):
    recs = _records(300)
    p, j = str(tmp_path / "p.avro"), str(tmp_path / "j.avro")
    pa.write_avro(p, SCHEMA, recs, codec=codec, block_records=block_records)
    ja.write_avro(j, SCHEMA, recs, codec=codec, block_records=block_records)
    with open(p, "rb") as fp, open(j, "rb") as fj:
        assert fp.read() == fj.read()
    other = str(tmp_path / "s.avro")
    sync = bytes(range(16))
    pa.write_avro(other, SCHEMA, recs[:20], codec=codec, sync=sync)
    ja.write_avro(j, SCHEMA, recs[:20], codec=codec, sync=sync)
    with open(other, "rb") as fp, open(j, "rb") as fj:
        assert fp.read() == fj.read()


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_read_avro_equals_the_jax_records(tmp_path, codec):
    recs = _records(500, seed=1)
    path = str(tmp_path / "j.avro")
    ja.write_avro(path, SCHEMA, recs, codec=codec, block_records=64)
    schema, got = pa.read_avro(path)
    jschema, want = ja.read_avro(path)
    assert schema == jschema == SCHEMA
    assert got == want
    assert [r["defaulted"] for r in got[:7]] == [
        "none", "d1", "d2", "d3", "d4", "d5", "none"]
    assert got[3]["widened"] == -47.0 and isinstance(got[3]["widened"],
                                                     float)


def _varint(v):
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _literal(data):
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    return bytes([60 << 2, n]) + data           # one length byte


def _snappy(data):
    """A greedy raw-snappy encoder: literals and back-references of all
    three kinds (1-, 2- and 4-byte offsets; overlapping copies of runs)."""
    out = bytearray(_varint(len(data)))
    last, i, lit, kind = {}, 0, 0, 0
    while i + 4 <= len(data):
        key = data[i:i + 4]
        j = last.get(key)
        last[key] = i
        if j is None:
            i += 1
            continue
        off, ln = i - j, 4
        while i + ln < len(data) and ln < 64 and data[j + ln] == data[i + ln]:
            ln += 1
        for s in range(lit, i, 200):
            out += _literal(data[s:min(i, s + 200)])
        kind = (kind + 1) % 3
        if kind == 1 and ln <= 11 and off < 2048:
            out += bytes([1 | ((ln - 4) << 2) | ((off >> 8) << 5),
                          off & 0xFF])
        elif kind == 2:
            out += bytes([2 | ((ln - 1) << 2)]) + off.to_bytes(2, "little")
        else:
            out += bytes([3 | ((ln - 1) << 2)]) + off.to_bytes(4, "little")
        i += ln
        lit = i
    for s in range(lit, len(data), 200):
        out += _literal(data[s:s + 200])
    return bytes(out)


def _snappy_file(path, schema, records, bad_crc=False):
    """An OCF with the snappy codec: one block of ``records``."""
    named = {}
    pa._register_named(schema, named)
    body = pa._Encoder()
    for r in records:
        pa._encode(schema, body, r, named)
    raw = body.getvalue()
    crc = zlib.crc32(raw) ^ (1 if bad_crc else 0)
    payload = _snappy(raw) + struct.pack(">I", crc)
    sync = b"\x05" * 16
    enc = pa._Encoder()
    enc.write(b"Obj\x01")
    enc.write_long(2)
    enc.write_string("avro.schema")
    enc.write_bytes(json.dumps(schema).encode())
    enc.write_string("avro.codec")
    enc.write_bytes(b"snappy")
    enc.write_long(0)
    enc.write(sync)
    enc.write_long(len(records))
    enc.write_long(len(payload))
    enc.write(payload)
    enc.write(sync)
    with open(path, "wb") as f:
        f.write(enc.getvalue())
    return raw, payload


def test_snappy_block_decodes_equal(tmp_path):
    recs = _records(400, seed=2)
    path = str(tmp_path / "s.avro")
    raw, payload = _snappy_file(path, SCHEMA, recs)
    assert len(payload) < len(raw)          # back-references were taken
    assert pa._snappy_decompress(payload[:-4]) == raw == \
        ja._snappy_decompress(payload[:-4])
    _, got = pa.read_avro(path)
    _, want = ja.read_avro(path)
    assert got == want
    assert [r["id"] for r in got] == [r["id"] for r in recs]
    _snappy_file(path, SCHEMA, recs, bad_crc=True)
    for mod in (pa, ja):
        with pytest.raises(mod.AvroBlockError, match="CRC mismatch"):
            mod.read_avro(path)


def test_corrupt_files_raise_attributed_errors(tmp_path):
    recs = _records(40, seed=3)
    path = str(tmp_path / "c.avro")
    pa.write_avro(path, SCHEMA, recs, codec="null", block_records=10)
    data = open(path, "rb").read()
    with open(path, "wb") as f:                   # one sync marker broken
        f.write(data[:-1] + b"\x00")
    with pytest.raises(pa.AvroBlockError, match="block 3 .*sync marker"):
        pa.read_avro(path)
    with open(path, "wb") as f:                   # a truncated last block
        f.write(data[:-40])
    with pytest.raises(pa.AvroBlockError) as err:
        pa.read_avro(path)
    assert err.value.block_index == 3
    with pytest.raises(NotImplementedError, match="item 6.3"):
        pa.read_avro(path, resilience=object())


def test_feature_types_match_jax():
    types = ["int", "long", "float", "double", "boolean", "string", "bytes",
             "null", ["null", "double"], ["double", "null"],
             ["null", "string", "long"], ENUM,
             {"type": "fixed", "name": "F", "size": 2},
             {"type": "array", "items": "string"},
             {"type": "array", "items": ["null", "long"]},
             {"type": "array", "items": "long", "name": "eventDates"},
             {"type": "map", "values": "double"},
             {"type": "map", "values": ["null", "long"]},
             {"type": "map", "values": "boolean"},
             {"type": "map", "values": "string"},
             {"type": "double"}, {"type": ["null", "int"]}]
    for t in types:
        assert pa.avro_to_feature_type(t).__name__ == \
            ja.avro_to_feature_type(t).__name__, t
    got = {k: v.__name__ for k, v in pa.schema_feature_types(SCHEMA).items()}
    want = {k: v.__name__ for k, v in ja.schema_feature_types(SCHEMA).items()}
    assert got == want
    with pytest.raises(ValueError):
        pa.schema_feature_types({"type": "enum"})


PASSENGER = {"type": "record", "name": "Passenger", "fields": [
    {"name": "PassengerId", "type": "long"},
    {"name": "Survived", "type": ["null", "double"]},
    {"name": "Name", "type": ["null", "string"]},
    {"name": "Sex", "type": ["null", "string"]},
    {"name": "Age", "type": ["null", "double"]},
    {"name": "SibSp", "type": ["null", "long"]},
    {"name": "Tags", "type": {"type": "array", "items": "string"}},
    {"name": "Scores", "type": {"type": "map", "values": "double"}}]}


def _passengers(n, seed=4):
    rng = np.random.default_rng(seed)
    return [{"PassengerId": 1000 + i,
             "Survived": None if i % 17 == 0 else float(rng.random() < 0.4),
             "Name": None if i % 11 == 0 else f"Name {i % 23}",
             "Sex": ["male", "female", None][i % 3],
             "Age": None if i % 5 == 0 else float(rng.normal(30, 12)),
             "SibSp": None if i % 9 == 0 else int(rng.integers(0, 5)),
             "Tags": [f"t{j}" for j in range(i % 3)],
             "Scores": {"a": float(i)} if i % 2 else {}}
            for i in range(n)]


def _features(fb):
    return [fb.RealNN("Survived").as_response(), fb.Text("Name").as_predictor(),
            fb.PickList("Sex").as_predictor(), fb.Real("Age").as_predictor(),
            fb.Integral("SibSp").as_predictor(),
            fb.TextList("Tags").as_predictor(),
            fb.RealMap("Scores").as_predictor()]


def _assert_same_dataset(got, want, names):
    assert sorted(got.names()) == sorted(want.names()) == sorted(names)
    for name in names:
        g, w = got[name], want[name]
        assert g.ftype.__name__ == w.ftype.__name__, name
        gv, wv = np.asarray(g.values), np.asarray(w.values)
        if gv.dtype.kind == "f":
            np.testing.assert_array_equal(gv, wv)
        else:
            assert list(gv) == list(wv), name
        if w.mask is None:
            assert g.mask is None, name
        else:
            np.testing.assert_array_equal(g.mask, w.mask)


def test_avro_reader_dataset_and_key_equal_jax(tmp_path):
    recs = _passengers(257)
    path = str(tmp_path / "p.avro")
    pa.write_avro(path, PASSENGER, recs, block_records=50)
    reader = pa.AvroReader(path, key_field="PassengerId")
    got = reader.generate_dataset(_features(FeatureBuilder))
    want = ja.AvroReader(path, key_field="PassengerId").generate_dataset(
        _features(JFB))
    names = ["Survived", "Name", "Sex", "Age", "SibSp", "Tags", "Scores",
             "key"]
    _assert_same_dataset(got, want, names)
    assert list(got["key"].values[:2]) == ["1000", "1001"]
    assert set(reader.read_seconds) == {"decode_s", "columns_s"}
    assert reader.schema == PASSENGER and len(reader.records) == 257
    # no key field: no key column
    plain = pa.AvroReader(path).generate_dataset(_features(FeatureBuilder))
    assert "key" not in plain
    # the chunked read (blocks of 50 cut by chunks of 10) gives the same
    # rows, key included
    chunks = list(reader.iter_chunks(_features(FeatureBuilder), 10))
    assert [len(c) for c in chunks] == [10] * 25 + [7]
    _assert_same_dataset(chunks[5], want.slice(50, 60), names)


@pytest.mark.parametrize("n,block_records", [(0, 10), (1, 10), (257, 50),
                                             (1000, 1000), (1001, 1000)])
def test_estimate_rows_is_exact(tmp_path, n, block_records):
    path = str(tmp_path / "e.avro")
    pa.write_avro(path, PASSENGER, _passengers(n), block_records=block_records)
    reader = pa.AvroReader(path)
    assert reader.estimate_rows() == n == ja.AvroReader(path).estimate_rows()
    assert pa.AvroReader(str(tmp_path / "absent.avro")).estimate_rows() \
        is None


def test_schema_csv_reader_equals_jax(tmp_path):
    schema = {"type": "record", "name": "P", "fields": [
        {"name": "PassengerId", "type": "long"},
        {"name": "Survived", "type": ["null", "double"]},
        {"name": "Sex", "type": ["null", "string"]},
        {"name": "Age", "type": ["null", "double"]},
        {"name": "SibSp", "type": ["null", "int"]}]}
    avsc = tmp_path / "p.avsc"
    avsc.write_text(json.dumps(schema))
    rng = np.random.default_rng(5)
    lines = []
    for i in range(120):
        age = "" if i % 6 == 0 else f"{rng.normal(30, 9):.3f}"
        sib = "" if i % 7 == 0 else str(int(rng.integers(0, 4)))
        sex = ["male", "female", ""][i % 3]
        lines.append(f"{i + 1}, {float(i % 2)}, {sex}, {age},{sib}")
    csv = tmp_path / "p.csv"
    csv.write_text("\n".join(lines) + "\n")
    reader = pa.AvroSchemaCSVReader(str(csv), str(avsc),
                                    key_field="PassengerId")
    jreader = ja.AvroSchemaCSVReader(str(csv), str(avsc),
                                     key_field="PassengerId")
    assert {k: v.__name__ for k, v in reader.feature_types.items()} == \
        {k: v.__name__ for k, v in jreader.feature_types.items()}

    def feats(fb):
        return [fb.RealNN("Survived").as_response(),
                fb.PickList("Sex").as_predictor(), fb.Real("Age").as_predictor(),
                fb.Integral("SibSp").as_predictor()]

    got = reader.generate_dataset(feats(FeatureBuilder))
    want = jreader.generate_dataset(feats(JFB))
    _assert_same_dataset(got, want, ["Survived", "Sex", "Age", "SibSp",
                                     "key"])
    with pytest.raises(KeyError, match="Fare"):
        reader.generate_dataset([FeatureBuilder.Real("Fare").as_predictor()])


def test_keyed_readers():
    recs = [{"id": i, "x": float(i)} for i in range(5)]
    feats = [FeatureBuilder.Real("x").as_predictor()]
    ds = RecordsReader(recs, key_fn=lambda r: r["id"] * 10).generate_dataset(
        feats)
    assert list(ds["key"].values) == ["0", "10", "20", "30", "40"]
    assert ds["key"].ftype.__name__ == "ID"
    assert "key" not in RecordsReader(recs).generate_dataset(feats)
    pd = pytest.importorskip("pandas")
    frame = DataFrameReader(pd.DataFrame(recs), key_col="id")
    assert frame.key_col == "id"
    assert list(frame.generate_dataset(feats)["x"].values) == [
        0.0, 1.0, 2.0, 3.0, 4.0]
