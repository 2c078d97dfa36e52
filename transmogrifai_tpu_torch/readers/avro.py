"""Avro ingestion, the reference's canonical data format (counterpart of
``transmogrifai_tpu.readers.avro``, which is pure Python: this is the
port's own copy, with no import of the JAX package).

The Avro 1.x Object Container File format is implemented directly (no
Avro package): zig-zag varint primitives, records in blocks between
16-byte sync markers, the null, deflate and (read-only) snappy codecs.
It is host IO: the device pipeline starts after the columns are
extracted.  Each schema is compiled once into a tree of closures (one
reader or writer per schema node), which decodes and encodes the same
bytes as the JAX package's recursive walk at a fraction of its dispatch
cost; ``write_avro`` writes files byte-identical to the JAX package's for
the same schema, records, codec and sync marker.

Supported schema surface: null, boolean, int, long, float, double, bytes,
string, fixed, enum, array, map, union, record (with named-type
references).  Only the fail-fast path runs: a corrupt block raises
``AvroBlockError`` or ``AvroRecordError`` (the quarantine policy waits
for ``readers/resilience.py``, ROADMAP Queue A item 6.3).
``iter_avro_blocks`` streams a file block by block, and the readers'
``iter_chunks`` regroup the records into chunks of ``chunk_rows``, cut
across block boundaries, holding at most one block and one chunk.
"""
from __future__ import annotations

import io
import json
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..features.feature import Feature
from ..types import feature_types as ft
from ..types.columns import ColumnarDataset, FeatureColumn
from .base import (ChunkStream, Reader, RecordsReader, _check_chunk_rows,
                   _stream)

__all__ = ["read_avro", "write_avro", "iter_avro_blocks", "AvroReader",
           "AvroSchemaCSVReader", "avro_to_feature_type",
           "schema_feature_types", "AvroBlockError", "AvroRecordError"]

_MAGIC = b"Obj\x01"
_PRIMITIVES = ("null", "boolean", "int", "long", "float", "double",
               "bytes", "string")


class AvroBlockError(ValueError):
    """A corrupt container block: the message carries the block index and
    the block's byte offset in the file."""

    def __init__(self, path: str, block_index: int, byte_offset: int,
                 reason: str):
        super().__init__(
            f"{path}: corrupt avro block {block_index} "
            f"(byte offset {byte_offset}): {reason}")
        self.path = path
        self.block_index = block_index
        self.byte_offset = byte_offset
        self.reason = reason


class AvroRecordError(AvroBlockError):
    """A record that failed to decode inside a framed block, by record
    index; ``decoded`` holds the block's records before it."""

    def __init__(self, path: str, block_index: int, byte_offset: int,
                 record_index: int, reason: str, decoded=None):
        super().__init__(path, block_index, byte_offset,
                         f"record {record_index} failed to decode: {reason}")
        self.record_index = record_index
        self.decoded = decoded if decoded is not None else []


# ---------------------------------------------------------------------------
# binary decoder / encoder (Avro spec, Binary Encoding)
# ---------------------------------------------------------------------------

class _Decoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def read_long(self) -> int:
        buf, pos = self.buf, self.pos
        b = buf[pos]
        pos += 1
        acc = b & 0x7F
        shift = 7
        while b & 0x80:
            b = buf[pos]
            pos += 1
            acc |= (b & 0x7F) << shift
            shift += 7
        self.pos = pos
        return (acc >> 1) ^ -(acc & 1)  # zig-zag

    def read_null(self):
        return None

    read_int = read_long  # the same zig-zag varint on the wire

    def read_boolean(self) -> bool:
        return self.read(1) != b"\x00"

    def read_float(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def read_double(self) -> float:
        pos = self.pos
        if pos + 8 > len(self.buf):
            raise EOFError("truncated avro data")
        self.pos = pos + 8
        return _DOUBLE.unpack_from(self.buf, pos)[0]

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")


_DOUBLE = struct.Struct("<d")


class _Encoder:
    def __init__(self):
        self.out = io.BytesIO()

    def write(self, b: bytes):
        self.out.write(b)

    def write_long(self, v: int):
        v = (v << 1) ^ (v >> 63) if v >= 0 else ((-v - 1) << 1 | 1)
        out = bytearray()
        while v > 0x7F:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
        self.out.write(out)

    def write_boolean(self, v: bool):
        self.out.write(b"\x01" if v else b"\x00")

    def write_float(self, v: float):
        self.out.write(struct.pack("<f", v))

    def write_double(self, v: float):
        self.out.write(_DOUBLE.pack(v))

    def write_bytes(self, v: bytes):
        self.write_long(len(v))
        self.out.write(v)

    def write_string(self, v: str):
        self.write_bytes(v.encode("utf-8"))

    def getvalue(self) -> bytes:
        return self.out.getvalue()


class _FileDecoder:
    """Varints and bytes over a file object: the container header and the
    block framing, read without loading the whole file."""

    def __init__(self, fh):
        self.fh = fh

    def read(self, n: int) -> bytes:
        b = self.fh.read(n)
        if len(b) != n:
            raise EOFError("truncated avro data")
        return b

    def read_long(self) -> int:
        shift, acc = 0, 0
        while True:
            b = self.fh.read(1)
            if not b:
                raise EOFError("truncated avro varint")
            acc |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")


# ---------------------------------------------------------------------------
# schemas compiled to readers and writers
# ---------------------------------------------------------------------------

def _register_named(schema, named: Dict[str, Any]):
    if isinstance(schema, dict) and schema.get("type") in ("record", "enum",
                                                           "fixed"):
        name = schema.get("name", "")
        ns = schema.get("namespace", "")
        named[name] = schema
        if ns:
            named[f"{ns}.{name}"] = schema
        for f in schema.get("fields", []) or []:
            _register_named(f.get("type"), named)
    elif isinstance(schema, dict) and schema.get("type") in ("array", "map"):
        _register_named(schema.get("items") or schema.get("values"), named)
    elif isinstance(schema, list):
        for s in schema:
            _register_named(s, named)


def _blocks(dec: _Decoder, item: Callable[[_Decoder], Any]) -> None:
    """Run ``item`` once per element of an array or map's blocks."""
    while True:
        n = dec.read_long()
        if n == 0:
            return
        if n < 0:  # a block with its byte size
            n = -n
            dec.read_long()
        for _ in range(n):
            item(dec)


def _reader(schema, named: Dict[str, Any], memo: Dict[str, Callable]
            ) -> Callable[[_Decoder], Any]:
    """A function that decodes one value of ``schema``; ``memo`` holds the
    named types' readers (a record may refer to itself)."""
    if isinstance(schema, str):
        if schema in _PRIMITIVES:
            return getattr(_Decoder, f"read_{schema}")
        if schema not in named:  # fails when a value reaches it
            return lambda dec: _decode(named[schema], dec, named)
        if schema not in memo:
            memo[schema] = None  # a recursive reference resolves late
            memo[schema] = _reader(named[schema], named, memo)
        fn = memo[schema]
        return fn if fn is not None else (lambda dec: memo[schema](dec))
    if isinstance(schema, list):  # a union: the branch index, then a value
        branches = [_reader(s, named, memo) for s in schema]
        return lambda dec: branches[dec.read_long()](dec)
    t = schema["type"]
    if t in _PRIMITIVES:
        return getattr(_Decoder, f"read_{t}")
    if t == "record":
        fields = [(f["name"], _reader(f["type"], named, memo))
                  for f in schema["fields"]]
        return lambda dec: {name: fn(dec) for name, fn in fields}
    if t == "enum":
        symbols = schema["symbols"]
        return lambda dec: symbols[dec.read_long()]
    if t == "fixed":
        size = schema["size"]
        return lambda dec: dec.read(size)
    if t == "array":
        item = _reader(schema["items"], named, memo)

        def read_array(dec):
            out: List[Any] = []
            _blocks(dec, lambda d: out.append(item(d)))
            return out
        return read_array
    if t == "map":
        value = _reader(schema["values"], named, memo)

        def read_map(dec):
            out: Dict[str, Any] = {}

            def entry(d):
                k = d.read_string()  # the key before its value
                out[k] = value(d)
            _blocks(dec, entry)
            return out
        return read_map
    if isinstance(t, (dict, list)):  # a nested {"type": {...}} wrapper
        return _reader(t, named, memo)
    raise ValueError(f"unsupported avro type {t!r}")


def _decode(schema, dec: _Decoder, named: Dict[str, Any]):
    """One value of ``schema`` from ``dec``."""
    return _reader(schema, named, {})(dec)


def _union_branch(schema_list, value):
    """The union branch a Python value is written under: exact type matches
    first (int to int/long, str to string, an enum only when the symbol is
    a member), widening matches second (an int under a ['double'] union),
    as a reference Avro writer chooses."""
    def matches(s, v, exact):
        base = s if isinstance(s, str) else s.get("type")
        if v is None:
            return base == "null"
        if isinstance(v, bool):
            return base == "boolean"
        if isinstance(v, (int, np.integer)):
            return (base in ("int", "long") if exact
                    else base in ("int", "long", "double", "float"))
        if isinstance(v, (float, np.floating)):
            return base in ("double", "float")
        if isinstance(v, str):
            if exact:
                return base == "string" or (
                    base == "enum" and not isinstance(s, str)
                    and v in s.get("symbols", ()))
            return base in ("string", "enum")
        if isinstance(v, bytes):
            return base in ("bytes", "fixed")
        if isinstance(v, dict):
            return base in ("record", "map")
        if isinstance(v, (list, tuple)):
            return base == "array"
        return False
    for exact in (True, False):
        for i, s in enumerate(schema_list):
            if matches(s, value, exact):
                return i
    raise ValueError(f"no union branch in {schema_list} for {value!r}")


def _writer(schema, named: Dict[str, Any], memo: Dict[str, Callable]
            ) -> Callable[[_Encoder, Any], None]:
    """A function that encodes one value of ``schema``."""
    if isinstance(schema, str):
        if schema == "null":
            return lambda enc, v: None
        if schema in ("int", "long"):
            return lambda enc, v: enc.write_long(int(v))
        if schema in _PRIMITIVES:
            return getattr(_Encoder, f"write_{schema}")
        if schema not in named:  # fails when a value reaches it
            return lambda enc, v: _encode(named[schema], enc, v, named)
        if schema not in memo:
            memo[schema] = None
            memo[schema] = _writer(named[schema], named, memo)
        fn = memo[schema]
        return fn if fn is not None else (
            lambda enc, v: memo[schema](enc, v))
    if isinstance(schema, list):
        branches = [_writer(s, named, memo) for s in schema]

        def write_union(enc, v):
            i = _union_branch(schema, v)
            enc.write_long(i)
            branches[i](enc, v)
        return write_union
    t = schema["type"]
    if t in _PRIMITIVES or isinstance(t, (dict, list)):
        return _writer(t, named, memo)
    if t == "record":
        fields = [(f["name"], _writer(f["type"], named, memo),
                   "default" in f and not isinstance(f["type"], list),
                   f.get("default")) for f in schema["fields"]]

        def write_record(enc, value):
            is_dict = isinstance(value, dict)
            for name, fn, has_default, default in fields:
                v = value.get(name) if is_dict else None
                if v is None and has_default:
                    v = default
                fn(enc, v)
        return write_record
    if t == "enum":
        symbols = schema["symbols"]
        return lambda enc, v: enc.write_long(symbols.index(v))
    if t == "fixed":
        return lambda enc, v: enc.write(v)
    if t == "array":
        item = _writer(schema["items"], named, memo)

        def write_array(enc, value):
            if value:
                enc.write_long(len(value))
                for v in value:
                    item(enc, v)
            enc.write_long(0)
        return write_array
    if t == "map":
        val = _writer(schema["values"], named, memo)

        def write_map(enc, value):
            if value:
                enc.write_long(len(value))
                for k, v in value.items():
                    enc.write_string(k)
                    val(enc, v)
            enc.write_long(0)
        return write_map
    raise ValueError(f"unsupported avro type {t!r}")


def _encode(schema, enc: _Encoder, value, named: Dict[str, Any]):
    """Write one value of ``schema`` to ``enc``."""
    _writer(schema, named, {})(enc, value)


def _snappy_decompress(data: bytes) -> bytes:
    """Raw snappy (decode only: written blocks use deflate).  A varint
    uncompressed length, then tagged elements: 00 a literal, 01/10/11
    back-references with 1/2/4-byte offsets."""
    pos, shift, n = 0, 0, 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("corrupt snappy stream (bad offset)")
        start = len(out) - off
        for i in range(ln):  # may overlap itself: byte by byte
            out.append(out[start + i])
    if len(out) != n:
        raise ValueError("corrupt snappy stream (length mismatch)")
    return bytes(out)


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------

def _read_header(dec, path: str):
    """(schema, codec, sync, named) of an OCF header."""
    if dec.read(4) != _MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = dec.read_long()
        if n == 0:
            break
        if n < 0:
            n = -n
            dec.read_long()
        for _ in range(n):
            k = dec.read_string()
            meta[k] = dec.read_bytes()
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate", "snappy"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = dec.read(16)
    named: Dict[str, Any] = {}
    _register_named(schema, named)
    return schema, codec, sync, named


def _decode_block(block: bytes, count: int, codec: str, schema, named,
                  path: str, block_index: int = 0, byte_offset: int = 0,
                  reader: Optional[Callable] = None) -> List[dict]:
    """One container block's records.  A codec failure raises
    ``AvroBlockError``, a record that fails ``AvroRecordError`` (with the
    records decoded before it)."""
    try:
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec == "snappy":
            crc = int.from_bytes(block[-4:], "big")
            block = _snappy_decompress(block[:-4])
            if zlib.crc32(block) & 0xFFFFFFFF != crc:
                raise ValueError("snappy block CRC mismatch")
    except Exception as exc:
        raise AvroBlockError(path, block_index, byte_offset,
                             f"{codec} decompression failed: {exc}") from exc
    read = reader if reader is not None else _reader(schema, named, {})
    bdec = _Decoder(block)
    out: List[dict] = []
    for i in range(count):
        try:
            out.append(read(bdec))
        except Exception as exc:
            raise AvroRecordError(path, block_index, byte_offset, i,
                                  str(exc), decoded=out) from exc
    return out


def _no_resilience(resilience) -> None:
    if resilience is not None:
        raise NotImplementedError(
            "the Avro bad-record quarantine is not ported yet (ROADMAP "
            "Queue A item 6.3: readers/resilience.py)")


def read_avro(path: str, resilience=None) -> Tuple[Dict[str, Any],
                                                   List[dict]]:
    """Read an Avro OCF: (writer schema, records).  A corrupt block raises
    an attributed ``AvroBlockError``; so does a sync-marker mismatch (past
    it the block framing is gone)."""
    _no_resilience(resilience)
    with open(path, "rb") as fh:
        raw = fh.read()
    dec = _Decoder(raw)
    schema, codec, sync, named = _read_header(dec, path)
    read = _reader(schema, named, {})
    records: List[dict] = []
    block_index = 0
    while dec.pos < len(raw):
        byte_offset = dec.pos
        try:
            count = dec.read_long()
            size = dec.read_long()
            block = dec.read(size)
        except (EOFError, IndexError) as exc:
            raise AvroBlockError(path, block_index, byte_offset,
                                 f"truncated block framing: {exc}") from exc
        records.extend(_decode_block(block, count, codec, schema, named,
                                     path, block_index, byte_offset, read))
        if dec.read(16) != sync:
            raise AvroBlockError(path, block_index, byte_offset,
                                 "sync marker mismatch")
        block_index += 1
    return schema, records


def iter_avro_blocks(path: str, bytes_pos: Optional[dict] = None,
                     resilience=None):
    """Stream an OCF block by block: yields ``(schema, records)`` per
    container block, never holding the whole file.  ``bytes_pos["bytes"]``
    (when a dict is given) follows the file position after each block.
    A corrupt block raises as in ``read_avro``."""
    _no_resilience(resilience)
    with open(path, "rb") as fh:
        dec = _FileDecoder(fh)
        schema, codec, sync, named = _read_header(dec, path)
        read = _reader(schema, named, {})
        block_index = 0
        while fh.read(1):
            fh.seek(-1, 1)
            byte_offset = fh.tell()
            try:
                count = dec.read_long()
                block = dec.read(dec.read_long())
            except EOFError as exc:
                raise AvroBlockError(path, block_index, byte_offset,
                                     f"truncated block framing: {exc}"
                                     ) from exc
            records = _decode_block(block, count, codec, schema, named, path,
                                    block_index, byte_offset, read)
            if dec.read(16) != sync:
                raise AvroBlockError(path, block_index, byte_offset,
                                     "sync marker mismatch")
            if bytes_pos is not None:
                bytes_pos["bytes"] = fh.tell()
            block_index += 1
            yield schema, records


def write_avro(path: str, schema: Dict[str, Any], records: Sequence[dict],
               codec: str = "deflate", sync: bytes = b"\x07" * 16,
               block_records: int = 4096) -> None:
    """Write records as an Avro OCF (null or deflate codec), in blocks of
    ``block_records``."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    named: Dict[str, Any] = {}
    _register_named(schema, named)
    write = _writer(schema, named, {})
    enc = _Encoder()
    enc.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    enc.write_long(len(meta))
    for k, v in meta.items():
        enc.write_string(k)
        enc.write_bytes(v)
    enc.write_long(0)
    enc.write(sync)
    for s in range(0, len(records), block_records):
        chunk = records[s:s + block_records]
        benc = _Encoder()
        for r in chunk:
            write(benc, r)
        payload = benc.getvalue()
        if codec == "deflate":
            co = zlib.compressobj(9, zlib.DEFLATED, -15)
            payload = co.compress(payload) + co.flush()
        enc.write_long(len(chunk))
        enc.write_long(len(payload))
        enc.write(payload)
        enc.write(sync)
    with open(path, "wb") as f:
        f.write(enc.getvalue())


# ---------------------------------------------------------------------------
# Avro types to feature types
# ---------------------------------------------------------------------------

def _unwrap_union(t):
    """['null', T] / [T, 'null'] -> T (nullability lives in the feature
    type); a union of several branches reads as text."""
    if isinstance(t, list):
        branches = [b for b in t if b != "null"]
        return branches[0] if len(branches) == 1 else "string"
    return t


def avro_to_feature_type(avro_type) -> Type[ft.FeatureType]:
    t = _unwrap_union(avro_type)
    if isinstance(t, dict):
        inner = t.get("type")
        if inner == "enum":
            return ft.PickList
        if inner == "fixed":
            return ft.Base64
        if inner == "array":
            item = _unwrap_union(t.get("items"))
            if item in ("int", "long"):
                return ft.DateList if "date" in str(
                    t.get("name", "")).lower() else ft.TextList
            return ft.TextList
        if inner == "map":
            val = _unwrap_union(t.get("values"))
            if val in ("float", "double"):
                return ft.RealMap
            if val in ("int", "long"):
                return ft.IntegralMap
            if val == "boolean":
                return ft.BinaryMap
            return ft.TextMap
        return avro_to_feature_type(inner)
    return {
        "boolean": ft.Binary,
        "int": ft.Integral, "long": ft.Integral,
        "float": ft.Real, "double": ft.Real,
        "string": ft.Text, "bytes": ft.Base64,
    }.get(t, ft.Text)


def schema_feature_types(schema: Dict[str, Any]
                         ) -> Dict[str, Type[ft.FeatureType]]:
    """A record schema's {field name: feature type}."""
    if schema.get("type") != "record":
        raise ValueError("expected a record schema")
    return {f["name"]: avro_to_feature_type(f["type"])
            for f in schema["fields"]}


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _key_fn(key_field: Optional[str]):
    return (lambda r: str(r.get(key_field))) if key_field else None


class AvroReader(Reader):
    """An Avro OCF's records as a dataset; with ``key_field`` a ``key``
    ID column of that field's values.  The file is decoded once and its
    records kept; ``read_seconds`` holds the last ``generate_dataset``'s
    host seconds: ``decode_s`` (reading and decoding the file, 0 once the
    records are kept) and ``columns_s`` (the features' columns)."""

    def __init__(self, path: str, key_field: Optional[str] = None):
        self.path = path
        self.key_field = key_field
        self._cache: Optional[Tuple[Dict, List[dict]]] = None
        self.read_seconds: Dict[str, float] = {}

    def _load(self) -> Tuple[Dict, List[dict]]:
        if self._cache is None:
            self._cache = read_avro(self.path)
        return self._cache

    @property
    def schema(self) -> Dict[str, Any]:
        return self._load()[0]

    @property
    def records(self) -> List[dict]:
        return self._load()[1]

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        t0 = time.perf_counter()
        records = self.records
        t1 = time.perf_counter()
        ds = RecordsReader(records, key_fn=_key_fn(self.key_field)
                           ).generate_dataset(raw_features)
        self.read_seconds = {"decode_s": t1 - t0,
                             "columns_s": time.perf_counter() - t1}
        return ds

    def estimate_rows(self) -> Optional[int]:
        """The exact record count, from the block headers alone: each
        block's framing carries its count and payload size, so the scan
        seeks past every payload without decoding a record."""
        try:
            with open(self.path, "rb") as fh:
                dec = _FileDecoder(fh)
                _read_header(dec, self.path)
                total = 0
                while fh.read(1):
                    fh.seek(-1, 1)
                    total += dec.read_long()
                    fh.seek(dec.read_long() + 16, 1)  # payload + sync
                return total
        except (OSError, EOFError, ValueError):
            return None

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range=None) -> ChunkStream:
        """Blocks decode one at a time and regroup into ``chunk_rows``
        records; ``bytes_read`` follows the file position."""
        _check_chunk_rows(chunk_rows)
        key_fn = _key_fn(self.key_field)
        pos = {"bytes": 0}

        def gen():
            pending: List[dict] = []
            for _schema, records in iter_avro_blocks(self.path, pos):
                pending.extend(records)
                while len(pending) >= chunk_rows:
                    batch, pending = (pending[:chunk_rows],
                                      pending[chunk_rows:])
                    yield RecordsReader(batch, key_fn=key_fn
                                        ).generate_dataset(raw_features)
            if pending:
                yield RecordsReader(pending, key_fn=key_fn
                                    ).generate_dataset(raw_features)

        return _stream(gen(), host_range, lambda: pos["bytes"])


class AvroSchemaCSVReader(Reader):
    """Headerless CSV whose columns an Avro schema names (the reference's
    CSV path types its rows through Avro).  ``feature_types`` is the
    schema's field-to-type map; a feature's declared type decides how its
    column is read.  Cells parse as the port's ``CSVReader`` reads them,
    spaces after a delimiter skipped (pandas' ``skipinitialspace``)."""

    def __init__(self, csv_path: str, schema_path: str,
                 key_field: Optional[str] = None):
        self.csv_path = csv_path
        self.schema_path = schema_path
        self.key_field = key_field
        with open(schema_path) as fh:
            self.schema = json.load(fh)
        if self.schema.get("type") != "record":
            raise ValueError(f"{schema_path}: expected a record schema")
        self.feature_types = schema_feature_types(self.schema)

    def _csv(self, raw_features: Sequence[Feature]):
        from .files import CSVReader

        names = [f["name"] for f in self.schema["fields"]]
        unknown = [f.name for f in raw_features if f.name not in names]
        if unknown:
            raise KeyError(f"{unknown[0]!r} not in avro schema fields "
                           f"{names}")
        csv_reader = CSVReader(self.csv_path, column_names=names,
                               has_header=False)
        csv_reader.skip_initial_space = True
        return csv_reader

    def _dataset(self, csv_reader, columns, n: int,
                 raw_features: Sequence[Feature]) -> ColumnarDataset:
        from .files import _text

        out = csv_reader._dataset(columns, n, raw_features)
        if self.key_field and self.key_field in columns:
            out = out.with_columns({"key": FeatureColumn.from_values(
                ft.ID, [str(v) for v in _text(columns[self.key_field])])})
        return out

    def generate_dataset(self, raw_features: Sequence[Feature]
                         ) -> ColumnarDataset:
        csv_reader = self._csv(raw_features)
        columns, n = next(csv_reader._tables(None))
        return self._dataset(csv_reader, columns, n, raw_features)

    def iter_chunks(self, raw_features: Sequence[Feature], chunk_rows: int,
                    host_range=None) -> ChunkStream:
        """The schema-typed CSV ``chunk_rows`` rows at a time."""
        _check_chunk_rows(chunk_rows)
        csv_reader = self._csv(raw_features)
        pos = {"bytes": 0}
        gen = (self._dataset(csv_reader, columns, n, raw_features)
               for columns, n in csv_reader._tables(chunk_rows, pos))
        return _stream(gen, host_range, lambda: pos["bytes"])
