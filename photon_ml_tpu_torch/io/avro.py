"""Minimal Avro implementation: binary codec + object container files.

The reference interchanges everything — training data, models, scores —
as Avro object container files (photon-avro-schemas/src/main/avro/*.avsc,
read/written through avro-mapred in AvroUtils.scala:47). This image ships no
Avro library, so the format is implemented here from the public Avro 1.x
specification: zigzag-varint longs, little-endian IEEE floats, length-prefixed
bytes/strings, block-encoded arrays/maps, index-prefixed unions, and the
`Obj\\x01` container framing with null/deflate codecs.

Schemas are plain Python dicts in Avro JSON form (see
photon_ml_tpu_torch.io.schemas); data values are plain dicts/lists/scalars.
This is a host-side ETL path — device code never sees Avro. The port's own
copy of `photon_ml_tpu/io/avro.py`. Reads are strict by default (a corrupt
block raises); row-shaped reads (training ingest, request replay) pass
`quarantine=True`, which skips and counts a corrupt block.
"""

from __future__ import annotations

import io
import json
import logging
import math
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, List, Optional, Union

logger = logging.getLogger(__name__)

Schema = Union[str, dict, list]

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}


# ---------------------------------------------------------------------------
# Binary encoding


class BinaryEncoder:
    def __init__(self, out: BinaryIO):
        self._out = out

    def write_long(self, n: int) -> None:
        # zigzag then varint (Avro spec "long").
        n = (n << 1) ^ (n >> 63)
        while (n & ~0x7F) != 0:
            self._out.write(bytes([(n & 0x7F) | 0x80]))
            n >>= 7
        self._out.write(bytes([n]))

    def write_boolean(self, v: bool) -> None:
        self._out.write(b"\x01" if v else b"\x00")

    def write_float(self, v: float) -> None:
        self._out.write(struct.pack("<f", v))

    def write_double(self, v: float) -> None:
        self._out.write(struct.pack("<d", v))

    def write_bytes(self, v: bytes) -> None:
        self.write_long(len(v))
        self._out.write(v)

    def write_string(self, v: str) -> None:
        self.write_bytes(v.encode("utf-8"))

    def write_fixed(self, v: bytes) -> None:
        self._out.write(v)


class BinaryDecoder:
    def __init__(self, data: bytes, pos: int = 0):
        self._data = data
        self.pos = pos

    def read_long(self) -> int:
        b = self._data[self.pos]
        self.pos += 1
        n = b & 0x7F
        shift = 7
        while b & 0x80:
            b = self._data[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
        return (n >> 1) ^ -(n & 1)

    def read_boolean(self) -> bool:
        v = self._data[self.pos] == 1
        self.pos += 1
        return v

    def read_float(self) -> float:
        (v,) = struct.unpack_from("<f", self._data, self.pos)
        self.pos += 4
        return v

    def read_double(self) -> float:
        (v,) = struct.unpack_from("<d", self._data, self.pos)
        self.pos += 8
        return v

    def read_bytes(self) -> bytes:
        n = self.read_long()
        v = self._data[self.pos : self.pos + n]
        self.pos += n
        return v

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_fixed(self, n: int) -> bytes:
        v = self._data[self.pos : self.pos + n]
        self.pos += n
        return v

    @property
    def remaining(self) -> int:
        return len(self._data) - self.pos


# ---------------------------------------------------------------------------
# Schema-driven datum codec


class _Names:
    """Resolves named-type references within one schema tree."""

    def __init__(self):
        self.types: Dict[str, dict] = {}

    def register(self, schema: dict) -> None:
        name = schema.get("name")
        if name:
            ns = schema.get("namespace")
            self.types[name] = schema
            if ns:
                self.types[f"{ns}.{name}"] = schema

    def resolve(self, schema: Schema) -> Schema:
        if isinstance(schema, str) and schema not in _PRIMITIVES:
            if schema not in self.types:
                raise ValueError(f"Unknown named type {schema!r}")
            return self.types[schema]
        return schema


def _collect_names(schema: Schema, names: _Names) -> None:
    if isinstance(schema, list):
        for s in schema:
            _collect_names(s, names)
    elif isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            names.register(schema)
        if t == "record":
            for f in schema["fields"]:
                _collect_names(f["type"], names)
        elif t == "array":
            _collect_names(schema["items"], names)
        elif t == "map":
            _collect_names(schema["values"], names)


def _matches(branch: Schema, datum: Any, names: _Names) -> bool:
    branch = names.resolve(branch)
    t = branch if isinstance(branch, str) else branch["type"]
    if t == "null":
        return datum is None
    if t == "boolean":
        return isinstance(datum, bool)
    if t in ("int", "long"):
        return isinstance(datum, int) and not isinstance(datum, bool)
    if t in ("float", "double"):
        return isinstance(datum, (int, float)) and not isinstance(datum, bool)
    if t == "string":
        return isinstance(datum, str)
    if t in ("bytes", "fixed"):
        return isinstance(datum, (bytes, bytearray))
    if t == "enum":
        return isinstance(datum, str) and datum in branch["symbols"]
    if t == "array":
        return isinstance(datum, (list, tuple))
    if t == "map":
        return isinstance(datum, dict)
    if t == "record":
        return isinstance(datum, dict)
    return False


def write_datum(enc: BinaryEncoder, schema: Schema, datum: Any, names: _Names) -> None:
    schema = names.resolve(schema)
    if isinstance(schema, list):  # union: branch index then value
        for i, branch in enumerate(schema):
            if _matches(branch, datum, names):
                enc.write_long(i)
                write_datum(enc, branch, datum, names)
                return
        raise ValueError(f"datum {datum!r} matches no union branch {schema!r}")
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return
    if t == "boolean":
        enc.write_boolean(datum)
    elif t == "int" or t == "long":
        enc.write_long(int(datum))
    elif t == "float":
        enc.write_float(float(datum))
    elif t == "double":
        enc.write_double(float(datum))
    elif t == "bytes":
        enc.write_bytes(bytes(datum))
    elif t == "string":
        enc.write_string(datum)
    elif t == "fixed":
        enc.write_fixed(bytes(datum))
    elif t == "enum":
        enc.write_long(schema["symbols"].index(datum))
    elif t == "array":
        if datum:
            enc.write_long(len(datum))
            for item in datum:
                write_datum(enc, schema["items"], item, names)
        enc.write_long(0)
    elif t == "map":
        if datum:
            enc.write_long(len(datum))
            for k, v in datum.items():
                enc.write_string(k)
                write_datum(enc, schema["values"], v, names)
        enc.write_long(0)
    elif t == "record":
        for field in schema["fields"]:
            name = field["name"]
            if name in datum:
                value = datum[name]
            elif "default" in field:
                value = field["default"]
            else:
                raise ValueError(f"record missing field {name!r} with no default")
            write_datum(enc, field["type"], value, names)
    else:
        raise ValueError(f"unsupported schema {schema!r}")


def read_datum(dec: BinaryDecoder, schema: Schema, names: _Names) -> Any:
    schema = names.resolve(schema)
    if isinstance(schema, list):
        return read_datum(dec, schema[dec.read_long()], names)
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "null":
        return None
    if t == "boolean":
        return dec.read_boolean()
    if t == "int" or t == "long":
        return dec.read_long()
    if t == "float":
        return dec.read_float()
    if t == "double":
        return dec.read_double()
    if t == "bytes":
        return dec.read_bytes()
    if t == "string":
        return dec.read_string()
    if t == "fixed":
        return dec.read_fixed(schema["size"])
    if t == "enum":
        return schema["symbols"][dec.read_long()]
    if t == "array":
        out: List[Any] = []
        n = dec.read_long()
        while n != 0:
            if n < 0:  # block with byte-size prefix
                n = -n
                dec.read_long()
            for _ in range(n):
                out.append(read_datum(dec, schema["items"], names))
            n = dec.read_long()
        return out
    if t == "map":
        m: Dict[str, Any] = {}
        n = dec.read_long()
        while n != 0:
            if n < 0:
                n = -n
                dec.read_long()
            for _ in range(n):
                k = dec.read_string()
                m[k] = read_datum(dec, schema["values"], names)
            n = dec.read_long()
        return m
    if t == "record":
        return {f["name"]: read_datum(dec, f["type"], names) for f in schema["fields"]}
    raise ValueError(f"unsupported schema {schema!r}")


# ---------------------------------------------------------------------------
# Object container files


def write_container(
    path: str,
    schema: Schema,
    records: Iterable[dict],
    *,
    codec: str = "deflate",
    block_records: int = 4096,
    sync: Optional[bytes] = None,
) -> int:
    """Write records to an Avro object container file; returns record count."""
    names = _Names()
    _collect_names(schema, names)
    sync = sync or os.urandom(SYNC_SIZE)
    count_total = 0
    with open(path, "wb") as f:
        f.write(MAGIC)
        header = BinaryEncoder(f)
        meta = {
            "avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8"),
        }
        header.write_long(len(meta))
        for k, v in meta.items():
            header.write_string(k)
            header.write_bytes(v)
        header.write_long(0)
        f.write(sync)

        buf = io.BytesIO()
        enc = BinaryEncoder(buf)
        in_block = 0

        def flush():
            nonlocal in_block
            if in_block == 0:
                return
            raw = buf.getvalue()
            if codec == "deflate":
                raw = zlib.compress(raw)[2:-4]  # raw deflate stream (no zlib header/adler)
            elif codec != "null":
                raise ValueError(f"unsupported codec {codec!r}")
            blk = BinaryEncoder(f)
            blk.write_long(in_block)
            blk.write_long(len(raw))
            f.write(raw)
            f.write(sync)
            buf.seek(0)
            buf.truncate()
            in_block = 0

        for rec in records:
            write_datum(enc, schema, rec, names)
            in_block += 1
            count_total += 1
            if in_block >= block_records:
                flush()
        flush()
    return count_total


def read_header(data: bytes, path: str = "<bytes>"):
    """Parse the container header: (schema, codec, sync, body_start)."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path} is not an Avro container file")
    dec = BinaryDecoder(data, 4)
    meta: Dict[str, bytes] = {}
    n = dec.read_long()
    while n != 0:
        if n < 0:
            n = -n
            dec.read_long()
        for _ in range(n):
            k = dec.read_string()
            meta[k] = dec.read_bytes()
        n = dec.read_long()
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = dec.read_fixed(SYNC_SIZE)
    return schema, codec, sync, dec.pos


def list_container_files(path: str) -> List[str]:
    """The .avro part files under a directory (sorted; names starting with
    "." or "_" skipped: the HDFS part-file convention), or the file itself."""
    if os.path.isfile(path):
        return [path]
    return [
        os.path.join(path, name)
        for name in sorted(os.listdir(path))
        if not name.startswith((".", "_")) and name.endswith(".avro")
    ]


def read_container(path: str, *, quarantine: bool = False) -> tuple[Schema, List[Any]]:
    """Read every record from an Avro object container file."""
    records: List[Any] = []
    schema = None
    for schema, rec in iter_container(path, quarantine=quarantine):
        records.append(rec)
    if schema is None:  # empty container: still surface the schema
        with open(path, "rb") as f:
            data = f.read()
        schema, _, _, _ = read_header(data, path)
    return schema, records


def iter_container(path: str, *, quarantine: bool = False):
    """Stream (schema, record) pairs from an Avro container, decoding one
    block at a time: only a single block's decoded records are ever live
    (the file BYTES are read whole, but those are compact; the decoded
    Python dicts are the memory cost).

    By default a block that fails its framing, sync-marker check, inflate,
    or datum decode raises a ValueError naming the file and the block's
    byte offset. With `quarantine=True` such a block is skipped whole: the
    reader re-synchronizes at the next sync marker, counts the block in
    COUNTERS["quarantined_blocks"] and streams on; a torn tail block is
    skipped the same way. A file whose every block is bad still raises,
    and so does an unknown codec (a file-level fault, never quarantined).
    Quarantine is for row-shaped data, where a lost block costs rows
    (request replay, training ingest); model, score and checkpoint reads
    keep the strict default."""
    from photon_ml_tpu_torch.utils.faults import COUNTERS

    with open(path, "rb") as f:
        data = f.read()
    schema, codec, sync, pos = read_header(data, path)
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported codec {codec!r}")
    dec = BinaryDecoder(data, pos)
    names = _Names()
    _collect_names(schema, names)

    total_blocks = good_blocks = 0
    first_error: Optional[Exception] = None
    while dec.remaining > 0:
        block_start = dec.pos
        try:
            count = dec.read_long()
            size = dec.read_long()
            if count < 0 or size < 0 or size > dec.remaining:
                raise ValueError(
                    f"implausible block framing (count={count}, size={size})"
                )
            block = dec.read_fixed(size)
            if dec.read_fixed(SYNC_SIZE) != sync:
                raise ValueError("sync marker mismatch")
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            bdec = BinaryDecoder(block)
            # Decode the whole block BEFORE yielding: a datum error halfway
            # through must not hand a consumer half its records first.
            records = [read_datum(bdec, schema, names) for _ in range(count)]
        except Exception as exc:
            if not quarantine:
                raise ValueError(
                    f"{path}: corrupt block at byte {block_start} ({exc})"
                ) from exc
            total_blocks += 1
            first_error = first_error or exc
            COUNTERS.increment("quarantined_blocks")
            logger.warning("%s: quarantined corrupt block at byte %d (%s)", path, block_start, exc)
            # The next sync marker past the block's start is the next block
            # boundary; none left means the tail is unreadable.
            nxt = data.find(sync, block_start + 1)
            if nxt < 0:
                break
            dec.pos = nxt + SYNC_SIZE
            continue
        total_blocks += 1
        good_blocks += 1
        for rec in records:
            yield schema, rec
    if total_blocks and good_blocks == 0:
        raise ValueError(
            f"{path}: all {total_blocks} block(s) are corrupt (first error: {first_error})"
        )


def read_directory(path: str, *, quarantine: bool = False) -> tuple[Optional[Schema], List[Any]]:
    """Every record of the .avro part files under a directory (or of one
    file), in `list_container_files` order, and the first file's schema."""
    if os.path.isfile(path):
        return read_container(path, quarantine=quarantine)
    schema = None
    records: List[Any] = []
    for part in list_container_files(path):
        s, recs = read_container(part, quarantine=quarantine)
        schema = schema or s
        records.extend(recs)
    return schema, records


def iter_directory(path: str, *, quarantine: bool = False):
    """Stream (schema, record) pairs across every .avro part file under a
    directory (or one file), in `list_container_files` order."""
    for part in list_container_files(path):
        yield from iter_container(part, quarantine=quarantine)


def part_file_sizes(n_records: int, records_per_file: int) -> List[int]:
    """Records in each part file, split as the reference's
    `write_part_files` splits them: ceil(n / records_per_file) files, each
    but the last ceil(n / files) long. No records give one empty file."""
    n_files = max(1, math.ceil(n_records / records_per_file))
    per_file = math.ceil(n_records / n_files) if n_records else 0
    sizes = [per_file] * (n_files - 1)
    return sizes + [n_records - per_file * (n_files - 1)]


def part_file_path(output_dir: str, k: int) -> str:
    return os.path.join(output_dir, f"part-{k:05d}.avro")
