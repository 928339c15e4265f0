"""The port's Avro codec, container files and native library against the
JAX package: files written by either package's writers (the Python record
writer with null and deflate codecs, the native columnar writer) decode to
the same records through the other package's readers, on the Python codec
and on the native decoder; corrupt and unsupported files raise on the
native route; concurrent first builds of the library agree."""

from __future__ import annotations

import io
import threading

import numpy as np
import pytest

from photon_ml_tpu.data.index_map import DELIMITER as JAX_DELIMITER
from photon_ml_tpu.io import avro as jax_avro
from photon_ml_tpu.io import schemas as jax_schemas
from photon_ml_tpu.native import avro_reader as jax_reader
from photon_ml_tpu.native import avro_writer as jax_writer
from photon_ml_tpu_torch.data.index_map import DELIMITER
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_data, schemas
from photon_ml_tpu_torch.native import avro_reader, avro_writer, build

PRIMITIVES = {
    "name": "P",
    "type": "record",
    "fields": [
        {"name": "l", "type": "long"},
        {"name": "i", "type": "int"},
        {"name": "f", "type": "float"},
        {"name": "d", "type": "double"},
        {"name": "b", "type": "boolean"},
        {"name": "s", "type": "string"},
        {"name": "y", "type": "bytes"},
        {"name": "u", "type": ["null", "string"]},
        {"name": "a", "type": {"type": "array", "items": "double"}},
        {"name": "m", "type": {"type": "map", "values": "long"}},
        {"name": "e", "type": {"type": "enum", "name": "E", "symbols": ["x", "y"]}},
        {"name": "x", "type": {"type": "fixed", "name": "F", "size": 3}},
    ],
}


def _primitive_records(n=300, seed=0):
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, 63, -64, 64, 2**31 - 1, -(2**31), 2**63 - 1, -(2**63)]
    return [
        dict(
            l=edges[i % len(edges)] if i < 40 else int(rng.integers(-(2**40), 2**40)),
            i=int(rng.integers(-(2**31), 2**31)),
            f=float(np.float32(rng.normal())),
            d=float(rng.normal()),
            b=bool(i % 2),
            s="ü" * (i % 4) + str(i),
            y=bytes(rng.integers(0, 256, size=i % 5, dtype=np.uint8)),
            u=None if i % 3 == 0 else f"u{i}",
            a=[float(v) for v in rng.normal(size=i % 4)],
            m={f"k{j}": j - i for j in range(i % 3)},
            e="xy"[i % 2],
            x=bytes([i % 256, 1, 2]),
        )
        for i in range(n)
    ]


def test_binary_codec_matches_the_jax_codec_both_ways():
    for value in (0, 1, -1, 63, -64, 64, 300, -(2**31), 2**63 - 1, -(2**63)):
        port, ref = io.BytesIO(), io.BytesIO()
        avro_io.BinaryEncoder(port).write_long(value)
        jax_avro.BinaryEncoder(ref).write_long(value)
        assert port.getvalue() == ref.getvalue()
        assert jax_avro.BinaryDecoder(port.getvalue()).read_long() == value
        assert avro_io.BinaryDecoder(ref.getvalue()).read_long() == value
    names, jnames = avro_io._Names(), jax_avro._Names()
    avro_io._collect_names(PRIMITIVES, names)
    jax_avro._collect_names(PRIMITIVES, jnames)
    for rec in _primitive_records(50):
        port, ref = io.BytesIO(), io.BytesIO()
        avro_io.write_datum(avro_io.BinaryEncoder(port), PRIMITIVES, rec, names)
        jax_avro.write_datum(jax_avro.BinaryEncoder(ref), PRIMITIVES, rec, jnames)
        assert port.getvalue() == ref.getvalue()
        assert avro_io.read_datum(avro_io.BinaryDecoder(ref.getvalue()), PRIMITIVES, names) == rec


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_container_files_cross_read(tmp_path, codec):
    recs = _primitive_records()
    mine, theirs = str(tmp_path / "port.avro"), str(tmp_path / "jax.avro")
    assert avro_io.write_container(mine, PRIMITIVES, recs, codec=codec, block_records=64) == len(recs)
    jax_avro.write_container(theirs, PRIMITIVES, recs, codec=codec, block_records=64)
    for path in (mine, theirs):
        schema, got = jax_avro.read_container(path)
        assert schema == PRIMITIVES and got == recs
        schema, got = avro_io.read_container(path)
        assert schema == PRIMITIVES and got == recs
    assert schemas.TRAINING_EXAMPLE == jax_schemas.TRAINING_EXAMPLE
    assert schemas.BAYESIAN_LINEAR_MODEL == jax_schemas.BAYESIAN_LINEAR_MODEL


def _training_columns(n=900, d=40, seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 7, size=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    ids = np.concatenate([rng.choice(d, size=k, replace=False) for k in lens]).astype(np.int32)
    return dict(
        labels=(rng.uniform(size=n) < 0.4).astype(np.float64),
        feature_indptr=indptr,
        feature_name_ids=ids,
        feature_values=rng.normal(size=len(ids)),
        feature_names=[f"f{j}" for j in range(d)],
        offsets=rng.normal(size=n) * 0.1,
        weights=rng.uniform(0.5, 2.0, size=n),
        int_tags={"userId": rng.integers(0, 50, size=n), "movieId": rng.integers(0, 9, size=n)},
    )


def _decode_native(module, path, tags, delimiter):
    with open(path, "rb") as f:
        data = f.read()
    schema, codec, sync, body = jax_avro.read_header(data, path)
    program = module.compile_program(
        schema, response="response", fallback_label="label", offset="offset", weight="weight",
        uid="uid", metadata_map="metadataMap", bag_names=("features",), tag_fields=tags)
    assert program is not None
    return module.decode_file_native(data, body, codec, sync, program, delimiter, n_threads=3)


def _assert_decoded_equal(a, b):
    for field in ("labels", "offsets", "weights", "tag_ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    for field in ("bag_indptr", "bag_keys", "bag_vals"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            np.testing.assert_array_equal(x, y, err_msg=field)
    assert a.keys == b.keys and a.tag_values == b.tag_values


@pytest.mark.parametrize("writer", ["port_native", "jax_native", "port_python", "jax_python"])
def test_training_files_decode_alike_in_both_packages(tmp_path, writer):
    """Each writer's file, decoded by the port's and the JAX package's native
    decoders (the same columns) and by both Python codecs (the same
    records)."""
    cols = _training_columns()
    path = str(tmp_path / f"{writer}.avro")
    if writer.endswith("native"):
        write = (avro_writer if writer == "port_native" else jax_writer).write_training_examples_columnar
        assert write(path, block_records=128, **cols) == len(cols["labels"])
    else:
        names = cols["feature_names"]
        ip, ids, vals = cols["feature_indptr"], cols["feature_name_ids"], cols["feature_values"]
        feats = [[(names[ids[e]], vals[e]) for e in range(ip[i], ip[i + 1])]
                 for i in range(len(cols["labels"]))]
        pkg = avro_data if writer == "port_python" else __import__(
            "photon_ml_tpu.io.avro_data", fromlist=["write_training_examples"])
        pkg.write_training_examples(path, feats, cols["labels"], offsets=cols["offsets"],
                                    weights=cols["weights"], id_tags=cols["int_tags"])
    tags = ("userId", "movieId")
    _assert_decoded_equal(_decode_native(avro_reader, path, tags, DELIMITER),
                          _decode_native(jax_reader, path, tags, JAX_DELIMITER))
    assert avro_io.read_container(path)[1] == jax_avro.read_container(path)[1]


def test_port_writers_agree_with_the_jax_writers_record_for_record(tmp_path):
    cols = _training_columns(seed=2)
    mine, theirs = str(tmp_path / "port.avro"), str(tmp_path / "jax.avro")
    avro_writer.write_training_examples_columnar(mine, **cols)
    jax_writer.write_training_examples_columnar(theirs, **cols)
    assert avro_io.read_container(mine)[1] == jax_avro.read_container(theirs)[1]


def test_deflate_file_of_the_jax_package_decodes_natively_or_names_zlib(tmp_path, monkeypatch):
    cols = _training_columns(seed=3)
    names = cols["feature_names"]
    ip, ids, vals = cols["feature_indptr"], cols["feature_name_ids"], cols["feature_values"]
    feats = [[(names[ids[e]], vals[e]) for e in range(ip[i], ip[i + 1])] for i in range(len(ip) - 1)]
    from photon_ml_tpu.io import avro_data as jax_avro_data

    path = str(tmp_path / "deflate.avro")
    jax_avro_data.write_training_examples(path, feats, cols["labels"], id_tags=cols["int_tags"])
    assert jax_avro.read_header(open(path, "rb").read())[1] == "deflate"
    tags = ("userId", "movieId")
    if avro_reader.has_deflate():
        _assert_decoded_equal(_decode_native(avro_reader, path, tags, DELIMITER),
                              _decode_native(jax_reader, path, tags, JAX_DELIMITER))
    monkeypatch.setattr(avro_reader, "has_deflate", lambda: False)
    with pytest.raises(ValueError, match="zlib"):
        _decode_native(avro_reader, path, tags, DELIMITER)


def _three_block_file(tmp_path):
    schema = {"name": "R", "type": "record", "fields": [{"name": "v", "type": "long"}]}
    p = str(tmp_path / "q.avro")
    avro_io.write_container(p, schema, [{"v": i} for i in range(6)], block_records=2)
    data = bytearray(open(p, "rb").read())
    _, _, sync, _ = avro_io.read_header(bytes(data), p)
    marks = [i for i in range(len(data)) if bytes(data[i:i + 16]) == sync]
    assert len(marks) == 4  # header + 3 blocks
    return p, data, sync, marks


@pytest.mark.parametrize("where", ["middle", "torn_tail"])
def test_python_reader_raises_on_a_corrupt_block(tmp_path, where):
    """The port's reader is strict, as the JAX reader is by default: a
    corrupt middle block or a torn last block raises, naming the block."""
    p, data, sync, marks = _three_block_file(tmp_path)
    if where == "middle":
        data[marks[1] + len(sync):marks[2]] = b"\xff" * (marks[2] - marks[1] - len(sync))
    else:
        del data[marks[3] - 3:]
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt block at byte"):
        avro_io.read_container(p)
    with pytest.raises(ValueError, match="corrupt block at byte"):
        list(avro_io.iter_container(p))
    with pytest.raises(ValueError):
        jax_avro.read_container(p)


def test_native_decoder_raises_on_a_corrupt_file_and_an_unknown_codec(tmp_path):
    cols = _training_columns(n=600, seed=4)
    path = str(tmp_path / "t.avro")
    avro_writer.write_training_examples_columnar(path, block_records=100, **cols)
    data = bytearray(open(path, "rb").read())
    schema, codec, sync, body = avro_io.read_header(bytes(data), path)
    program = avro_reader.compile_program(
        schema, response="response", fallback_label="label", offset="offset", weight="weight",
        uid="uid", metadata_map="metadataMap", bag_names=("features",), tag_fields=())
    mid = len(data) // 2
    data[mid:mid + 40] = b"\xff" * 40
    with pytest.raises(ValueError, match="rejected"):
        avro_reader.decode_file_native(bytes(data), body, codec, sync, program, DELIMITER, path=path)
    with pytest.raises(ValueError, match="unsupported codec"):
        avro_reader.decode_file_native(bytes(data), body, "snappy", sync, program, DELIMITER)


def test_concurrent_first_builds_agree(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    paths, errors = [], []

    def one():
        try:
            paths.append(build.build_library())
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(set(paths)) == 1 and paths[0].exists()
    assert not any(t.is_alive() for t in threads)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [paths[0].name]
    assert paths[0].name.endswith("-nozlib.so") != build.have_zlib()
