"""Corrupt Avro blocks on the port's read paths, against the JAX package.

Row-shaped reads (training ingest, request replay) read with quarantine: a
block that fails its framing, sync marker, inflate or datum decode is
skipped whole, counted in `quarantined_blocks`, and the read goes on. The
same corrupted files go through the JAX package's readers, and the records,
rows, features, tags and counter must be equal:

  * `io.avro.iter_container(quarantine=True)` against the JAX reader, for a
    block whose inflate fails (deflate), a block whose datum decode fails
    halfway (null codec: the first records decode and are dropped with the
    block), a bad sync marker, bad framing and a torn tail block;
  * `read_game_dataset` on both of the port's routes (the native decoder
    quarantines by itself) against the JAX package's ingest, which falls
    back to its Python codec with quarantine;
  * a file whose every block is bad raises in both packages, and an
    unknown codec raises even under quarantine;
  * the `decode` fault site: a transient fault is retried and gives the
    clean rows; spent retries raise, naming the file.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from photon_ml_tpu.io import avro as jax_avro
from photon_ml_tpu.io import avro_data as jad
from photon_ml_tpu.utils import faults as jax_faults
from photon_ml_tpu_torch.data.index_map import DELIMITER
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_data as pad
from photon_ml_tpu_torch.io import avro_fast
from photon_ml_tpu_torch.native import avro_reader
from photon_ml_tpu_torch.utils import faults, telemetry

ROWS, BLOCK = 480, 60  # 8 blocks a file
TAGS = ("userId", "movieId")
CORRUPTIONS = ("inflate", "decode", "sync", "framing", "torn_tail")


@pytest.fixture(autouse=True)
def _port_counters():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _write(path, seed, codec):
    """ROWS training records, BLOCK a block, with integer-valued tags and
    named features, written by the port's Python record writer."""
    rng = np.random.default_rng(seed)
    feats = [[(f"f{j}", float(v)) for j, v in zip(rng.choice(30, size=5, replace=False), rng.normal(size=5))]
             for _ in range(ROWS)]
    labels = (rng.uniform(size=ROWS) < 0.5).astype(float)
    tags = {"userId": rng.integers(0, 40, size=ROWS), "movieId": rng.integers(0, 9, size=ROWS)}
    # Block 3 (the one `_corrupt` breaks) has user ids of its own, so a
    # value of it left in a tag table would show.
    tags["userId"][3 * BLOCK:4 * BLOCK] += 1000
    avro_io.write_container(path, _schema(), _records(feats, labels, tags), codec=codec, block_records=BLOCK)


def _schema():
    from photon_ml_tpu_torch.io import schemas

    return schemas.TRAINING_EXAMPLE


def _records(feats, labels, tags):
    for i, label in enumerate(labels):
        yield {"uid": f"r{i}", "label": float(label),
               "features": [{"name": n, "term": "", "value": v} for n, v in feats[i]],
               "weight": 1.0 + (i % 3), "offset": 0.01 * (i % 7),
               "metadataMap": {k: str(v[i]) for k, v in tags.items()}}


def _blocks(data: bytes, path: str):
    """(start, payload start, payload end) of each block."""
    _, _, sync, pos = avro_io.read_header(data, path)
    out = []
    dec = avro_io.BinaryDecoder(data, pos)
    while dec.remaining > 0:
        start = dec.pos
        dec.read_long()
        size = dec.read_long()
        out.append((start, dec.pos, dec.pos + size))
        dec.pos += size + avro_io.SYNC_SIZE
    return out


def _corrupt(path: str, how: str, block: int = 3) -> None:
    data = bytearray(open(path, "rb").read())
    blocks = _blocks(bytes(data), path)
    start, lo, hi = blocks[block]
    if how == "inflate":
        data[lo] = 0x07  # a final deflate block of the reserved type 3
    elif how == "decode":
        data[hi - 40:hi] = b"\xff" * 40  # the block's last records run off its end
    elif how == "sync":
        data[hi + 5] ^= 0x5A  # the block's sync marker: its successor is lost with it
    elif how == "framing":
        data[start:lo] = b"\xff" * (lo - start)  # the count and size varints
    elif how == "torn_tail":
        _, lo, hi = blocks[-1]
        del data[(lo + hi) // 2:]
    else:
        raise ValueError(how)
    open(path, "wb").write(bytes(data))


def _jax_quarantined() -> int:
    return jax_faults.COUNTERS.get("quarantined_blocks")


def _port_quarantined() -> int:
    return faults.COUNTERS.get("quarantined_blocks")


@pytest.mark.parametrize("how", CORRUPTIONS)
def test_a_quarantined_read_matches_the_jax_reader(tmp_path, how):
    codec = "null" if how == "decode" else "deflate"
    path = str(tmp_path / "part-0.avro")
    _write(path, 1, codec)
    clean = avro_io.read_container(path)[1]
    _corrupt(path, how)
    with pytest.raises(ValueError, match="corrupt block at byte"):
        avro_io.read_container(path)  # strict by default
    j0 = _jax_quarantined()
    theirs = [r for _, r in jax_avro.iter_container(path, quarantine=True)]
    j_count = _jax_quarantined() - j0
    ours = [r for _, r in avro_io.iter_container(path, quarantine=True)]
    assert ours == theirs and _port_quarantined() == j_count == 1
    assert 0 < len(ours) < len(clean) and all(r in clean for r in ours)
    lost = {"sync": 2 * BLOCK, "torn_tail": ROWS - (ROWS // BLOCK - 1) * BLOCK}.get(how, BLOCK)
    assert len(clean) - len(ours) == lost
    assert avro_io.read_container(path, quarantine=True)[1] == ours
    assert avro_io.read_directory(str(tmp_path), quarantine=True)[1] == ours
    assert [r for _, r in avro_io.iter_directory(str(tmp_path), quarantine=True)] == ours


def _dataset_parts(root, how):
    """Two part files (deflate, or null for the mid-block decode case);
    the first corrupted."""
    codec = "null" if how == "decode" else "deflate"
    for fi in range(2):
        _write(str(root / f"part-{fi}.avro"), 10 + fi, codec)
    _corrupt(str(root / "part-0.avro"), how)
    return str(root)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("how", CORRUPTIONS)
def test_ingest_quarantines_as_the_jax_ingest(tmp_path, monkeypatch, how, route):
    path = _dataset_parts(tmp_path, how)
    if route == "python":
        monkeypatch.setattr(avro_fast, "compile_native", lambda *a, **k: None)
    configs = {"g": pad.FeatureShardConfig(("features",), True)}
    ds, built = pad.read_game_dataset(path, configs, id_tag_fields=list(TAGS), device="cpu")
    j0 = _jax_quarantined()
    jds, jbuilt = jad.read_game_dataset(path, {"g": jad.FeatureShardConfig(("features",), True)},
                                        id_tag_fields=list(TAGS))
    assert _port_quarantined() == _jax_quarantined() - j0 == 1
    assert ds.ingest_timing["ingest_path"] == ("native" if route == "native" else "python") \
        or ds.ingest_timing["ingest_path"] == "native-stream"
    for field in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(ds, field).numpy(), np.asarray(getattr(jds, field)), err_msg=field)
    assert 0 < ds.num_samples < 2 * ROWS
    sf, jsf = ds.shards["g"], jds.shards["g"]
    assert dict(built["g"].items()) == dict(jbuilt["g"].items())
    np.testing.assert_array_equal(sf.indices.numpy(), np.asarray(jsf.indices))
    np.testing.assert_array_equal(sf.values.numpy(), np.asarray(jsf.values))
    assert set(ds.id_tags) == set(jds.id_tags)
    kept = {""}.union(*(col.tolist() for col in jds.id_tags.values()))
    for tag, col in jds.id_tags.items():
        np.testing.assert_array_equal(ds.id_tags[tag], col, err_msg=tag)
        # The codes index the column, and their table (one for every tag on
        # the native route, with "" for an absent one) holds no value of a
        # dropped block.
        codes, table = ds.tag_codes[tag]
        np.testing.assert_array_equal(np.asarray(table)[codes], col, err_msg=tag)
        assert set(np.asarray(table).tolist()) <= kept


@pytest.mark.parametrize("route", ["native", "python"])
def test_a_file_with_every_block_corrupt_raises_in_both_packages(tmp_path, monkeypatch, route):
    path = str(tmp_path / "part-0.avro")
    _write(path, 3, "deflate")
    data = bytearray(open(path, "rb").read())
    for _, lo, _ in _blocks(bytes(data), path):
        data[lo] = 0x07
    open(path, "wb").write(bytes(data))
    if route == "python":
        monkeypatch.setattr(avro_fast, "compile_native", lambda *a, **k: None)
    with pytest.raises(ValueError, match=f"all {ROWS // BLOCK} block"):
        list(avro_io.iter_container(path, quarantine=True))
    with pytest.raises(ValueError, match=f"all {ROWS // BLOCK} block"):
        pad.read_game_dataset(path, {"g": pad.FeatureShardConfig(("features",), True)}, device="cpu")
    with pytest.raises(ValueError, match="corrupt"):
        list(jax_avro.iter_container(path, quarantine=True))
    with pytest.raises(ValueError):
        jad.read_game_dataset(path, {"g": jad.FeatureShardConfig(("features",), True)})


def test_an_unknown_codec_raises_even_under_quarantine(tmp_path):
    path = str(tmp_path / "part-0.avro")
    _write(path, 4, "null")
    data = open(path, "rb").read().replace(b"\x08null", b"\x08nope", 1)
    open(path, "wb").write(data)
    for reader in (avro_io, jax_avro):
        with pytest.raises(ValueError, match="unsupported codec"):
            list(reader.iter_container(path, quarantine=True))
    schema, codec, sync, body = avro_io.read_header(data, path)
    program = avro_reader.compile_program(
        schema, response="response", fallback_label="label", offset="offset", weight="weight",
        uid="uid", metadata_map="metadataMap", bag_names=("features",), tag_fields=())
    with pytest.raises(ValueError, match="unsupported codec"):
        avro_reader.decode_file_native(data, body, codec, sync, program, DELIMITER, quarantine=True)


def test_the_native_decoder_is_strict_unless_asked(tmp_path):
    path = str(tmp_path / "part-0.avro")
    _write(path, 5, "deflate")
    _corrupt(path, "inflate")
    data = open(path, "rb").read()
    schema, codec, sync, body = avro_io.read_header(data, path)
    program = avro_reader.compile_program(
        schema, response="response", fallback_label="label", offset="offset", weight="weight",
        uid="uid", metadata_map="metadataMap", bag_names=("features",), tag_fields=TAGS)
    with pytest.raises(ValueError, match="rejected"):
        avro_reader.decode_file_native(data, body, codec, sync, program, DELIMITER, path=path)
    for threads in (1, 3, 8):
        d = avro_reader.decode_file_native(data, body, codec, sync, program, DELIMITER, path=path,
                                           n_threads=threads, quarantine=True)
        assert d.quarantined_blocks == 1 and len(d.labels) == ROWS - BLOCK
    assert _port_quarantined() == 0  # counting is the caller's


def _one_clean_file(tmp_path):
    path = str(tmp_path / "part-0.avro")
    _write(path, 6, "deflate")
    return path


def test_a_transient_decode_fault_is_retried_and_gives_the_clean_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    path = _one_clean_file(tmp_path)
    configs = {"g": pad.FeatureShardConfig(("features",), True)}
    clean, _ = pad.read_game_dataset(path, configs, id_tag_fields=list(TAGS), device="cpu")
    with faults.inject("decode:2"):
        again, _ = pad.read_game_dataset(path, configs, id_tag_fields=list(TAGS), device="cpu")
    assert faults.COUNTERS.get("retries") == 2 and faults.COUNTERS.get("injected_faults") == 2
    np.testing.assert_array_equal(again.labels.numpy(), clean.labels.numpy())
    np.testing.assert_array_equal(again.shards["g"].indices.numpy(), clean.shards["g"].indices.numpy())
    np.testing.assert_array_equal(again.shards["g"].values.numpy(), clean.shards["g"].values.numpy())
    for tag in TAGS:
        np.testing.assert_array_equal(again.id_tags[tag], clean.id_tags[tag])


def test_spent_decode_retries_raise_naming_the_file(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    monkeypatch.setenv("PHOTON_RETRY_MAX_ATTEMPTS", "2")
    path = _one_clean_file(tmp_path)
    with faults.inject("decode:5"):
        with pytest.raises(RuntimeError, match=os.path.basename(path)) as err:
            pad.read_game_dataset(path, {"g": pad.FeatureShardConfig(("features",), True)}, device="cpu")
    assert isinstance(err.value.__cause__, faults.InjectedFault)
    assert faults.COUNTERS.get("retries") == 1 and faults.COUNTERS.get("injected_faults") == 2
