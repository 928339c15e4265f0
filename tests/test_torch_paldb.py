"""The port's PalDB v1 reader and writer (io/paldb.py) against the JAX
package's, on the CPU.

The reference's own PalDB fixtures are not in this repository (which is why
tests/test_paldb.py skips), so parity rests on the JAX package's writer:

  * `write_store` with a fixed timestamp writes the JAX bytes, for keys and
    values of every serialized form the index maps use; each package reads
    and looks up the other's stores.
  * `write_index_map` (the JAX one under a fixed clock) and `load_index_map`
    give the JAX files and maps, with Java string-hash partitioning;
    murmur3 and `java_string_hash` are the JAX functions.
  * `partition_files` matches shards exactly, and
    `resolve_offheap_index_maps` finds PalDB or PHIDX per shard to the maps
    the JAX function gives.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from photon_ml_tpu.io import paldb as jax_paldb
from photon_ml_tpu.native import index_store as jax_ist
from photon_ml_tpu_torch.io import paldb
from photon_ml_tpu_torch.native import index_store as ist

STAMP = 1_481_234_567_890


def _keys(seed: int, n: int):
    rng = np.random.default_rng(seed)
    names = {f"feat{rng.integers(0, 10 * n)}\x01term{rng.integers(0, 7)}" for _ in range(n)}
    return sorted(names | {"(INTERCEPT)\x01", "ünï\x01cödé"})


def _entries(keys):
    out = []
    for i, k in enumerate(keys):
        out.append((k, i))
        out.append((i, k))
    return out


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 9), (2, 300), (3, 2000)])
def test_write_store_is_the_jax_writer_byte_for_byte(tmp_path, seed, n):
    entries = _entries(_keys(seed, n))  # ids cover 0..8, 9..254 and varints past 254
    paldb.write_store(str(tmp_path / "port.dat"), entries, timestamp_ms=STAMP)
    jax_paldb.write_store(str(tmp_path / "jax.dat"), entries, timestamp_ms=STAMP)
    ours = open(tmp_path / "port.dat", "rb").read()
    assert ours == open(tmp_path / "jax.dat", "rb").read()
    assert paldb.read_store(str(tmp_path / "jax.dat")) == jax_paldb.read_store(str(tmp_path / "port.dat")) \
        == dict(entries)
    for k, v in entries[:: max(1, len(entries) // 50)]:
        assert paldb.lookup(ours, k) == jax_paldb.lookup(ours, k) == v
    assert paldb.lookup(ours, "absent\x01") is None and paldb.lookup(ours, 10**6) is None


def test_the_hashes_and_the_serialization_are_the_jax_functions():
    rng = np.random.default_rng(5)
    for n in range(0, 40):
        raw = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert paldb._murmur3_32(raw) == jax_paldb._murmur3_32(raw)
    for s in ["", "a", "feature\x01term", "ünï𝄞cödé", "x" * 300]:
        assert paldb.java_string_hash(s) == jax_paldb.java_string_hash(s)
        for p in (1, 2, 7):
            assert paldb.java_partition(s, p) == jax_paldb.java_partition(s, p)
    for v in [0, 8, 9, 254, 255, 10**9, "", "name\x01term"]:
        assert paldb._encode(v) == jax_paldb._encode(v)
        assert paldb._decode(paldb._encode(v), 0)[0] == v
    for bad in (True, -1):
        with pytest.raises((TypeError, ValueError)):
            paldb._encode(bad)


def test_read_store_rejects_a_non_paldb_file(tmp_path):
    path = tmp_path / "x.dat"
    path.write_bytes(b"\x00\x08NOTPALDB" + b"\x00" * 32)
    with pytest.raises(ValueError, match="not a PALDB_V1 store"):
        paldb.read_store(str(path))


@pytest.mark.parametrize("partitions", [1, 3])
def test_write_index_map_and_load_index_map_are_the_jax_functions(tmp_path, monkeypatch, partitions):
    """Partition by the Java hash of the stored key, sorted local ids, global
    id = local + the sizes before (PalDBIndexMap.load:88-96)."""
    monkeypatch.setattr("time.time", lambda: STAMP / 1000)
    feats = [f"f{i}" for i in range(97)] + ["name\x01term", "(INTERCEPT)"]
    ours = paldb.write_index_map(str(tmp_path / "port"), "myShard", feats, partitions)
    theirs = jax_paldb.write_index_map(str(tmp_path / "jax"), "myShard", feats, partitions)
    assert ours == theirs and len(ours) == len(feats)
    files = paldb.partition_files(str(tmp_path / "port"), "myShard")
    assert [os.path.basename(f) for f in files] == [f"paldb-partition-myShard-{k}.dat" for k in range(partitions)]
    for f in files:
        assert open(f, "rb").read() == open(str(tmp_path / "jax" / os.path.basename(f)), "rb").read()
    imap = paldb.load_index_map(str(tmp_path / "jax"), "myShard")
    jmap = jax_paldb.load_index_map(str(tmp_path / "port"), "myShard")
    assert dict(imap.items()) == dict(jmap.items()) == ours
    assert imap.intercept_index == jmap.intercept_index is not None
    for k in feats:
        stored = k if "\x01" in k else k + "\x01"
        blob = open(files[paldb.java_partition(stored, partitions)], "rb").read()
        assert paldb.lookup(blob, stored) is not None
    with pytest.raises(FileNotFoundError, match="no paldb-partition-other"):
        paldb.load_index_map(str(tmp_path / "port"), "other")


def test_load_index_map_cross_checks_both_directions(tmp_path):
    entries = _entries(["a\x01", "b\x01"])
    entries[-1] = (1, "c\x01")  # id 1 names another key
    paldb.write_store(str(tmp_path / "paldb-partition-s-0.dat"), entries, timestamp_ms=STAMP)
    with pytest.raises(ValueError, match="id->name mismatch"):
        paldb.load_index_map(str(tmp_path), "s")
    paldb.write_store(str(tmp_path / "paldb-partition-s-0.dat"), _entries(["a\x01"])[:1], timestamp_ms=STAMP)
    with pytest.raises(ValueError, match="asymmetric"):
        paldb.load_index_map(str(tmp_path), "s")


def test_partition_files_exact_shard_match(tmp_path):
    """Shard 'global' does not swallow 'global-v2' partitions or stray
    non-numeric .dat files."""
    for name in ("paldb-partition-global-0.dat", "paldb-partition-global-1.dat",
                 "paldb-partition-global-10.dat", "paldb-partition-global-v2-0.dat",
                 "paldb-partition-global-meta.dat"):
        (tmp_path / name).write_bytes(b"x")
    for shard in ("global", "global-v2", "missing"):
        ours = [os.path.basename(p) for p in paldb.partition_files(str(tmp_path), shard)]
        assert ours == [os.path.basename(p) for p in jax_paldb.partition_files(str(tmp_path), shard)]
    assert [os.path.basename(p) for p in paldb.partition_files(str(tmp_path), "global")] == [
        "paldb-partition-global-0.dat", "paldb-partition-global-1.dat", "paldb-partition-global-10.dat"]
    assert paldb.partition_files(str(tmp_path / "missing"), "x") == []


def test_resolve_offheap_index_maps_finds_each_shards_format(tmp_path):
    """One directory with a PalDB shard and a PHIDX shard, written by the
    JAX package: the port resolves each to the maps the JAX function gives."""
    d = str(tmp_path)
    jax_paldb.write_index_map(d, "a", [f"x{i}" for i in range(40)] + ["(INTERCEPT)"], 2)
    jax_ist.build_partitioned_store(d, [f"y{i}\x01t" for i in range(60)], 3, namespace="b")
    ours = paldb.resolve_offheap_index_maps(d, ["a", "b"])
    theirs = jax_paldb.resolve_offheap_index_maps(d, ["a", "b"])
    assert isinstance(ours["b"], ist.PartitionedIndexStore) and not isinstance(ours["a"], ist.PartitionedIndexStore)
    for shard in ("a", "b"):
        assert dict(ours[shard].items()) == dict(theirs[shard].items())
        assert ours[shard].size == theirs[shard].size
        assert ours[shard].intercept_index == theirs[shard].intercept_index
    with pytest.raises(FileNotFoundError, match="no index partitions"):
        paldb.resolve_offheap_index_maps(d, ["c"])
