"""The port's off-heap index store (native/index_store.{cc,py}) and its two
indexing drivers (cli/build_index.py, cli/name_and_term.py) against the JAX
package's, on the CPU.

  * PHIDX partitions are the JAX package's byte for byte for the same keys
    and partition count, through the library and through the plain
    version; each package reads the other's stores to the same maps.
  * The JAX tests/test_index_store.py cases on the port: the partition
    round trip, the partitioned store's global indices, an empty partition,
    stale partitions, a metadata mismatch, a corrupt partition and the
    routing.
  * There is no fallback: when the native library does not build, every
    entry point raises.
  * cli.name_and_term and cli.build_index write the JAX drivers' files, from
    raw Avro data and from name-and-term files.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from photon_ml_tpu.cli import build_index as jax_build_index
from photon_ml_tpu.cli import name_and_term as jax_name_and_term
from photon_ml_tpu.native import index_store as jax_ist
from photon_ml_tpu_torch.cli import build_index, name_and_term
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.io.avro_data import write_training_examples
from photon_ml_tpu_torch.native import index_store as ist

KEYS = [feature_key(f"f{i}", f"t{i % 3}") for i in range(100)] + ["plain", INTERCEPT_KEY, "ünï\x01cödé"]
ENGINES = [False, True]  # force_python: the library, then the plain version


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def _random_keys(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return sorted({feature_key(f"n{rng.integers(0, n)}", f"t{rng.integers(0, 9)}" if rng.uniform() < 0.7 else "")
                   for _ in range(n)})


# ------------------------------------------------------------- the format


@pytest.mark.parametrize("force_python", ENGINES)
@pytest.mark.parametrize("keys_seed,n,partitions", [(0, 1, 1), (1, 300, 1), (2, 2000, 8), (3, 50, 3)])
def test_stores_are_the_jax_packages_byte_for_byte(tmp_path, force_python, keys_seed, n, partitions):
    keys = _random_keys(keys_seed, n)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert ist.build_partitioned_store(ours, keys, partitions, "s", force_python=force_python) == len(keys)
    jax_ist.build_partitioned_store(theirs, keys, partitions, "s")
    assert _files(ours) == _files(theirs)
    assert len(_files(ours)) == partitions


@pytest.mark.parametrize("force_python", ENGINES)
def test_each_package_reads_the_others_store(tmp_path, force_python):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    ist.build_partitioned_store(ours, KEYS, 4, "s")
    jax_ist.build_partitioned_store(theirs, KEYS, 4, "s")
    with ist.PartitionedIndexStore(theirs, "s", force_python=force_python) as a, \
            jax_ist.PartitionedIndexStore(ours, "s", force_python=force_python) as b:
        assert dict(a.items()) == dict(b.items())
        assert a.size == b.size == len(KEYS) and a.num_partitions == b.num_partitions == 4
        for key in KEYS:
            assert a.get_index(key) == b.get_index(key) >= 0
        assert a.intercept_index == b.intercept_index is not None


def test_the_hash_is_the_jax_packages(tmp_path):
    for key in KEYS + ["", "x" * 5000]:
        raw = key.encode("utf-8")
        assert ist.fnv1a64(raw) == jax_ist.fnv1a64(raw) == ist._hasher(False)(raw)
        for p in (1, 3, 8):
            assert ist.partition_for_key(key, p) == ist.partition_for_key(key, p, force_python=True) \
                == jax_ist.partition_for_key(key, p)


# ------------------------------------------- the JAX test_index_store cases


@pytest.mark.parametrize("force_python", ENGINES)
def test_partition_roundtrip(tmp_path, force_python):
    path = str(tmp_path / "part.bin")
    ist.build_partition(path, KEYS, force_python=force_python)
    part = ist.open_partition(path, force_python=force_python)
    assert part.size == len(KEYS)
    for i, key in enumerate(KEYS):
        assert part.get(key.encode()) == i
        assert part.name(i) == key
    assert part.get(b"missing") == -1
    assert part.name(len(KEYS)) is None
    part.close()
    jax_ist.build_partition(str(tmp_path / "jax.bin"), KEYS)
    assert open(path, "rb").read() == open(tmp_path / "jax.bin", "rb").read()


@pytest.mark.parametrize("builder_python,reader_python", [(True, False), (False, True)])
def test_the_library_and_the_plain_version_read_each_others_files(tmp_path, builder_python, reader_python):
    path = str(tmp_path / "part.bin")
    ist.build_partition(path, KEYS, force_python=builder_python)
    part = ist.open_partition(path, force_python=reader_python)
    for i, key in enumerate(KEYS):
        assert part.get(key.encode()) == i
        assert part.name(i) == key
    part.close()


def test_an_oversized_key_reads_back_whole(tmp_path):
    path = str(tmp_path / "part.bin")
    keys = ["k" * 10000, "short"]
    ist.build_partition(path, keys)
    part = ist.open_partition(path)
    assert [part.name(0), part.name(1)] == keys and part.get(keys[0].encode()) == 0
    part.close()


@pytest.mark.parametrize("force_python", ENGINES)
def test_empty_partition(tmp_path, force_python):
    path = str(tmp_path / "empty.bin")
    ist.build_partition(path, [], force_python=force_python)
    jax_ist.build_partition(str(tmp_path / "jax.bin"), [], force_python=True)
    assert open(path, "rb").read() == open(tmp_path / "jax.bin", "rb").read()
    for force in ENGINES:
        part = ist.open_partition(path, force_python=force)
        assert part.size == 0
        assert part.get(b"x") == -1
        part.close()


@pytest.mark.parametrize("force_python", ENGINES)
def test_partitioned_store_global_indices(tmp_path, force_python):
    """Global idx = local + offset, unique and dense over all partitions
    (PalDBIndexMap.scala:36-44 offset-array semantics), as the JAX store."""
    store_dir = str(tmp_path / "store")
    total = ist.build_partitioned_store(store_dir, KEYS, num_partitions=4, namespace="shardA",
                                        force_python=force_python)
    assert total == len(KEYS)
    with ist.PartitionedIndexStore(store_dir, "shardA", force_python=force_python) as store, \
            jax_ist.PartitionedIndexStore(store_dir, "shardA") as theirs:
        assert store.num_partitions == 4
        assert store.size == len(store) == len(KEYS)
        seen = {}
        for key in KEYS:
            idx = store.get_index(key)
            assert 0 <= idx < store.size and idx not in seen
            assert store[key] == idx == theirs.get_index(key)
            seen[idx] = key
            assert store.get_feature_name(idx) == key == theirs.get_feature_name(idx)
        assert sorted(seen) == list(range(len(KEYS)))
        assert store.get_index("nope") == -1 and "nope" not in store
        with pytest.raises(KeyError):
            store["nope"]
        assert store.get_feature_name(-1) is None
        assert store.get_feature_name(store.size) is None
        assert store.intercept_index == store.get_index(INTERCEPT_KEY) == theirs.intercept_index
        assert INTERCEPT_KEY in store
        assert dict(store.items()) == {v: k for k, v in seen.items()} == dict(theirs.items())
        assert list(store) == list(theirs)
        store.save(str(tmp_path / "ours.json"))
        theirs.save(str(tmp_path / "theirs.json"))
        assert json.load(open(tmp_path / "ours.json")) == json.load(open(tmp_path / "theirs.json"))


def test_rebuild_removes_stale_partitions(tmp_path):
    """Rebuilding with fewer partitions leaves no old file the loader would
    silently mix in."""
    store_dir = str(tmp_path / "store")
    ist.build_partitioned_store(store_dir, KEYS, num_partitions=4)
    ist.build_partitioned_store(store_dir, KEYS, num_partitions=2)
    assert not os.path.exists(os.path.join(store_dir, ist.partition_filename(2)))
    assert not os.path.exists(os.path.join(store_dir, ist.partition_filename(3)))
    with ist.PartitionedIndexStore(store_dir) as store:
        assert store.num_partitions == 2
        assert store.size == len(KEYS)
        assert all(store.get_index(k) >= 0 for k in KEYS)


def test_metadata_partition_count_mismatch(tmp_path):
    """A deleted partition file fails loudly, not as a truncated store."""
    store_dir = str(tmp_path / "store")
    ist.build_partitioned_store(store_dir, KEYS, num_partitions=3)
    with open(os.path.join(store_dir, ist.METADATA_FILE), "w") as f:
        json.dump({"num_partitions": 3}, f)
    os.remove(os.path.join(store_dir, ist.partition_filename(2)))
    for force in ENGINES:
        with pytest.raises(OSError, match="metadata"):
            ist.PartitionedIndexStore(store_dir, force_python=force)
    with pytest.raises(FileNotFoundError, match="no index partitions"):
        ist.PartitionedIndexStore(store_dir, "other")


def test_corrupt_partition_rejected(tmp_path):
    """Zero-slot and truncated files are refused by both engines, as by the
    JAX package's, without crashing the process."""
    path = str(tmp_path / "bad.bin")
    ist.build_partition(path, KEYS[:10])
    blob = bytearray(open(path, "rb").read())
    blob[16:24] = b"\x00" * 8  # num_slots
    open(path, "wb").write(bytes(blob))
    for force in ENGINES:
        with pytest.raises(OSError):
            ist.open_partition(path, force_python=force)
        with pytest.raises(OSError):
            jax_ist.open_partition(path, force_python=force)
    ist.build_partition(path, KEYS[:10])
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-4])
    for force in ENGINES:
        with pytest.raises(OSError):
            ist.open_partition(path, force_python=force)
    open(path, "wb").write(b"NOTPHIDX" + data[8:])
    for force in ENGINES:
        with pytest.raises(OSError):
            ist.open_partition(path, force_python=force)


def test_partition_routing_matches_hash(tmp_path):
    """Each key lives in the partition fnv1a64(key) % P selects."""
    store_dir = str(tmp_path / "store")
    ist.build_partitioned_store(store_dir, KEYS, num_partitions=3)
    for key in KEYS:
        p = ist.partition_for_key(key, 3)
        assert p == jax_ist.partition_for_key(key, 3)
        part = ist.open_partition(os.path.join(store_dir, ist.partition_filename(p)))
        assert part.get(key.encode()) >= 0
        part.close()


def test_without_the_native_library_every_entry_point_raises(tmp_path, monkeypatch):
    """No fallback: the plain version is reached by `force_python` alone."""
    store_dir = str(tmp_path / "store")
    ist.build_partitioned_store(store_dir, KEYS, num_partitions=2)

    def no_library():
        raise RuntimeError("g++ failed to build libphoton_native")

    monkeypatch.setattr(ist, "load_native", no_library)
    for call in (lambda: ist.build_partition(str(tmp_path / "p.bin"), KEYS),
                 lambda: ist.open_partition(os.path.join(store_dir, ist.partition_filename(0))),
                 lambda: ist.PartitionedIndexStore(store_dir),
                 lambda: ist.build_partitioned_store(str(tmp_path / "other"), KEYS, 2),
                 lambda: ist.partition_for_key("k", 2)):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
    with ist.PartitionedIndexStore(store_dir, force_python=True) as store:
        assert store.size == len(KEYS)


# --------------------------------------------------------------- the drivers


def _write_sample_data(path, n=40):
    feats = []
    for i in range(n):
        row = [(feature_key("age"), float(i)), (feature_key("genre", f"g{i % 5}"), 1.0)]
        if i % 2:
            row.append((feature_key("songs", f"s{i % 7}"), 2.0))
        feats.append(row)
    write_training_examples(path, feats, [float(i % 2) for i in range(n)])


@pytest.fixture()
def sample(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_sample_data(str(data / "part-0.avro"))
    _write_sample_data(str(data / "part-1.avro"), n=23)
    return str(data)


def test_name_and_term_driver_writes_the_jax_drivers_files(tmp_path, sample):
    args = ["--input-data-directories", sample, "--feature-bags-keys", "features"]
    assert name_and_term.main(args + ["--output-dir", str(tmp_path / "port")]) == 0
    assert jax_name_and_term.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    pairs = name_and_term.read_name_and_term_file(str(tmp_path / "port" / "features"))
    assert pairs == jax_name_and_term.read_name_and_term_file(str(tmp_path / "port" / "features"))
    assert ("age", "") in pairs and ("genre", "g0") in pairs and len(pairs) == len(set(pairs)) == 13
    # The decoded-records form gives the same pairs as the files' route.
    from photon_ml_tpu_torch.io import avro

    records = [r for f in sorted(os.listdir(sample)) for _, r in avro.iter_container(os.path.join(sample, f))]
    assert name_and_term.extract_name_and_terms(records, ["features"]) == \
        name_and_term.name_and_terms_of_files([sample], ["features"])


def test_name_and_term_rejects_delimiters(tmp_path):
    for pair in (("a\tb", "t"), ("a", "t\nx")):
        with pytest.raises(ValueError, match="tab/newline"):
            name_and_term.write_name_and_term_file(str(tmp_path / "f"), {pair})


@pytest.mark.parametrize("fmt", ["phidx", "paldb"])
@pytest.mark.parametrize("partitions", [1, 2])
def test_build_index_driver_from_raw_data_writes_the_jax_drivers_stores(tmp_path, sample, monkeypatch, fmt,
                                                                        partitions):
    monkeypatch.setattr("time.time", lambda: 1700000000.0)  # the PalDB header's timestamp
    args = ["--input-data-directories", sample, "--feature-shard-configurations",
            "name=globalShard,feature.bags=features", "--num-partitions", str(partitions),
            "--output-format", fmt]
    assert build_index.main(args + ["--output-dir", str(tmp_path / "port")]) == 0
    assert jax_build_index.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    meta = json.load(open(tmp_path / "port" / ist.METADATA_FILE))
    assert meta["num_partitions"] == partitions and meta["shards"]["globalShard"]["num_features"] == 14


def test_build_index_driver_from_name_and_term(tmp_path, sample):
    name_and_term.main(["--input-data-directories", sample, "--feature-bags-keys", "features",
                        "--output-dir", str(tmp_path / "nat")])
    args = ["--name-and-term-directory", str(tmp_path / "nat"), "--feature-shard-configurations",
            "name=globalShard,feature.bags=features,intercept=false", "--num-partitions", "3"]
    assert build_index.main(args + ["--output-dir", str(tmp_path / "port")]) == 0
    assert jax_build_index.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    with ist.PartitionedIndexStore(str(tmp_path / "port"), "globalShard") as store:
        assert store.get_index(feature_key("genre", "g1")) >= 0
        assert store.intercept_index is None and store.size == 13
    # Neither input: the driver refuses, as the JAX one does.
    with pytest.raises(SystemExit):
        build_index.main(["--feature-shard-configurations", "name=s", "--output-dir", str(tmp_path / "x")])


def test_shard_keys_are_the_jax_drivers(tmp_path, sample):
    from photon_ml_tpu.cli.config import parse_feature_shard_config as jax_parse
    from photon_ml_tpu.io import avro as jax_avro
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config

    shards = ["name=a,feature.bags=features", "name=b,feature.bags=features|other,intercept=false"]
    records = []
    for f in sorted(os.listdir(sample)):
        records.extend(jax_avro.read_container(os.path.join(sample, f))[1])
    theirs = jax_build_index.collect_shard_keys(records, dict(jax_parse(s) for s in shards))
    configs = dict(parse_feature_shard_config(s) for s in shards)
    assert build_index.collect_shard_keys(records, configs) == theirs
    assert build_index.shard_keys_of_files([sample], configs) == theirs
    with pytest.raises(ValueError, match="store_format"):
        build_index.build_index_stores(theirs, str(tmp_path / "x"), 1, "parquet")
