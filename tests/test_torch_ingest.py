"""The port's `read_game_dataset` against the JAX package's on the same Avro
files: labels, offsets, weights, ELL planes, id tags, factorized tag codes
and index maps must be exactly equal, on the native route and on the
Python route. Cases: `examples/generate_dataset.py` data through the JAX
package's `cli.libsvm_to_avro`; a two-file columnar write with integer
tags; a multi-bag shard with a key repeated across bags and the intercept
key in the data; supplied index maps that drop unseen features; and a
schema the native compiler rejects. The port never falls back: a file the
native route rejects raises."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import libsvm_to_avro
from photon_ml_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_ml_tpu.io import avro_data as jad
from photon_ml_tpu.utils.contracts import INGEST_STAGES, INGEST_TIMING_REQUIRED_KEYS
from photon_ml_tpu_torch import contracts
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_data as pad
from photon_ml_tpu_torch.native.avro_writer import write_training_examples_columnar

REPO = Path(__file__).resolve().parent.parent


def _generate_module():
    spec = importlib.util.spec_from_file_location("generate_dataset", REPO / "examples" / "generate_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs(pkg, spec):
    return {name: pkg.FeatureShardConfig(bags, icpt) for name, (bags, icpt) in spec.items()}


def read_both(path, shards, *, tags=(), maps=None):
    """(port dataset, port maps, JAX dataset, JAX maps) of one read."""
    jmaps_in = None if maps is None else {k: JaxIndexMap(dict(v.items())) for k, v in maps.items()}
    ds, built = pad.read_game_dataset(path, _configs(pad, shards), id_tag_fields=list(tags),
                                      index_maps=maps, device="cpu")
    jds, jbuilt = jad.read_game_dataset(path, _configs(jad, shards), id_tag_fields=list(tags),
                                        index_maps=jmaps_in)
    return ds, built, jds, jbuilt


def assert_same_dataset(ds, built, jds, jbuilt):
    for field in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(ds, field).numpy(), np.asarray(getattr(jds, field)),
                                      err_msg=field)
    assert set(ds.shards) == set(built) == set(jbuilt)
    for name in ds.shards:
        sf, jsf = ds.shards[name], jds.shards[name]
        assert sf.dim == jsf.dim == built[name].size
        np.testing.assert_array_equal(sf.indices.numpy(), np.asarray(jsf.indices), err_msg=name)
        np.testing.assert_array_equal(sf.values.numpy(), np.asarray(jsf.values), err_msg=name)
        assert dict(built[name].items()) == dict(jbuilt[name].items())
    assert set(ds.id_tags) == set(jds.id_tags)
    for tag, col in jds.id_tags.items():
        np.testing.assert_array_equal(ds.id_tags[tag], col, err_msg=tag)
    # Ingest's codes where the JAX package has them (the native route); the
    # factorized tag elsewhere.
    assert set(ds.tag_codes) == set(ds.id_tags)
    for tag, col in jds.id_tags.items():
        codes, table = jds.tag_codes.get(tag) or gd.factorize_tag(col)
        np.testing.assert_array_equal(ds.tag_codes[tag][0], codes, err_msg=tag)
        np.testing.assert_array_equal(ds.tag_codes[tag][1], table, err_msg=tag)
    timing = ds.ingest_timing
    assert set(timing) == set(INGEST_TIMING_REQUIRED_KEYS)
    assert all(timing[k] >= 0.0 for k in INGEST_STAGES) and timing["stash"] == 0.0
    assert timing["ingest_path"] == jds.ingest_timing["ingest_path"]
    assert timing["chunks"] == jds.ingest_timing["chunks"]


def test_port_contract_keys_are_the_jax_packages():
    assert contracts.INGEST_STAGES == INGEST_STAGES
    assert contracts.INGEST_TIMING_REQUIRED_KEYS == INGEST_TIMING_REQUIRED_KEYS


def test_generated_libsvm_through_the_jax_converter(tmp_path):
    _generate_module().generate(str(tmp_path / "train.libsvm"), 2500, 0, entities=40)
    path = str(tmp_path / "train.avro")
    libsvm_to_avro.convert(str(tmp_path / "train.libsvm"), path, tag_comments=True)
    ds, built, jds, jbuilt = read_both(path, {"g": (("features",), True)}, tags=("memberId",))
    assert_same_dataset(ds, built, jds, jbuilt)
    assert ds.ingest_timing["ingest_path"] == "native" and "uid" in ds.id_tags


def _columnar_files(root, n=6000, seed=23):
    """bench.py's e2e generator at a small size: two files, 8 ids a row over
    dim 200, integer userId/movieId tags written by the native writer."""
    rng = np.random.default_rng(seed)
    users, movies = rng.integers(0, 41, size=n), rng.integers(0, 12, size=n)
    indptr = np.arange(n + 1, dtype=np.int64) * 8
    ids = rng.integers(0, 200, size=n * 8).astype(np.int32)
    vals = rng.normal(size=n * 8)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float64)
    half = n // 2
    for fi, (lo, hi) in enumerate([(0, half), (half, n)]):
        write_training_examples_columnar(
            str(root / f"part-{fi}.avro"), labels[lo:hi], indptr[lo:hi + 1] - indptr[lo],
            ids[indptr[lo]:indptr[hi]], vals[indptr[lo]:indptr[hi]], [f"f{i}" for i in range(200)],
            int_tags={"userId": users[lo:hi], "movieId": movies[lo:hi]})
    return str(root)


def test_two_file_columnar_write_with_integer_tags(tmp_path):
    path = _columnar_files(tmp_path)
    ds, built, jds, jbuilt = read_both(path, {"g": (("features",), True)}, tags=("userId", "movieId"))
    assert_same_dataset(ds, built, jds, jbuilt)
    assert ds.ingest_timing["chunks"] == 2
    assert ds.ingest_timing["ingest_path"] in ("native", "native-stream")
    # The intercept is one constant column after the 8 ids of every row.
    assert ds.shards["g"].indices.shape == (6000, 9)
    assert bool((ds.shards["g"].indices[:, 8] == built["g"].intercept_index).all())


MULTI_BAG = {
    "name": "TwoBags",
    "type": "record",
    "fields": [
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": {
            "name": "F", "type": "record", "fields": [
                {"name": "name", "type": "string"}, {"name": "term", "type": "string"},
                {"name": "value", "type": "double"}]}}},
        {"name": "extra", "type": {"type": "array", "items": "F"}},
        {"name": "weight", "type": "double"},
        {"name": "metadataMap", "type": ["null", {"type": "map", "values": "string"}]},
    ],
}


def test_multi_bag_shard_with_repeated_and_intercept_keys(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    recs = []
    for i in range(700):
        feats = [{"name": f"a{j}", "term": "t" if j % 2 else "", "value": float(rng.normal())}
                 for j in rng.choice(12, size=3, replace=False)]
        extra = [{"name": f"a{i % 12}", "term": "", "value": float(rng.normal())},
                 {"name": f"b{i % 5}", "term": "", "value": 1.5}]
        if i % 4 == 0:  # the intercept key in the data itself
            extra.append({"name": INTERCEPT_KEY, "term": "", "value": 2.0})
        recs.append(dict(label=float(i % 2), features=feats, extra=extra, weight=1.0 + i % 3,
                         metadataMap={"userId": str(i % 13)}))
    path = str(tmp_path / "bags.avro")
    avro_io.write_container(path, MULTI_BAG, recs, codec="null")
    shards = {"both": (("features", "extra"), True), "extra": (("extra",), True),
              "features": (("features",), False)}
    ds, built, jds, jbuilt = read_both(path, shards, tags=("userId",))
    assert_same_dataset(ds, built, jds, jbuilt)
    assert ds.ingest_timing["ingest_path"] == "native"

    # The intercept key in the data of a shard without an intercept: the
    # port drops it on the native route as both packages' Python routes do.
    # (The JAX package's native route keeps it as index -1, so the planes
    # are held to its Python route here.)
    monkeypatch.setenv("PHOTON_DISABLE_NATIVE", "1")
    ds, built, jds, jbuilt = read_both(path, {"extra": (("extra",), False)})
    assert jds.ingest_timing["ingest_path"] == "python"
    assert ds.ingest_timing["ingest_path"] == "native" and INTERCEPT_KEY not in built["extra"]
    dense = _dense(ds.shards["extra"]), _dense(jds.shards["extra"])
    np.testing.assert_array_equal(*dense)
    assert dict(built["extra"].items()) == dict(jbuilt["extra"].items())


def _dense(sf):
    idx, val = np.asarray(sf.indices), np.asarray(sf.values)
    out = np.zeros((idx.shape[0], sf.dim), np.float64)
    np.add.at(out, (np.arange(idx.shape[0])[:, None].repeat(idx.shape[1], 1), idx), val)
    return out


def test_supplied_index_maps_drop_unseen_features(tmp_path):
    path = _columnar_files(tmp_path, n=3000, seed=7)
    maps = {"g": IndexMap.from_feature_names({f"f{i}" for i in range(0, 200, 3)}, add_intercept=True)}
    ds, built, jds, jbuilt = read_both(path, {"g": (("features",), True)}, tags=("userId",), maps=maps)
    assert_same_dataset(ds, built, jds, jbuilt)
    assert built["g"] is maps["g"] and ds.shards["g"].dim == 68
    with pytest.raises(ValueError, match="intercept"):
        pad.read_game_dataset(path, _configs(pad, {"g": (("features",), True)}),
                              index_maps={"g": IndexMap.from_feature_names({"f1"})}, device="cpu")


def test_schema_the_native_compiler_rejects_takes_the_python_route(tmp_path):
    schema = {"name": "Scored", "type": "record", "fields": [
        {"name": "response", "type": "double"},
        {"name": "score", "type": "double"},  # a float-typed tag: Python route only
        {"name": "features", "type": {"type": "array", "items": {
            "name": "F", "type": "record", "fields": [
                {"name": "name", "type": "string"}, {"name": "term", "type": "string"},
                {"name": "value", "type": "double"}]}}},
        {"name": "offset", "type": "double"},
    ]}
    rng = np.random.default_rng(9)
    recs = [dict(response=float(i % 3 == 0), score=float(i % 7) / 2,
                 features=[{"name": f"x{j}", "term": "", "value": float(rng.normal())}
                           for j in rng.choice(30, size=1 + i % 5, replace=False)]
                 + [{"name": "x0", "term": "", "value": 1.0}] * (i % 2),  # repeated within a record
                 offset=float(rng.normal()))
            for i in range(900)]
    avro_io.write_container(str(tmp_path / "part-0.avro"), schema, recs[:500])
    avro_io.write_container(str(tmp_path / "part-1.avro"), schema, recs[500:])
    ds, built, jds, jbuilt = read_both(str(tmp_path), {"g": (("features",), True)}, tags=("score",))
    assert_same_dataset(ds, built, jds, jbuilt)
    assert ds.ingest_timing["ingest_path"] == "python" and not jds.tag_codes


def test_a_file_the_native_route_rejects_raises(tmp_path):
    path = _columnar_files(tmp_path, n=3000, seed=11)
    part = Path(path) / "part-1.avro"
    data = bytearray(part.read_bytes())
    data[len(data) // 2:len(data) // 2 + 64] = b"\xff" * 64
    part.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="rejected"):
        pad.read_game_dataset(path, _configs(pad, {"g": (("features",), True)}), device="cpu")


def test_entity_layout_from_tag_codes_is_the_string_sorted_layout(tmp_path):
    """Integer tags are strings after ingest, so entity "10" sorts before
    "2"; the layout from ingest's codes is the one from the tag factorized
    by np.unique, as a dataset built from arrays has it."""
    ds, _ = pad.read_game_dataset(_columnar_files(tmp_path, n=4000, seed=13),
                                  _configs(pad, {"g": (("features",), True)}),
                                  id_tag_fields=["userId"], device="cpu")
    cfg = gd.RandomEffectDataConfig("userId", "g", active_upper_bound=64, min_bucket=8)
    fast = gd.entity_layout(ds.tag_codes["userId"], cfg, torch.device("cpu"))
    built = gd.GameDataset.build({}, ds.labels, id_tags=ds.id_tags, device="cpu")
    slow = gd.entity_layout(built.tag_codes["userId"], cfg, torch.device("cpu"))
    assert fast.entity_index == slow.entity_index
    assert list(fast.entity_index)[:3] == ["0", "1", "10"]
    np.testing.assert_array_equal(fast.codes, slow.codes)
    for a, b in zip(fast.blocks, slow.blocks):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_a_corrupt_block_on_the_python_route_raises(tmp_path):
    schema = {"name": "Tagged", "type": "record", "fields": [
        {"name": "label", "type": "double"},
        {"name": "score", "type": "double"},  # a float-typed tag: Python route only
        {"name": "features", "type": {"type": "array", "items": {
            "name": "F", "type": "record", "fields": [
                {"name": "name", "type": "string"}, {"name": "value", "type": "double"}]}}},
    ]}
    path = tmp_path / "part-0.avro"
    recs = [dict(label=1.0, score=0.5, features=[{"name": f"x{i % 9}", "value": 1.0}]) for i in range(600)]
    avro_io.write_container(str(path), schema, recs, codec="null", block_records=100)
    data = bytearray(path.read_bytes())
    data[len(data) // 2:len(data) // 2 + 32] = b"\xff" * 32
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt block"):
        pad.read_game_dataset(str(tmp_path), _configs(pad, {"g": (("features",), True)}),
                              id_tag_fields=["score"], device="cpu")


@pytest.mark.parametrize("case", ["duplicates", "clean", "extra_col_clean", "extra_col_duplicates"])
def test_pack_csr_to_ell_matches_the_jax_packer(case):
    from photon_ml_tpu.data.containers import pack_csr_to_ell as jax_pack
    from photon_ml_tpu_torch.data.containers import pack_csr_to_ell

    rng = np.random.default_rng(17)
    n, dim = 400, 60
    lens = rng.integers(0, 12, size=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    if case.endswith("duplicates"):
        cols = rng.integers(0, dim - 1, size=int(indptr[-1]))  # repeats within rows
    else:
        cols = np.concatenate([rng.choice(dim - 1, size=k, replace=False) for k in lens])
    vals = rng.normal(size=len(cols)).astype(np.float32)
    kw = {"duplicates": {}, "clean": dict(assume_clean=True),
          "extra_col_clean": dict(assume_clean=True, extra_col=(dim - 1, 1.0)),
          "extra_col_duplicates": dict(extra_col=(dim - 1, 2.5))}[case]
    sf = pack_csr_to_ell(indptr, cols, vals, dim, **kw)
    jsf = jax_pack(indptr, cols, vals, dim, device=False, **kw)
    np.testing.assert_array_equal(sf.indices.numpy(), np.asarray(jsf.indices))
    np.testing.assert_array_equal(sf.values.numpy(), np.asarray(jsf.values))
