"""The port's model and score stores and its model bridge against the JAX
package's, on the same numpy inputs.

  * Model directories: the port's save -> load is exact; a directory saved
    by either package loads in both to the same artifact, exactly; the
    port's columnar part files decode, through the JAX package's codec, to
    the records its per-record writer makes: the same part files, split the
    same way, byte for byte but for the random sync marker.
  * Score files: the same, for ScoringResultAvro, with and without uids,
    labels and weights, also byte for byte; both packages' `load_scores` agree, and the port's
    refuses a record with a metadataMap.
  * The bridge: one small GLMix's coordinates prepared by both estimators
    (INDEX_MAP and RANDOM projectors, STANDARDIZATION with a global and a
    per-entity context), given the same coefficients, convert to the same
    artifacts, warm-start the same matrices, and score the same once
    saved and loaded, within PORT_TOLERANCES["estimator"].
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.data.containers import SparseFeatures as JaxSparseFeatures
from photon_ml_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_ml_tpu.estimators import game_estimator as jax_ge
from photon_ml_tpu.game import model as jax_model
from photon_ml_tpu.io import avro as jax_avro
from photon_ml_tpu.io import model_bridge as jax_bridge
from photon_ml_tpu.io import model_store as jax_store
from photon_ml_tpu.io import score_store as jax_scores
from photon_ml_tpu.transformers.game_transformer import GameTransformer as JaxGameTransformer
from photon_ml_tpu.types import NormalizationType as JaxNorm
from photon_ml_tpu.types import ProjectorType as JaxProjector
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
from photon_ml_tpu_torch.game import model as port_model
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import model_bridge, model_store, schemas, score_store
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import NormalizationType, ProjectorType, TaskType

TOL = PORT_TOLERANCES["estimator"]
TASK, JTASK = TaskType.LOGISTIC_REGRESSION, JaxTaskType.LOGISTIC_REGRESSION
D = 60  # ids 0..59; the intercept is column 60


def _names():
    """Feature keys of the interchange tests: bare names, name+term keys and
    the intercept."""
    keys = {(f"f{i}" if i % 3 else f"f{i}\x01t{i % 5}"): i for i in range(D)}
    keys["(INTERCEPT)"] = D
    return keys


def _artifact(pkg, seed: int, *, variances: bool, zero_variance_row: bool = False):
    rng = np.random.default_rng(seed)
    e = 23
    means = rng.normal(size=(e, D + 1)).astype(np.float32)
    means[rng.uniform(size=means.shape) < 0.3] = 0.0
    var = None
    fe_var = None
    if variances:
        var = np.abs(rng.normal(size=(e, D + 1))).astype(np.float32)
        var[0, 3], var[1, 4] = np.inf, np.nan
        if zero_variance_row:
            var[2] = 0.0
        fe_var = np.abs(rng.normal(size=D + 1))
    coords = {
        "global": pkg.FixedEffectArtifact("g", rng.normal(size=D + 1), fe_var),
        "per-user": pkg.RandomEffectArtifact("userId", "g", [f"u{i}" for i in range(e)], means, var),
    }
    task = TASK if pkg is model_store else JTASK
    return pkg.GameModelArtifact(task, coords, {"global": {"reg_weight": 1.0}})


def _same_artifact(a, b):
    assert a.task.value == b.task.value and a.opt_configs == b.opt_configs
    assert sorted(a.coordinates) == sorted(b.coordinates)
    for cid, x in a.coordinates.items():
        y = b.coordinates[cid]
        assert x.feature_shard == y.feature_shard
        assert x.means.dtype == y.means.dtype and np.array_equal(x.means, y.means), cid
        assert (x.variances is None) == (y.variances is None), cid
        if x.variances is not None:
            assert np.array_equal(x.variances, y.variances), cid
        if hasattr(x, "entity_ids"):
            assert x.entity_ids == y.entity_ids and x.random_effect_type == y.random_effect_type


@pytest.mark.parametrize("threshold", [0.0, 0.5])
@pytest.mark.parametrize("variances", [False, True])
def test_port_save_then_load_is_exact(tmp_path, monkeypatch, threshold, variances):
    monkeypatch.setattr(model_store, "RECORDS_PER_FILE", 7)
    art = _artifact(model_store, 1, variances=variances)
    model_store.save_game_model(str(tmp_path), art, {"g": IndexMap(_names())},
                                sparsity_threshold=threshold)
    parts = os.listdir(tmp_path / "random-effect" / "per-user" / "coefficients")
    assert len(parts) == len(avro_io.part_file_sizes(23, 7)) == 4
    got = model_store.load_game_model(str(tmp_path), {"g": IndexMap(_names())})
    re, fe = got.coordinates["per-user"], got.coordinates["global"]
    src = art.coordinates["per-user"]
    kept = np.where(np.abs(src.means) > np.float32(threshold), src.means, 0.0)
    assert re.means.dtype == np.float32 and np.array_equal(re.means, kept)
    assert re.entity_ids == src.entity_ids
    assert np.array_equal(fe.means, np.where(np.abs(art.coordinates["global"].means) > threshold,
                                             art.coordinates["global"].means, 0.0))
    if variances:
        assert np.array_equal(re.variances, np.where(np.isfinite(src.variances), src.variances, 0.0))
    else:
        assert re.variances is None
    assert got.opt_configs == art.opt_configs


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("zero_variance_row", [False, True])
def test_a_directory_saved_by_either_package_loads_the_same_in_both(tmp_path, monkeypatch, writer,
                                                                    zero_variance_row):
    pkg = jax_store if writer == "jax" else model_store
    imap = (JaxIndexMap if writer == "jax" else IndexMap)(_names())
    monkeypatch.setattr(model_store, "RECORDS_PER_FILE", 10)
    split = dict(records_per_file=10) if writer == "jax" else {}
    pkg.save_game_model(str(tmp_path), _artifact(pkg, 2, variances=True,
                                                 zero_variance_row=zero_variance_row),
                        {"g": imap}, **split)
    ours = model_store.load_game_model(str(tmp_path), {"g": IndexMap(_names())})
    theirs = jax_store.load_game_model(str(tmp_path), {"g": JaxIndexMap(_names())})
    _same_artifact(ours, theirs)
    # An entity with no nonzero variance leaves the coordinate without variances, in both.
    assert (ours.coordinates["per-user"].variances is None) == zero_variance_row


@pytest.mark.parametrize("records_per_file", [5, 1000])
@pytest.mark.parametrize("threshold", [0.0, 0.25])
def test_columnar_model_parts_decode_to_the_jax_records(tmp_path, monkeypatch, records_per_file, threshold):
    monkeypatch.setattr(model_store, "RECORDS_PER_FILE", records_per_file)
    for pkg, tag in ((jax_store, "jax"), (model_store, "port")):
        imap = (JaxIndexMap if tag == "jax" else IndexMap)(_names())
        split = dict(records_per_file=records_per_file) if tag == "jax" else {}
        pkg.save_game_model(str(tmp_path / tag), _artifact(pkg, 3, variances=True), {"g": imap},
                            sparsity_threshold=threshold, **split)
    sub = os.path.join("random-effect", "per-user", "coefficients")
    files = sorted(os.listdir(tmp_path / "jax" / sub))
    assert files == sorted(os.listdir(tmp_path / "port" / sub))
    for name in files:
        assert _bytes_but_sync(tmp_path / "port" / sub / name) == _bytes_but_sync(tmp_path / "jax" / sub / name)
        s1, r1 = jax_avro.read_container(str(tmp_path / "jax" / sub / name))
        s2, r2 = jax_avro.read_container(str(tmp_path / "port" / sub / name))
        assert s1 == s2 and r1 == r2, name


def _bytes_but_sync(path) -> bytes:
    """A container's bytes with its random sync marker blanked: equal for
    two files of the same schema, codec, blocks and deflate streams."""
    with open(path, "rb") as f:
        data = f.read()
    schema, codec, sync, _ = avro_io.read_header(data, str(path))
    assert codec == "deflate"
    return data.replace(sync, bytes(avro_io.SYNC_SIZE))


@pytest.mark.parametrize("n,records_per_file", [(0, 4), (10, 4), (9, 4), (7, 2), (5, 100)])
def test_part_file_sizes_split_as_the_jax_writer_does(tmp_path, n, records_per_file):
    recs = [{"featureName": f"f{i}", "featureTerm": "", "metrics": {"max": float(i)}} for i in range(n)]
    jax_avro.write_part_files(str(tmp_path), schemas.FEATURE_SUMMARIZATION, iter(recs), n,
                              records_per_file=records_per_file)
    sizes = [len(jax_avro.read_container(str(tmp_path / name))[1]) for name in sorted(os.listdir(tmp_path))]
    assert avro_io.part_file_sizes(n, records_per_file) == sizes
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(avro_io.part_file_path(str(tmp_path), k))
                                            for k in range(len(sizes))]


def _score_columns(kind: str, n: int):
    rng = np.random.default_rng(4)
    scores = rng.normal(size=n).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    if kind == "bare":
        return scores, dict()
    if kind == "int_uids":
        return scores, dict(uids=np.arange(n), labels=labels)
    return scores, dict(uids=np.asarray([f"r{i % 97}" for i in range(n)]), labels=labels, weights=weights)


@pytest.mark.parametrize("kind", ["bare", "int_uids", "string_uids"])
def test_columnar_score_parts_decode_to_the_jax_records(tmp_path, monkeypatch, kind):
    n = 1300
    scores, cols = _score_columns(kind, n)
    monkeypatch.setattr(score_store, "RECORDS_PER_FILE", 500)
    jax_scores.save_scores(str(tmp_path / "jax"), scores, "m", records_per_file=500, **cols)
    port_cols = {k: (torch.from_numpy(v) if k in ("labels", "weights") else v) for k, v in cols.items()}
    assert score_store.save_scores(str(tmp_path / "port"), torch.from_numpy(scores), "m", **port_cols) == n
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 3
    for name in files:
        assert _bytes_but_sync(tmp_path / "port" / name) == _bytes_but_sync(tmp_path / "jax" / name)
        assert jax_avro.read_container(str(tmp_path / "jax" / name))[1] == \
            jax_avro.read_container(str(tmp_path / "port" / name))[1]
    for where in ("jax", "port"):
        ours = score_store.load_scores(str(tmp_path / where))
        theirs = jax_scores.load_scores(str(tmp_path / where))
        assert [vars(x) for x in ours] == [vars(x) for x in theirs]


@pytest.mark.parametrize("store", ["model", "scores"])
def test_stores_refuse_a_library_without_zlib_before_any_work(tmp_path, monkeypatch, store):
    """Both stores write deflate containers: with a library built without
    zlib they raise before a file or directory is made."""
    from photon_ml_tpu_torch.native import avro_writer

    monkeypatch.setattr(avro_writer, "_lib", lambda: type("NoZlib", (), {
        "photon_avro_has_deflate": staticmethod(lambda: 0)})())
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="zlib"):
        if store == "model":
            model_store.save_game_model(str(out), _artifact(model_store, 1, variances=False),
                                        {"g": IndexMap(_names())})
        else:
            score_store.save_scores(str(out), torch.zeros(4), "m")
    assert not out.exists()


def test_score_reader_refuses_a_metadata_map(tmp_path):
    """The reference can write id tags into a score record's metadataMap;
    the port writes none and refuses to read them rather than drop them."""
    scores = np.linspace(-1, 1, 10)
    jax_scores.save_scores(str(tmp_path), scores, "m", id_tags={"userId": [f"u{i}" for i in range(10)]})
    with pytest.raises(ValueError, match="metadataMap"):
        score_store.load_scores(str(tmp_path))


# ----------------------------------------------------------------- the bridge


def _bridge_data():
    rng = np.random.default_rng(5)
    n, n_users = 1600, 40
    users = rng.integers(0, n_users, n).astype(str)
    idx = np.argsort(rng.uniform(size=(n, D)), axis=1)[:, :4]
    idx = np.concatenate([idx, np.full((n, 1), D)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, 4)) + 0.5, np.ones((n, 1))], 1).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    jds = jax_gd.GameDataset.build({"g": JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), D + 1)},
                                   y, id_tags={"userId": users})
    ds = gd.GameDataset.build({"g": SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D + 1)},
                              y, id_tags={"userId": users}, device="cpu")
    return jds, ds


BRIDGE_CASES = {
    "index_map": (ProjectorType.INDEX_MAP, NormalizationType.NONE),
    "random": (ProjectorType.RANDOM, NormalizationType.NONE),
    "standardization_global": (ProjectorType.IDENTITY, NormalizationType.STANDARDIZATION),
    "standardization_per_entity": (ProjectorType.INDEX_MAP, NormalizationType.STANDARDIZATION),
}


@pytest.fixture(scope="module")
def bridge_data():
    return _bridge_data()


def _prepared_pair(case, data):
    proj, norm = BRIDGE_CASES[case]
    jds, ds = data
    dim = dict(projected_dim=8) if proj == ProjectorType.RANDOM else {}

    def configs(pkg, projector):
        return {"global": pkg.FixedEffectDataConfig("g"),
                "per-user": pkg.RandomEffectDataConfig("userId", "g", min_bucket=8,
                                                       projector_type=projector, **dim)}

    jest = jax_ge.GameEstimator(JTASK, configs(jax_gd, JaxProjector[proj.value]),
                                normalization=JaxNorm[norm.value], intercept_indices={"g": D})
    est = GameEstimator(TASK, configs(gd, proj), normalization=norm, intercept_indices={"g": D})
    jest.prepare(jds)
    est.prepare(ds)
    jspecs, specs = jest.scoring_specs(), est.scoring_specs()
    if proj == ProjectorType.RANDOM:  # the same P on both sides (each package draws its own)
        specs["per-user"].projector.matrix = torch.from_numpy(np.array(jspecs["per-user"].projector.matrix))
    return jspecs, specs


def _models(jspecs, specs):
    rng = np.random.default_rng(6)
    e = len(specs["per-user"].entity_index)
    d_re = specs["per-user"].projector.projected_dim
    fe, fe_var = rng.normal(size=D + 1).astype(np.float32), rng.uniform(0.5, 2, D + 1).astype(np.float32)
    m = rng.normal(size=(e + 1, d_re)).astype(np.float32)
    v = rng.uniform(0.5, 2, (e + 1, d_re)).astype(np.float32)
    m[e], v[e] = 0.0, 0.0
    jm = jax_model.GameModel({
        "global": jax_model.FixedEffectModel(jax_model.Coefficients(jnp.asarray(fe), jnp.asarray(fe_var)), JTASK),
        "per-user": jax_model.RandomEffectModel(jnp.asarray(m), jnp.asarray(v), JTASK)})
    pm = port_model.GameModel({
        "global": port_model.FixedEffectModel(port_model.Coefficients(torch.from_numpy(fe),
                                                                      torch.from_numpy(fe_var)), TASK),
        "per-user": port_model.RandomEffectModel(torch.from_numpy(m), torch.from_numpy(v), TASK)})
    return jm, pm


def _close(got, want, *, var=False):
    want = np.asarray(want)
    if var:
        np.testing.assert_allclose(got, want, rtol=TOL["variance_rtol"], atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL["coef_atol"])


@pytest.mark.parametrize("case", sorted(BRIDGE_CASES))
def test_bridge_matches_the_jax_bridge_and_round_trips(tmp_path, bridge_data, case):
    jspecs, specs = _prepared_pair(case, bridge_data)
    jm, pm = _models(jspecs, specs)
    jart = jax_bridge.artifact_from_game_model(jm, jspecs, JTASK)
    art = model_bridge.artifact_from_game_model(pm, specs, TASK)
    for cid in ("global", "per-user"):
        a, b = art.coordinates[cid], jart.coordinates[cid]
        _close(a.means, b.means)
        _close(a.variances, b.variances, var=True)
    assert art.coordinates["per-user"].entity_ids == jart.coordinates["per-user"].entity_ids

    # Warm start: the artifact back in each estimator's training representation.
    jwarm = jax_bridge.warm_start_model_for_estimator(jart, jspecs)
    warm = model_bridge.warm_start_model_for_estimator(art, specs, "cpu")
    _close(warm["global"].coefficients.means.numpy(), jwarm["global"].coefficients.means)
    _close(warm["per-user"].coefficients_matrix.numpy(), jwarm["per-user"].coefficients_matrix)
    if BRIDGE_CASES[case][0] != ProjectorType.RANDOM:  # least squares through P is not an inverse
        again = model_bridge.artifact_from_game_model(warm, specs, TASK)
        for cid in ("global", "per-user"):
            _close(again.coordinates[cid].means, art.coordinates[cid].means)

    # Saved by the port, loaded and scored by each package in original space.
    model_store.save_game_model(str(tmp_path), art, {"g": IndexMap(_names())})
    loaded = model_store.load_game_model(str(tmp_path), {"g": IndexMap(_names())})
    jloaded = jax_store.load_game_model(str(tmp_path), {"g": JaxIndexMap(_names())})
    _same_artifact(loaded, jloaded)
    jds, ds = bridge_data
    model, lspecs = model_bridge.game_model_from_artifact(loaded, "cpu")
    jmodel, jlspecs = jax_bridge.game_model_from_artifact(jloaded)
    scores = GameTransformer(model, lspecs, TASK).transform(ds).scores.numpy()
    jscores = np.asarray(JaxGameTransformer(jmodel, jlspecs, JTASK).transform(jds).scores)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=TOL["score_atol"])
