"""`GameEstimator.fit` against the JAX package's on one small sparse GLMix (a
fixed effect plus per-user and per-movie random effects, all on one ELL
shard of 4 ids and an intercept over dim 101), from the same numpy arrays:
fixed-effect coefficients, back-projected random-effect matrices, slot
tables (bit-equal), variances, training and validation scores and the
validation metrics, under PORT_TOLERANCES["estimator"]. The validation
rows include users the training rows never saw."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.data.containers import SparseFeatures as JaxSparseFeatures
from photon_ml_tpu.estimators import game_estimator as jax_ge
from photon_ml_tpu.evaluation.suite import EvaluatorType as JaxEvaluatorType
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.transformers import game_transformer as jax_gt
from photon_ml_tpu.types import NormalizationType as JaxNorm
from photon_ml_tpu.types import ProjectorType as JaxProjector
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.types import VarianceComputationType as JaxVariance
from photon_ml_tpu.utils.contracts import FIT_TIMING_REQUIRED_KEYS as JAX_FIT_TIMING_REQUIRED_KEYS
from photon_ml_tpu.utils.contracts import PREPARE_STAGES as JAX_PREPARE_STAGES
from photon_ml_tpu_torch import contracts
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator, select_best_result
from photon_ml_tpu_torch.evaluation.suite import EvaluatorType
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import NormalizationType, TaskType, VarianceComputationType

TOL = PORT_TOLERANCES["estimator"]
D = 100  # ids 0..99; the intercept is column 100
TASK, JTASK = TaskType.LOGISTIC_REGRESSION, JaxTaskType.LOGISTIC_REGRESSION
_TRUTH = np.random.default_rng(99)
_W, _B_USER, _B_MOVIE = _TRUTH.normal(size=D + 1) * 0.3, _TRUTH.normal(size=400) * 0.7, _TRUTH.normal(size=40) * 0.7


def _arrays(seed, n, n_users, n_movies=12, k=4):
    """~40 rows a user (about 80 of the 101 features each, so the index map
    compacts), ~500 a movie; labels from one shared true model."""
    rng = np.random.default_rng(seed)
    users, movies = rng.integers(0, n_users, n), rng.integers(0, n_movies, n)
    idx = np.argsort(rng.uniform(size=(n, D)), axis=1)[:, :k]
    idx = np.concatenate([idx, np.full((n, 1), D)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, k)), np.ones((n, 1))], 1).astype(np.float32)
    margin = (val * _W[idx]).sum(1) + _B_USER[users] + _B_MOVIE[movies]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return idx, val, users.astype(str), movies.astype(str), y


def _datasets(seed, n, n_users):
    idx, val, users, movies, y = _arrays(seed, n, n_users)
    tags = {"userId": users, "movieId": movies}
    jds = jax_gd.GameDataset.build({"g": JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), D + 1)},
                                   y, id_tags=tags)
    ds = gd.GameDataset.build({"g": SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D + 1)},
                              y, id_tags=tags, device="cpu")
    return jds, ds


def _data_configs(pkg, pearson=None, user_projector=None):
    kw = {} if user_projector is None else {"projector_type": user_projector}
    return {
        "fixed": pkg.FixedEffectDataConfig("g"),
        "per-user": pkg.RandomEffectDataConfig(
            "userId", "g", active_upper_bound=64, min_bucket=8,
            num_features_to_samples_ratio_upper_bound=pearson, **kw),
        "per-movie": pkg.RandomEffectDataConfig("movieId", "g", active_upper_bound=256, min_bucket=8),
    }


def _opt_configs(pkg, variance, fe_weight=3.0, re_weight=5.0):
    def one(weight):
        return pkg.CoordinateOptimizationConfig(
            optimizer=pkg.OptimizerConfig(max_iterations=100, tolerance=1e-9),
            regularization=pkg.L2, reg_weight=weight, variance_computation=variance)
    return {"fixed": one(fe_weight), "per-user": one(re_weight), "per-movie": one(re_weight)}


CASES = {
    "index_map": dict(),
    "standardization_simple_variances": dict(normalization=True, variances=True),
    "pearson_ratio": dict(pearson=0.5),
    "two_configurations": dict(weights=[(10.0, 20.0), (3.0, 5.0)]),
}


def _fit_both(case, train, validation):
    jtr, tr = train
    jva, va = validation
    norm = case.get("normalization", False)
    pearson = case.get("pearson")
    weights = case.get("weights", [(3.0, 5.0)])
    variance = VarianceComputationType.SIMPLE if case.get("variances") else VarianceComputationType.NONE
    jvariance = JaxVariance.SIMPLE if case.get("variances") else JaxVariance.NONE
    common = dict(coordinate_descent_iterations=2, intercept_indices={"g": D})
    # The reference applies a Pearson mask, built over the original features,
    # to the projected slots (its gather indexes the mask by local slot), so
    # its INDEX_MAP fit with Pearson selection masks the wrong features; the
    # port maps the mask into the slots. Held against the reference's
    # IDENTITY projection, where slots are the original features.
    jest = jax_ge.GameEstimator(
        JTASK, _data_configs(jax_gd, pearson, JaxProjector.IDENTITY if pearson else None),
        normalization=JaxNorm.STANDARDIZATION if norm else JaxNorm.NONE,
        validation_evaluators=[JaxEvaluatorType("AUC"), JaxEvaluatorType("AUPR")], **common)
    est = GameEstimator(
        TASK, _data_configs(gd, pearson),
        normalization=NormalizationType.STANDARDIZATION if norm else NormalizationType.NONE,
        validation_evaluators=[EvaluatorType("AUC"), EvaluatorType("AUPR")], **common)
    jres = jest.fit(jtr, jva, [_opt_configs(jax_config, jvariance, *w) for w in weights])
    res = est.fit(tr, va, [_opt_configs(config, variance, *w) for w in weights])
    return jest, est, jres, res


def _back_projected(estimator, model, cid, port):
    proj = estimator._prepared[cid].projector
    m = model[cid].coefficients_matrix
    if port:
        return proj.back_project_matrix(m).numpy()
    return np.asarray(proj.back_project_matrix(m))


@pytest.fixture(scope="module")
def data():
    return _datasets(1, 6000, 150), _datasets(2, 2000, 200)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_the_jax_estimator(case, data):
    train, validation = data
    # Each case fits fresh datasets: fit registers projected shards on them.
    train, validation = _datasets(1, 6000, 150), _datasets(2, 2000, 200)
    jest, est, jres, res = _fit_both(CASES[case], train, validation)
    assert len(res) == len(jres)
    for r, jr in zip(res, jres):
        fe, jfe = r.model["fixed"].coefficients, jr.model["fixed"].coefficients
        np.testing.assert_allclose(fe.means.numpy(), np.asarray(jfe.means), atol=TOL["coef_atol"], rtol=0)
        for cid in ("per-user", "per-movie"):
            np.testing.assert_allclose(_back_projected(est, r.model, cid, True),
                                       _back_projected(jest, jr.model, cid, False),
                                       atol=TOL["coef_atol"], rtol=0, err_msg=cid)
        if CASES[case].get("variances"):
            np.testing.assert_allclose(fe.variances.numpy(), np.asarray(jfe.variances),
                                       rtol=TOL["variance_rtol"])
            for cid in ("per-user", "per-movie"):
                np.testing.assert_allclose(r.model[cid].variances_matrix.numpy(),
                                           np.asarray(jr.model[cid].variances_matrix),
                                           rtol=TOL["variance_rtol"], err_msg=cid)
        assert set(r.evaluation.results) == set(jr.evaluation.results) == {"AUC", "AUPR"}
        for name, value in jr.evaluation.results.items():
            assert abs(r.evaluation.results[name] - value) <= TOL["metric_atol"], name
    if "pearson" not in CASES[case]:
        for cid in ("per-user", "per-movie"):
            np.testing.assert_array_equal(est._prepared[cid].projector.slot_tables.numpy(),
                                          np.asarray(jest._prepared[cid].projector.slot_tables))
    else:
        # The reference's own INDEX_MAP fit with Pearson masks lands elsewhere
        # (its masks hit the wrong slots; ROADMAP, Queue 3).
        jidx = jax_ge.GameEstimator(JTASK, _data_configs(jax_gd, CASES[case]["pearson"]),
                                    coordinate_descent_iterations=2)
        jmodel = jidx.fit(train[0], None, [_opt_configs(jax_config, JaxVariance.NONE)])[0].model
        gap = np.abs(_back_projected(jidx, jmodel, "per-user", False)
                     - _back_projected(est, res[-1].model, "per-user", True)).max()
        assert gap > 10 * TOL["coef_atol"]
    # Training scores through the views prepare built; validation scores through the projector.
    # The coefficients are held in the normalized space; a score uses them times the factors.
    model, jmodel = res[-1].model, jres[-1].model
    factors = [spec.norm.factors.abs().max() for spec in est.scoring_specs().values() if spec.norm]
    score_atol = TOL["score_atol"] * max([1.0, *map(float, factors)])
    got = GameTransformer(model, est.scoring_specs(), TASK).transform(train[1], est.training_prepared())
    ref = jax_gt.GameTransformer(jmodel, jest.scoring_specs(), JTASK).transform(
        train[0], jest.training_prepared())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=score_atol, rtol=0)
    got = GameTransformer(model, est.scoring_specs(), TASK).transform(validation[1])
    ref = jax_gt.GameTransformer(jmodel, jest.scoring_specs(), JTASK).transform(validation[0])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=score_atol, rtol=0)
    unseen = np.array([int(u) >= 150 for u in validation[1].id_tags["userId"]])
    assert unseen.any() and torch.all(got.per_coordinate["per-user"][torch.from_numpy(unseen)] == 0)
    assert select_best_result(res)[0] == select_best_result(jres)[0]


def test_a_locked_coordinate_keeps_its_initial_model(data):
    train, _ = data
    train = _datasets(1, 6000, 150)
    none = dict(variance=VarianceComputationType.NONE)
    base = GameEstimator(TASK, _data_configs(gd)).fit(train[1], None, [_opt_configs(config, **none)])[0].model
    jbase = jax_ge.GameEstimator(JTASK, _data_configs(jax_gd)).fit(
        train[0], None, [_opt_configs(jax_config, JaxVariance.NONE)])[0].model
    cfgs = _opt_configs(config, re_weight=1.0, **none)
    jcfgs = _opt_configs(jax_config, JaxVariance.NONE, re_weight=1.0)
    est = GameEstimator(TASK, _data_configs(gd), locked_coordinates={"fixed"})
    jest = jax_ge.GameEstimator(JTASK, _data_configs(jax_gd), locked_coordinates={"fixed"})
    model = est.fit(train[1], None, [{c: cfgs[c] for c in ("per-user", "per-movie")}],
                    initial_model=base)[0].model
    jmodel = jest.fit(train[0], None, [{c: jcfgs[c] for c in ("per-user", "per-movie")}],
                      initial_model=jbase)[0].model
    assert torch.equal(model["fixed"].coefficients.means, base["fixed"].coefficients.means)
    np.testing.assert_allclose(model["fixed"].coefficients.means.numpy(),
                               np.asarray(jmodel["fixed"].coefficients.means), atol=TOL["coef_atol"], rtol=0)
    for cid in ("per-user", "per-movie"):
        np.testing.assert_allclose(_back_projected(est, model, cid, True),
                                   _back_projected(jest, jmodel, cid, False),
                                   atol=TOL["coef_atol"], rtol=0, err_msg=cid)
        assert not torch.equal(model[cid].coefficients_matrix, base[cid].coefficients_matrix)


def test_fit_timing_has_the_reference_stages_and_they_tile_prepare():
    assert contracts.PREPARE_STAGES == JAX_PREPARE_STAGES
    _, ds = _datasets(3, 1500, 40)
    est = GameEstimator(TASK, _data_configs(gd), normalization=NormalizationType.STANDARDIZATION,
                        intercept_indices={"g": D})
    est.fit(ds, None, [_opt_configs(config, VarianceComputationType.NONE)])
    ft = est.fit_timing
    assert set(contracts.FIT_TIMING_REQUIRED_KEYS) <= set(JAX_FIT_TIMING_REQUIRED_KEYS)
    assert set(JAX_PREPARE_STAGES) <= set(contracts.FIT_TIMING_REQUIRED_KEYS) <= set(ft)
    stages = sum(ft[k] for k in JAX_PREPARE_STAGES)
    assert ft["other"] >= 0 and stages + ft["other"] == pytest.approx(ft["prepare_s"], rel=1e-9, abs=1e-9)
    assert ft["re_build"] > 0 and ft["projector"] > 0 and ft["stats"] > 0 and ft["compile"] > 0
    assert ft["re_path"] == "device" and 0 < ft["re_device_s"] <= ft["re_build"] and ft["re_host_s"] == 0.0
    assert ft["pack"] == ft["upload"] == 0.0 and ft["solve_s"] > 0
    # Projected shards are registered beside the original, as in the reference.
    assert {"g@userId", "g@movieId"} <= set(ds.shards)
    # A second fit reuses what prepare built: no layout, no projection.
    est.fit(ds, None, [_opt_configs(config, VarianceComputationType.NONE)])
    assert est.fit_timing["re_build"] == 0.0 and est.fit_timing["re_path"] == "none"
    with pytest.raises(ValueError):
        est.fit(_datasets(3, 1500, 40)[1], None, [_opt_configs(config, VarianceComputationType.NONE)])


def test_estimator_refuses_bad_configurations():
    with pytest.raises(ValueError):
        GameEstimator(TASK, _data_configs(gd), update_sequence=["fixed", "nope"])
    with pytest.raises(ValueError):
        GameEstimator(TASK, _data_configs(gd), update_sequence=["fixed"])
    _, ds = _datasets(4, 600, 20)
    est = GameEstimator(TASK, _data_configs(gd))
    with pytest.raises(ValueError):
        est.fit(ds, None, [{"fixed": _opt_configs(config, VarianceComputationType.NONE)["fixed"]}])
    with pytest.raises(ValueError):
        est.fit(ds, None, [])
