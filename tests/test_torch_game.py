"""The GLMix slice end to end against the JAX package: the random-effect
bucket layout, a small fixed effect + per-entity random effect fit by two
coordinate-descent sweeps (coefficients, training scores, AUC, validation
history), and the AUC metric."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.evaluation import metrics as jax_metrics
from photon_ml_tpu.evaluation import suite as jax_suite
from photon_ml_tpu.game import coordinate as jax_coordinate
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.evaluation import metrics, suite
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.types import TaskType

GLMIX = PORT_TOLERANCES["glmix"]


def glmix_arrays(seed=0, n=4096, d_fixed=32, d_re=4, n_entities=64, skew=False):
    """The bench's GLMix generator (bench.py primary measurement), in numpy."""
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fixed)).astype(np.float32)
    Xe = rng.normal(size=(n, d_re)).astype(np.float32)
    if skew:  # a long tail of entity sizes: several buckets and capped entities
        p = 1.0 / np.arange(1, n_entities + 1) ** 1.1
        entity = rng.choice(n_entities, size=n, p=p / p.sum())
    else:
        entity = rng.integers(0, n_entities, size=n)
    w = (rng.normal(size=d_fixed) * 0.1).astype(np.float32)
    u = (rng.normal(size=(n_entities, d_re)) * 0.5).astype(np.float32)
    margin = Xf @ w + np.einsum("nd,nd->n", Xe, u[entity])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return Xf, Xe, entity.astype(np.int64), y


LAYOUTS = {
    "uncapped": dict(min_bucket=8),
    "reservoir_cap": dict(active_upper_bound=40, min_bucket=8),
    "lower_bound_and_chunks": dict(active_upper_bound=64, active_lower_bound=5,
                                   min_bucket=4, max_block_cells=256),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_random_effect_layout_matches_jax(layout):
    Xf, Xe, entity, y = glmix_arrays(1, n=3000, n_entities=90, skew=True)
    kw = LAYOUTS[layout]
    ref = jax_gd.build_random_effect_dataset(
        jax_gd.GameDataset.build({"re": Xe}, y, id_tags={"e": entity}),
        jax_gd.RandomEffectDataConfig("e", "re", **kw),
    )
    got = gd.build_random_effect_dataset(
        gd.GameDataset.build({"re": Xe}, y, id_tags={"e": entity}, device="cpu"),
        gd.RandomEffectDataConfig("e", "re", **kw),
    )
    assert got.entity_index == ref.entity_index
    assert (got.num_active_samples, got.num_passive_samples) == (
        ref.num_active_samples, ref.num_passive_samples)
    if "active_upper_bound" in kw:
        assert got.num_passive_samples > 0  # the reservoir cap engaged
    np.testing.assert_array_equal(got.sample_entity_rows.numpy(), np.asarray(ref.sample_entity_rows))
    assert len(got.buckets) == len(ref.buckets) > 1
    for b, rb in zip(got.buckets, ref.buckets):
        np.testing.assert_array_equal(b.gather.numpy(), np.asarray(rb.gather))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(rb.mask))
        np.testing.assert_array_equal(b.entity_rows.numpy(), np.asarray(rb.entity_rows))


def test_gather_block_data_masks_padding():
    Xf, Xe, entity, y = glmix_arrays(2, n=500, n_entities=20)
    ds = gd.GameDataset.build({"re": Xe}, y, id_tags={"e": entity}, device="cpu")
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("e", "re", min_bucket=8))
    for b in red.buckets:
        block = gd.gather_block_data(ds, "re", b)
        assert block.features.shape == (b.num_entities, b.capacity, Xe.shape[1])
        assert torch.equal(block.weights, b.mask)
        assert torch.equal(block.features, ds.shards["re"][b.gather])


def _configs(pkg, fe_iters=40, re_iters=20):
    # The bench's iteration caps and L2 weights. Its tolerances (1e-8 FE,
    # 1e-7 RE) sit below float32 resolution of these objectives, so a solve
    # would stop wherever rounding noise first looks flat, in either
    # package; these stop on real progress and make the comparison exact.
    fe = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=fe_iters, tolerance=1e-6),
        regularization=pkg.L2, reg_weight=1.0,
    )
    re = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=re_iters, tolerance=1e-5),
        regularization=pkg.L2, reg_weight=10.0,
    )
    return fe, re


@pytest.fixture(scope="module")
def glmix_pair():
    """The same small GLMix fit by both packages: two sweeps, validation on
    the training set."""
    Xf, Xe, entity, y = glmix_arrays(0)
    re_kw = dict(active_upper_bound=48, min_bucket=16)

    jds = jax_gd.GameDataset.build({"global": Xf, "per_entity": Xe}, y, id_tags={"entityId": entity})
    jred = jax_gd.build_random_effect_dataset(
        jds, jax_gd.RandomEffectDataConfig("entityId", "per_entity", **re_kw))
    jfe, jre = _configs(jax_config)
    jtask = JaxTaskType.LOGISTIC_REGRESSION
    jcoords = {
        "fixed": jax_coordinate.FixedEffectCoordinate(jds, "global", jfe, jtask),
        "per-entity": jax_coordinate.RandomEffectCoordinate(jds, jred, jre, jtask),
    }
    jsuite = jax_suite.EvaluationSuite([jax_suite.EvaluatorType("AUC")], jds.labels)
    jres = jax_run_cd(
        jcoords, 2, validation_scorer=lambda c, m: jcoords[c].score(m), validation_suite=jsuite
    )

    ds = gd.GameDataset.build({"global": Xf, "per_entity": Xe}, y,
                              id_tags={"entityId": entity}, device="cpu")
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("entityId", "per_entity", **re_kw))
    fe, re = _configs(config)
    task = TaskType.LOGISTIC_REGRESSION
    coords = {
        "fixed": FixedEffectCoordinate(ds, "global", fe, task),
        "per-entity": RandomEffectCoordinate(ds, red, re, task),
    }
    psuite = suite.EvaluationSuite([suite.EvaluatorType("AUC")], ds.labels)
    res = run_coordinate_descent(
        coords, 2, validation_scorer=lambda c, m: coords[c].score(m), validation_suite=psuite
    )
    return dict(jcoords=jcoords, jres=jres, coords=coords, res=res, y=y)


def test_glmix_coefficients_match_jax(glmix_pair):
    jm, m = glmix_pair["jres"].model, glmix_pair["res"].model
    np.testing.assert_allclose(
        m["fixed"].coefficients.means.numpy(),
        np.asarray(jm["fixed"].coefficients.means), atol=GLMIX["coef_atol"], rtol=0,
    )
    got = m["per-entity"].coefficients_matrix.numpy()
    ref = np.asarray(jm["per-entity"].coefficients_matrix)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=GLMIX["coef_atol"], rtol=0)
    assert np.all(got[-1] == 0.0)  # the pinned unseen-entity row


def test_glmix_scores_and_auc_match_jax(glmix_pair):
    jc, c = glmix_pair["jcoords"], glmix_pair["coords"]
    jm, m = glmix_pair["jres"].model, glmix_pair["res"].model
    jscores = sum(np.asarray(jc[k].score(jm[k])) for k in jc)
    scores = sum(c[k].score(m[k]) for k in c)
    np.testing.assert_allclose(scores.numpy(), jscores, atol=GLMIX["score_atol"], rtol=0)
    y = glmix_pair["y"]
    auc = float(metrics.area_under_roc_curve(scores, torch.from_numpy(y)))
    jauc = float(jax_metrics.area_under_roc_curve(jnp.asarray(jscores), jnp.asarray(y)))
    assert abs(auc - jauc) <= GLMIX["auc_atol"]
    assert auc > 0.7


def test_glmix_validation_history_and_best_model(glmix_pair):
    jres, res = glmix_pair["jres"], glmix_pair["res"]
    assert [(i, c) for i, c, _ in res.validation_history] == [
        (i, c) for i, c, _ in jres.validation_history
    ]
    for (_, _, r), (_, _, jr) in zip(res.validation_history, jres.validation_history):
        assert abs(r.results["AUC"] - jr.results["AUC"]) <= GLMIX["auc_atol"]
    assert res.diverged_steps == 0
    assert set(res.best_model.coordinate_ids) == {"fixed", "per-entity"}
    assert int(res.train_stats["fixed"].iterations) > 0
    assert res.train_stats["per-entity"]["total_iterations"] > 0


@pytest.mark.parametrize("ties", [False, True])
def test_auc_matches_jax(ties):
    rng = np.random.default_rng(9)
    scores = rng.normal(size=2000).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    y = (rng.uniform(size=2000) < 0.4).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=2000).astype(np.float32)
    got = float(metrics.area_under_roc_curve(torch.from_numpy(scores), torch.from_numpy(y),
                                             torch.from_numpy(w)))
    ref = float(jax_metrics.area_under_roc_curve(jnp.asarray(scores), jnp.asarray(y), jnp.asarray(w)))
    assert abs(got - ref) <= 1e-6
    one_class = metrics.area_under_roc_curve(torch.from_numpy(scores), torch.zeros(2000))
    assert float(one_class) == 0.5


def test_fixed_effect_keeps_f32_on_cpu_and_locked_coordinates_only_score():
    Xf, Xe, entity, y = glmix_arrays(3, n=600, d_fixed=6, n_entities=10)
    ds = gd.GameDataset.build({"global": Xf, "per_entity": Xe}, y,
                              id_tags={"entityId": entity}, device="cpu")
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("entityId", "per_entity"))
    fe, re = _configs(config, 10, 5)
    task = TaskType.LOGISTIC_REGRESSION
    fixed = FixedEffectCoordinate(ds, "global", fe, task)
    assert fixed.training_features.dtype == torch.float32  # bf16 storage is for CUDA only
    coords = {"fixed": fixed, "per-entity": RandomEffectCoordinate(ds, red, re, task)}
    first = run_coordinate_descent(coords, 1)
    locked = run_coordinate_descent(
        coords, 1, initial_models=first.model, locked_coordinates={"fixed"}
    )
    assert torch.equal(locked.model["fixed"].coefficients.means,
                       first.model["fixed"].coefficients.means)
    with pytest.raises(ValueError):
        run_coordinate_descent(coords, 1, locked_coordinates={"fixed"})
