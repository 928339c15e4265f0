"""Carrying a model across: train GLMix in the JAX package, hand its arrays
to `convert.game_model_from_numpy`, and score in the port; the scores must
match the JAX GameTransformer's, on the training set and on a fresh set
with unseen entities."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.game import coordinate as jax_coordinate
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.transformers import game_transformer as jax_gt
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import TaskType

TOL = PORT_TOLERANCES["convert_scores"]


def _arrays(seed, n, n_entities=40, d_fixed=12, d_re=3, entity_offset=0):
    rng = np.random.default_rng(seed)
    Xf = (rng.normal(size=(n, d_fixed)) + 0.3).astype(np.float32)
    Xf[:, 0] = 1.0  # intercept, so the fixed effect can be standardized
    Xe = rng.normal(size=(n, d_re)).astype(np.float32)
    entity = rng.integers(0, n_entities, size=n) + entity_offset
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    return Xf, Xe, entity.astype(np.int64), y, off


@pytest.fixture(scope="module")
def jax_trained():
    Xf, Xe, entity, y, off = _arrays(0, 2000)
    ds = jax_gd.GameDataset.build(
        {"global": Xf, "per_entity": Xe}, y, offsets=off, id_tags={"entityId": entity}
    )
    red = jax_gd.build_random_effect_dataset(
        ds, jax_gd.RandomEffectDataConfig("entityId", "per_entity", min_bucket=16)
    )
    std = Xf.std(axis=0)
    factors = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0).astype(np.float32)
    factors[0] = 1.0
    shifts = Xf.mean(axis=0).astype(np.float32)
    shifts[0] = 0.0
    norm = JaxNorm(jnp.asarray(factors), jnp.asarray(shifts), 0)
    cfg = jax_config.CoordinateOptimizationConfig(
        optimizer=jax_config.OptimizerConfig(max_iterations=20, tolerance=1e-6),
        regularization=jax_config.L2, reg_weight=1.0,
    )
    task = JaxTaskType.LOGISTIC_REGRESSION
    coords = {
        "fixed": jax_coordinate.FixedEffectCoordinate(ds, "global", cfg, task, norm=norm),
        "per-entity": jax_coordinate.RandomEffectCoordinate(ds, red, cfg, task),
    }
    model = jax_run_cd(coords, 1).model
    specs = {
        "fixed": jax_gt.CoordinateScoringSpec("global", norm=norm),
        "per-entity": jax_gt.CoordinateScoringSpec(
            "per_entity", random_effect_type="entityId", entity_index=red.entity_index
        ),
    }
    transformer = jax_gt.GameTransformer(model, specs, task)
    return dict(model=model, transformer=transformer, factors=factors, shifts=shifts,
                entity_index=red.entity_index)


def _port_model(t):
    jm = t["model"]
    return convert.game_model_from_numpy(
        {
            "fixed": convert.FixedEffectArrays(
                "global", np.asarray(jm["fixed"].coefficients.means),
                factors=t["factors"], shifts=t["shifts"], intercept_index=0,
            ),
            "per-entity": convert.RandomEffectArrays(
                "per_entity", "entityId", np.asarray(jm["per-entity"].coefficients_matrix),
                t["entity_index"],
            ),
        },
        TaskType.LOGISTIC_REGRESSION,
        device="cpu",
    )


@pytest.mark.parametrize("which", ["training_set", "fresh_set_with_unseen_entities"])
def test_carried_model_scores_like_the_jax_transformer(jax_trained, which):
    if which == "training_set":
        Xf, Xe, entity, y, off = _arrays(0, 2000)
    else:  # entities 20..59: half of them unseen at training time
        Xf, Xe, entity, y, off = _arrays(1, 500, entity_offset=20)
    jds = jax_gd.GameDataset.build(
        {"global": Xf, "per_entity": Xe}, y, offsets=off, id_tags={"entityId": entity}
    )
    ref = jax_trained["transformer"].transform(jds)
    model, specs = _port_model(jax_trained)
    ds = GameDataset.build({"global": Xf, "per_entity": Xe}, y, offsets=off,
                           id_tags={"entityId": entity}, device="cpu")
    got = GameTransformer(model, specs, TaskType.LOGISTIC_REGRESSION).transform(ds)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **TOL)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means), **TOL)
    for cid in ("fixed", "per-entity"):
        np.testing.assert_allclose(
            got.per_coordinate[cid].numpy(), np.asarray(ref.per_coordinate[cid]), **TOL
        )
    if which != "training_set":
        unseen = entity >= 40
        assert unseen.any()
        assert torch.all(got.per_coordinate["per-entity"][torch.from_numpy(unseen)] == 0)


def test_convert_refuses_a_matrix_without_its_pinned_zero_row(jax_trained):
    matrix = np.asarray(jax_trained["model"]["per-entity"].coefficients_matrix).copy()
    index = jax_trained["entity_index"]
    bad = {
        "missing_row": (matrix[:-1], index),
        "nonzero_row": (np.where(np.arange(len(matrix))[:, None] == len(matrix) - 1, 1.0, matrix), index),
        "index_gap": (matrix, {k: v + 1 for k, v in index.items()}),
    }
    for m, idx in bad.values():
        with pytest.raises(ValueError):
            convert.game_model_from_numpy(
                {"re": convert.RandomEffectArrays("per_entity", "entityId", m, idx)},
                TaskType.LOGISTIC_REGRESSION, device="cpu",
            )
