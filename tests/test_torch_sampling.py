"""Down-sampling (data/sampling.py) against the JAX package's: given the
same keep mask the weights are the same. Fits with sampling are not
compared bit for bit with the reference's, because the draws come from a
torch.Generator, not from jax.random; they are held to their own
determinism (same seed, same sample) instead."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import sampling as jax_sampling
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import LabeledData
from photon_ml_tpu_torch.data import sampling
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.types import TaskType


@pytest.mark.parametrize("task", list(TaskType))
def test_weights_given_the_keep_mask_match_jax(task):
    rng = np.random.default_rng(0)
    labels = (rng.uniform(size=500) < 0.3).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    key, rate = jax.random.PRNGKey(3), 0.4
    keep = np.array(jax.random.bernoulli(key, rate, labels.shape))
    negatives_only = sampling.down_sampler_for_task(task)
    assert negatives_only == jax_sampling.down_sampler_for_task(JaxTaskType[task.name])
    ref = jax_sampling.down_sample_weights(key, jnp.asarray(labels), jnp.asarray(weights), rate,
                                           negatives_only=negatives_only)
    got = sampling.keep_weights(torch.from_numpy(keep), torch.from_numpy(labels), torch.from_numpy(weights),
                                rate, negatives_only=negatives_only)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _fit(seed, rate):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(800, 5)).astype(np.float32)
    y = (rng.uniform(size=800) < 1 / (1 + np.exp(-X @ np.arange(5)))).astype(np.float32)
    ds = gd.GameDataset.build({"x": X}, y, id_tags={"e": rng.integers(0, 8, 800)}, device="cpu")
    cfg = config.CoordinateOptimizationConfig(regularization=config.L2, reg_weight=1.0,
                                              down_sampling_rate=rate)
    coord = FixedEffectCoordinate(ds, "x", cfg, TaskType.LOGISTIC_REGRESSION)
    return run_coordinate_descent({"fixed": coord}, 2, seed=seed).model["fixed"].coefficients.means, ds


def test_down_sampled_fits_are_reproducible_and_differ_from_the_full_fit():
    a, ds = _fit(5, 0.5)
    b, _ = _fit(5, 0.5)
    c, _ = _fit(6, 0.5)
    full, _ = _fit(5, 1.0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, full)
    data = LabeledData(ds.shards["x"], ds.labels, ds.offsets, ds.weights)
    w = sampling.down_sample(torch.Generator().manual_seed(0), data, 0.5, TaskType.LOGISTIC_REGRESSION).weights
    assert torch.all(w[ds.labels > 0.5] == 1.0) and set(w[ds.labels < 0.5].tolist()) <= {0.0, 2.0}
    sampled = FixedEffectCoordinate(ds, "x", config.CoordinateOptimizationConfig(down_sampling_rate=0.5),
                                    TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(ValueError, match="generator"):
        sampled.train(ds.offsets)
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("e", "x"))
    with pytest.raises(ValueError):
        RandomEffectCoordinate(ds, red, config.CoordinateOptimizationConfig(down_sampling_rate=0.5),
                               TaskType.LOGISTIC_REGRESSION)
