"""The evaluators (evaluation/metrics.py, evaluation/suite.py) against the
JAX package's: AUPR, precision@k, R^2, peak F1 and the grouped evaluators
(AUC and precision@k per id tag) on the same scores, with ties and
zero-weight rows."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.evaluation import metrics as jax_metrics
from photon_ml_tpu.evaluation import suite as jax_suite
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.evaluation import metrics, suite
from photon_ml_tpu_torch.types import TaskType

ATOL = PORT_TOLERANCES["glmix"]["auc_atol"]


def _scored(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=n), 2).astype(np.float32)  # ties
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-2 * scores))).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    weights[rng.uniform(size=n) < 0.1] = 0.0
    groups = rng.integers(0, 60, size=n)
    return scores, labels, weights, groups


@pytest.mark.parametrize("name", ["area_under_pr_curve", "r_squared", "peak_f1", "area_under_roc_curve"])
def test_global_metrics_match_jax(name):
    s, y, w, _ = _scored()
    got = getattr(metrics, name)(torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(w))
    ref = getattr(jax_metrics, name)(jnp.asarray(s), jnp.asarray(y), jnp.asarray(w))
    assert abs(float(got) - float(ref)) <= ATOL


@pytest.mark.parametrize("k", [1, 5, 80])
def test_precision_at_k_matches_jax(k):
    s, y, w, _ = _scored(1, n=60)
    got = metrics.precision_at_k(k, torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(w))
    ref = jax_metrics.precision_at_k(k, jnp.asarray(s), jnp.asarray(y), jnp.asarray(w))
    assert float(got) == float(ref)


def test_grouped_evaluators_match_jax():
    s, y, w, g = _scored(2)
    specs = ["AUC", "AUPR", "AUC:query", "PRECISION@3:query", "RMSE"]
    ets = [suite.EvaluatorType.parse(x) for x in specs]
    jets = [jax_suite.EvaluatorType.parse(x) for x in specs]
    assert [str(e) for e in ets] == [str(e) for e in jets]
    got = suite.EvaluationSuite(ets, torch.from_numpy(y), torch.from_numpy(w),
                                id_tag_values={"query": g}).evaluate(torch.from_numpy(s))
    ref = jax_suite.EvaluationSuite(jets, jnp.asarray(y), jnp.asarray(w),
                                    id_tag_values={"query": g}).evaluate(jnp.asarray(s))
    assert set(got.results) == set(ref.results)
    for key, value in ref.results.items():
        assert abs(got.results[key] - value) <= ATOL, key
    idx, jidx = suite.build_grouped_index(g), jax_suite.build_grouped_index(g)
    np.testing.assert_array_equal(idx.gather.numpy(), np.asarray(jidx.gather))
    np.testing.assert_array_equal(idx.mask.numpy(), np.asarray(jidx.mask))
    capped, jcapped = suite.build_grouped_index(g, max_group_size=20), jax_suite.build_grouped_index(
        g, max_group_size=20)
    np.testing.assert_array_equal(capped.gather.numpy(), np.asarray(jcapped.gather))
    with pytest.raises(ValueError):
        suite.EvaluationSuite([suite.EvaluatorType.parse("AUC:query")], torch.from_numpy(y))
    with pytest.raises(ValueError):
        suite.EvaluatorType.parse("NOPE")


def test_default_evaluators_and_direction_match_jax():
    for task in TaskType:
        assert str(suite.default_evaluator_for_task(task)) == str(
            jax_suite.default_evaluator_for_task(JaxTaskType[task.name]))
    for name in ("AUC", "AUPR", "RMSE", "LOGISTIC_LOSS"):
        et, jet = suite.EvaluatorType.parse(name), jax_suite.EvaluatorType.parse(name)
        assert suite.better_than(et, 0.6, 0.5) == jax_suite.better_than(jet, 0.6, 0.5)
