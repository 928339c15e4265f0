"""The port's hyperparameter search (photon_ml_tpu_torch/hyperparameter/)
against the JAX package's, on the CPU.

  * The kernels, the log evidence `_lml` and the posterior `_posterior` at
    fixed vectors agree with the JAX functions within
    PORT_TOLERANCES["gp_float32"]: the port's GP is float64 torch on the
    CPU, the JAX one float32.
  * The numpy halves are the JAX package's copies and agree exactly: the
    rescaling, the tuning JSON, the slice sampler on a numpy target, and
    every RANDOM proposal (the same scrambled Sobol stream), serial and
    batched.
  * BAYESIAN: the first `min_observations` proposals are Sobol points and
    equal. A later proposal is the argmax of expected improvement under
    slice-sampled kernels. Where both packages' samplers take the same
    accept/reject path (their kernel samples agree to 1e-4, a flipped step
    moves them by ~0.1 or more), the proposals are equal. Where the float32
    evidence flips a step, the two searches go their own ways, and the test
    compares the best value each found instead.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.hyperparameter import gp as jax_gp
from photon_ml_tpu.hyperparameter import kernels as jax_kernels
from photon_ml_tpu.hyperparameter import search as jax_search
from photon_ml_tpu.hyperparameter import tuner as jax_tuner
from photon_ml_tpu.hyperparameter.slice_sampler import slice_sample as jax_slice_sample
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.hyperparameter import gp, kernels, search, tuner
from photon_ml_tpu_torch.hyperparameter.slice_sampler import slice_sample

TOL = PORT_TOLERANCES["gp_float32"]
SAME_PATH_ATOL = 1e-4


def _draw(seed: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3.0 * x.sum(1)) + 0.1 * rng.normal(size=n)
    y = (y - y.mean()) / y.std()
    vec = np.concatenate([[0.5 * rng.normal(), np.log(1e-2) + rng.normal()], 0.5 * rng.normal(size=d)])
    return x, y, vec, rng.uniform(size=(9, d))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _configs(mod, d: int):
    return [mod.HyperparameterConfig(f"w{i}", 1e-4, 1e4, transform="LOG") for i in range(d)]


def _objective(point: np.ndarray) -> float:
    """A smooth bowl over log10 weights, best at 10 and 0.1."""
    target = np.array([1.0, -1.0])[: len(point)]
    return float(np.sum((np.log10(point) - target) ** 2))


# ------------------------------------------------------------- the GP math


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
@pytest.mark.parametrize("seed,n,d", [(0, 3, 1), (1, 8, 2), (2, 12, 3), (3, 20, 2)])
def test_lml_and_posterior_match_the_jax_functions(kernel, seed, n, d):
    x, y, vec, xt = _draw(seed, n, d)
    ours = float(gp._lml(kernel, _t(vec), _t(x), _t(y)))
    theirs = float(jax_gp._lml(kernel, jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y)))
    assert abs(ours - theirs) <= TOL["lml_rtol"] * max(1.0, abs(ours))
    mean, var = gp._posterior(kernel, _t(vec), _t(x), _t(y), _t(xt))
    jmean, jvar = jax_gp._posterior(kernel, jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(xt))
    assert mean.dtype == torch.float64 and mean.shape == (len(xt),)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=TOL["posterior_atol"])
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0, atol=TOL["posterior_atol"])
    assert bool((var > 0).all())


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
def test_kernels_and_gram_match_the_jax_functions(kernel):
    x, _, vec, xt = _draw(7, 10, 3)
    ours = kernels.KernelParams.from_vector(_t(vec))
    theirs = jax_kernels.KernelParams.from_vector(jnp.asarray(vec))
    cross = kernels.KERNELS[kernel](ours, _t(x), _t(xt))
    np.testing.assert_allclose(cross.numpy(), np.asarray(jax_kernels.KERNELS[kernel](theirs, jnp.asarray(x),
                                                                                   jnp.asarray(xt))),
                               rtol=1e-5, atol=1e-6)
    gram = kernels.gram(kernels.KERNELS[kernel], ours, _t(x))
    np.testing.assert_allclose(gram.numpy(), np.asarray(jax_kernels.gram(jax_kernels.KERNELS[kernel], theirs,
                                                                         jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    default = kernels.KernelParams.default(3)
    np.testing.assert_allclose(default.as_vector().numpy(),
                               np.asarray(jax_kernels.KernelParams.default(3).as_vector()), rtol=1e-6)


def test_a_kernel_that_is_not_positive_definite_gives_a_non_finite_evidence():
    """As the JAX Cholesky does: the slice sampler reads -1e30 there."""
    x, y = np.zeros((3, 1)), np.array([1.0, -1.0, 0.5])
    vec = np.array([50.0, -1e3, 0.0])  # amplitude e^50 swamps noise and jitter: K is singular
    assert not np.isfinite(float(gp._lml("rbf", _t(vec), _t(x), _t(y))))
    assert not np.isfinite(float(jax_gp._lml("rbf", jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y))))


def test_fit_gp_takes_the_jax_samplers_path_here():
    """The reference's schedule (burn-in 100, 10 samples): on this draw the
    float32 and float64 evidences never flip a step, so the kernel samples
    agree to f32 rounding, and so do predictions and EI."""
    x, y, _, xt = _draw(11, 6, 2)
    ours = gp.fit_gp(x, y, seed=3, maximize=True)
    theirs = jax_gp.fit_gp(x, y, seed=3, maximize=True)
    assert ours.param_vectors.shape == (10, 4)
    np.testing.assert_allclose(ours.param_vectors, theirs.param_vectors, rtol=0, atol=SAME_PATH_ATOL)
    np.testing.assert_array_equal(ours.y, theirs.y)
    for a, b in zip(ours.predict(xt), theirs.predict(xt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL["posterior_atol"])
    np.testing.assert_allclose(ours.expected_improvement(xt), theirs.expected_improvement(xt), rtol=0,
                               atol=TOL["posterior_atol"])
    np.testing.assert_allclose(ours.confidence_bound(xt), theirs.confidence_bound(xt), rtol=0,
                               atol=TOL["posterior_atol"])


# ------------------------------------------------------- the numpy halves


def test_rescaling_and_the_tuning_json_are_the_jax_functions():
    doc = {"variables": [{"name": "a", "min": -2, "max": 6}, {"name": "b", "min": 1e-4, "max": 1e2,
                                                               "transform": "LOG"},
                         {"name": "c", "min": 1, "max": 10, "type": "DISCRETE"}]}
    ours, theirs = search.config_from_json(doc), jax_search.config_from_json(doc)
    assert [dataclasses.asdict(c) for c in ours] == [dataclasses.asdict(c) for c in theirs]
    pts = np.random.default_rng(0).uniform(size=(20, 3))
    np.testing.assert_array_equal(search.backward_scale(pts, ours), jax_search.backward_scale(pts, theirs))
    back = search.backward_scale(pts, ours)
    np.testing.assert_array_equal(search.forward_scale(back, ours), jax_search.forward_scale(back, theirs))
    priors = {"records": [{"a": 1.0, "b": 0.1, "c": 3, "evaluationValue": 0.7}]}
    for (p, v), (q, w) in zip(search.priors_from_json(priors, ours), jax_search.priors_from_json(priors, theirs)):
        np.testing.assert_array_equal(p, q)
        assert v == w


def test_the_slice_sampler_is_the_jax_sampler():
    logpdf = lambda x: float(-0.5 * np.sum((x - 2.0) ** 2))
    ours = slice_sample(logpdf, np.zeros(2), np.random.default_rng(7), num_samples=200, burn_in=20)
    theirs = jax_slice_sample(logpdf, np.zeros(2), np.random.default_rng(7), num_samples=200, burn_in=20)
    np.testing.assert_array_equal(ours, theirs)
    assert abs(ours.mean() - 2.0) < 0.25


@pytest.mark.parametrize("batch", [1, 3])
def test_random_search_proposes_the_jax_points(batch):
    ours = search.RandomSearch(_configs(search, 2), _objective, seed=5)
    theirs = jax_search.RandomSearch(_configs(jax_search, 2), _objective, seed=5)
    a, b = ours.find_batched(10, batch), theirs.find_batched(10, batch)
    np.testing.assert_array_equal(np.stack([o.point for o in a.observations]),
                                  np.stack([o.point for o in b.observations]))
    assert a.best_value == b.best_value and len(a.observations) == 10


def test_the_tuner_runs_the_jax_tuners_random_search():
    assert tuner.get_tuner(tuner.HyperparameterTuningMode.NONE).search(
        5, _configs(search, 1), tuner.HyperparameterTuningMode.NONE, _objective) is None
    for batch in (1, 2):
        ours = tuner.get_tuner(tuner.HyperparameterTuningMode.RANDOM).search(
            6, _configs(search, 2), tuner.HyperparameterTuningMode.RANDOM, _objective, seed=9, batch_size=batch,
            priors=[(np.array([1.0, 1.0]), 4.0)])
        theirs = jax_tuner.get_tuner(jax_tuner.HyperparameterTuningMode.RANDOM).search(
            6, _configs(jax_search, 2), jax_tuner.HyperparameterTuningMode.RANDOM, _objective, seed=9,
            batch_size=batch, priors=[(np.array([1.0, 1.0]), 4.0)])
        np.testing.assert_array_equal(ours.best_point, theirs.best_point)
    assert tuner.HyperparameterTuningMode.parse(" bayesian ") is tuner.HyperparameterTuningMode.BAYESIAN


# ------------------------------------------------------------ BAYESIAN


def _gp_samples(searcher_mod, configs, observations, seed):
    """The kernel samples a GaussianProcessSearch with `seed` fits first."""
    x = np.stack([searcher_mod.forward_scale(o.point, configs) for o in observations])
    y = np.asarray([o.value for o in observations])
    fit = gp.fit_gp if searcher_mod is search else jax_gp.fit_gp
    return fit(x, y, seed=int(np.random.default_rng(seed).integers(1 << 31))).param_vectors


def test_bayesian_proposals_are_the_jax_proposals_where_the_sampler_agrees():
    ours = search.GaussianProcessSearch(_configs(search, 2), _objective, seed=4)
    theirs = jax_search.GaussianProcessSearch(_configs(jax_search, 2), _objective, seed=4)
    a, b = ours.find(4), theirs.find(4)
    pa = np.stack([o.point for o in a.observations])
    pb = np.stack([o.point for o in b.observations])
    # The first min_observations proposals are Sobol points.
    np.testing.assert_array_equal(pa[: ours.min_observations], pb[: ours.min_observations])
    first_fit = a.observations[: ours.min_observations]
    same_path = np.allclose(_gp_samples(search, ours.configs, first_fit, 4),
                            _gp_samples(jax_search, theirs.configs, b.observations[: ours.min_observations], 4),
                            rtol=0, atol=SAME_PATH_ATOL)
    if same_path:
        # The first GP proposal is the same pool point.
        np.testing.assert_array_equal(pa[ours.min_observations], pb[ours.min_observations])
    else:
        # A float32 evidence flipped a sampler step: the searches diverge
        # from here, and the best values found are compared instead.
        assert abs(a.best_value - b.best_value) <= 0.5 * max(a.best_value, b.best_value) + 0.05
    assert a.best_value <= min(o.value for o in a.observations[: ours.min_observations])


def test_a_constant_liar_batch_is_the_jax_batch_where_the_sampler_agrees():
    priors = [(np.array([10 ** v, 10 ** w]), _objective(np.array([10 ** v, 10 ** w])))
              for v, w in ((-3.0, 2.0), (0.5, 0.0), (2.0, -2.5), (1.5, -0.5))]
    ours = search.GaussianProcessSearch(_configs(search, 2), _objective, seed=6)
    theirs = jax_search.GaussianProcessSearch(_configs(jax_search, 2), _objective, seed=6)
    ours.seed_priors(priors)
    theirs.seed_priors(priors)
    same_path = np.allclose(_gp_samples(search, ours.configs, ours.prior_observations, 6),
                            _gp_samples(jax_search, theirs.configs, theirs.prior_observations, 6),
                            rtol=0, atol=SAME_PATH_ATOL)
    batch, jbatch = ours.propose_batch(3), theirs.propose_batch(3)
    assert batch.shape == (3, 2) and len({tuple(p) for p in batch}) == 3
    if same_path:
        np.testing.assert_array_equal(batch, jbatch)
    else:
        # A float32 evidence flipped a sampler step: compare the best
        # objective value each batch reaches instead.
        best = min(_objective(p) for p in batch)
        assert abs(best - min(_objective(p) for p in jbatch)) <= 0.5 * best + 0.05


def test_shrink_search_range_is_the_jax_range_where_the_sampler_agrees():
    configs = _configs(search, 2)
    rng = np.random.default_rng(2)
    priors = []
    for _ in range(6):
        p = 10.0 ** rng.uniform(-4, 4, size=2)
        priors.append((p, _objective(p)))
    ours = search.shrink_search_range(configs, priors, seed=3)
    theirs = jax_search.shrink_search_range(_configs(jax_search, 2), priors, seed=3)
    same_path = np.allclose(
        gp.fit_gp(np.stack([search.forward_scale(p, configs) for p, _ in priors]),
                  np.array([v for _, v in priors]), seed=3).param_vectors,
        jax_gp.fit_gp(np.stack([search.forward_scale(p, configs) for p, _ in priors]),
                      np.array([v for _, v in priors]), seed=3).param_vectors, rtol=0, atol=SAME_PATH_ATOL)
    for a, b, c in zip(ours, theirs, configs):
        assert c.min_value <= a.min_value < a.max_value <= c.max_value
        if same_path:
            assert (a.min_value, a.max_value) == (b.min_value, b.max_value)
