"""The port's dense GLM objective against the JAX package's XLA path
(`use_pallas=False`), with and without STANDARDIZATION, through both of the
port's paths (the kernel wrapper's raw sums and the plain composition); and
the batched (E, S, D) form against a per-problem loop."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.containers import LabeledData as JaxLabeledData
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import objective as jax_objective
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import LabeledData, dense_data
from photon_ml_tpu_torch.ops import losses, objective
from photon_ml_tpu_torch.ops.normalization import from_feature_stats
from photon_ml_tpu_torch.types import NormalizationType

TOL = PORT_TOLERANCES["objective"]
N, D, L2 = 700, 24, 0.3


def _data(seed=5):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(N, D)) * 0.5 + 0.2).astype(np.float32)
    X[:, 0] = 1.0  # intercept column, required by STANDARDIZATION
    y = (rng.uniform(size=N) > 0.4).astype(np.float32)
    off = (rng.normal(size=N) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    w = (rng.normal(size=D) * 0.2).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)
    return X, y, off, wt, w, v


def _norms(X, standardize):
    if not standardize:
        return None, None
    mean = X.mean(axis=0)
    var = X.var(axis=0)
    port = from_feature_stats(
        NormalizationType.STANDARDIZATION,
        mean=torch.from_numpy(mean), variance=torch.from_numpy(var),
        max_abs=torch.from_numpy(np.abs(X).max(axis=0)), intercept_index=0,
    )
    ref = JaxNorm(jnp.asarray(port.factors.numpy()), jnp.asarray(port.shifts.numpy()), 0)
    return port, ref


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.ndim == 0:
        np.testing.assert_allclose(got, ref, rtol=TOL["rtol"], atol=TOL["atol"])
    else:
        assert np.max(np.abs(got - ref)) <= TOL["scale_rel"] * (np.max(np.abs(ref)) + 1e-6)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_sums", "plain"])
@pytest.mark.parametrize("standardize", [False, True], ids=["identity", "standardized"])
def test_value_gradient_hvp_match_jax(standardize, use_kernel, monkeypatch):
    if use_kernel:
        # Take the kernel branch on CPU tensors: the wrapper then computes
        # the raw sums with its plain version.
        monkeypatch.setattr(objective, "_kernel_eligible", lambda f, w: f.ndim == 2 and w.ndim == 1)
    use_kernel = None if use_kernel else False
    X, y, off, wt, w, v = _data()
    norm, jnorm = _norms(X, standardize)
    data = dense_data(X, y, offsets=off, weights=wt, device="cpu")
    jdata = JaxLabeledData(jnp.asarray(X), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    wt_, vt = torch.from_numpy(w), torch.from_numpy(v)

    f, g = objective.value_and_gradient(losses.LOGISTIC, wt_, data, norm, L2, use_kernel)
    jf, jg = jax_objective.value_and_gradient(
        jax_losses.LOGISTIC, jnp.asarray(w), jdata, jnorm, L2, use_pallas=False
    )
    _close(f, jf)
    _close(g, jg)
    hv = objective.hessian_vector(losses.LOGISTIC, wt_, vt, data, norm, L2, use_kernel)
    jhv = jax_objective.hessian_vector(
        jax_losses.LOGISTIC, jnp.asarray(w), jnp.asarray(v), jdata, jnorm, L2, use_pallas=False
    )
    _close(hv, jhv)


@pytest.mark.parametrize("standardize", [False, True], ids=["identity", "standardized"])
def test_hessian_diagonal_and_margins_match_jax(standardize):
    X, y, off, wt, w, _ = _data(6)
    norm, jnorm = _norms(X, standardize)
    data = dense_data(X, y, offsets=off, weights=wt, device="cpu")
    jdata = JaxLabeledData(jnp.asarray(X), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    wt_ = torch.from_numpy(w)
    diag = objective.hessian_diagonal(losses.POISSON, wt_ * 0.1, data, norm, L2)
    jdiag = jax_objective.hessian_diagonal(jax_losses.POISSON, jnp.asarray(w) * 0.1, jdata, jnorm, L2)
    _close(diag, jdiag)
    _close(objective.compute_margins(wt_, data, norm),
           jax_objective.compute_margins(jnp.asarray(w), jdata, jnorm))
    _close(objective.value(losses.SQUARED, wt_, data, norm, L2),
           jax_objective.value(jax_losses.SQUARED, jnp.asarray(w), jdata, jnorm, L2))


def test_batched_objective_equals_per_problem_loop():
    rng = np.random.default_rng(7)
    E, S, d = 5, 16, 4
    X = torch.from_numpy(rng.normal(size=(E, S, d)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=(E, S)) > 0.5).astype(np.float32))
    off = torch.from_numpy(rng.normal(size=(E, S)).astype(np.float32))
    wt = torch.from_numpy((rng.uniform(size=(E, S)) > 0.2).astype(np.float32))  # padding rows
    W = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32))
    block = LabeledData(X, y, off, wt)
    f, g = objective.value_and_gradient(losses.LOGISTIC, W, block, None, 2.0)
    hv = objective.hessian_vector(losses.LOGISTIC, W, V, block, None, 2.0)
    for e in range(E):
        one = LabeledData(X[e], y[e], off[e], wt[e])
        fe, ge = objective.value_and_gradient(losses.LOGISTIC, W[e], one, None, 2.0, False)
        _close(f[e], fe)
        _close(g[e], ge)
        _close(hv[e], objective.hessian_vector(losses.LOGISTIC, W[e], V[e], one, None, 2.0, False))


def test_kernel_path_is_chosen_only_for_2d_float_cuda_features():
    X = torch.zeros(8, 3)
    w = torch.zeros(3)
    assert not objective._use_kernel(None, X, w)  # CPU tensor: plain path
    assert not objective._use_kernel(None, X[None], w[None])  # batched: plain path
    assert not objective._use_kernel(False, X, w)


def test_normalization_round_trip():
    X, *_ = _data(8)
    norm, jnorm = _norms(X, True)
    w = torch.from_numpy(np.linspace(-1, 1, D).astype(np.float32))
    got = norm.model_to_original_space(w)
    ref = jnorm.model_to_original_space(jnp.asarray(w.numpy()))
    _close(got, ref)
    _close(norm.margin_shift(w), jnorm.margin_shift(jnp.asarray(w.numpy())))
