"""The port's GLM objective on sparse features against the JAX package's on
the same ELL matrix: value and gradient, Hessian-vector product, Hessian
diagonal and margins, with and without STANDARDIZATION, through the ELL
container's plain products and through the CSR/CSC layout (the fused sums
and the composed matvec/rmatvec path)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import objective as jax_objective
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import sparse_layout
from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures
from photon_ml_tpu_torch.ops import losses, objective
from photon_ml_tpu_torch.ops.normalization import from_feature_stats
from photon_ml_tpu_torch.types import NormalizationType

TOL = PORT_TOLERANCES["objective"]
N, D, K, L2 = 900, 70, 9, 0.3
# How the port's objective sees the features, and whether the fused sums run.
PATHS = {"ell": ("ell", None), "layout_fused": ("layout", None), "layout_composed": ("layout", False)}


def _data(seed=11):
    """ELL rows with an intercept at column 0 (required by STANDARDIZATION),
    duplicates-free entries elsewhere and some short rows."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((N, K), np.int32)
    val = np.zeros((N, K), np.float32)
    for r in range(N):
        m = int(rng.integers(2, K))
        idx[r, 0], val[r, 0] = 0, 1.0
        idx[r, 1:m] = rng.choice(np.arange(1, D), size=m - 1, replace=False)
        val[r, 1:m] = rng.normal(size=m - 1) * 0.7 + 0.3
    y = (rng.uniform(size=N) > 0.4).astype(np.float32)
    off = (rng.normal(size=N) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    w = (rng.normal(size=D) * 0.2).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)
    return idx, val, y, off, wt, w, v


def _norms(idx, val, standardize):
    if not standardize:
        return None, None
    X = np.zeros((N, D), np.float64)
    np.add.at(X, (np.repeat(np.arange(N), K), idx.ravel()), val.ravel())
    port = from_feature_stats(
        NormalizationType.STANDARDIZATION,
        mean=torch.from_numpy(X.mean(axis=0).astype(np.float32)),
        variance=torch.from_numpy(X.var(axis=0).astype(np.float32)),
        max_abs=torch.from_numpy(np.abs(X).max(axis=0).astype(np.float32)), intercept_index=0,
    )
    ref = JaxNorm(jnp.asarray(port.factors.numpy()), jnp.asarray(port.shifts.numpy()), 0)
    return port, ref


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.ndim == 0:
        np.testing.assert_allclose(got, ref, rtol=TOL["rtol"], atol=TOL["atol"])
    else:
        assert np.max(np.abs(got - ref)) <= TOL["scale_rel"] * (np.max(np.abs(ref)) + 1e-6)


def _pair(path, standardize, seed=11):
    idx, val, y, off, wt, w, v = _data(seed)
    norm, jnorm = _norms(idx, val, standardize)
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D)
    kind, use_kernel = PATHS[path]
    feats = sf if kind == "ell" else sparse_layout.from_ell(sf)
    data = LabeledData(feats, torch.from_numpy(y), torch.from_numpy(off), torch.from_numpy(wt))
    jsf = jax_containers.SparseFeatures(jnp.asarray(idx), jnp.asarray(val), D)
    jdata = jax_containers.LabeledData(jsf, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    return data, jdata, norm, jnorm, use_kernel, w, v


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("standardize", [False, True], ids=["identity", "standardized"])
def test_value_gradient_hvp_match_jax(path, standardize):
    data, jdata, norm, jnorm, use_kernel, w, v = _pair(path, standardize)
    wt_, vt = torch.from_numpy(w), torch.from_numpy(v)
    f, g = objective.value_and_gradient(losses.LOGISTIC, wt_, data, norm, L2, use_kernel)
    jf, jg = jax_objective.value_and_gradient(jax_losses.LOGISTIC, jnp.asarray(w), jdata, jnorm, L2)
    _close(f, jf)
    _close(g, jg)
    hv = objective.hessian_vector(losses.LOGISTIC, wt_, vt, data, norm, L2, use_kernel)
    jhv = jax_objective.hessian_vector(
        jax_losses.LOGISTIC, jnp.asarray(w), jnp.asarray(v), jdata, jnorm, L2
    )
    _close(hv, jhv)


@pytest.mark.parametrize("path", ["ell", "layout_fused"])
@pytest.mark.parametrize("standardize", [False, True], ids=["identity", "standardized"])
def test_hessian_diagonal_margins_and_value_match_jax(path, standardize):
    data, jdata, norm, jnorm, _, w, _ = _pair(path, standardize, seed=12)
    wt_ = torch.from_numpy(w)
    _close(objective.hessian_diagonal(losses.POISSON, wt_ * 0.1, data, norm, L2),
           jax_objective.hessian_diagonal(jax_losses.POISSON, jnp.asarray(w) * 0.1, jdata, jnorm, L2))
    _close(objective.compute_margins(wt_, data, norm),
           jax_objective.compute_margins(jnp.asarray(w), jdata, jnorm))
    _close(objective.value(losses.SQUARED, wt_, data, norm, L2),
           jax_objective.value(jax_losses.SQUARED, jnp.asarray(w), jdata, jnorm, L2))


def test_fused_and_composed_layout_paths_agree_for_every_loss():
    data, _, _, _, _, w, _ = _pair("layout_fused", False, seed=13)
    wt_ = torch.from_numpy(w)
    for loss in (losses.LOGISTIC, losses.SQUARED, losses.POISSON, losses.SMOOTHED_HINGE):
        f, g = objective.value_and_gradient(loss, wt_, data, None, L2)
        f2, g2 = objective.value_and_gradient(loss, wt_, data, None, L2, use_kernel=False)
        _close(f, f2)
        _close(g, g2)
