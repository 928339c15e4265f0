"""Feature summaries (data/stats.py) against the JAX package's `summarize`,
dense and sparse, and the normalization contexts built from them, under
PORT_TOLERANCES["stats"] (the port sums in float64, the reference in
float32)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.containers import SparseFeatures as JaxSparseFeatures
from photon_ml_tpu.data.stats import summarize as jax_summarize
from photon_ml_tpu.ops.normalization import from_feature_stats as jax_from_feature_stats
from photon_ml_tpu.types import NormalizationType as JaxNorm
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.ops.normalization import from_feature_stats
from photon_ml_tpu_torch.types import NormalizationType

TOL = PORT_TOLERANCES["stats"]
FIELDS = ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1", "norm_l2", "mean_abs")


def _sparse(seed=0, n=2000, d=40, k=6):
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.uniform(size=(n, d - 1)), axis=1)[:, :k].astype(np.int32)
    val = (rng.normal(size=(n, k)) * 2 + 0.5).astype(np.float32)
    val[rng.uniform(size=val.shape) < 0.3] = 0.0  # padding-like zeros
    idx[:, -1] = d - 1
    val[:, -1] = 1.0  # an intercept column in every row
    return idx, val, d


def _assert_stats(got, ref):
    assert float(got.count) == float(ref.count)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f, **TOL)
    np.testing.assert_allclose(got.max_abs.numpy(), np.asarray(ref.max_abs), **TOL)


def test_sparse_summary_matches_jax():
    idx, val, d = _sparse()
    got = summarize(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d), intercept_index=d - 1)
    ref = jax_summarize(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d), intercept_index=d - 1)
    _assert_stats(got, ref)
    assert got.intercept_index == d - 1 and got.mean.dtype == torch.float32
    # Implicit zeros: every feature but the intercept misses some row, so min <= 0 <= max.
    assert bool((got.min[:-1] <= 0).all() and (got.max[:-1] >= 0).all())
    assert float(got.min[d - 1]) == float(got.max[d - 1]) == 1.0 and float(got.variance[d - 1]) == 0.0


def test_dense_summary_matches_jax():
    X = np.random.default_rng(1).normal(size=(500, 7)).astype(np.float32) * 3 + 1
    X[:, 2] = 0.0
    _assert_stats(summarize(torch.from_numpy(X)), jax_summarize(jnp.asarray(X)))


@pytest.mark.parametrize("norm_type", [NormalizationType.STANDARDIZATION,
                                       NormalizationType.SCALE_WITH_STANDARD_DEVIATION,
                                       NormalizationType.SCALE_WITH_MAX_MAGNITUDE])
def test_contexts_from_feature_stats_match_jax(norm_type):
    idx, val, d = _sparse(2)
    s = summarize(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d))
    js = jax_summarize(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d))
    ctx = from_feature_stats(norm_type, mean=s.mean, variance=s.variance, max_abs=s.max_abs,
                             intercept_index=d - 1)
    jctx = jax_from_feature_stats(JaxNorm[norm_type.name], mean=js.mean, variance=js.variance,
                                  max_abs=js.max_abs, intercept_index=d - 1)
    np.testing.assert_allclose(ctx.factors.numpy(), np.asarray(jctx.factors), **TOL)
    if jctx.shifts is None:
        assert ctx.shifts is None
    else:
        np.testing.assert_allclose(ctx.shifts.numpy(), np.asarray(jctx.shifts), **TOL)
    assert float(ctx.factors[d - 1]) == 1.0
