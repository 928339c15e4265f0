"""The port's batched L-BFGS and TRON against the JAX package's
`minimize_lbfgs` / `minimize_tron` (single problems, and vmapped lanes that
stop at different iterations), and `problem.solve` against the JAX solve."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.containers import LabeledData as JaxLabeledData
from photon_ml_tpu.data.containers import dense_data as jax_dense_data
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import objective as jax_objective
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.optimize import problem as jax_problem
from photon_ml_tpu.optimize.lbfgs import minimize_lbfgs as jax_lbfgs
from photon_ml_tpu.optimize.tron import minimize_tron as jax_tron
from photon_ml_tpu.types import OptimizerType as JaxOptimizerType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import LabeledData, dense_data
from photon_ml_tpu_torch.ops import losses, objective
from photon_ml_tpu_torch.optimize import config, problem
from photon_ml_tpu_torch.optimize.common import ConvergenceReason
from photon_ml_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimize.tron import minimize_tron
from photon_ml_tpu_torch.types import OptimizerType

TOL = PORT_TOLERANCES["solver"]


def _logistic(seed, n=200, d=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(X @ w_true)))).astype(np.float32)
    return X, y


def _assert_same_solve(res, ref):
    np.testing.assert_allclose(
        res.coefficients.numpy(), np.asarray(ref.coefficients), atol=TOL["coef_atol"], rtol=0
    )
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=TOL["loss_rtol"])
    assert int(res.reason) == int(ref.reason)
    assert abs(int(res.iterations) - int(ref.iterations)) <= TOL["iterations"]


def _lift(fn):
    def vg(W):
        f, g = fn(W[0])
        return f[None], g[None]
    return vg


def test_lbfgs_quadratic_matches_jax():
    center = np.arange(5.0, dtype=np.float32)
    jc, tc = jnp.asarray(center), torch.from_numpy(center)
    ref = jax_lbfgs(lambda w: (0.5 * jnp.dot(w - jc, w - jc), w - jc), jnp.zeros(5, jnp.float32))
    res = minimize_lbfgs(
        _lift(lambda w: (0.5 * torch.dot(w - tc, w - tc), w - tc)), torch.zeros(1, 5)
    ).lane(0)
    _assert_same_solve(res, ref)
    assert int(res.fn_evals) == int(ref.fn_evals)


@pytest.mark.parametrize("seed,l2", [(0, 1e-2), (1, 1.0), (2, 10.0)])
def test_lbfgs_logistic_matches_jax(seed, l2):
    X, y = _logistic(seed)
    jd = jax_dense_data(X, y)
    td = dense_data(X, y, device="cpu")
    ref = jax_lbfgs(
        lambda w: jax_objective.value_and_gradient(jax_losses.LOGISTIC, w, jd, None, l2),
        jnp.zeros(8, jnp.float32), tolerance=1e-7,
    )
    res = minimize_lbfgs(
        _lift(lambda w: objective.value_and_gradient(losses.LOGISTIC, w, td, None, l2)),
        torch.zeros(1, 8), tolerance=1e-7, tracking=True,
    ).lane(0)
    _assert_same_solve(res, ref)
    hist = res.loss_history.numpy()
    seen = hist[: int(res.iterations) + 1]
    assert np.all(np.isfinite(seen)) and np.all(np.diff(seen) <= 1e-4)
    assert np.all(np.isnan(hist[int(res.iterations) + 1:]))


@pytest.mark.parametrize("seed,l2", [(0, 1e-2), (3, 1.0)])
def test_tron_logistic_matches_jax(seed, l2):
    X, y = _logistic(seed)
    jd = jax_dense_data(X, y)
    td = dense_data(X, y, device="cpu")
    ref = jax_tron(
        lambda w: jax_objective.value_and_gradient(jax_losses.LOGISTIC, w, jd, None, l2),
        lambda w, v: jax_objective.hessian_vector(jax_losses.LOGISTIC, w, v, jd, None, l2),
        jnp.zeros(8, jnp.float32),
    )
    res = minimize_tron(
        _lift(lambda w: objective.value_and_gradient(losses.LOGISTIC, w, td, None, l2)),
        lambda W, V: objective.hessian_vector(losses.LOGISTIC, W[0], V[0], td, None, l2)[None],
        torch.zeros(1, 8),
    ).lane(0)
    _assert_same_solve(res, ref)
    assert int(res.fn_evals) == int(ref.fn_evals)


def _lanes(E=6, S=48, d=5, seed=11):
    """Per-lane logistic problems of different difficulty; lane 0 is an
    all-padding lane (zero weights) that has converged before it starts."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(E, S, d)).astype(np.float32) * rng.uniform(0.2, 3.0, size=(E, 1, 1)).astype(np.float32)
    y = (rng.uniform(size=(E, S)) > 0.5).astype(np.float32)
    wt = (rng.uniform(size=(E, S)) > 0.1).astype(np.float32)
    wt[0] = 0.0
    return X, y, np.zeros((E, S), np.float32), wt


@pytest.mark.parametrize("method", ["lbfgs", "tron"])
def test_batched_lanes_match_vmapped_jax_and_single_lanes(method):
    X, y, off, wt = _lanes()
    E, _, d = X.shape
    l2 = 0.5
    max_it = 40 if method == "lbfgs" else 15

    def jax_one(Xe, ye, oe, we):
        data = JaxLabeledData(Xe, ye, oe, we)
        vg = lambda w: jax_objective.value_and_gradient(jax_losses.LOGISTIC, w, data, None, l2)
        if method == "lbfgs":
            return jax_lbfgs(vg, jnp.zeros(d, jnp.float32), max_iterations=max_it, tolerance=1e-5)
        hvp = lambda w, v: jax_objective.hessian_vector(jax_losses.LOGISTIC, w, v, data, None, l2)
        return jax_tron(vg, hvp, jnp.zeros(d, jnp.float32), max_iterations=max_it, tolerance=1e-5)

    ref = jax.vmap(jax_one)(*(jnp.asarray(a) for a in (X, y, off, wt)))

    def run(Xb, yb, ob, wb):
        block = LabeledData(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (Xb, yb, ob, wb)))
        vg = lambda W: objective.value_and_gradient(losses.LOGISTIC, W, block, None, l2)
        W0 = torch.zeros(Xb.shape[0], d)
        if method == "lbfgs":
            return minimize_lbfgs(vg, W0, max_iterations=max_it, tolerance=1e-5)
        hvp = lambda W, V: objective.hessian_vector(losses.LOGISTIC, W, V, block, None, l2)
        return minimize_tron(vg, hvp, W0, max_iterations=max_it, tolerance=1e-5)

    res = run(X, y, off, wt)
    iters = res.iterations.numpy()
    assert len(set(iters.tolist())) > 1, "lanes should stop at different iterations"
    assert iters[0] == 0 and res.reason[0] == ConvergenceReason.GRADIENT_CONVERGED
    assert torch.equal(res.coefficients[0], torch.zeros(d))  # the padding lane never moved
    for e in range(E):
        _assert_same_solve(res.lane(e), jax.tree_util.tree_map(lambda a: a[e], ref))
        # A lane run alone takes exactly the batched lane's path: finished
        # lanes stay frozen while the others go on.
        alone = run(X[e:e + 1], y[e:e + 1], off[e:e + 1], wt[e:e + 1]).lane(0)
        assert int(alone.iterations) == int(res.iterations[e])
        assert int(alone.reason) == int(res.reason[e])
        assert int(alone.fn_evals) == int(res.fn_evals[e])
        np.testing.assert_allclose(alone.coefficients.numpy(), res.coefficients[e].numpy(), atol=1e-6)


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_problem_solve_matches_jax(opt):
    X, y = _logistic(4, n=300, d=6)
    cfg = config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(OptimizerType[opt], 30, 1e-7),
        regularization=config.L2, reg_weight=1.0,
    )
    jcfg = jax_config.CoordinateOptimizationConfig(
        optimizer=jax_config.OptimizerConfig(JaxOptimizerType[opt], 30, 1e-7),
        regularization=jax_config.L2, reg_weight=1.0,
    )
    ref = jax_problem.solve(
        jax_losses.LOGISTIC, jax_dense_data(X, y), jcfg, jnp.zeros(6, jnp.float32), use_pallas=False
    )
    res = problem.solve(losses.LOGISTIC, dense_data(X, y, device="cpu"), cfg, torch.zeros(6))
    _assert_same_solve(res, ref)


def test_solve_refuses_what_is_not_ported():
    data = dense_data(np.ones((4, 2), np.float32), np.ones(4, np.float32), device="cpu")
    for cfg in (
        config.CoordinateOptimizationConfig(regularization=config.L1, reg_weight=1.0),
        config.CoordinateOptimizationConfig(
            optimizer=config.OptimizerConfig(box_constraints=(np.zeros(2), np.ones(2)))
        ),
    ):
        with pytest.raises(NotImplementedError):
            problem.solve(losses.LOGISTIC, data, cfg, torch.zeros(2))
