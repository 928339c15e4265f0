"""The optimizers' other modes against the JAX package: OWLQN (L1 and
elastic net) and box-constrained L-BFGS, lane by lane against the JAX
`minimize_lbfgs` vmapped over the same lanes, and FULL variances
(diag(H^-1)) against the JAX `compute_variances` for one problem and for
random-effect lanes, dense and sparse."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import objective as jax_objective
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.optimize import problem as jax_problem
from photon_ml_tpu.optimize.lbfgs import minimize_lbfgs as jax_lbfgs
from photon_ml_tpu.types import VarianceComputationType as JaxVC
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import sparse_layout
from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures
from photon_ml_tpu_torch.ops import losses, objective
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize import config, problem
from photon_ml_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.types import VarianceComputationType

TOL = PORT_TOLERANCES["solver"]
VTOL = PORT_TOLERANCES["full_variance"]
LOSSES = {"logistic": (losses.LOGISTIC, jax_losses.LOGISTIC),
          "poisson": (losses.POISSON, jax_losses.POISSON),
          "linear": (losses.SQUARED, jax_losses.SQUARED)}


def _lanes(loss_name, E=6, S=200, d=7, seed=3):
    """E problems of different scale; lane 0 is all padding (zero weights).

    A lane stops where f no longer changes in f32, anywhere within about
    sqrt(2 eps f / lambda_min(H)) of its optimum, on either package's side;
    the rows and scales keep that below the solver tolerance's coef_atol
    (an L1-only lane has no L2 term to lift lambda_min)."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(E, S, d)) * rng.uniform(0.7, 1.5, size=(E, 1, 1))).astype(np.float32)
    X[:, :, -1] = 1.0
    w_true = (rng.normal(size=(E, d)) * (rng.uniform(size=(E, d)) > 0.4)).astype(np.float32)
    z = np.einsum("esd,ed->es", X, w_true)
    if loss_name == "logistic":
        y = (rng.uniform(size=(E, S)) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    elif loss_name == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(np.float32)
    else:
        y = (z + 0.3 * rng.normal(size=(E, S))).astype(np.float32)
    off = (0.05 * rng.normal(size=(E, S))).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=(E, S)).astype(np.float32)
    wt[0] = 0.0
    return X, y, off, wt


def _jax_lanes(jloss, arrays, l2, max_it, tol, **kw):
    d = arrays[0].shape[-1]

    def one(Xe, ye, oe, we):
        data = jax_containers.LabeledData(Xe, ye, oe, we)
        vg = lambda w: jax_objective.value_and_gradient(jloss, w, data, None, l2)
        return jax_lbfgs(vg, jnp.zeros(d, jnp.float32), max_iterations=max_it, tolerance=tol, **kw)

    return jax.vmap(one)(*(jnp.asarray(a) for a in arrays))


def _port_lanes(loss, arrays, l2, max_it, tol, **kw):
    block = LabeledData(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    vg = lambda W: objective.value_and_gradient(loss, W, block, None, l2)
    return minimize_lbfgs(vg, torch.zeros(arrays[0].shape[0], arrays[0].shape[-1]),
                          max_iterations=max_it, tolerance=tol, **kw)


def _assert_lane(res, ref, e):
    c = res.coefficients[e].numpy()
    rc = np.asarray(ref.coefficients[e])
    np.testing.assert_array_equal(c == 0.0, rc == 0.0)
    np.testing.assert_allclose(c, rc, atol=TOL["coef_atol"], rtol=0)
    np.testing.assert_allclose(float(res.loss[e]), float(ref.loss[e]), rtol=TOL["loss_rtol"])
    assert int(res.reason[e]) == int(ref.reason[e])
    assert abs(int(res.iterations[e]) - int(ref.iterations[e])) <= TOL["iterations"]


@pytest.mark.parametrize("loss_name", sorted(LOSSES))
@pytest.mark.parametrize("reg", ["l1", "elastic_net"])
def test_owlqn_lanes_match_vmapped_jax(loss_name, reg):
    loss, jloss = LOSSES[loss_name]
    arrays = _lanes(loss_name)
    weight = {"logistic": 3.0, "poisson": 4.0, "linear": 6.0}[loss_name]
    alpha = 1.0 if reg == "l1" else 0.5
    l1, l2 = alpha * weight, (1.0 - alpha) * weight
    ref = _jax_lanes(jloss, arrays, l2, 60, 1e-6, l1_weight=l1)
    res = _port_lanes(loss, arrays, l2, 60, 1e-6, l1_weight=l1)
    zeros = 0
    for e in range(arrays[0].shape[0]):
        _assert_lane(res, ref, e)
        zeros += int((res.coefficients[e] == 0.0).sum())
    assert zeros > arrays[0].shape[0], "the L1 weight should zero some coefficients"
    assert torch.equal(res.coefficients[0], torch.zeros(arrays[0].shape[-1]))


@pytest.mark.parametrize("loss_name", sorted(LOSSES))
def test_box_lanes_match_vmapped_jax_and_hold_exactly(loss_name):
    loss, jloss = LOSSES[loss_name]
    arrays = _lanes(loss_name, seed=5)
    d = arrays[0].shape[-1]
    lower = np.full(d, -np.inf, np.float32)
    upper = np.full(d, np.inf, np.float32)
    lower[:3], upper[:3] = -0.05, 0.05
    lower[4] = 0.0
    upper[5] = -0.02
    ref = _jax_lanes(jloss, arrays, 0.5, 60, 1e-6, lower_bounds=lower, upper_bounds=upper)
    res = _port_lanes(loss, arrays, 0.5, 60, 1e-6, lower_bounds=lower, upper_bounds=upper)
    for e in range(1, arrays[0].shape[0]):
        _assert_lane(res, ref, e)
    c = res.coefficients.numpy()
    assert np.all(c >= lower) and np.all(c <= upper)
    assert np.any(c[1:, :3] == 0.05) or np.any(c[1:, :3] == -0.05), "the box should bind"


def test_owlqn_with_box_matches_jax():
    arrays = _lanes("logistic", seed=8)
    d = arrays[0].shape[-1]
    lower, upper = np.full(d, -0.3, np.float32), np.full(d, 0.3, np.float32)
    kw = dict(l1_weight=1.5, lower_bounds=lower, upper_bounds=upper)
    ref = _jax_lanes(jax_losses.LOGISTIC, arrays, 0.2, 60, 1e-6, **kw)
    res = _port_lanes(losses.LOGISTIC, arrays, 0.2, 60, 1e-6, **kw)
    for e in range(arrays[0].shape[0]):
        _assert_lane(res, ref, e)
    c = res.coefficients.numpy()
    assert np.all(np.abs(c) <= 0.3)


def test_lanes_are_independent_with_per_lane_l1_weights():
    """Each lane carries its own L1 weight; changing one lane's weight (so
    that it stops elsewhere) leaves every other lane's bits, iterations and
    evaluations as they were, and a lane run alone takes the batched lane's
    path."""
    arrays = _lanes("logistic", seed=9)
    E = arrays[0].shape[0]
    l1 = torch.linspace(0.5, 4.0, E)
    res = _port_lanes(losses.LOGISTIC, arrays, 0.1, 50, 1e-6, l1_weight=l1)
    assert len(set(res.iterations.tolist())) > 1
    l1b = l1.clone()
    l1b[2] = 40.0
    other = _port_lanes(losses.LOGISTIC, arrays, 0.1, 50, 1e-6, l1_weight=l1b)
    assert int(other.iterations[2]) != int(res.iterations[2])
    for e in range(E):
        if e != 2:
            assert torch.equal(other.coefficients[e], res.coefficients[e])
            assert int(other.iterations[e]) == int(res.iterations[e])
            assert int(other.fn_evals[e]) == int(res.fn_evals[e])
        alone = _port_lanes(losses.LOGISTIC, tuple(a[e:e + 1] for a in arrays), 0.1, 50, 1e-6,
                            l1_weight=float(l1[e]))
        assert int(alone.iterations[0]) == int(res.iterations[e])
        assert int(alone.fn_evals[0]) == int(res.fn_evals[e])
        np.testing.assert_array_equal(alone.coefficients[0].numpy() == 0.0,
                                      res.coefficients[e].numpy() == 0.0)
        np.testing.assert_allclose(alone.coefficients[0].numpy(), res.coefficients[e].numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("reg,opt", [("L1", "LBFGS"), ("ELASTIC_NET", "LBFGS"), ("L2", "OWLQN"),
                                     ("L2", "LBFGSB")])
def test_problem_solve_routes_as_jax(reg, opt):
    """OWLQN when the optimizer is OWLQN or the regularization is L1 or
    elastic net; LBFGSB is L-BFGS with its box."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    y = (rng.uniform(size=300) < 1 / (1 + np.exp(-X[:, 0] + X[:, 1]))).astype(np.float32)
    alpha = 0.4 if reg == "ELASTIC_NET" else None
    box = (np.full(6, -0.5, np.float32), np.full(6, 0.5, np.float32)) if opt == "LBFGSB" else None

    def cfg(mod, Opt, Reg):
        return mod.CoordinateOptimizationConfig(
            optimizer=mod.OptimizerConfig(Opt[opt], 50, 1e-7, box_constraints=box),
            regularization=mod.RegularizationContext(Reg[reg], alpha), reg_weight=5.0)

    from photon_ml_tpu.types import OptimizerType as JOpt, RegularizationType as JReg
    from photon_ml_tpu_torch.types import OptimizerType as Opt, RegularizationType as Reg

    ref = jax_problem.solve(jax_losses.LOGISTIC, jax_containers.dense_data(X, y),
                            cfg(jax_config, JOpt, JReg), jnp.zeros(6, jnp.float32), use_pallas=False)
    data = LabeledData(torch.from_numpy(X), torch.from_numpy(y), torch.zeros(300), torch.ones(300))
    res = problem.solve(losses.LOGISTIC, data, cfg(config, Opt, Reg), torch.zeros(6))
    np.testing.assert_array_equal(res.coefficients.numpy() == 0.0, np.asarray(ref.coefficients) == 0.0)
    np.testing.assert_allclose(res.coefficients.numpy(), np.asarray(ref.coefficients),
                               atol=TOL["coef_atol"], rtol=0)
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=TOL["loss_rtol"])


# --------------------------------------------------------------- FULL variances

def _full_cfg(mod, vc):
    return mod.CoordinateOptimizationConfig(regularization=mod.L2, reg_weight=0.7,
                                            variance_computation=vc.FULL)


def _close_var(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    np.testing.assert_allclose(got, ref, rtol=VTOL["rtol"], atol=0)


def _sparse(seed, n=700, d=40, k=7):
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    for r in range(n):
        m = int(rng.integers(2, k + 1))
        idx[r, 0], val[r, 0] = 0, 1.0
        idx[r, 1:m] = rng.choice(np.arange(1, d), size=m - 1, replace=False)
        val[r, 1:m] = rng.normal(size=m - 1)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (0.2 * rng.normal(size=d)).astype(np.float32)
    return idx, val, y, off, wt, w


@pytest.mark.parametrize("features", ["dense", "ell", "layout"])
@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "row_chunks"])
@pytest.mark.parametrize("normalized", [False, True], ids=["identity", "standardized"])
def test_full_variances_single_problem_match_jax(features, chunked, normalized, monkeypatch):
    idx, val, y, off, wt, w = _sparse(31)
    n, d = idx.shape[0], w.shape[0]
    if chunked:  # rows densified at most 64 at a time
        monkeypatch.setattr(objective, "HESSIAN_CHUNK_BYTES", 64 * d * 4)
    jsf = jax_containers.SparseFeatures(jnp.asarray(idx), jnp.asarray(val), d)
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d)
    if features == "dense":
        dense = np.array(jsf.to_dense())
        jfeats, feats = jnp.asarray(dense), torch.from_numpy(dense)
    else:
        jfeats, feats = jsf, sf if features == "ell" else sparse_layout.from_ell(sf)
    norm = jnorm = None
    if normalized:
        rng = np.random.default_rng(4)
        factors = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
        shifts = (0.1 * rng.normal(size=d)).astype(np.float32)
        factors[0], shifts[0] = 1.0, 0.0
        norm = NormalizationContext(torch.from_numpy(factors), torch.from_numpy(shifts), 0)
        jnorm = JaxNorm(jnp.asarray(factors), jnp.asarray(shifts), 0)
    data = LabeledData(feats, torch.from_numpy(y), torch.from_numpy(off), torch.from_numpy(wt))
    jdata = jax_containers.LabeledData(jfeats, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt))
    got = problem.compute_variances(losses.LOGISTIC, data, _full_cfg(config, VarianceComputationType),
                                    torch.from_numpy(w), norm)
    ref = jax_problem.compute_variances(jax_losses.LOGISTIC, jdata, _full_cfg(jax_config, JaxVC),
                                        jnp.asarray(w), jnorm)
    _close_var(got, ref)
    H = objective.hessian_matrix(losses.LOGISTIC, torch.from_numpy(w), data, norm, 0.7)
    jH = jax_objective.hessian_matrix(jax_losses.LOGISTIC, jnp.asarray(w), jdata, jnorm, 0.7)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=VTOL["rtol"],
                               atol=VTOL["rtol"] * float(np.abs(np.asarray(jH)).max()))


@pytest.mark.parametrize("loss_name", ["logistic", "poisson"])
@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "lane_chunks"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
def test_full_variances_lanes_match_vmapped_jax(loss_name, chunked, sparse, monkeypatch):
    """E random-effect lanes: the JAX package vmaps `compute_variances` over
    the lanes' blocks (dense, or ELL planes); the port solves a random effect
    over an ELL shard on its dense blocks (`ell_block_to_dense`), and forms
    the lanes' Hessians a chunk of lanes at a time."""
    from photon_ml_tpu_torch.data.containers import ell_block_to_dense

    loss, jloss = LOSSES[loss_name]
    X, y, off, wt = _lanes(loss_name, E=7, S=40, seed=13)
    E, S, d = X.shape
    if chunked:  # two lanes' blocks and Hessians at a time
        monkeypatch.setattr(objective, "HESSIAN_CHUNK_BYTES", 2 * (d * d + S * d) * 4)
    W = (0.1 * np.random.default_rng(2).normal(size=(E, d))).astype(np.float32)
    rows = np.random.default_rng(3).uniform(0.5, 2.0, size=(E, d)).astype(np.float32)
    norm = NormalizationContext(torch.from_numpy(rows), None, None)
    if sparse:  # each row keeps 4 of its d features, in a shuffled order
        rng = np.random.default_rng(4)
        idx = np.argsort(rng.uniform(size=(E, S, d)), axis=-1)[..., :4].astype(np.int32)
        val = np.take_along_axis(X, idx, axis=-1)
        feats = ell_block_to_dense(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d))
    else:
        feats = torch.from_numpy(X)
    block = LabeledData(feats, *(torch.from_numpy(a) for a in (y, off, wt)))
    got = problem.compute_variances(loss, block, _full_cfg(config, VarianceComputationType),
                                    torch.from_numpy(W), norm)

    def one(Fe, ye, oe, we, w, f):
        data = jax_containers.LabeledData(Fe, ye, oe, we)
        return jax_problem.compute_variances(jloss, data, _full_cfg(jax_config, JaxVC), w,
                                             JaxNorm(f, None, None))

    rest = tuple(jnp.asarray(a) for a in (y, off, wt, W, rows))
    if sparse:
        ref = jax.vmap(lambda i, v, *r: one(jax_containers.SparseFeatures(i, v, d), *r))(
            jnp.asarray(idx), jnp.asarray(val), *rest)
    else:
        ref = jax.vmap(one)(jnp.asarray(X), *rest)
    _close_var(got, ref)
