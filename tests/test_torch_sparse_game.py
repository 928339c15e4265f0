"""The sparse fixed-effect slice end to end against the JAX package on the
same ELL shard: a sparse fixed effect + per-entity random effect GLMix fit
by two coordinate-descent sweeps (coefficients, scores, AUC), a sparse TRON
fit with SIMPLE coefficient variances, and scoring a carried-over model
through the transformer."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.evaluation import metrics as jax_metrics
from photon_ml_tpu.game import coordinate as jax_coordinate
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.transformers import game_transformer as jax_gt
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.types import VarianceComputationType as JaxVariance
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import pack_csr_to_ell
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout
from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

GLMIX = PORT_TOLERANCES["glmix"]
SOLVER = PORT_TOLERANCES["solver"]
D_SPARSE = 300  # not a multiple of 32 or 128


def sparse_glmix_arrays(seed=0, n=4096, k=12, dim=D_SPARSE, d_re=4, n_entities=64):
    """bench.py's sparse shape at a small size (k uniform ids per row, normal
    values), merged into ELL planes by the port's host packer (duplicates
    summed), and a per-entity random effect; labels from both."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, dim, size=n * k)
    vals = rng.normal(size=n * k).astype(np.float32)
    ell = pack_csr_to_ell(np.arange(n + 1) * k, cols, vals, dim)
    idx, val = ell.indices.numpy(), ell.values.numpy()
    Xe = rng.normal(size=(n, d_re)).astype(np.float32)
    entity = rng.integers(0, n_entities, size=n).astype(np.int64)
    w = (rng.normal(size=dim) * 0.3).astype(np.float32)
    u = (rng.normal(size=(n_entities, d_re)) * 0.5).astype(np.float32)
    margin = np.sum(val * w[idx], axis=1) + np.einsum("nd,nd->n", Xe, u[entity])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return idx, val, Xe, entity, y


def _jax_dataset(idx, val, Xe, entity, y):
    jsf = jax_containers.SparseFeatures(jnp.asarray(idx), jnp.asarray(val), D_SPARSE)
    return jax_gd.GameDataset.build({"sparse": jsf, "per_entity": Xe}, y, id_tags={"entityId": entity})


def _port_dataset(idx, val, Xe, entity, y):
    sf = convert.sparse_features_from_numpy(idx, val, D_SPARSE, device="cpu")
    return gd.GameDataset.build({"sparse": sf, "per_entity": Xe}, y,
                                id_tags={"entityId": entity}, device="cpu")


def _glmix_configs(pkg):
    # The bench's iteration caps and L2 weights, with tolerances that stop on
    # real progress in float32 (see tests/test_torch_game.py).
    fe = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=20, tolerance=1e-6),
        regularization=pkg.L2, reg_weight=1.0,
    )
    re = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=20, tolerance=1e-5),
        regularization=pkg.L2, reg_weight=10.0,
    )
    return fe, re


@pytest.fixture(scope="module")
def sparse_glmix_pair():
    arrays = sparse_glmix_arrays(0)
    re_kw = dict(active_upper_bound=48, min_bucket=16)

    jds = _jax_dataset(*arrays)
    jred = jax_gd.build_random_effect_dataset(
        jds, jax_gd.RandomEffectDataConfig("entityId", "per_entity", **re_kw))
    jfe, jre = _glmix_configs(jax_config)
    jtask = JaxTaskType.LOGISTIC_REGRESSION
    jcoords = {
        "fixed": jax_coordinate.FixedEffectCoordinate(jds, "sparse", jfe, jtask),
        "per-entity": jax_coordinate.RandomEffectCoordinate(jds, jred, jre, jtask),
    }
    jres = jax_run_cd(jcoords, 2)

    ds = _port_dataset(*arrays)
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("entityId", "per_entity", **re_kw))
    fe, re = _glmix_configs(config)
    task = TaskType.LOGISTIC_REGRESSION
    coords = {
        "fixed": FixedEffectCoordinate(ds, "sparse", fe, task),
        "per-entity": RandomEffectCoordinate(ds, red, re, task),
    }
    res = run_coordinate_descent(coords, 2)
    return dict(jcoords=jcoords, jres=jres, coords=coords, res=res, ds=ds, y=arrays[-1])


def test_sparse_glmix_coefficients_match_jax(sparse_glmix_pair):
    jm, m = sparse_glmix_pair["jres"].model, sparse_glmix_pair["res"].model
    np.testing.assert_allclose(m["fixed"].coefficients.means.numpy(),
                               np.asarray(jm["fixed"].coefficients.means), atol=GLMIX["coef_atol"], rtol=0)
    np.testing.assert_allclose(m["per-entity"].coefficients_matrix.numpy(),
                               np.asarray(jm["per-entity"].coefficients_matrix), atol=GLMIX["coef_atol"], rtol=0)
    assert int(sparse_glmix_pair["res"].train_stats["fixed"].iterations) > 1


def test_sparse_glmix_scores_and_auc_match_jax(sparse_glmix_pair):
    jc, c = sparse_glmix_pair["jcoords"], sparse_glmix_pair["coords"]
    jm, m = sparse_glmix_pair["jres"].model, sparse_glmix_pair["res"].model
    fe, jfe = c["fixed"].score(m["fixed"]).numpy(), np.asarray(jc["fixed"].score(jm["fixed"]))
    np.testing.assert_allclose(fe, jfe, atol=GLMIX["score_atol"], rtol=0)
    # A random-effect lane stops where f32 first looks flat (3 iterations
    # here), so its margins differ by what its coefficients may:
    # |x.(u - u')| <= ||x||_1 coef_atol.
    re, jre = c["per-entity"].score(m["per-entity"]).numpy(), np.asarray(jc["per-entity"].score(jm["per-entity"]))
    bound = GLMIX["coef_atol"] * np.abs(sparse_glmix_pair["ds"].shards["per_entity"].numpy()).sum(axis=1)
    assert np.all(np.abs(re - jre) <= bound)
    scores, jscores = torch.from_numpy(fe + re), jfe + jre
    y = sparse_glmix_pair["y"]
    auc = float(metrics.area_under_roc_curve(scores, torch.from_numpy(y)))
    jauc = float(jax_metrics.area_under_roc_curve(jnp.asarray(jscores), jnp.asarray(y)))
    assert abs(auc - jauc) <= GLMIX["auc_atol"]
    assert auc > 0.7


def test_fixed_effect_trains_on_the_layout_cached_on_the_dataset(sparse_glmix_pair):
    ds = sparse_glmix_pair["ds"]
    fixed = sparse_glmix_pair["coords"]["fixed"]
    assert isinstance(fixed.training_features, SparseLayout)
    assert fixed.training_features is ds.sparse_layout("sparse")
    fe, _ = _glmix_configs(config)
    again = FixedEffectCoordinate(ds, "sparse", fe, TaskType.LOGISTIC_REGRESSION)
    assert again.training_features is fixed.training_features


def test_sparse_tron_fit_and_simple_variances_match_jax():
    """Both packages' float32 TRON fits stop where the objective (f ~ 2.4e3,
    one ulp ~ 2.4e-4) first looks flat, which leaves coefficients ~1e-3
    apart along weakly curved directions. So each fit is held to a float64
    optimum of the same problem (the port's plain ELL path in double): the
    port must land no farther from it than the reference does. The
    variances are held to the JAX package's `compute_variances` at the
    port's own coefficients, which isolates them from the solvers' stops."""
    from photon_ml_tpu.ops import losses as jax_losses
    from photon_ml_tpu.optimize import problem as jax_problem
    from photon_ml_tpu.types import OptimizerType as JaxOptimizerType
    from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.optimize import problem

    idx, val, Xe, entity, y = arrays = sparse_glmix_arrays(1)
    jcfg = jax_config.CoordinateOptimizationConfig(
        optimizer=jax_config.OptimizerConfig(JaxOptimizerType.TRON, 15, 1e-6),
        regularization=jax_config.L2, reg_weight=1.0, variance_computation=JaxVariance.SIMPLE,
    )
    jds = _jax_dataset(*arrays)
    jcoord = jax_coordinate.FixedEffectCoordinate(jds, "sparse", jcfg, JaxTaskType.LOGISTIC_REGRESSION)
    jmodel, jres = jcoord.train(jds.offsets)

    cfg = config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(OptimizerType.TRON, 15, 1e-6),
        regularization=config.L2, reg_weight=1.0, variance_computation=VarianceComputationType.SIMPLE,
    )
    ds = _port_dataset(*arrays)
    coord = FixedEffectCoordinate(ds, "sparse", cfg, TaskType.LOGISTIC_REGRESSION)
    model, res = coord.train(ds.offsets)
    np.testing.assert_allclose(float(res.loss), float(jres.loss), rtol=SOLVER["loss_rtol"])

    n = len(y)
    data64 = LabeledData(
        SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val).double(), D_SPARSE),
        torch.from_numpy(y).double(), torch.zeros(n, dtype=torch.float64),
        torch.ones(n, dtype=torch.float64))
    polish = config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(OptimizerType.TRON, 100, 0.0),
        regularization=config.L2, reg_weight=1.0)
    w64 = problem.solve(losses.LOGISTIC, data64, polish, torch.zeros(D_SPARSE, dtype=torch.float64),
                        use_kernel=False).coefficients
    port_dist = float((model.coefficients.means.double() - w64).abs().max())
    ref_dist = float((torch.tensor(np.asarray(jmodel.coefficients.means), dtype=torch.float64) - w64)
                     .abs().max())
    assert port_dist <= max(ref_dist, SOLVER["coef_atol"])

    var = model.coefficients.variances.numpy()
    assert np.all(np.isfinite(var)) and np.all(var > 0)
    jdata = jax_containers.LabeledData(jds.shards["sparse"], jds.labels, jds.offsets, jds.weights)
    jvar = jax_problem.compute_variances(jax_losses.LOGISTIC, jdata, jcfg,
                                         jnp.asarray(model.coefficients.means.numpy()))
    np.testing.assert_allclose(var, np.asarray(jvar), rtol=PORT_TOLERANCES["objective"]["rtol"], atol=0)

    auc = float(metrics.area_under_roc_curve(coord.score(model), torch.from_numpy(y)))
    jauc = float(jax_metrics.area_under_roc_curve(jcoord.score(jmodel), jnp.asarray(y)))
    assert abs(auc - jauc) <= GLMIX["auc_atol"]


def test_variances_are_inf_where_the_hessian_diagonal_is_zero():
    from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.optimize import problem

    # Column 2 is empty and there is no L2, so its Hessian diagonal is 0.
    sf = SparseFeatures(torch.tensor([[0, 1], [1, 0]], dtype=torch.int32), torch.ones(2, 2), 3)
    data = LabeledData(sf, torch.tensor([1.0, 0.0]), torch.zeros(2), torch.ones(2))
    cfg = config.CoordinateOptimizationConfig(variance_computation=VarianceComputationType.SIMPLE)
    var = problem.compute_variances(losses.LOGISTIC, data, cfg, torch.zeros(3))
    assert torch.isinf(var[2]) and torch.all(torch.isfinite(var[:2]))
    # FULL variances (ported since): the Hessian is singular there, and
    # diag(H^-1) is NaN throughout, as the JAX package's Cholesky gives it.
    from photon_ml_tpu.ops import losses as jax_losses
    from photon_ml_tpu.optimize import problem as jax_problem

    full = config.CoordinateOptimizationConfig(variance_computation=VarianceComputationType.FULL)
    jdata = jax_containers.LabeledData(
        jax_containers.SparseFeatures(jnp.asarray([[0, 1], [1, 0]], jnp.int32), jnp.ones((2, 2)), 3),
        jnp.asarray([1.0, 0.0]), jnp.zeros(2), jnp.ones(2))
    jvar = jax_problem.compute_variances(
        jax_losses.LOGISTIC, jdata,
        jax_config.CoordinateOptimizationConfig(variance_computation=JaxVariance.FULL), jnp.zeros(3))
    full_var = problem.compute_variances(losses.LOGISTIC, data, full, torch.zeros(3))
    assert torch.isnan(full_var).all() and np.isnan(np.asarray(jvar)).all()
    assert problem.compute_variances(losses.LOGISTIC, data, config.CoordinateOptimizationConfig(),
                                     torch.zeros(3)) is None


def test_carried_sparse_model_scores_like_the_jax_transformer():
    arrays = sparse_glmix_arrays(2, n=1500)
    jds = _jax_dataset(*arrays)
    jfe, _ = _glmix_configs(jax_config)
    jcfg = jax_config.CoordinateOptimizationConfig(
        optimizer=jfe.optimizer, regularization=jfe.regularization, reg_weight=jfe.reg_weight,
        variance_computation=JaxVariance.SIMPLE,
    )
    task = JaxTaskType.LOGISTIC_REGRESSION
    jmodel = jax_run_cd({"fixed": jax_coordinate.FixedEffectCoordinate(jds, "sparse", jcfg, task)}, 1).model
    ref = jax_gt.GameTransformer(jmodel, {"fixed": jax_gt.CoordinateScoringSpec("sparse")}, task).transform(jds)
    jfixed = jmodel["fixed"].coefficients
    model, specs = convert.game_model_from_numpy(
        {"fixed": convert.FixedEffectArrays("sparse", np.asarray(jfixed.means),
                                            variances=np.asarray(jfixed.variances))},
        TaskType.LOGISTIC_REGRESSION, device="cpu",
    )
    np.testing.assert_array_equal(model["fixed"].coefficients.variances.numpy(), np.asarray(jfixed.variances))
    got = GameTransformer(model, specs, TaskType.LOGISTIC_REGRESSION).transform(_port_dataset(*arrays))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **PORT_TOLERANCES["convert_scores"])


def test_sparse_features_convert_from_jax_planes():
    idx, val, *_ = sparse_glmix_arrays(3, n=50)
    jsf = jax_containers.SparseFeatures(jnp.asarray(idx), jnp.asarray(val), D_SPARSE)
    sf = convert.sparse_features_from_numpy(np.asarray(jsf.indices), np.asarray(jsf.values), jsf.dim,
                                            device="cpu")
    np.testing.assert_array_equal(sf.indices.numpy(), idx)
    np.testing.assert_array_equal(sf.values.numpy(), val)
    assert sf.indices.dtype == torch.int32 and sf.shape == jsf.shape
    with pytest.raises(ValueError):
        convert.sparse_features_from_numpy(idx[:, :3], val, D_SPARSE, device="cpu")


def test_random_effects_over_sparse_shards_and_their_variances_are_not_ported_yet():
    """(The name predates the port of both.) A random effect over a sparse
    shard builds (tests/test_torch_sparse_re.py holds it against the JAX
    package), and SIMPLE random-effect variances, over a sparse and a dense
    shard, match the JAX package's lane by lane; the pinned row stays 0."""
    arrays = sparse_glmix_arrays(4, n=3000, n_entities=20)
    ds, jds = _port_dataset(*arrays), _jax_dataset(*arrays)
    tol = PORT_TOLERANCES["estimator"]["variance_rtol"]
    for shard in ("sparse", "per_entity"):
        red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("entityId", shard))
        jred = jax_gd.build_random_effect_dataset(jds, jax_gd.RandomEffectDataConfig("entityId", shard))
        assert red.num_entities == len(np.unique(arrays[3]))
        kw = dict(optimizer_type=OptimizerType.LBFGS, max_iterations=100, tolerance=1e-9)
        cfg = config.CoordinateOptimizationConfig(
            optimizer=config.OptimizerConfig(**kw), regularization=config.L2, reg_weight=10.0,
            variance_computation=VarianceComputationType.SIMPLE)
        jcfg = jax_config.CoordinateOptimizationConfig(
            optimizer=jax_config.OptimizerConfig(max_iterations=100, tolerance=1e-9),
            regularization=jax_config.L2, reg_weight=10.0, variance_computation=JaxVariance.SIMPLE)
        model, _ = RandomEffectCoordinate(ds, red, cfg, TaskType.LOGISTIC_REGRESSION).train(ds.offsets)
        jmodel, _ = jax_coordinate.RandomEffectCoordinate(
            jds, jred, jcfg, JaxTaskType.LOGISTIC_REGRESSION).train(jds.offsets)
        var = model.variances_matrix.numpy()
        np.testing.assert_allclose(var, np.asarray(jmodel.variances_matrix), rtol=tol, err_msg=shard)
        assert np.all(var[-1] == 0) and np.all(var[:-1] > 0)
