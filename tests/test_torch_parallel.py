"""Data-parallel training on torch.distributed ranks against the JAX
package's sharded path (counterpart of tests/test_parallel.py).

The port runs on W = 1, 3 and 4 gloo ranks on the CPU, each a process
started by `parallel/launch.py`; every rank runs `rank_program` once per W
and returns host arrays, which the tests below hold against the JAX package
on its 8-device virtual CPU mesh (tests/conftest.py) and against the port in
one process, on the same numpy inputs. JAX is imported inside the fixtures
that build its side only: the ranks import this module to find their
program, and load torch alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import (
    GameDataset,
    RandomEffectDataConfig,
    build_random_effect_dataset,
    entity_layout,
    factorize_tag,
)
from photon_ml_tpu_torch.evaluation import metrics, suite
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.ops import glm_kernels, losses, objective
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize import config, problem
from photon_ml_tpu_torch.parallel import mesh as pmesh
from photon_ml_tpu_torch.parallel.launch import launch
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

SUMS = PORT_TOLERANCES["kernel_sums_f32"]
SOLVER = PORT_TOLERANCES["solver"]
GLMIX = PORT_TOLERANCES["glmix"]
TASK = TaskType.LOGISTIC_REGRESSION
RE_CONFIG = RandomEffectDataConfig("entityId", "per_entity", active_upper_bound=96, min_bucket=16)
DEADLINE_S = 120.0


# ------------------------------------------------------------------ inputs


def sums_arrays(seed=11):
    """TestShardedFusedObjective's shape (8 x 2048 rows, d = 128, intercept
    column), with offsets, weights and a non-zero margin shift."""
    rng = np.random.default_rng(seed)
    n, d = 8 * 2048, 128
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ (rng.normal(size=d) * 0.2)))).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    return X, y, off, wt, w, v


def uneven_bounds(n, world):
    """Row ranges of sizes proportional to 1, 2, ..., W."""
    cuts = np.cumsum(np.arange(1, world + 1))
    return np.concatenate([[0], (n * cuts) // cuts[-1]])


def glmix_arrays(seed=3, n=4096, d_fixed=6, d_re=3, n_entities=48):
    """The bench's GLMix generator with a tail of entity sizes (~50 to ~330
    rows): two buckets, and capped entities for the reservoir. n is a
    multiple of 8, so the JAX side needs no padding rows (nor their sentinel
    entity). Entities this size keep the float32 solves' stopping noise well
    inside PORT_TOLERANCES["glmix"]; entities of ~10 rows do not."""
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fixed)).astype(np.float32)
    Xf[:, 0] = 1.0
    Xe = rng.normal(size=(n, d_re)).astype(np.float32)
    p = 1.0 / np.arange(1, n_entities + 1) ** 0.5
    entity = rng.choice(n_entities, size=n, p=p / p.sum()).astype(np.int64)
    w = (rng.normal(size=d_fixed) * 0.3).astype(np.float32)
    u = (rng.normal(size=(n_entities, d_re)) * 0.5).astype(np.float32)
    margin = Xf @ w + np.einsum("nd,nd->n", Xe, u[entity])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return Xf, Xe, entity, y


def sparse_arrays(seed=5, n=1500, k=6, dim=50):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, k), dtype=np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    w = rng.normal(size=dim) * 0.3
    m = np.einsum("nk,nk->n", val, w[idx])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    return idx, val, dim, y


def configs(pkg):
    """Bench-like caps; tolerances that stop on real progress (see
    tests/test_torch_game.py), so both packages stop at the same place."""
    fe = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=40, tolerance=1e-6),
        regularization=pkg.L2, reg_weight=1.0)
    re = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=20, tolerance=1e-5),
        regularization=pkg.L2, reg_weight=10.0)
    return fe, re


def tron_config():
    return config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(OptimizerType.TRON, 15, 1e-6), regularization=config.L2,
        reg_weight=1.0, variance_computation=VarianceComputationType.SIMPLE)


def standardization(Xf):
    std = Xf.std(axis=0)
    factors = (1.0 / np.where(std > 0, std, 1.0)).astype(np.float32)
    shifts = Xf.mean(axis=0).astype(np.float32)
    factors[0], shifts[0] = 1.0, 0.0  # the intercept column
    return NormalizationContext(torch.from_numpy(factors), torch.from_numpy(shifts), 0)


# ------------------------------------------------- the port, on ranks or not
#
# Each part takes `mesh`: None runs the port in this process on all rows,
# a RankMesh runs it on that rank's rows. Results are host values over all
# rows (gathered on ranks).


def dataset(mesh, shards, y, *, owner=None, id_tags=None):
    if mesh is None:
        return GameDataset.build(shards, y, id_tags=id_tags, device="cpu")
    return pmesh.shard_game_dataset(mesh, shards, y, id_tags=id_tags, owner=owner)


def all_rows(ds, values):
    return values if ds.sharding is None else ds.sharding.gather(values)


def part_collectives(mesh):
    """exact_sum of per-rank parts of mixed shapes and dtypes, and
    owned_to_global of an uneven split of a global matrix."""
    rng = np.random.default_rng(100 + mesh.rank)
    parts = [torch.from_numpy(rng.normal(size=5).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2, 3))), torch.tensor(float(mesh.rank) + 0.1)]
    sums = mesh.exact_sum(parts)
    glob = np.random.default_rng(7).normal(size=(37, 2)).astype(np.float32)
    perm = np.random.default_rng(8).permutation(37)
    mine = perm[uneven_bounds(37, mesh.world_size)[mesh.rank]:
                uneven_bounds(37, mesh.world_size)[mesh.rank + 1]]
    placed = mesh.owned_to_global(torch.from_numpy(glob[mine]), torch.from_numpy(mine), 37)
    return dict(parts=[p.numpy() for p in parts], sums=[s.numpy() for s in sums],
                placed=placed.numpy())


@contextlib.contextmanager
def counted_collectives(calls):
    """Count this rank's calls of each torch.distributed collective by name."""
    names = ("all_gather", "all_gather_into_tensor", "all_reduce", "broadcast", "reduce_scatter")
    saved = {n: getattr(torch.distributed, n) for n in names}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(torch.distributed, n, counting(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.distributed, n, f)


def part_gather_traffic(mesh):
    """exact_sum of k values (one part, then three), twice each: the
    collectives each call ran and the elements the mesh counted."""
    rows = []
    for sizes in ((1,), (7,), (512, 1, 1), (512, 1, 1)):
        parts = [torch.full((s,), float(mesh.rank + 1)) for s in sizes]
        calls = {}
        before = (mesh.counts["exact_sum"], mesh.elements["exact_sum"])
        with counted_collectives(calls):
            sums = mesh.exact_sum(parts)
        rows.append(dict(k=sum(sizes), calls=calls,
                         counts=mesh.counts["exact_sum"] - before[0],
                         elements=mesh.elements["exact_sum"] - before[1],
                         sums=[t.numpy() for t in sums]))
    return rows


def part_sums(mesh):
    """The sharded sums (plain path) over this rank's uneven share of rows."""
    X, y, off, wt, w, v = sums_arrays()
    lo, hi = uneven_bounds(len(y), mesh.world_size)[mesh.rank:mesh.rank + 2]
    rows = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])) for a in (X, y, off, wt)]
    wt_, vt = torch.from_numpy(w), torch.from_numpy(v)
    vg = glm_kernels.sharded_value_gradient_sums(losses.LOGISTIC, wt_, 0.07, *rows, mesh=mesh)
    hv = glm_kernels.sharded_hessian_vector_sums(
        losses.LOGISTIC, wt_, 0.07, vt, -0.2, *rows, mesh=mesh)
    return dict(vg=[t.numpy() for t in vg], hv=[t.numpy() for t in hv])


def part_fixed_effect(mesh):
    """L-BFGS on contiguous row ranges; TRON with SIMPLE variances under
    STANDARDIZATION, on the random effect's row ownership."""
    Xf, Xe, entity, y = glmix_arrays()
    fe, _ = configs(config)
    ds = dataset(mesh, {"global": Xf}, y)
    model, res = FixedEffectCoordinate(ds, "global", fe, TASK).train(ds.offsets)
    ds_t = dataset(mesh, {"global": Xf}, y, owner=RE_CONFIG, id_tags={"entityId": entity})
    tron_model, tron_res = FixedEffectCoordinate(
        ds_t, "global", tron_config(), TASK, norm=standardization(Xf)).train(ds_t.offsets)
    return dict(coef=model.coefficients.means.numpy(), loss=float(res.loss),
                iterations=int(res.iterations), tron_coef=tron_model.coefficients.means.numpy(),
                tron_var=tron_model.coefficients.variances.numpy(), tron_loss=float(tron_res.loss))


def part_glmix(mesh):
    """Two coordinate-descent sweeps with validation on the training rows;
    the model assembled over ranks; where the rows and lanes sit."""
    Xf, Xe, entity, y = glmix_arrays()
    fe, re = configs(config)
    ds = dataset(mesh, {"global": Xf, "per_entity": Xe}, y, owner=RE_CONFIG,
                 id_tags={"entityId": entity})
    red = build_random_effect_dataset(ds, RE_CONFIG)
    coords = {"fixed": FixedEffectCoordinate(ds, "global", fe, TASK),
              "per-entity": RandomEffectCoordinate(ds, red, re, TASK)}
    vsuite = suite.EvaluationSuite([suite.EvaluatorType("AUC")], ds.labels, sharding=ds.sharding)
    counts0 = None if mesh is None else dict(mesh.counts)
    res = run_coordinate_descent(coords, 2, validation_scorer=lambda c, m: coords[c].score(m),
                                 validation_suite=vsuite)
    counts = None if mesh is None else {k: mesh.counts[k] - counts0[k] for k in mesh.counts}
    # One more fixed-effect solve on its own: its collectives, against its passes.
    sums0 = None if mesh is None else mesh.counts["exact_sum"]
    _, fe_res = coords["fixed"].train(ds.offsets + coords["per-entity"].score(res.model["per-entity"]))
    fe_sums = None if mesh is None else mesh.counts["exact_sum"] - sums0
    scores = sum(coords[c].score(res.model[c]) for c in coords)
    if mesh is None:
        auc = metrics.area_under_roc_curve(scores, ds.labels)
    else:
        auc = metrics.area_under_roc_curve_over_ranks(ds.sharding, scores, ds.labels)
    model = gather_game_model(coords, res.model)
    rows = np.arange(ds.num_samples) if mesh is None else ds.sharding.global_rows.numpy()
    active = np.concatenate([rows[b.gather[b.mask > 0].numpy()] for b in red.buckets])
    return dict(
        fe=model["fixed"].coefficients.means.numpy(),
        local_fe=res.model["fixed"].coefficients.means.numpy(),
        re=model["per-entity"].coefficients_matrix.numpy(),
        store=res.model["per-entity"].coefficients_matrix.numpy(),
        scores=all_rows(ds, scores).numpy(), auc=float(auc),
        history=[(i, c, r.results["AUC"]) for i, c, r in res.validation_history],
        diverged=res.diverged_steps, counts=counts, fe_sums=fe_sums,
        fe_evals=int(fe_res.fn_evals), rows=rows, active=np.sort(active),
        owned=None if red.owned_entities is None else red.owned_entities.numpy(),
        entity_index=red.entity_index,
    )


def part_nan(mesh, bad_rank):
    """A non-finite random-effect update on one rank only: a NaN feature in
    one of its active rows."""
    Xf, Xe, entity, y = glmix_arrays()
    fe, re = configs(config)
    ds = dataset(mesh, {"global": Xf, "per_entity": Xe}, y, owner=RE_CONFIG,
                 id_tags={"entityId": entity})
    red = build_random_effect_dataset(ds, RE_CONFIG)
    rank = 0 if mesh is None else mesh.rank
    if rank == bad_rank:
        ds.shards["per_entity"][red.buckets[0].gather[0, 0]] = float("nan")
    coords = {"fixed": FixedEffectCoordinate(ds, "global", fe, TASK),
              "per-entity": RandomEffectCoordinate(ds, red, re, TASK)}
    res = run_coordinate_descent(coords, 1)
    return dict(diverged=res.diverged_steps, models=sorted(res.model.coordinate_ids),
                poisoned=rank == bad_rank)


def part_sparse(mesh):
    """A sparse (ELL) fixed effect: the objective at a fixed point, and an
    L-BFGS fit."""
    idx, val, dim, y = sparse_arrays()
    fe, _ = configs(config)
    shard = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), dim)
    ds = dataset(mesh, {"sparse": shard}, y)
    coord = FixedEffectCoordinate(ds, "sparse", fe, TASK)
    w = torch.from_numpy((np.random.default_rng(9).normal(size=dim) * 0.2).astype(np.float32))
    data = LabeledData(coord.training_features, ds.labels, ds.offsets, ds.weights, ds.mesh)
    f, g = objective.value_and_gradient(losses.LOGISTIC, w, data, None, 1.0)
    hv = objective.hessian_vector(losses.LOGISTIC, w, w, data, None, 1.0)
    model, res = coord.train(ds.offsets)
    return dict(f=float(f), g=g.numpy(), hv=hv.numpy(), coef=model.coefficients.means.numpy(),
                loss=float(res.loss))


def part_converted(mesh, arrays):
    """A model carried over as numpy arrays, scored on this rank's rows."""
    Xf, Xe, entity, y = glmix_arrays()
    ds = dataset(mesh, {"global": Xf, "per_entity": Xe}, y, owner=RE_CONFIG,
                 id_tags={"entityId": entity})
    model, specs = convert.game_model_from_numpy(arrays, TASK, device="cpu")
    return all_rows(ds, GameTransformer(model, specs, TASK).transform(ds).scores).numpy()


def rank_program(mesh, converted_arrays):
    torch.set_num_threads(1)
    return dict(
        rank=mesh.rank, collectives=part_collectives(mesh), traffic=part_gather_traffic(mesh),
        sums=part_sums(mesh),
        fixed=part_fixed_effect(mesh), glmix=part_glmix(mesh),
        nan=part_nan(mesh, bad_rank=min(1, mesh.world_size - 1)), sparse=part_sparse(mesh),
        converted=part_converted(mesh, converted_arrays),
    )


# ------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's sharded path on the 8-device mesh: the sums with the
    Pallas kernels in interpret mode, the fixed effect, and two GLMix sweeps
    on padded, sample-sharded data with entity-sharded buckets."""
    import jax.numpy as jnp

    from photon_ml_tpu.data import game_dataset as jax_gd
    from photon_ml_tpu.evaluation import suite as jax_suite
    from photon_ml_tpu.game import coordinate as jax_coordinate
    from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
    from photon_ml_tpu.ops import losses as jax_losses
    from photon_ml_tpu.ops import pallas_glm
    from photon_ml_tpu.optimize import config as jax_config
    from photon_ml_tpu.parallel.mesh import (
        DATA_AXIS,
        make_mesh,
        pad_game_dataset,
        shard_game_dataset,
        shard_random_effect_dataset,
    )
    from photon_ml_tpu.types import TaskType as JaxTaskType

    mesh = make_mesh()
    out = {}
    X, y, off, wt, w, v = sums_arrays()
    sds = shard_game_dataset(jax_gd.GameDataset.build({"g": X}, y, offsets=off, weights=wt), mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_glm, "FORCE_INTERPRET", True)
        mp.setattr(pallas_glm, "_HEALTHY", None)
        args = (sds.shards["g"], sds.labels, sds.offsets, sds.weights)
        out["vg"] = [np.asarray(t) for t in pallas_glm.sharded_value_gradient_sums(
            jax_losses.LOGISTIC, jnp.asarray(w), jnp.float32(0.07), *args, mesh=mesh,
            axis=DATA_AXIS, interpret=True)]
        out["hv"] = [np.asarray(t) for t in pallas_glm.sharded_hessian_vector_sums(
            jax_losses.LOGISTIC, jnp.asarray(w), jnp.float32(0.07), jnp.asarray(v),
            jnp.float32(-0.2), *args, mesh=mesh, axis=DATA_AXIS, interpret=True)]

    Xf, Xe, entity, y = glmix_arrays()
    fe, re = configs(jax_config)
    task = JaxTaskType.LOGISTIC_REGRESSION
    fds = shard_game_dataset(jax_gd.GameDataset.build({"global": Xf}, y), mesh)
    fmodel, fres = jax_coordinate.FixedEffectCoordinate(fds, "global", fe, task).train(fds.offsets)
    out["fixed"] = dict(coef=np.asarray(fmodel.coefficients.means), loss=float(fres.loss),
                        iterations=int(fres.iterations))

    ds = jax_gd.GameDataset.build({"global": Xf, "per_entity": Xe}, y, id_tags={"entityId": entity})
    sharded = shard_game_dataset(pad_game_dataset(ds, mesh.devices.size), mesh)
    jre_cfg = jax_gd.RandomEffectDataConfig(
        "entityId", "per_entity", active_upper_bound=RE_CONFIG.active_upper_bound,
        min_bucket=RE_CONFIG.min_bucket)
    red = shard_random_effect_dataset(jax_gd.build_random_effect_dataset(sharded, jre_cfg), mesh)
    coords = {"fixed": jax_coordinate.FixedEffectCoordinate(sharded, "global", fe, task),
              "per-entity": jax_coordinate.RandomEffectCoordinate(sharded, red, re, task)}
    vsuite = jax_suite.EvaluationSuite([jax_suite.EvaluatorType("AUC")], sharded.labels)
    res = jax_run_cd(coords, 2, validation_scorer=lambda c, m: coords[c].score(m),
                     validation_suite=vsuite)
    scores = np.asarray(sum(coords[c].score(res.model[c]) for c in coords))
    # The row-sharded store pads the matrix to a multiple of the mesh after
    # the pinned row E; the model proper is its first E + 1 rows.
    num_e = red.num_entities
    matrix = np.asarray(res.model["per-entity"].coefficients_matrix)
    assert np.all(matrix[num_e:] == 0.0)
    out["glmix"] = dict(
        fe=np.asarray(res.model["fixed"].coefficients.means), re=matrix[:num_e + 1],
        entity_index=dict(red.entity_index), scores=scores,
        history=[(i, c, r.results["AUC"]) for i, c, r in res.validation_history])
    # The sharded fit's model as numpy arrays, for convert.py.
    out["converted_arrays"] = {
        "fixed": convert.FixedEffectArrays("global", out["glmix"]["fe"]),
        "per-entity": convert.RandomEffectArrays(
            "per_entity", "entityId", out["glmix"]["re"], out["glmix"]["entity_index"]),
    }
    # How the JAX package splits each bucket's lanes over 8 devices.
    out["lane_split"] = [
        [sorted(int(e) for e in np.asarray(s.data) if e < red.num_entities)
         for s in sorted(b.entity_rows.addressable_shards, key=lambda s: s.index[0].start)]
        for b in red.buckets]
    return out


# ---------------------------------------------------------------- the ranks

_RUNS = {}


def ranks_of(world, jax_side):
    """The rank programs' results for W = world (one spawn per W per module)."""
    if world not in _RUNS:
        _RUNS[world] = launch(rank_program, world, backend="gloo", devices=["cpu"] * world,
                              deadline_s=DEADLINE_S, args=(jax_side["converted_arrays"],))
    return _RUNS[world]


@pytest.fixture(scope="module", params=[1, 3, 4], ids=lambda w: f"W{w}")
def ranks(request, jax_side):
    return ranks_of(request.param, jax_side)


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as in every rank; the count is restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def one_process(jax_side):
    """The same parts in this process, on all rows, with no mesh."""
    with one_thread():
        return dict(fixed=part_fixed_effect(None), glmix=part_glmix(None), sparse=part_sparse(None),
                    converted=part_converted(None, jax_side["converted_arrays"]))


# -------------------------------------------------------------------- tests


def _close_vec(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.max(np.abs(got - ref)) <= tol["scale_rel"] * (np.max(np.abs(ref)) + 1e-6)


def _close_scalar(got, ref, tol):
    np.testing.assert_allclose(float(got), float(ref), rtol=tol["rtol"], atol=tol["atol"])


def test_exact_sum_and_owned_to_global_are_bit_exact(ranks):
    world = len(ranks)
    parts = [r["collectives"]["parts"] for r in ranks]
    want = []
    for i in range(len(parts[0])):
        total = np.asarray(parts[0][i], np.float64).copy()
        for p in parts[1:]:
            total += np.asarray(p[i], np.float64)  # rank order, in float64
        want.append(total)
    glob = np.random.default_rng(7).normal(size=(37, 2)).astype(np.float32)
    for r in ranks:
        for got, ref in zip(r["collectives"]["sums"], want):
            assert got.dtype == np.float64 and np.array_equal(got, ref)
        assert np.array_equal(r["collectives"]["placed"], glob)
    if world == 1:  # one rank: the identity, in float64
        for got, p in zip(ranks[0]["collectives"]["sums"], parts[0]):
            assert np.array_equal(got, np.asarray(p, np.float64))


def test_exact_sum_sends_k_values_through_one_gather(ranks):
    """Each call is one all_gather of the rank's k float64 values (the mesh
    counts k elements sent, not W x k), and nothing else crosses the ranks;
    the rank-ordered sum of the ranks' 1, 2, ..., W is W (W + 1) / 2."""
    world = len(ranks)
    for r in ranks:
        for row in r["traffic"]:
            assert row["calls"] == {"all_gather": 1}, row["calls"]
            assert row["counts"] == 1 and row["elements"] == row["k"]
            for got in row["sums"]:
                assert got.dtype == np.float64
                assert np.all(got == world * (world + 1) / 2)


def test_sharded_sums_match_jax_sharded_kernels(ranks, jax_side):
    for r in ranks:
        (val, g, sum_u), (hv, sum_r) = r["sums"]["vg"], r["sums"]["hv"]
        jval, jg, jsum_u = jax_side["vg"]
        jhv, jsum_r = jax_side["hv"]
        _close_scalar(val, jval, SUMS)
        _close_vec(g, jg, SUMS)
        _close_scalar(sum_u, jsum_u, SUMS)
        _close_vec(hv, jhv, SUMS)
        _close_scalar(sum_r, jsum_r, SUMS)
        for a, b in zip(r["sums"]["vg"] + r["sums"]["hv"], ranks[0]["sums"]["vg"] + ranks[0]["sums"]["hv"]):
            assert a.dtype == np.float32 and np.array_equal(a, b)  # the same bits on every rank


def test_one_rank_sums_are_the_single_device_bits(jax_side):
    X, y, off, wt, w, v = (torch.from_numpy(a) for a in sums_arrays())
    (r,) = ranks_of(1, jax_side)
    with one_thread():
        vg = glm_kernels.value_gradient_sums(losses.LOGISTIC, w, 0.07, X, y, off, wt)
        hv = glm_kernels.hessian_vector_sums(losses.LOGISTIC, w, 0.07, v, -0.2, X, y, off, wt)
    for got, ref in zip(r["sums"]["vg"] + r["sums"]["hv"], list(vg) + list(hv)):
        assert np.array_equal(got, ref.numpy())


def test_fixed_effect_matches_jax_on_its_mesh(ranks, jax_side):
    ref = jax_side["fixed"]
    for r in ranks:
        np.testing.assert_allclose(r["fixed"]["coef"], ref["coef"], atol=SOLVER["coef_atol"], rtol=0)
        np.testing.assert_allclose(r["fixed"]["loss"], ref["loss"], rtol=SOLVER["loss_rtol"])
        assert abs(r["fixed"]["iterations"] - ref["iterations"]) <= SOLVER["iterations"]


def test_tron_and_simple_variances_match_one_process(ranks, one_process):
    """TRON's Hessian-vector products and the variances' Hessian diagonal
    (with STANDARDIZATION's shift terms) cross the ranks. The variances are
    held to the one-process `compute_variances` at the ranks' coefficients,
    which isolates them from the solvers' stops."""
    Xf, Xe, entity, y = glmix_arrays()
    ds = GameDataset.build({"global": Xf}, y, device="cpu")
    data = LabeledData(ds.shards["global"], ds.labels, ds.offsets, ds.weights)
    ref = one_process["fixed"]
    for r in ranks:
        f = r["fixed"]
        np.testing.assert_allclose(f["tron_coef"], ref["tron_coef"], atol=SOLVER["coef_atol"], rtol=0)
        np.testing.assert_allclose(f["tron_loss"], ref["tron_loss"], rtol=SOLVER["loss_rtol"])
        var = problem.compute_variances(losses.LOGISTIC, data, tron_config(),
                                        torch.from_numpy(f["tron_coef"]), standardization(Xf))
        assert np.all(np.isfinite(f["tron_var"])) and np.all(f["tron_var"] > 0)
        np.testing.assert_allclose(f["tron_var"], var.numpy(),
                                   rtol=PORT_TOLERANCES["objective"]["rtol"], atol=0)


def test_glmix_two_sweeps_match_jax_sharded_training(ranks, jax_side):
    ref = jax_side["glmix"]
    for r in ranks:
        g = r["glmix"]
        np.testing.assert_allclose(g["fe"], ref["fe"], atol=GLMIX["coef_atol"], rtol=0)
        assert g["entity_index"] == {k: v for k, v in ref["entity_index"].items()}
        for ent, row in g["entity_index"].items():  # entity by entity
            np.testing.assert_allclose(g["re"][row], ref["re"][ref["entity_index"][ent]],
                                       atol=GLMIX["coef_atol"], rtol=0)
        assert np.all(g["re"][-1] == 0.0)  # the pinned unseen-entity row
        np.testing.assert_allclose(g["scores"], ref["scores"], atol=GLMIX["score_atol"], rtol=0)
        assert [(i, c) for i, c, _ in g["history"]] == [(i, c) for i, c, _ in ref["history"]]
        for (_, _, auc), (_, _, jauc) in zip(g["history"], ref["history"]):
            assert abs(auc - jauc) <= GLMIX["auc_atol"]
        assert abs(g["auc"] - g["history"][-1][2]) <= GLMIX["auc_atol"]
        assert g["diverged"] == 0 and g["auc"] > 0.7


def test_every_rank_holds_the_same_model_bits(ranks):
    for r in ranks:
        assert np.array_equal(r["glmix"]["local_fe"], ranks[0]["glmix"]["local_fe"])
        assert np.array_equal(r["glmix"]["fe"], ranks[0]["glmix"]["fe"])
        assert np.array_equal(r["glmix"]["re"], ranks[0]["glmix"]["re"])
        assert r["glmix"]["auc"] == ranks[0]["glmix"]["auc"]
        assert np.array_equal(r["fixed"]["tron_var"], ranks[0]["fixed"]["tron_var"])


def test_one_collective_per_objective_pass(ranks):
    """A fixed-effect solve runs one exact sum per objective pass; in the
    sweeps, rows move only for the validation scores, once per update."""
    for r in ranks:
        g = r["glmix"]
        assert g["fe_sums"] == g["fe_evals"] > 0
        assert g["counts"]["owned_to_global"] == 4
        assert g["counts"]["exact_sum"] > 4  # objective passes plus one finiteness vote per update


def test_entity_rows_sit_on_one_rank_and_the_reservoir_keeps_the_global_rows(ranks, one_process):
    entity, y = glmix_arrays()[2:]
    n = len(y)
    rows = np.concatenate([r["glmix"]["rows"] for r in ranks])
    assert np.array_equal(np.sort(rows), np.arange(n))  # every row on exactly one rank
    owned = np.concatenate([r["glmix"]["owned"] for r in ranks])
    assert np.array_equal(np.sort(owned), np.arange(len(ranks[0]["glmix"]["entity_index"])))
    index = ranks[0]["glmix"]["entity_index"]
    codes = np.array([index[e] for e in entity.tolist()])
    for r in ranks:
        assert np.all(np.diff(r["glmix"]["rows"]) > 0)  # global row order
        assert set(codes[r["glmix"]["rows"]]) <= set(r["glmix"]["owned"])
    active = np.sort(np.concatenate([r["glmix"]["active"] for r in ranks]))
    assert np.array_equal(active, one_process["glmix"]["active"])


def test_each_rank_stores_its_own_entities_rows_alone(ranks):
    """A rank's random-effect store is (entities owned + 1, D): its
    entities' rows in order, then the pinned zero row; the assembled matrix
    places them at their global rows."""
    for r in ranks:
        g = r["glmix"]
        assert g["store"].shape == (len(g["owned"]) + 1, g["re"].shape[1])
        assert np.array_equal(g["store"][:-1], g["re"][g["owned"]])
        assert np.all(g["store"][-1] == 0.0)
    assert sum(len(r["glmix"]["owned"]) for r in ranks) == len(ranks[0]["glmix"]["entity_index"])


def test_a_rank_store_refuses_an_assembled_matrix_as_warm_start():
    """Rank 1 of 2, set up in this process (building and training a random
    effect run no collective): it trains a store of its own entities, warm
    starts from that store, and refuses a global (E + 1, D) matrix."""
    Xf, Xe, entity, y = glmix_arrays()
    layout = entity_layout(factorize_tag(entity), RE_CONFIG, torch.device("cpu"))
    owner = pmesh.entity_owners(layout, 2)
    rows = np.nonzero(owner[layout.codes] == 1)[0]
    ds = GameDataset.build({"per_entity": Xe[rows]}, y[rows], id_tags={"entityId": entity[rows]},
                           device="cpu")
    ds.sharding = pmesh.RowSharding(pmesh.RankMesh(1, 2, "gloo", torch.device("cpu")),
                                    torch.from_numpy(rows), len(y), RE_CONFIG, layout, owner)
    red = build_random_effect_dataset(ds, RE_CONFIG)
    assert np.array_equal(red.owned_entities.numpy(), np.nonzero(owner == 1)[0])
    coord = RandomEffectCoordinate(ds, red, configs(config)[1], TASK)
    model, _ = coord.train(ds.offsets)
    assert model.coefficients_matrix.shape == (int((owner == 1).sum()) + 1, Xe.shape[1])
    again, _ = coord.train(ds.offsets, model)
    assert again.coefficients_matrix.shape == model.coefficients_matrix.shape
    assembled = RandomEffectModel(torch.zeros(layout.num_entities + 1, Xe.shape[1]), None, TASK)
    with pytest.raises(ValueError):
        coord.train(ds.offsets, assembled)


def test_lane_split_matches_the_jax_entity_sharding(jax_side):
    """The host lane split over 8 ranks gives each rank the entities the JAX
    package puts on that device, bucket by bucket."""
    entity = glmix_arrays()[2]
    layout = entity_layout(factorize_tag(entity), RE_CONFIG, torch.device("cpu"))
    owner = pmesh.entity_owners(layout, 8)
    assert len(layout.blocks) == len(jax_side["lane_split"])
    for (_, _, ent_rows), devices in zip(layout.blocks, jax_side["lane_split"]):
        real = ent_rows[ent_rows < layout.num_entities]
        for dev, ents in enumerate(devices):
            assert sorted(int(e) for e in real[owner[real] == dev]) == ents


def test_a_nan_on_one_rank_is_rejected_on_every_rank(ranks):
    assert any(r["nan"]["poisoned"] for r in ranks)
    for r in ranks:
        # The rejected update and its one retry (PHOTON_SOLVE_RETRIES = 1),
        # the reference's count.
        assert r["nan"]["diverged"] == 2
        assert r["nan"]["models"] == ["fixed"]  # the random-effect update was rejected everywhere


def test_sparse_fixed_effect_across_ranks_matches_one_process(ranks, one_process):
    ref = one_process["sparse"]
    obj = PORT_TOLERANCES["objective"]
    for r in ranks:
        s = r["sparse"]
        np.testing.assert_allclose(s["f"], ref["f"], rtol=obj["rtol"])
        _close_vec(s["g"], ref["g"], obj)
        _close_vec(s["hv"], ref["hv"], obj)
        np.testing.assert_allclose(s["coef"], ref["coef"], atol=SOLVER["coef_atol"], rtol=0)
        np.testing.assert_allclose(s["loss"], ref["loss"], rtol=SOLVER["loss_rtol"])


def test_a_converted_model_scores_the_same_on_ranks(ranks, one_process):
    tol = PORT_TOLERANCES["convert_scores"]
    for r in ranks:
        np.testing.assert_allclose(r["converted"], one_process["converted"], rtol=tol["rtol"],
                                   atol=tol["atol"])


def test_one_rank_is_bit_identical_to_one_process(jax_side, one_process):
    (r,) = ranks_of(1, jax_side)
    for key in ("fe", "re", "scores", "active"):
        assert np.array_equal(r["glmix"][key], one_process["glmix"][key]), key
    assert r["glmix"]["auc"] == one_process["glmix"]["auc"]
    assert r["glmix"]["history"] == one_process["glmix"]["history"]
    for key in ("coef", "tron_coef", "tron_var"):
        assert np.array_equal(r["fixed"][key], one_process["fixed"][key]), key
    for key in ("g", "hv", "coef"):
        assert np.array_equal(r["sparse"][key], one_process["sparse"][key]), key
    assert np.array_equal(r["converted"], one_process["converted"])


# ------------------------------------------------------------ the launcher


def failing_program(mesh, pid_dir):
    """Rank 1 fails at once; the others wait in a collective for it."""
    with open(os.path.join(pid_dir, f"rank{mesh.rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()


def sleeping_program(mesh, pid_dir):
    with open(os.path.join(pid_dir, f"rank{mesh.rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(60)


def _gone(pid_dir, world):
    for r in range(world):
        path = os.path.join(pid_dir, f"rank{r}.pid")
        if os.path.exists(path):
            pid = int(open(path).read())
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)


def test_a_failing_rank_fails_the_launch_and_the_others_are_killed(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        launch(failing_program, 3, backend="gloo", devices=["cpu"] * 3, deadline_s=60,
               args=(str(tmp_path),))
    assert time.monotonic() - t0 < 50
    _gone(tmp_path, 3)


def test_the_deadline_fails_the_launch_and_kills_the_ranks(tmp_path):
    with pytest.raises(TimeoutError):
        launch(sleeping_program, 2, backend="gloo", devices=["cpu"] * 2, deadline_s=6,
               args=(str(tmp_path),))
    _gone(tmp_path, 2)


@pytest.mark.parametrize("bad", ["backend", "devices", "nccl_shared"])
def test_launch_refuses_what_it_cannot_run(bad):
    kw = dict(backend="gloo", devices=["cpu", "cpu"], deadline_s=5)
    if bad == "backend":
        kw["backend"] = "mpi"
    elif bad == "devices":
        kw["devices"] = ["cpu"]
    else:
        kw.update(backend="nccl", devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        launch(sleeping_program, 2, args=("unused",), **kw)


@pytest.mark.parametrize("bad", ["backend", "store_and_method", "neither", "nccl_on_cpu"])
def test_init_rank_mesh_refuses_without_joining(bad, tmp_path):
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    kw = dict(backend="gloo", rank=0, world_size=1, device="cpu", store=store)
    if bad == "backend":
        kw["backend"] = "auto"
    elif bad == "store_and_method":
        kw["init_method"] = "env://"
    elif bad == "neither":
        kw["store"] = None
    else:
        kw["backend"] = "nccl"
    with pytest.raises(ValueError):
        pmesh.init_rank_mesh(**kw)
    assert not torch.distributed.is_initialized()


def test_a_second_random_effect_key_is_refused_on_ranks():
    """Rows follow one random effect's entities; a coordinate keyed by
    another id would need its residual offsets exchanged between ranks. The
    same key over another feature shard is the same layout and is taken."""
    Xf, Xe, entity, y = glmix_arrays()
    ds = GameDataset.build({"per_entity": Xe, "other": Xe[:, :2]}, y,
                           id_tags={"entityId": entity, "itemId": entity % 7}, device="cpu")
    layout = entity_layout(factorize_tag(entity), RE_CONFIG, torch.device("cpu"))
    ds.sharding = pmesh.RowSharding(
        pmesh.RankMesh(0, 1, "gloo", torch.device("cpu")), torch.arange(len(y)), len(y), RE_CONFIG,
        layout, pmesh.entity_owners(layout, 1))
    with pytest.raises(NotImplementedError):
        build_random_effect_dataset(ds, RandomEffectDataConfig("itemId", "per_entity"))
    red = build_random_effect_dataset(ds, dataclasses.replace(RE_CONFIG, feature_shard="other"))
    assert red.num_active_samples == layout.num_active


# ------------------------------------------------------- the rank-order sum


def test_rank_order_sum_adds_the_rows_in_rank_order_on_cpu():
    """The plain version (what the CUDA kernel is held to on the card): row 0,
    then + row 1, + row 2, ... in float64, rounded once; CPU tensors take it
    and count no launch."""
    rows = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 9)) * 1e8)
    rows[:, 0] = torch.tensor([1.0, 1e-17, 1e-17, -1.0], dtype=torch.float64)  # order shows
    before = dict(pmesh.LAUNCHES)
    want = rows[0].clone()
    for r in range(1, 4):
        want = want + rows[r]
    got64 = pmesh.rank_order_sum(rows, torch.float64)
    got32 = pmesh.rank_order_sum(rows, torch.float32)
    assert got64.dtype == torch.float64 and torch.equal(got64, want)
    assert got32.dtype == torch.float32 and torch.equal(got32, want.float())
    assert got64[0] == 0.0  # (1 + 1e-17) + 1e-17 - 1, not 2e-17
    assert pmesh.LAUNCHES == before


@pytest.mark.parametrize("bad", ["float32_rows", "one_d", "strided", "int_sum"])
def test_rank_order_sum_rejects_what_the_kernel_does_not_take(bad):
    rows = torch.zeros((3, 8), dtype=torch.float64)
    dtype = torch.float32
    if bad == "float32_rows":
        rows = rows.float()
    elif bad == "one_d":
        rows = rows[0]
    elif bad == "strided":
        rows = rows.t()
    else:
        dtype = torch.int64
    with pytest.raises((ValueError, TypeError)):
        pmesh.rank_order_sum(rows, dtype)


def test_exact_sum_library_is_named_by_its_source_and_built_under_the_package():
    from photon_ml_tpu_torch.ops import cuda_build

    path = cuda_build.library_path(pmesh.SOURCE)
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libexact_sum-")
    assert pmesh.SOURCE.exists() and pmesh.SOURCE.parent == cuda_build.CSRC_DIR
