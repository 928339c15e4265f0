"""GLMix with two random effects on torch.distributed ranks against the JAX
package's mesh fit, and the row exchange that makes the second one work.

Rows follow the per-user random effect (the owner); the per-item random
effect trains on a row view, the rows of the items a rank owns, so each of
its updates exchanges the residual offsets to the view and its scores back
(`RankMesh.exchange`). Every shard is sparse. The port runs on W = 1, 3 and
4 gloo ranks on the CPU (`parallel/launch.py`, one spawn per W), each rank
running `rank_program` once and returning host arrays, which the tests
hold against the JAX package on its 8-device virtual CPU mesh
(tests/conftest.py) and against the port in one process, on the same numpy
inputs. JAX is imported inside the fixture that builds its side only: the
ranks import this module to find their program, and load torch alone.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import (
    GameDataset,
    RandomEffectDataConfig,
    build_random_effect_dataset,
    entity_layout,
    factorize_tag,
)
from photon_ml_tpu_torch.evaluation import suite
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.parallel import mesh as pmesh
from photon_ml_tpu_torch.parallel.launch import launch
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import TaskType

GLMIX = PORT_TOLERANCES["glmix"]
TASK = TaskType.LOGISTIC_REGRESSION
USER = RandomEffectDataConfig("userId", "per_user", active_upper_bound=96, min_bucket=16)
ITEM = RandomEffectDataConfig("itemId", "per_item", active_upper_bound=256, min_bucket=16)
RE_CONFIGS = {"per-user": USER, "per-item": ITEM}
# Pearson selection: ceil(ratio * rows) of an entity's features (2 of a
# user's 9, 6 of an item's 9 sparse or 12 dense).
PEARSON_RATIO = 0.02
EVALUATORS = ("AUC", "AUC:userId", "PRECISION@5:itemId")
DEADLINE_S = 120.0


# ------------------------------------------------------------------ inputs


def ell(rng, n, k, dim):
    """(n, k + 1) ELL planes: k distinct ids of `dim`, then an intercept at `dim`."""
    idx = np.argsort(rng.random((n, dim)), axis=1)[:, :k].astype(np.int32)
    idx = np.concatenate([idx, np.full((n, 1), dim, np.int32)], 1)
    val = rng.normal(size=(n, k + 1)).astype(np.float32)
    val[:, -1] = 1.0
    return idx, val, dim + 1


def re_arrays(seed=3, n=4096, n_users=24, n_items=8):
    """A sparse fixed effect (6 of 40 ids) and sparse per-user and per-item
    shards (3 of 8 ids each), with an intercept each; users of ~100 to ~280
    rows (capped at 96 active), items of ~510 (capped at 256). n is a
    multiple of 8, so the JAX side needs no padding rows."""
    rng = np.random.default_rng(seed)
    shards = {"global": ell(rng, n, 6, 40), "per_user": ell(rng, n, 3, 8),
              "per_item": ell(rng, n, 3, 8)}
    p = 1.0 / np.arange(1, n_users + 1) ** 0.3
    users = rng.choice(n_users, size=n, p=p / p.sum()).astype(np.int64)
    items = rng.integers(0, n_items, size=n).astype(np.int64)
    (fi, fv, fd), (ui, uv, ud), (ii, iv, idim) = shards.values()
    w = rng.normal(size=fd) * 0.3
    u = rng.normal(size=(n_users, ud)) * 0.5
    v = rng.normal(size=(n_items, idim)) * 0.5
    margin = ((fv * w[fi]).sum(1) + (uv * u[users[:, None], ui]).sum(1)
              + (iv * v[items[:, None], ii]).sum(1))
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    dense_item = rng.normal(size=(n, 12)).astype(np.float32)  # a dense shard for the masks
    dense_item[:, 0] = 1.0
    return shards, dense_item, users, items, y


def port_shards():
    shards, dense_item, _, _, _ = re_arrays()
    out = {k: SparseFeatures(torch.from_numpy(i), torch.from_numpy(v), d)
           for k, (i, v, d) in shards.items()}
    out["dense_item"] = dense_item
    return out


def configs(pkg):
    """The bench's caps and L2 weights. The random effects stop at a
    relative tolerance of 1e-4: their second-sweep solves start near their
    optimum, where at 1e-5 float32 rounding decides in which step a lane
    stops (tests/test_torch_sparse_re.py::test_re_solve_length_is_as_
    sensitive_in_the_reference), so each package, and the JAX package on
    one device and on its mesh, may stop a lane a step apart; at 1e-4 they
    stop on real progress and land on the same point."""
    fe = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=40, tolerance=1e-6),
        regularization=pkg.L2, reg_weight=1.0)
    re = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=20, tolerance=1e-4),
        regularization=pkg.L2, reg_weight=10.0)
    return fe, re


# ------------------------------------------------- the port, on ranks or not
#
# Each part takes `mesh`: None runs the port in this process on all rows, a
# RankMesh runs it on that rank's rows (which follow the per-user entities).
# Results are host values over all rows (gathered on ranks).


def dataset(mesh):
    _, _, users, items, y = re_arrays()
    tags = {"userId": users, "itemId": items}
    if mesh is None:
        return GameDataset.build(port_shards(), y, id_tags=tags, device="cpu")
    return pmesh.shard_game_dataset(mesh, port_shards(), y, id_tags=tags, owner=USER)


def all_rows(ds, values):
    return values if ds.sharding is None else ds.sharding.gather(values)


@contextlib.contextmanager
def counted_collectives(calls):
    """Count this rank's calls of each torch.distributed collective by name."""
    names = ("all_gather", "all_gather_into_tensor", "all_reduce", "all_to_all_single", "broadcast")
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


def part_glmix(mesh):
    """Two coordinate-descent sweeps (fixed, per-user, per-item) with AUC
    validation on the training rows; the model assembled over ranks; the
    collectives of the sweeps; the per-item view's exchange of global row
    ids, there and back."""
    fe, re = configs(config)
    ds = dataset(mesh)
    coords = {"fixed": FixedEffectCoordinate(ds, "global", fe, TASK)}
    for cid, cfg in RE_CONFIGS.items():
        coords[cid] = RandomEffectCoordinate(ds, build_random_effect_dataset(ds, cfg), re, TASK)
    vsuite = suite.EvaluationSuite([suite.EvaluatorType("AUC")], ds.labels, sharding=ds.sharding)
    calls = {}
    if mesh is not None:
        mesh.reset_counts()
    with counted_collectives(calls):
        res = run_coordinate_descent(coords, 2, validation_scorer=lambda c, m: coords[c].score(m),
                                     validation_suite=vsuite)
    sweep = None if mesh is None else dict(counts=dict(mesh.counts), elements=dict(mesh.elements),
                                           calls=calls)
    scores = sum(coords[c].score(res.model[c]) for c in coords)
    model = gather_game_model(coords, res.model)
    out = dict(
        fe=model["fixed"].coefficients.means.numpy(),
        re={c: model[c].coefficients_matrix.numpy() for c in RE_CONFIGS},
        entity_index={c: coords[c].re_dataset.entity_index for c in RE_CONFIGS},
        scores=all_rows(ds, scores).numpy(),
        history=[(i, c, r.results["AUC"]) for i, c, r in res.validation_history],
        diverged=res.diverged_steps, sweep=sweep,
    )
    if mesh is not None:
        item = coords["per-item"].re_dataset
        rows = ds.sharding.global_rows
        out.update(
            rows=rows.numpy(), view_rows=item.view.global_rows,
            owned={c: coords[c].re_dataset.owned_entities.numpy() for c in RE_CONFIGS},
            user_view=coords["per-user"].re_dataset.view,
            sent=(item.view.to_view.rows_sent, item.view.from_view.rows_sent),
            moved_ids=mesh.exchange(rows.double(), item.view.to_view).numpy(),
            back_ids=mesh.exchange(mesh.exchange(rows.double(), item.view.to_view),
                                   item.view.from_view).numpy(),
            plan_counts=(item.view.to_view.send_counts, item.view.to_view.recv_counts),
        )
    return out


def part_masks(mesh):
    """Pearson masks of the owner (sparse per-user) and of two views
    (sparse and dense per-item), with the entities each mask row is for."""
    ds = dataset(mesh)
    out = {}
    for name, cfg in (("per-user", USER), ("per-item", ITEM),
                      ("dense-item", dataclasses.replace(ITEM, feature_shard="dense_item"))):
        red = build_random_effect_dataset(ds, dataclasses.replace(
            cfg, num_features_to_samples_ratio_upper_bound=PEARSON_RATIO))
        out[name] = dict(mask=red.feature_mask.numpy(),
                         rows=(np.arange(red.num_entities) if red.owned_entities is None
                               else red.owned_entities.numpy()))
    return out


def part_grouped(mesh):
    """Plain and grouped evaluators (per-user AUC, precision@5 by item) of
    fixed scores over all rows."""
    ds = dataset(mesh)
    n = len(re_arrays()[-1])
    scores = torch.from_numpy(np.random.default_rng(17).normal(size=n).astype(np.float32))
    weights = torch.from_numpy(np.random.default_rng(18).uniform(0.5, 2.0, size=n).astype(np.float32))
    if mesh is not None:
        scores, weights = scores[ds.sharding.global_rows], weights[ds.sharding.global_rows]
    ev = suite.EvaluationSuite([suite.EvaluatorType.parse(e) for e in EVALUATORS], ds.labels,
                               weights, id_tag_values=ds.id_tags, sharding=ds.sharding)
    return ev.evaluate(ds.labels * 0.5 + scores).results


def part_converted(mesh, arrays):
    """The JAX package's two-random-effect mesh fit, carried over as numpy
    arrays, scored on this rank's rows."""
    ds = dataset(mesh)
    model, specs = convert.game_model_from_numpy(arrays, TASK, device="cpu")
    return all_rows(ds, GameTransformer(model, specs, TASK).transform(ds).scores).numpy()


def rank_program(mesh, converted_arrays):
    torch.set_num_threads(1)
    return dict(rank=mesh.rank, glmix=part_glmix(mesh), masks=part_masks(mesh),
                grouped=part_grouped(mesh), converted=part_converted(mesh, converted_arrays))


# ------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def jax_side():
    """Two GLMix sweeps of the JAX package on its 8-device mesh: padded,
    sample-sharded data with each random effect's buckets entity-sharded."""
    from photon_ml_tpu.data import containers as jax_containers
    from photon_ml_tpu.data import game_dataset as jax_gd
    from photon_ml_tpu.evaluation import suite as jax_suite
    from photon_ml_tpu.game import coordinate as jax_coordinate
    from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
    from photon_ml_tpu.optimize import config as jax_config
    from photon_ml_tpu.parallel.mesh import (
        make_mesh,
        pad_game_dataset,
        shard_game_dataset,
        shard_random_effect_dataset,
    )
    from photon_ml_tpu.types import TaskType as JaxTaskType

    mesh = make_mesh()
    shards, _, users, items, y = re_arrays()
    fe, re = configs(jax_config)
    task = JaxTaskType.LOGISTIC_REGRESSION
    ds = jax_gd.GameDataset.build(
        {k: jax_containers.SparseFeatures(i, v, d) for k, (i, v, d) in shards.items()}, y,
        id_tags={"userId": users, "itemId": items})
    sharded = shard_game_dataset(pad_game_dataset(ds, mesh.devices.size), mesh)
    coords = {"fixed": jax_coordinate.FixedEffectCoordinate(sharded, "global", fe, task)}
    reds = {}
    for cid, cfg in RE_CONFIGS.items():
        jcfg = jax_gd.RandomEffectDataConfig(cfg.random_effect_type, cfg.feature_shard,
                                             active_upper_bound=cfg.active_upper_bound,
                                             min_bucket=cfg.min_bucket)
        reds[cid] = shard_random_effect_dataset(jax_gd.build_random_effect_dataset(sharded, jcfg),
                                                mesh)
        coords[cid] = jax_coordinate.RandomEffectCoordinate(sharded, reds[cid], re, task)
    vsuite = jax_suite.EvaluationSuite([jax_suite.EvaluatorType("AUC")], sharded.labels)
    res = jax_run_cd(coords, 2, validation_scorer=lambda c, m: coords[c].score(m),
                     validation_suite=vsuite)
    out = dict(fe=np.asarray(res.model["fixed"].coefficients.means),
               scores=np.asarray(sum(coords[c].score(res.model[c]) for c in coords)),
               history=[(i, c, r.results["AUC"]) for i, c, r in res.validation_history],
               re={}, entity_index={})
    for cid, red in reds.items():
        # The row-sharded store pads the matrix to a multiple of the mesh
        # after the pinned row E; the model proper is its first E + 1 rows.
        matrix = np.asarray(res.model[cid].coefficients_matrix)
        assert np.all(matrix[red.num_entities:] == 0.0)
        out["re"][cid] = matrix[:red.num_entities + 1]
        out["entity_index"][cid] = dict(red.entity_index)
    out["converted_arrays"] = {"fixed": convert.FixedEffectArrays("global", out["fe"])}
    for cid, cfg in RE_CONFIGS.items():
        out["converted_arrays"][cid] = convert.RandomEffectArrays(
            cfg.feature_shard, cfg.random_effect_type, out["re"][cid], out["entity_index"][cid])
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


@pytest.fixture(scope="module")
def one_process(jax_side):
    """The same parts in this process, on all rows, with no mesh (one
    intra-op thread, as in every rank)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dict(glmix=part_glmix(None), masks=part_masks(None), grouped=part_grouped(None),
                    converted=part_converted(None, jax_side["converted_arrays"]))
    finally:
        torch.set_num_threads(saved)


def owners_of_rows(world):
    """Each global row's rank under the per-user ownership, and its rank in
    the per-item layout, from the global tags as one process lays them out."""
    _, _, users, items, _ = re_arrays()
    out = []
    for tag, cfg in ((users, USER), (items, ITEM)):
        layout = entity_layout(factorize_tag(tag), cfg, torch.device("cpu"))
        out.append(pmesh.entity_owners(layout, world)[layout.codes.numpy()])
    return out


# -------------------------------------------------------------------- tests


def test_two_random_effects_match_jax_mesh_training(ranks, jax_side):
    ref = jax_side
    for r in ranks:
        g = r["glmix"]
        np.testing.assert_allclose(g["fe"], ref["fe"], atol=GLMIX["coef_atol"], rtol=0)
        for cid in RE_CONFIGS:
            index = ref["entity_index"][cid]
            assert g["entity_index"][cid] == index
            for ent, row in index.items():  # entity by entity
                np.testing.assert_allclose(g["re"][cid][row], ref["re"][cid][row],
                                           atol=GLMIX["coef_atol"], rtol=0)
            assert np.all(g["re"][cid][-1] == 0.0)  # the pinned unseen-entity row
        np.testing.assert_allclose(g["scores"], ref["scores"], atol=GLMIX["score_atol"], rtol=0)
        assert [(i, c) for i, c, _ in g["history"]] == [(i, c) for i, c, _ in ref["history"]]
        for (_, _, auc), (_, _, jauc) in zip(g["history"], ref["history"]):
            assert abs(auc - jauc) <= GLMIX["auc_atol"]
        assert g["diverged"] == 0 and g["history"][-1][2] > 0.75


def test_every_rank_holds_the_same_model_bits(ranks):
    for r in ranks:
        assert np.array_equal(r["glmix"]["fe"], ranks[0]["glmix"]["fe"])
        for cid in RE_CONFIGS:
            assert np.array_equal(r["glmix"]["re"][cid], ranks[0]["glmix"]["re"][cid])
        assert r["glmix"]["history"] == ranks[0]["glmix"]["history"]


def test_one_rank_is_bit_identical_to_one_process(jax_side, one_process):
    (r,) = ranks_of(1, jax_side)
    g, ref = r["glmix"], one_process["glmix"]
    assert np.array_equal(g["fe"], ref["fe"])
    for cid in RE_CONFIGS:
        assert np.array_equal(g["re"][cid], ref["re"][cid]), cid
    assert np.array_equal(g["scores"], ref["scores"])
    assert g["history"] == ref["history"]


def test_each_entity_has_one_owner_and_the_view_holds_its_rows(ranks):
    world = len(ranks)
    user_rank, item_rank = owners_of_rows(world)
    for cid in RE_CONFIGS:
        owned = np.concatenate([r["glmix"]["owned"][cid] for r in ranks])
        assert np.array_equal(np.sort(owned), np.arange(len(ranks[0]["glmix"]["entity_index"][cid])))
    for rank, r in enumerate(ranks):
        g = r["glmix"]
        assert g["user_view"] is None  # the owner trains on the rank's own rows
        assert np.array_equal(g["rows"], np.nonzero(user_rank == rank)[0])
        assert np.array_equal(g["view_rows"], np.nonzero(item_rank == rank)[0])


def test_the_exchange_moves_exactly_the_rows_whose_owners_differ(ranks):
    """Each rank sends the rows it holds whose per-item owner is another
    rank, receives those of its view held elsewhere, and the values land
    where the plan says (global row ids there, and back)."""
    world = len(ranks)
    user_rank, item_rank = owners_of_rows(world)
    for rank, r in enumerate(ranks):
        g = r["glmix"]
        to_view, from_view = g["sent"]
        assert to_view == int(((user_rank == rank) & (item_rank != rank)).sum())
        assert from_view == int(((item_rank == rank) & (user_rank != rank)).sum())
        send_counts, recv_counts = g["plan_counts"]
        assert send_counts == tuple(int(((user_rank == rank) & (item_rank == d)).sum())
                                    if d != rank else 0 for d in range(world))
        assert recv_counts == tuple(int(((item_rank == rank) & (user_rank == s)).sum())
                                    if s != rank else 0 for s in range(world))
        assert np.array_equal(g["moved_ids"], g["view_rows"].astype(np.float64))
        assert np.array_equal(g["back_ids"], g["rows"].astype(np.float64))
    assert sum(r["glmix"]["sent"][0] for r in ranks) == int((user_rank != item_rank).sum())


def test_the_sweeps_exchange_once_each_way_per_item_update(ranks):
    """Two sweeps update per-item twice: each update exchanges its offsets
    to the view and its scores back, and validation scores it once more.
    Only the validation gathers all-reduce N-long vectors; every other
    cross-rank move is an exact sum or an exchange. World size 1 moves
    nothing."""
    world = len(ranks)
    for r in ranks:
        s = r["glmix"]["sweep"]
        to_view, from_view = r["glmix"]["sent"]
        validations = len(r["glmix"]["history"])
        if world == 1:
            assert s["counts"]["exchange"] == 0 and s["elements"]["exchange"] == 0
            assert "all_to_all_single" not in s["calls"]
        else:
            assert s["counts"]["exchange"] == s["calls"]["all_to_all_single"] == 6
            assert s["elements"]["exchange"] == 2 * to_view + 4 * from_view
        assert s["counts"]["owned_to_global"] == s["calls"].get("all_reduce", 0) == validations
        assert s["calls"].get("all_gather", 0) == s["counts"]["exact_sum"]


def test_pearson_masks_on_ranks_are_one_process_masks(ranks, one_process):
    for r in ranks:
        for name, m in r["masks"].items():
            ref = one_process["masks"][name]["mask"]
            assert m["mask"].shape == (len(m["rows"]) + 1, ref.shape[1])
            assert np.array_equal(m["mask"][:-1], ref[m["rows"]]), name
            assert np.all(m["mask"][-1] == 1.0)
    for name, m in one_process["masks"].items():  # every selection dropped features
        assert (m["mask"][:-1] == 0).any(), name


def test_grouped_evaluators_on_ranks_are_one_process_bits(ranks, one_process):
    for r in ranks:
        assert r["grouped"] == one_process["grouped"]
    assert set(one_process["grouped"]) == set(EVALUATORS)


def test_a_converted_two_random_effect_model_scores_the_same_on_ranks(ranks, one_process,
                                                                      jax_side):
    tol = PORT_TOLERANCES["convert_scores"]
    np.testing.assert_allclose(one_process["converted"], jax_side["scores"], rtol=tol["rtol"],
                               atol=tol["atol"])
    for r in ranks:
        np.testing.assert_allclose(r["converted"], one_process["converted"], rtol=tol["rtol"],
                                   atol=tol["atol"])
