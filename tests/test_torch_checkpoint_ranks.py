"""Checkpoint-restart of a fit on torch.distributed ranks (game/checkpoint.py
`RankCheckpoint`, game/coordinate_descent.py) in the JAX package's elastic
shard layout.

A two-random-effect GLMix (rows follow the per-user entities; per-item
trains on a row view) runs on gloo CPU ranks through `parallel/launch.py`:
one spawn at W = 3 runs every scenario of that world size in turn (the
uninterrupted fit, one sweep then a resume, the fault drill, SIMPLE
variances), one at W = 2 resumes the 3-rank checkpoint, and this process
resumes it once more. Each rank returns host values; the tests hold them
against each other, against one process, and against the JAX package's
reader of the same directory. JAX is imported inside the tests only: the
ranks import this module to find their program.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import (
    GameDataset,
    RandomEffectDataConfig,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game import checkpoint
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import (
    gather_game_model,
    run_config_key,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.parallel import mesh as pmesh
from photon_ml_tpu_torch.parallel.launch import launch
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType
from photon_ml_tpu_torch.utils import faults, telemetry

GLMIX = PORT_TOLERANCES["glmix"]
TASK = TaskType.LOGISTIC_REGRESSION
USER = RandomEffectDataConfig("userId", "per_user", active_upper_bound=96, min_bucket=16)
ITEM = RandomEffectDataConfig("itemId", "per_item", active_upper_bound=256, min_bucket=16)
DEADLINE_S = 120.0
SEED = 5


def ell(rng, n, k, dim):
    """(n, k + 1) ELL planes: k distinct ids of `dim`, then an intercept at `dim`."""
    idx = np.argsort(rng.random((n, dim)), axis=1)[:, :k].astype(np.int32)
    idx = np.concatenate([idx, np.full((n, 1), dim, np.int32)], 1)
    val = rng.normal(size=(n, k + 1)).astype(np.float32)
    val[:, -1] = 1.0
    return idx, val, dim + 1


def arrays(seed=3, n=3072, n_users=24, n_items=8):
    rng = np.random.default_rng(seed)
    shards = {"global": ell(rng, n, 6, 40), "per_user": ell(rng, n, 3, 8),
              "per_item": ell(rng, n, 3, 8)}
    p = 1.0 / np.arange(1, n_users + 1) ** 0.3
    users = rng.choice(n_users, size=n, p=p / p.sum()).astype(np.int64)
    items = rng.integers(0, n_items, size=n).astype(np.int64)
    (fi, fv, fd), (ui, uv, ud), (ii, iv, idim) = shards.values()
    margin = ((fv * (rng.normal(size=fd) * 0.3)[fi]).sum(1)
              + (uv * (rng.normal(size=(n_users, ud)) * 0.5)[users[:, None], ui]).sum(1)
              + (iv * (rng.normal(size=(n_items, idim)) * 0.5)[items[:, None], ii]).sum(1))
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    feats = {k: SparseFeatures(torch.from_numpy(i), torch.from_numpy(v), d)
             for k, (i, v, d) in shards.items()}
    return feats, {"userId": users, "itemId": items}, y


def dataset(mesh):
    """All rows in this process (mesh None), or this rank's rows."""
    feats, tags, y = arrays()
    if mesh is None:
        return GameDataset.build(feats, y, id_tags=tags, device="cpu")
    return pmesh.shard_game_dataset(mesh, feats, y, id_tags=tags, owner=USER)


def coordinates(ds, variances=False):
    fe = config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(max_iterations=40, tolerance=1e-6),
        regularization=config.L2, reg_weight=1.0)
    re = config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(max_iterations=20, tolerance=1e-4),
        regularization=config.L2, reg_weight=10.0)
    if variances:
        re = dataclasses.replace(re, variance_computation=VarianceComputationType.SIMPLE)
    return {"global": FixedEffectCoordinate(ds, "global", fe, TASK),
            "per-user": RandomEffectCoordinate(ds, build_random_effect_dataset(ds, USER), re, TASK),
            "per-item": RandomEffectCoordinate(ds, build_random_effect_dataset(ds, ITEM), re, TASK)}


def host(model):
    """{cid: (coefficients, variances or None)} as numpy."""
    out = {}
    for cid, m in model.models.items():
        if hasattr(m, "coefficients_matrix"):
            mat, var = m.coefficients_matrix, m.variances_matrix
        else:
            mat, var = m.coefficients.means, m.coefficients.variances
        out[cid] = (mat.cpu().numpy(), None if var is None else var.cpu().numpy())
    return out


def fit(mesh, root, name, iterations, variances=False):
    """Coordinate descent with a checkpoint at root/name; the model of all
    ranks, this rank's stores and the run's fingerprint."""
    ds = dataset(mesh)
    coords = coordinates(ds, variances)
    res = run_coordinate_descent(coords, iterations, seed=SEED,
                                 checkpoint_dir=os.path.join(root, name))
    return dict(model=host(gather_game_model(coords, res.model)), store=host(res.model),
                owned={c: coords[c].re_dataset.owned_entities.cpu().numpy()
                       for c in ("per-user", "per-item")} if mesh is not None else None,
                key=run_config_key(coords, set(), None))


def rank_program_3(mesh, root):
    out = dict(rank=mesh.rank, full=fit(mesh, root, "full", 2), part=fit(mesh, root, "part", 1))
    # Copies of the one-sweep checkpoint for the other world sizes, made
    # while no rank writes it.
    mesh.all_true(True)
    if mesh.rank == 0:
        for copy in ("part-w2", "part-w1"):
            shutil.copytree(os.path.join(root, "part"), os.path.join(root, copy))
    mesh.all_true(True)
    out["resumed"] = fit(mesh, root, "part", 2)
    # Each rank's first checkpoint write fails once, then its first read on
    # resume: both retried.
    with faults.inject("checkpoint_write@1"):
        fit(mesh, root, "faulty", 1)
    with faults.inject("resume_load@1"):
        out["faulty"] = fit(mesh, root, "faulty", 2)
    out["retries"] = telemetry.METRICS.get_counter("retries")
    out["var"] = fit(mesh, root, "var", 1, variances=True)
    return out


def rank_program_2(mesh, root):
    return dict(resumed=fit(mesh, root, "part-w2", 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_ranks"))
    w3 = launch(rank_program_3, 3, backend="gloo", devices=["cpu"] * 3, deadline_s=DEADLINE_S,
                args=(root,))
    w2 = launch(rank_program_2, 2, backend="gloo", devices=["cpu"] * 2, deadline_s=DEADLINE_S,
                args=(root,))
    one = fit(None, root, "part-w1", 2)
    return dict(root=root, w3=w3, w2=w2, one=one)


def _bit_equal(a, b):
    return all(np.array_equal(a[c][0], b[c][0]) for c in a) and a.keys() == b.keys()


def _within(a, b, atol):
    return max(float(np.abs(a[c][0] - b[c][0]).max()) for c in a) <= atol


def test_resume_at_the_same_world_size_is_bit_equal(runs):
    for r in runs["w3"]:
        assert _bit_equal(r["resumed"]["model"], r["full"]["model"])
        assert _bit_equal(r["resumed"]["model"], runs["w3"][0]["full"]["model"])


@pytest.mark.parametrize("where", ["2 ranks", "one process"])
def test_resume_at_another_world_size_is_within_glmix(runs, where):
    full = runs["w3"][0]["full"]["model"]
    resumed = [r["resumed"]["model"] for r in runs["w2"]] if where == "2 ranks" else [runs["one"]["model"]]
    for model in resumed:
        assert _within(model, full, GLMIX["coef_atol"])


def test_the_jax_reader_loads_the_rank_checkpoint_to_the_same_bits(runs):
    from photon_ml_tpu.game import checkpoint as jax_checkpoint

    state = jax_checkpoint.CoordinateDescentCheckpoint(os.path.join(runs["root"], "full")).load(TASK)
    full = runs["w3"][0]["full"]["model"]
    assert state.completed_steps == 6
    for cid, (mat, _) in full.items():
        m = state.models[cid]
        got = m.coefficients.means if cid == "global" else m.coefficients_matrix
        assert np.array_equal(np.asarray(got), mat), cid
    with open(os.path.join(runs["root"], "full", checkpoint.STATE_FILE)) as f:
        state_json = json.load(f)
    # Every random effect in 3 blocks, each written by its own rank.
    for cid in ("per-user", "per-item"):
        rels = state_json["model_files"][cid]
        assert [r.rsplit(".", 2)[1] for r in rels] == ["shard0of3", "shard1of3", "shard2of3"]
        assert [state_json["multihost"]["shard_hosts"][r] for r in rels] == [0, 1, 2]


def test_every_rank_fingerprints_the_run_as_one_process(runs):
    ds = dataset(None)
    key = run_config_key(coordinates(ds), set(), None)
    assert {r[k]["key"] for r in runs["w3"] for k in ("full", "part", "resumed")} == {key}
    assert {r["resumed"]["key"] for r in runs["w2"]} == {key}


def test_a_deleted_shard_names_the_rank_that_wrote_it(runs, tmp_path):
    torn = str(tmp_path / "torn")
    shutil.copytree(os.path.join(runs["root"], "full"), torn)
    with open(os.path.join(torn, checkpoint.STATE_FILE)) as f:
        writers = json.load(f)["multihost"]["shard_hosts"]
    victim = sorted(r for r, w in writers.items() if w == 1)[0]
    os.remove(os.path.join(torn, victim))
    with pytest.raises(checkpoint.CheckpointIntegrityError, match=f"{victim}.*written by rank 1"):
        checkpoint.CoordinateDescentCheckpoint(torn).load(TASK)


def test_armed_write_and_read_faults_retry_to_the_same_bits(runs):
    for r in runs["w3"]:
        assert _bit_equal(r["faulty"]["model"], r["full"]["model"])
        assert r["retries"] >= 2  # one write and one read, retried


def test_simple_random_effect_variances_survive_gather_and_the_shard_files(runs, tmp_path):
    """Fails where `gather_model` dropped the variances of a fit on ranks."""
    var = [r["var"] for r in runs["w3"]]
    one = fit(None, str(tmp_path), "one", 1, variances=True)["model"]
    reread = checkpoint.CoordinateDescentCheckpoint(os.path.join(runs["root"], "var")).load(TASK)
    for cid in ("per-user", "per-item"):
        mat, v = var[0]["model"][cid]
        assert v is not None and v.shape == mat.shape and np.all(np.isfinite(v[:-1]))
        # Each rank's store rows are its owned entities' rows of the gathered matrices.
        for r in var:
            assert np.array_equal(r["model"][cid][1][r["owned"][cid]], r["store"][cid][1][:-1])
        assert np.array_equal(reread.models[cid].variances_matrix.numpy(), v)
        np.testing.assert_allclose(v, one[cid][1], rtol=PORT_TOLERANCES["estimator"]["variance_rtol"])
    with open(os.path.join(runs["root"], "var", checkpoint.STATE_FILE)) as f:
        rels = json.load(f)["model_files"]["per-user"]
    for rel in rels:
        with np.load(os.path.join(runs["root"], "var", rel)) as z:
            assert {"kind", "matrix", "variances", "shard_index", "n_shards", "row_start",
                    "n_entities"} <= set(z.files)


def test_a_mesh_loss_propagates_and_the_rerun_resumes_to_the_same_bits(tmp_path):
    """The `mesh_loss` site raises the typed, non-transient `MeshLoss` in
    the third update; the steps committed before it resume to the
    uninterrupted fit's bits (one process, as a relaunch would)."""
    telemetry.METRICS.reset()
    with faults.inject("mesh_loss@3"), pytest.raises(faults.MeshLoss, match="iteration 0 coordinate 'per-item'"):
        fit(None, str(tmp_path), "lost", 2)
    assert telemetry.METRICS.get_counter("mesh_losses") == 1
    assert not faults.default_policy().is_transient(faults.MeshLoss("x"))
    assert not faults.default_policy().is_transient(faults.HostLoss("x"))
    with open(tmp_path / "lost" / checkpoint.STATE_FILE) as f:
        assert json.load(f)["completed_steps"] == 2
    resumed = fit(None, str(tmp_path), "lost", 2)["model"]
    assert _bit_equal(resumed, fit(None, str(tmp_path), "straight", 2)["model"])
