"""Coordinate-descent checkpoint-restart in the port (game/checkpoint.py,
`run_coordinate_descent(checkpoint_dir=)`): the JAX package's five cases
of tests/test_checkpoint.py on the port, integrity errors, the run
fingerprint against the JAX package's, and each package resuming the
other's checkpoint (the JAX one in its single-blob and row-sharded
layouts)."""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.game import checkpoint as jax_checkpoint
from photon_ml_tpu.game.coordinate import FixedEffectCoordinate as JaxFE
from photon_ml_tpu.game.coordinate import RandomEffectCoordinate as JaxRE
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import (
    GameDataset,
    RandomEffectDataConfig,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorType
from photon_ml_tpu_torch.game import checkpoint
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_config_key, run_coordinate_descent
from photon_ml_tpu_torch.game.model import random_effect_margins
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.types import TaskType

RESUME = PORT_TOLERANCES["checkpoint_resume"]
GLMIX = PORT_TOLERANCES["glmix"]


def _arrays(seed, n=240, d=5, n_entities=6, d_re=3):
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d)).astype(np.float32)
    Xf[:, -1] = 1.0
    Xe = rng.normal(size=(n, d_re)).astype(np.float32)
    entity = rng.integers(0, n_entities, size=n)
    w = rng.normal(size=d)
    u = rng.normal(size=(n_entities, d_re))
    m = Xf @ w + np.einsum("nd,nd->n", Xe, u[entity])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    return Xf, Xe, entity, y


def _dataset(seed=0):
    Xf, Xe, entity, y = _arrays(seed)
    return GameDataset.build({"global": Xf, "per_entity": Xe}, y, id_tags={"entityId": entity},
                             device="cpu")


def _configs(mod, down_sampling=1.0):
    cfg_f = mod.CoordinateOptimizationConfig(
        optimizer=mod.OptimizerConfig(max_iterations=25, tolerance=1e-8),
        regularization=mod.L2, reg_weight=0.5, down_sampling_rate=down_sampling)
    cfg_r = mod.CoordinateOptimizationConfig(
        optimizer=mod.OptimizerConfig(max_iterations=20, tolerance=1e-8),
        regularization=mod.L2, reg_weight=1.0)
    return cfg_f, cfg_r


def _coords(ds, down_sampling=1.0):
    cfg_f, cfg_r = _configs(__import__("photon_ml_tpu_torch.optimize.config", fromlist=["x"]),
                            down_sampling)
    red = build_random_effect_dataset(ds, RandomEffectDataConfig("entityId", "per_entity",
                                                                 min_bucket=4))
    return {
        "fixed": FixedEffectCoordinate(ds, "global", cfg_f, TaskType.LOGISTIC_REGRESSION),
        "per-entity": RandomEffectCoordinate(ds, red, cfg_r, TaskType.LOGISTIC_REGRESSION),
    }


def _jax_coords(seed=0):
    Xf, Xe, entity, y = _arrays(seed)
    ds = jax_gd.GameDataset.build({"global": jnp.asarray(Xf), "per_entity": jnp.asarray(Xe)}, y,
                                  id_tags={"entityId": entity})
    cfg_f, cfg_r = _configs(jax_config)
    red = jax_gd.build_random_effect_dataset(
        ds, jax_gd.RandomEffectDataConfig("entityId", "per_entity", min_bucket=4))
    return {
        "fixed": JaxFE(ds, "global", cfg_f, JaxTask.LOGISTIC_REGRESSION),
        "per-entity": JaxRE(ds, red, cfg_r, JaxTask.LOGISTIC_REGRESSION),
    }


class _KillSwitch:
    """train() raises after `allowed` calls: a deterministic preemption."""

    def __init__(self, inner, allowed: int):
        self.inner = inner
        self.allowed = allowed
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def train(self, *args, **kwargs):
        if self.calls >= self.allowed:
            raise RuntimeError("simulated preemption")
        self.calls += 1
        return self.inner.train(*args, **kwargs)


def _model_arrays(models):
    out = {}
    for cid, m in models.items():
        a = m.coefficients_matrix if hasattr(m, "coefficients_matrix") else m.coefficients.means
        out[cid] = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return out


def _assert_resumed(a, b):
    for cid in a:
        np.testing.assert_allclose(a[cid], b[cid], rtol=RESUME["rtol"], atol=RESUME["atol"])


# ----------------------------------------------- the JAX package's five cases

def test_resume_between_iterations(tmp_path):
    ds = _dataset()
    straight = run_coordinate_descent(_coords(ds), 2, seed=3)
    ck = str(tmp_path / "ck")
    run_coordinate_descent(_coords(ds), 1, seed=3, checkpoint_dir=ck)
    resumed = run_coordinate_descent(_coords(ds), 2, seed=3, checkpoint_dir=ck)
    _assert_resumed(_model_arrays(straight.model.models), _model_arrays(resumed.model.models))


def test_kill_mid_pass_and_resume(tmp_path):
    """Preempt after the first coordinate of pass 2; the resumed run lands
    where the uninterrupted one does, down-sampling draws included."""
    ds = _dataset()
    straight = run_coordinate_descent(_coords(ds, down_sampling=0.7), 2, seed=7)
    ck = str(tmp_path / "ck")
    coords = _coords(ds, down_sampling=0.7)
    coords["fixed"] = _KillSwitch(coords["fixed"], allowed=1)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        run_coordinate_descent(coords, 2, seed=7, checkpoint_dir=ck)
    assert os.path.isfile(os.path.join(ck, "state.json"))
    with open(os.path.join(ck, "state.json")) as f:
        assert json.load(f)["completed_steps"] == 2
    resumed = run_coordinate_descent(_coords(ds, down_sampling=0.7), 2, seed=7, checkpoint_dir=ck)
    _assert_resumed(_model_arrays(straight.model.models), _model_arrays(resumed.model.models))


def test_seed_mismatch_refuses_resume(tmp_path):
    ds = _dataset()
    ck = str(tmp_path / "ck")
    run_coordinate_descent(_coords(ds), 1, seed=1, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="seed"):
        run_coordinate_descent(_coords(ds), 1, seed=2, checkpoint_dir=ck)


def test_validation_and_best_model_survive_resume(tmp_path):
    ds = _dataset()
    val = _dataset(99)
    suite = EvaluationSuite([EvaluatorType("AUC")], val.labels, val.weights)

    def make_scorer(coords):
        def scorer(cid, model):
            if cid == "fixed":
                return val.shards["global"] @ model.coefficients.means
            red = coords["per-entity"].re_dataset
            return random_effect_margins(val.shards["per_entity"], red.sample_entity_rows,
                                         model.coefficients_matrix, None)
        return scorer

    def run(iters, ck=None):
        c = _coords(ds)
        return run_coordinate_descent(c, iters, seed=5, checkpoint_dir=ck,
                                      validation_scorer=make_scorer(c), validation_suite=suite,
                                      validation_offsets=val.offsets)

    ck = str(tmp_path / "ck")
    run(1, ck)
    resumed = run(2, ck)
    straight = run(2)
    assert len(resumed.validation_history) == len(straight.validation_history)
    for (it_a, cid_a, ra), (it_b, cid_b, rb) in zip(resumed.validation_history,
                                                    straight.validation_history):
        assert (it_a, cid_a) == (it_b, cid_b)
        assert ra.primary_value == pytest.approx(rb.primary_value, abs=1e-6)
    _assert_resumed(_model_arrays(straight.best_model.models),
                    _model_arrays(resumed.best_model.models))


def test_config_change_refuses_resume(tmp_path):
    ds = _dataset()
    ck = str(tmp_path / "ck")
    run_coordinate_descent(_coords(ds), 1, seed=1, checkpoint_dir=ck)
    changed = _coords(ds)
    changed["fixed"].config = dataclasses.replace(changed["fixed"].config, reg_weight=123.0)
    with pytest.raises(ValueError, match="different run configuration"):
        run_coordinate_descent(changed, 1, seed=1, checkpoint_dir=ck, reg_weights={"fixed": 123.0})
    # "discard" clears the stale checkpoint and starts fresh instead.
    fresh = run_coordinate_descent(changed, 1, seed=1, checkpoint_dir=ck,
                                   reg_weights={"fixed": 123.0}, stale_checkpoint="discard")
    straight = run_coordinate_descent(_coords(ds), 1, seed=1, reg_weights={"fixed": 123.0})
    _assert_resumed(_model_arrays(straight.model.models), _model_arrays(fresh.model.models))


# --------------------------------------------------------------- integrity

@pytest.mark.parametrize("fault", ["corrupt", "missing", "truncated"])
def test_a_bad_model_file_raises_integrity_error(tmp_path, fault):
    ds = _dataset()
    ck = str(tmp_path / "ck")
    run_coordinate_descent(_coords(ds), 1, seed=1, checkpoint_dir=ck)
    with open(os.path.join(ck, "state.json")) as f:
        path = os.path.join(ck, json.load(f)["model_files"]["fixed"])
    if fault == "missing":
        os.remove(path)
    else:
        data = bytearray(open(path, "rb").read())
        if fault == "corrupt":
            data[len(data) // 2] ^= 0xFF
        else:
            data = data[: len(data) // 2]
        open(path, "wb").write(bytes(data))
    with pytest.raises(checkpoint.CheckpointIntegrityError, match="delete the checkpoint"):
        run_coordinate_descent(_coords(ds), 2, seed=1, checkpoint_dir=ck)


def test_steps_are_pruned_and_the_best_snapshot_references_current_files(tmp_path):
    ds = _dataset()
    val = _dataset(99)
    suite = EvaluationSuite([EvaluatorType("AUC")], val.labels, val.weights)
    coords = _coords(ds)
    scorer = lambda cid, m: coords[cid].score(m)  # any scores of the right shape
    ck = str(tmp_path / "ck")
    run_coordinate_descent(coords, 2, seed=1, checkpoint_dir=ck, validation_scorer=scorer,
                           validation_suite=suite)
    with open(os.path.join(ck, "state.json")) as f:
        state = json.load(f)
    live = {os.path.dirname(r) for r in list(state["model_files"].values())
            + list(state["best_files"].values())}
    assert sorted(os.path.join("steps", s) for s in os.listdir(os.path.join(ck, "steps"))) == sorted(live)
    assert set(state["checksums"]) == set(state["model_files"].values()) | set(state["best_files"].values())


# ------------------------------------------------------- across the packages

def test_the_same_run_has_the_same_config_key_in_both_packages(tmp_path):
    ck = str(tmp_path / "jax")
    jax_run(_jax_coords(), 1, seed=4, checkpoint_dir=ck, reg_weights={"fixed": 0.25})
    with open(os.path.join(ck, "state.json")) as f:
        jax_key = json.load(f)["config_key"]
    assert run_config_key(_coords(_dataset()), set(), {"fixed": 0.25}) == jax_key
    box = (np.full(5, -1.0, np.float32), np.full(5, 1.0, np.float32))
    port = _coords(_dataset())
    port["fixed"].config = dataclasses.replace(
        port["fixed"].config, optimizer=OptimizerConfig(max_iterations=25, tolerance=1e-8,
                                                        box_constraints=box))
    assert run_config_key(port, set(), {"fixed": 0.25}) != jax_key


def _jax_models_to_port(models):
    return {cid: np.asarray(m.coefficients_matrix if hasattr(m, "coefficients_matrix")
                            else m.coefficients.means) for cid, m in models.items()}


def test_the_port_resumes_a_jax_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    jax_run(_jax_coords(), 1, seed=3, checkpoint_dir=ck)
    resumed = run_coordinate_descent(_coords(_dataset()), 2, seed=3, checkpoint_dir=ck)
    straight = run_coordinate_descent(_coords(_dataset()), 2, seed=3)
    a, b = _model_arrays(straight.model.models), _model_arrays(resumed.model.models)
    np.testing.assert_allclose(b["fixed"], a["fixed"], atol=GLMIX["coef_atol"], rtol=0)
    np.testing.assert_allclose(b["per-entity"], a["per-entity"], atol=GLMIX["coef_atol"], rtol=0)


def test_the_port_resumes_a_row_sharded_jax_checkpoint(tmp_path):
    """The JAX mesh layout: the random effect as per-shard files with mesh
    padding rows and n_entities, listed in state.json."""
    ck = str(tmp_path / "ck")
    jax_run(_jax_coords(), 1, seed=3, checkpoint_dir=ck)
    with open(os.path.join(ck, "state.json")) as f:
        state = json.load(f)
    rel = state["model_files"]["per-entity"]
    with np.load(os.path.join(ck, rel)) as z:
        matrix = np.asarray(z["matrix"])
    n_entities = matrix.shape[0] - 1
    padded = np.concatenate([matrix, np.zeros((1, matrix.shape[1]), matrix.dtype)])  # 8 rows, 4 shards

    class _Padded:
        variances_matrix = None

    model = _Padded()
    model.n_entities = n_entities
    blocks = [(k, 2 * k, padded[2 * k:2 * k + 2]) for k in range(4)]
    rels, cks = jax_checkpoint._save_random_effect_sharded(ck, rel, model, blocks)
    os.remove(os.path.join(ck, rel))
    del state["checksums"][rel]
    state["checksums"].update(cks)
    for files in (state["model_files"], state["best_files"]):
        if files.get("per-entity") == rel:
            files["per-entity"] = rels

    def write_state(files):
        with open(os.path.join(ck, "state.json"), "w") as f:
            json.dump(dict(state, model_files=dict(state["model_files"], **{"per-entity": files})), f)

    write_state(list(reversed(rels)))  # a shard file out of its place is refused
    with pytest.raises(checkpoint.CheckpointIntegrityError, match="mixed checkpoints"):
        checkpoint.CoordinateDescentCheckpoint(ck).load(TaskType.LOGISTIC_REGRESSION)
    write_state(rels)
    loaded = checkpoint.CoordinateDescentCheckpoint(ck).load(TaskType.LOGISTIC_REGRESSION)
    assert torch.equal(loaded.models["per-entity"].coefficients_matrix, torch.from_numpy(matrix))
    resumed = run_coordinate_descent(_coords(_dataset()), 2, seed=3, checkpoint_dir=ck)
    straight = run_coordinate_descent(_coords(_dataset()), 2, seed=3)
    a, b = _model_arrays(straight.model.models), _model_arrays(resumed.model.models)
    for cid in a:
        np.testing.assert_allclose(b[cid], a[cid], atol=GLMIX["coef_atol"], rtol=0)


def test_the_jax_package_resumes_a_port_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    run_coordinate_descent(_coords(_dataset()), 1, seed=3, checkpoint_dir=ck)
    resumed = jax_run(_jax_coords(), 2, seed=3, checkpoint_dir=ck)
    straight = jax_run(_jax_coords(), 2, seed=3)
    a, b = _jax_models_to_port(straight.model.models), _jax_models_to_port(resumed.model.models)
    for cid in a:
        np.testing.assert_allclose(b[cid], a[cid], atol=GLMIX["coef_atol"], rtol=0)


def test_the_estimator_checkpoints_each_configuration_and_resumes_after_a_kill(tmp_path, monkeypatch):
    """GameEstimator.fit(checkpoint_dir=) checkpoints configuration i under
    config-<i>/; a fit killed in the first configuration's second sweep
    resumes to the uninterrupted fit."""
    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator

    ds = _dataset()
    cfg_f, cfg_r = _configs(__import__("photon_ml_tpu_torch.optimize.config", fromlist=["x"]))
    configs = [{"fixed": cfg_f, "per-entity": cfg_r},
               {"fixed": dataclasses.replace(cfg_f, reg_weight=2.0), "per-entity": cfg_r}]

    def estimator(ck=None):
        return GameEstimator(TaskType.LOGISTIC_REGRESSION,
                             {"fixed": FixedEffectDataConfig("global"),
                              "per-entity": RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)},
                             coordinate_descent_iterations=2, seed=5, checkpoint_dir=ck)

    straight = estimator().fit(ds, None, configs)
    ck = str(tmp_path / "ck")
    calls = {"n": 0}
    train = FixedEffectCoordinate.train

    def dying(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated preemption")
        return train(self, *a, **k)

    monkeypatch.setattr(FixedEffectCoordinate, "train", dying)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        estimator(ck).fit(ds, None, configs)
    monkeypatch.setattr(FixedEffectCoordinate, "train", train)
    assert os.path.isfile(os.path.join(ck, "config-0", "state.json"))
    assert not os.path.exists(os.path.join(ck, "config-1"))
    resumed = estimator(ck).fit(ds, None, configs)
    assert os.path.isfile(os.path.join(ck, "config-1", "state.json"))
    for a, b in zip(straight, resumed):
        _assert_resumed(_model_arrays(a.model.models), _model_arrays(b.model.models))


def _sparse_re_fits(tmp_path):
    """The JAX and the port's estimators over one sparse random-effect
    shard with the default INDEX_MAP projector (the main path's
    configuration), two configurations of two sweeps each, as callables:
    each takes a checkpoint directory (or None) and returns the results."""
    from photon_ml_tpu.data.containers import SparseFeatures as JaxSparse
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.optimize import config as port_config

    Xf, Xe, entity, y = _arrays(0)
    idx = np.tile(np.arange(3, dtype=np.int32), (Xe.shape[0], 1))
    jcf, jcr = _configs(jax_config)
    pcf, pcr = _configs(port_config)
    jax_configs = [{"fixed": jcf, "per-entity": jcr},
                   {"fixed": dataclasses.replace(jcf, reg_weight=2.0), "per-entity": jcr}]
    port_configs = [{"fixed": pcf, "per-entity": pcr},
                    {"fixed": dataclasses.replace(pcf, reg_weight=2.0), "per-entity": pcr}]

    def jax_fit(ck=None):
        jds = jax_gd.GameDataset.build({"global": jnp.asarray(Xf), "per_entity": JaxSparse(
            jnp.asarray(idx), jnp.asarray(Xe), 3)}, y, id_tags={"entityId": entity})
        return JaxEstimator(JaxTask.LOGISTIC_REGRESSION, {
            "fixed": jax_gd.FixedEffectDataConfig("global"),
            "per-entity": jax_gd.RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)},
            coordinate_descent_iterations=2, seed=5, checkpoint_dir=ck).fit(jds, None, jax_configs)

    def port_fit(ck=None):
        ds = GameDataset.build({"global": Xf, "per_entity": SparseFeatures(
            torch.from_numpy(idx), torch.from_numpy(Xe), 3)}, y, id_tags={"entityId": entity},
            device="cpu")
        return GameEstimator(TaskType.LOGISTIC_REGRESSION, {
            "fixed": FixedEffectDataConfig("global"),
            "per-entity": RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)},
            coordinate_descent_iterations=2, seed=5, checkpoint_dir=ck).fit(ds, None, port_configs)

    return jax_fit, port_fit


def _killed_in_the_second_configuration(monkeypatch, cls, fit, ck):
    """`fit(ck)` preempted at the first fixed-effect update of the second
    configuration: the first configuration's checkpoint is complete, the
    second's has not started."""
    calls = {"n": 0}
    train = cls.train

    def dying(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated preemption")
        return train(self, *a, **k)

    monkeypatch.setattr(cls, "train", dying)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        fit(ck)
    monkeypatch.setattr(cls, "train", train)
    with open(os.path.join(ck, "config-0", "state.json")) as f:
        assert json.load(f)["completed_steps"] == 4
    assert not os.path.exists(os.path.join(ck, "config-1", "state.json"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_projected_sparse_fit_resumes_across_the_packages(tmp_path, monkeypatch, writer):
    """One package's checkpoint of an INDEX_MAP fit over a sparse random
    effect, killed in the second configuration, resumed by the other. The
    first configuration comes back from the checkpoint within
    PORT_TOLERANCES["checkpoint_resume"] of the writer's uninterrupted fit;
    the second, trained by the reader from that warm start, within
    PORT_TOLERANCES["estimator"]["coef_atol"] of it (the packages' f32
    solves round differently)."""
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate as PortFE

    jax_fit, port_fit = _sparse_re_fits(tmp_path)
    write, read = (jax_fit, port_fit) if writer == "jax" else (port_fit, jax_fit)
    straight = write()
    ck = str(tmp_path / "ck")
    _killed_in_the_second_configuration(monkeypatch, JaxFE if writer == "jax" else PortFE, write, ck)
    resumed = read(ck)
    with open(os.path.join(ck, "config-1", "state.json")) as f:
        assert json.load(f)["completed_steps"] == 4
    a0, b0 = _model_arrays(straight[0].model.models), _model_arrays(resumed[0].model.models)
    assert a0["per-entity"].shape == b0["per-entity"].shape
    _assert_resumed(a0, b0)
    a1, b1 = _model_arrays(straight[1].model.models), _model_arrays(resumed[1].model.models)
    for cid in a1:
        np.testing.assert_allclose(b1[cid], a1[cid], atol=PORT_TOLERANCES["estimator"]["coef_atol"], rtol=0)


def test_the_config_key_differs_across_packages_only_by_a_projected_sparse_shards_orientation(tmp_path):
    """Through the estimators with INDEX_MAP over a sparse random-effect
    shard: the projected shard's ELL planes are (K, N) in the JAX package
    and (N, K) in the port, which was the one field their fingerprints
    differed by. The port fingerprints such a shard in the JAX
    orientation, so both packages compute one key."""
    from photon_ml_tpu.data.containers import SparseFeatures as JaxSparse
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator

    Xf, Xe, entity, y = _arrays(0)
    idx = np.tile(np.arange(3, dtype=np.int32), (Xe.shape[0], 1))
    jds = jax_gd.GameDataset.build({"global": jnp.asarray(Xf), "per_entity": JaxSparse(
        jnp.asarray(idx), jnp.asarray(Xe), 3)}, y, id_tags={"entityId": entity})
    JaxEstimator(JaxTask.LOGISTIC_REGRESSION, {
        "fixed": jax_gd.FixedEffectDataConfig("global"),
        "per-entity": jax_gd.RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)},
        checkpoint_dir=str(tmp_path / "jax")).fit(jds, None, [dict(zip(("fixed", "per-entity"),
                                                                       _configs(jax_config)))])
    with open(tmp_path / "jax" / "config-0" / "state.json") as f:
        jax_key = json.load(f)["config_key"]
    ds = GameDataset.build({"global": Xf, "per_entity": SparseFeatures(
        torch.from_numpy(idx), torch.from_numpy(Xe), 3)}, y, id_tags={"entityId": entity}, device="cpu")
    configs = [dict(zip(("fixed", "per-entity"),
                        _configs(__import__("photon_ml_tpu_torch.optimize.config", fromlist=["x"]))))]

    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectDataConfig("global"),
        "per-entity": RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)})
    est.fit(ds, None, configs)
    coords = {cid: c for (cid, _), c in est._coordinate_cache.items()}
    weights = {c: configs[0][c].reg_weight for c in coords}

    assert "per_entity@entityId" in jds.shards and "per_entity@entityId" in ds.shards
    assert tuple(jds.shards["per_entity@entityId"].indices.shape)[::-1] == \
        tuple(ds.shards["per_entity@entityId"].indices.shape)
    assert ds.shards["per_entity@entityId"].projected and not ds.shards["per_entity"].projected
    assert run_config_key(coords, set(), weights) == jax_key
