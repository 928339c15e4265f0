"""The port's batched trial executor (`hyperparameter/sweep.py`) on the CPU.

Every case of tests/test_sweep.py on the port, on the same fixture (96
training and 64 validation rows, a 4-wide fixed effect, a 3-wide random
effect over 6 entities, `min_bucket` 4): stacked and shard-group trials are
bit-equal to the serial per-trial loop, cold, warm and with warm start
off, variances included; the stack plan splits rounds; the finalized
winner is bit-equal to a standalone fit; the mode knob, the candidate
check, `reset`, the trial journal events and the zeros fallback of an
all-rejected trial; `tuner.sweep` drives the executor.

Then the port against the JAX package on the same numpy data and points:
trial values within PORT_TOLERANCES["glmix"]["auc_atol"], winner
coefficients within its "coef_atol", RANDOM sweeps proposing the same
points, and warm starts from a model carried over by `convert.py`. And the
refusals: a group of more than one device (ROADMAP item 9), forced
stacking over an entity-sharded store, the trial hooks of a sharded random
effect.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.estimators.game_estimator import GameEstimator as JaxGameEstimator
from photon_ml_tpu.hyperparameter import HyperparameterConfig as JaxHyperparameterConfig
from photon_ml_tpu.hyperparameter import HyperparameterTuningMode as JaxTuningMode
from photon_ml_tpu.hyperparameter import get_tuner as jax_get_tuner
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import contracts as jax_contracts
from photon_ml_tpu.utils import knobs as jax_knobs
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch import contracts
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.convert import FixedEffectArrays, RandomEffectArrays, game_model_from_numpy
from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
    build_random_effect_dataset,
    entity_layout,
    factorize_tag,
)
from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel
from photon_ml_tpu_torch.hyperparameter import (
    HyperparameterConfig,
    HyperparameterTuningMode,
    SweepExecutor,
    TrialRecord,
    get_tuner,
)
from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.parallel import mesh as pmesh
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType
from photon_ml_tpu_torch.utils import faults, knobs, telemetry

TOL = PORT_TOLERANCES["glmix"]
CPU = torch.device("cpu")
MODES = ("stacked", "shard_group")


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    """The port's fault plan and counters are its own process globals."""
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _arrays(n, n_entities, d_fixed=4, d_re=3, seed=0):
    r = np.random.default_rng(seed)
    entity = r.integers(0, n_entities, size=n)
    Xf = r.normal(size=(n, d_fixed)).astype(np.float32)
    Xe = r.normal(size=(n, d_re)).astype(np.float32)
    w = r.normal(size=d_fixed).astype(np.float32)
    u = r.normal(size=(n_entities, d_re)).astype(np.float32)
    margin = Xf @ w + np.einsum("nd,nd->n", Xe, u[entity])
    y = (r.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return Xf, Xe, entity, y


def _port_data(n, n_entities, seed):
    Xf, Xe, entity, y = _arrays(n, n_entities, seed=seed)
    return GameDataset.build({"global": Xf, "per_entity": Xe}, y, id_tags={"entityId": entity},
                             device="cpu")


def _jax_data(n, n_entities, seed):
    Xf, Xe, entity, y = _arrays(n, n_entities, seed=seed)
    return jax_gd.GameDataset.build({"global": jnp.asarray(Xf), "per_entity": jnp.asarray(Xe)}, y,
                                    id_tags={"entityId": entity})


def _opt_config(pkg, variance=None, max_iter=8):
    kw = {} if variance is None else {"variance_computation": variance}
    return pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=max_iter, tolerance=1e-7),
        regularization=pkg.L2, reg_weight=1.0, **kw)


def _data_configs(pkg):
    return {"fixed": pkg.FixedEffectDataConfig("global"),
            "re": pkg.RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)}


@pytest.fixture(scope="module")
def sweep_problem():
    return _port_data(96, 6, 1), _port_data(64, 6, 2)


def _executor(problem, mode, *, variance=None, warm_start=True, max_stack=None, shard_groups=None,
              iterations=1, seed=4):
    train, val = problem
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION, _data_configs(_PortPkg),
                        coordinate_descent_iterations=iterations, seed=seed)
    base = {"fixed": _opt_config(_PortPkg, variance), "re": _opt_config(_PortPkg, variance)}
    return est, est.sweep_executor(train, val, base, mode=mode, warm_start=warm_start,
                                   max_stack=max_stack, shard_groups=shard_groups)


class _PortPkg:
    CoordinateOptimizationConfig = CoordinateOptimizationConfig
    OptimizerConfig = OptimizerConfig
    L2 = L2
    FixedEffectDataConfig = FixedEffectDataConfig
    RandomEffectDataConfig = RandomEffectDataConfig


class _JaxPkg:
    CoordinateOptimizationConfig = jax_config.CoordinateOptimizationConfig
    OptimizerConfig = jax_config.OptimizerConfig
    L2 = jax_config.L2
    FixedEffectDataConfig = jax_gd.FixedEffectDataConfig
    RandomEffectDataConfig = jax_gd.RandomEffectDataConfig


def _assert_models_equal(a, b, what=""):
    assert len(a) == len(b)
    for i, (x, z) in enumerate(zip(a, b)):
        assert x.keys() == z.keys()
        for cid in x:
            assert x[cid].keys() == z[cid].keys()
            for name in x[cid]:
                u, v = x[cid][name], z[cid][name]
                assert (u is None) == (v is None), f"{what} trial {i} {cid}/{name}"
                if u is not None:
                    assert torch.equal(u, v), f"{what} trial {i} {cid}/{name} not bitwise"


_POINTS = np.array([[0.1, 0.5], [10.0, 0.02]])
_POINTS2 = np.array([[0.7, 1.5], [3.0, 0.2]])


def _groups_kw(mode):
    return {"shard_groups": 2} if mode == "shard_group" else {}


class TestStackedParity:
    @pytest.mark.parametrize("mode", MODES)
    def test_matches_serial_bitwise_cold_and_warm(self, sweep_problem, mode):
        _, ex_serial = _executor(sweep_problem, "serial")
        _, ex_other = _executor(sweep_problem, mode, **_groups_kw(mode))
        assert ex_serial.evaluate_batch(_POINTS) == ex_other.evaluate_batch(_POINTS)
        _assert_models_equal(ex_serial.last_trial_models, ex_other.last_trial_models, "cold")
        # The warm-started round: the incumbent seeds every trial.
        assert ex_serial.evaluate_batch(_POINTS2) == ex_other.evaluate_batch(_POINTS2)
        _assert_models_equal(ex_serial.last_trial_models, ex_other.last_trial_models, "warm")
        assert [t.mode for t in ex_other.trials] == [mode] * 4
        assert [t.diverged_steps for t in ex_other.trials] == [0] * 4

    def test_warm_start_disabled_parity(self, sweep_problem):
        """Every round cold: round 2 is independent of round 1 in both modes."""
        _, ex_serial = _executor(sweep_problem, "serial", warm_start=False)
        _, ex_stacked = _executor(sweep_problem, "stacked", warm_start=False)
        ex_serial.evaluate_batch(_POINTS)
        ex_stacked.evaluate_batch(_POINTS)
        assert ex_serial.evaluate_batch(_POINTS2) == ex_stacked.evaluate_batch(_POINTS2)
        _assert_models_equal(ex_serial.last_trial_models, ex_stacked.last_trial_models,
                             "warm start off")
        _, ex_fresh = _executor(sweep_problem, "serial", warm_start=False)
        ex_fresh.evaluate_batch(_POINTS2)
        _assert_models_equal(ex_fresh.last_trial_models, ex_stacked.last_trial_models,
                             "round independence")

    def test_variance_parity(self, sweep_problem):
        """FE variances come out of the same `compute_variances` call in both
        modes (no replay), RE variances out of the same bucket loop."""
        simple = VarianceComputationType.SIMPLE
        _, ex_serial = _executor(sweep_problem, "serial", variance=simple)
        _, ex_stacked = _executor(sweep_problem, "stacked", variance=simple)
        assert ex_serial.evaluate_batch(_POINTS) == ex_stacked.evaluate_batch(_POINTS)
        assert ex_serial.evaluate_batch(_POINTS2) == ex_stacked.evaluate_batch(_POINTS2)
        _assert_models_equal(ex_serial.last_trial_models, ex_stacked.last_trial_models, "variance")
        for trial in ex_stacked.last_trial_models:
            assert trial["fixed"]["var"] is not None and trial["re"]["v"] is not None

    def test_stack_plan_splits_rounds(self, sweep_problem):
        pts = np.array([[0.1, 0.5], [10.0, 0.02], [1.0, 1.0]])
        _, ex_serial = _executor(sweep_problem, "serial")
        _, ex_stacked = _executor(sweep_problem, "stacked", max_stack=2)
        assert ex_serial.evaluate_batch(pts) == ex_stacked.evaluate_batch(pts)
        _assert_models_equal(ex_serial.last_trial_models, ex_stacked.last_trial_models, "split")
        (dec,) = ex_stacked.stack_decisions
        assert dec == {"k": 3, "max_stack": 2, "chunks": [2, 1]}

    def test_stack_plan_reads_the_knob(self, sweep_problem, monkeypatch):
        monkeypatch.setenv("PHOTON_SWEEP_MAX_STACK", "1")
        _, ex = _executor(sweep_problem, "stacked")
        assert ex._stack_plan(3) == [1, 1, 1]

    def test_a_weight_float32_cannot_hold_is_bitwise(self, sweep_problem):
        """0.1 enters the objective as the same Python float in both modes."""
        pts = np.array([[0.1, 0.1]])
        _, ex_serial = _executor(sweep_problem, "serial", iterations=2)
        _, ex_stacked = _executor(sweep_problem, "stacked", iterations=2)
        assert ex_serial.evaluate_batch(pts) == ex_stacked.evaluate_batch(pts)
        _assert_models_equal(ex_serial.last_trial_models, ex_stacked.last_trial_models, "0.1")


class TestShardGroups:
    @pytest.mark.parametrize("groups", [None, 1, 2, 3])
    def test_single_device_groups_bitwise(self, sweep_problem, groups):
        """On the CPU every group is one CPU device; group 0 reuses the main
        coordinates and the others run on the builder's copies."""
        _, ex_serial = _executor(sweep_problem, "serial")
        _, ex_group = _executor(sweep_problem, "shard_group", shard_groups=groups)
        assert ex_serial.evaluate_batch(_POINTS) == ex_group.evaluate_batch(_POINTS)
        _assert_models_equal(ex_serial.last_trial_models, ex_group.last_trial_models, "group cold")
        assert ex_serial.evaluate_batch(_POINTS2) == ex_group.evaluate_batch(_POINTS2)
        _assert_models_equal(ex_serial.last_trial_models, ex_group.last_trial_models, "group warm")
        contexts = ex_group._groups()
        assert len(contexts) == max(1, groups or 1)
        assert contexts[0]["coordinates"] is ex_group.coordinates
        for ctx in contexts[1:]:
            assert ctx["coordinates"] is not ex_group.coordinates

    def test_multi_device_group_raises_naming_item_9(self, sweep_problem):
        train, _ = sweep_problem
        est, _ = _executor(sweep_problem, "shard_group")
        build = est._sweep_group_builder(train, {"fixed": _opt_config(_PortPkg),
                                                 "re": _opt_config(_PortPkg)})
        with pytest.raises(NotImplementedError, match="item 9"):
            build([CPU, CPU])

    def test_group_copy_names_its_device(self, sweep_problem):
        train, _ = sweep_problem
        est, _ = _executor(sweep_problem, "shard_group")
        coords = est._sweep_group_builder(train, {"fixed": _opt_config(_PortPkg),
                                                  "re": _opt_config(_PortPkg)})([CPU])
        assert coords["fixed"].dataset is not train
        assert coords["re"].re_dataset.buckets[0].gather.device == CPU
        assert coords["fixed"].dataset.device == CPU

    def test_groups_need_a_builder(self, sweep_problem):
        _, ex = _executor(sweep_problem, "shard_group")
        ex.group_builder = None
        with pytest.raises(ValueError, match="group_builder"):
            ex.evaluate_batch(_POINTS)


class TestExecutorSurface:
    def test_finalize_winner_bitwise_vs_standalone(self, sweep_problem):
        train, val = sweep_problem
        est, ex = _executor(sweep_problem, "stacked")
        ex.evaluate_batch(_POINTS)
        ex.evaluate_batch(_POINTS2)
        res = ex.finalize()
        assert res.best_trial in range(4) and np.isfinite(res.winner_value)
        assert res.winner_refit_s >= 0 and len(res.trials) == 4
        base = {"fixed": _opt_config(_PortPkg), "re": _opt_config(_PortPkg)}
        win = {cid: dataclasses.replace(base[cid], reg_weight=float(w))
               for cid, w in zip(("fixed", "re"), res.best_point)}
        standalone = est.fit(train, val, [win])[0]
        assert torch.equal(res.winner_model["fixed"].coefficients.means,
                           standalone.model["fixed"].coefficients.means)
        assert torch.equal(res.winner_model["re"].coefficients_matrix,
                           standalone.model["re"].coefficients_matrix)

    def test_finalize_needs_a_trial(self, sweep_problem):
        _, ex = _executor(sweep_problem, "serial")
        with pytest.raises(ValueError, match="at least one"):
            ex.finalize()

    def test_mode_knob_forcing(self, sweep_problem, monkeypatch):
        _, ex = _executor(sweep_problem, None)
        assert ex._choose_mode(2) == "stacked"  # auto on a one-process store
        monkeypatch.setenv("PHOTON_SWEEP_TRIAL_STACK", "0")
        assert ex._choose_mode(2) == "serial"  # one CPU: no shard groups
        monkeypatch.setenv("PHOTON_SWEEP_TRIAL_STACK", "1")
        assert ex._choose_mode(2) == "stacked"
        monkeypatch.setenv("PHOTON_SWEEP_TRIAL_STACK", "maybe")  # malformed: auto
        assert ex._choose_mode(2) == "stacked"
        ex.evaluate_batch(_POINTS[:1])
        assert ex.trials[0].mode == "stacked"

    def test_candidate_matrix_shape_validation(self, sweep_problem):
        _, ex = _executor(sweep_problem, "serial")
        with pytest.raises(ValueError, match="columns"):
            ex.evaluate_batch(np.ones((2, 3)))
        with pytest.raises(ValueError, match="unknown sweep mode"):
            _executor(sweep_problem, "bogus")

    def test_reset_keeps_coordinates_and_groups(self, sweep_problem):
        _, ex = _executor(sweep_problem, "shard_group", shard_groups=2)
        ex.evaluate_batch(_POINTS)
        contexts, coords = ex._group_contexts, ex.coordinates
        assert contexts is not None and ex._best is not None
        ex.reset()
        assert ex.trials == [] and ex.rounds == 0 and ex._best is None
        assert ex.stack_decisions == [] and ex.last_trial_models == []
        assert ex._group_contexts is contexts and ex.coordinates is coords
        ex.evaluate_batch(_POINTS)
        assert [t.trial for t in ex.trials] == [0, 1] and ex.rounds == 1

    @pytest.mark.parametrize("mode", ("serial", "stacked"))
    def test_trial_journal_events(self, sweep_problem, tmp_path, mode):
        path = str(tmp_path / "journal.jsonl")
        journal = telemetry.RunJournal(path)
        telemetry.install_journal(journal)
        seen = []
        try:
            _, ex = _executor(sweep_problem, mode)
            ex.on_event = lambda etype, **f: seen.append(etype)
            ex.evaluate_batch(_POINTS)
        finally:
            telemetry.uninstall_journal()
            journal.close()
        assert telemetry.validate_journal(path)[1] == []
        assert jax_telemetry.validate_journal(path)[1] == []
        lines = [json.loads(line) for line in open(path) if line.strip()]
        starts = [line for line in lines if line["type"] == "trial_start"]
        finishes = [line for line in lines if line["type"] == "trial_finish"]
        assert len(starts) == 2 and len(finishes) == 2
        assert {f["trial"] for f in finishes} == {0, 1}
        assert all(f["mode"] == mode and np.isfinite(f["value"]) for f in finishes)
        assert seen == ["trial_start", "trial_start", "trial_finish", "trial_finish"]

    def test_a_failing_observer_does_not_kill_trials(self, sweep_problem):
        _, ex = _executor(sweep_problem, "serial")

        def boom(etype, **fields):
            raise RuntimeError("observer")

        ex.on_event = boom
        assert len(ex.evaluate_batch(_POINTS)) == 2

    def test_nan_weight_gives_the_zeros_model_in_every_mode(self, sweep_problem):
        """A NaN reg weight: whether the solve is rejected or resolves to an
        accepted zeros step, the model and the count are mode-invariant."""
        bad = np.array([[np.nan, 1.0]])
        runs = {}
        for mode in ("serial", *MODES):
            _, ex = _executor(sweep_problem, mode, **_groups_kw(mode))
            runs[mode] = (ex.evaluate_batch(bad), ex)
        for mode in MODES:
            assert runs[mode][0] == runs["serial"][0]
            _assert_models_equal(runs["serial"][1].last_trial_models, runs[mode][1].last_trial_models,
                                 f"NaN weight, {mode}")
            assert runs[mode][1].trials[0].diverged_steps == runs["serial"][1].trials[0].diverged_steps
        assert torch.equal(runs["serial"][1].last_trial_models[0]["fixed"]["w"], torch.zeros(4))
        zeros = runs["serial"][1]._trial_arrays("fixed", GameModel({}))
        assert torch.equal(zeros["w"], torch.zeros(4)) and zeros["var"] is None

    @pytest.mark.parametrize("retries", ["0", "1", "2"])
    def test_all_rejected_trial_falls_back_to_zeros_in_every_mode(self, sweep_problem, monkeypatch,
                                                                  retries):
        """Every FE solve non-finite: each mode retries, keeps no FE model
        and reports the zeros model, and each rejected update costs
        1 + PHOTON_SOLVE_RETRIES in every mode."""
        monkeypatch.setenv("PHOTON_SOLVE_RETRIES", retries)
        train = FixedEffectCoordinate.train

        def poisoned(self, *a, **kw):
            model, res = train(self, *a, **kw)
            c = model.coefficients
            return FixedEffectModel(Coefficients(c.means * float("nan"), c.variances),
                                    self.task), res

        monkeypatch.setattr(FixedEffectCoordinate, "train", poisoned)
        runs = {}
        for mode in ("serial", *MODES):
            _, ex = _executor(sweep_problem, mode, iterations=2, **_groups_kw(mode))
            runs[mode] = (ex.evaluate_batch(_POINTS), ex)
        expected = 2 * (1 + int(retries))  # two rejected FE updates a trial
        for mode, (values, ex) in runs.items():
            assert values == runs["serial"][0]
            assert [t.diverged_steps for t in ex.trials] == [expected] * 2, mode
            _assert_models_equal(runs["serial"][1].last_trial_models, ex.last_trial_models, mode)
            for trial in ex.last_trial_models:
                assert torch.equal(trial["fixed"]["w"], torch.zeros(4))
                assert bool(torch.isfinite(trial["re"]["m"]).all())

    def test_tuner_sweep_drives_executor(self, sweep_problem):
        dims = [HyperparameterConfig("fixed", 1e-2, 1e2, transform="LOG"),
                HyperparameterConfig("re", 1e-2, 1e2, transform="LOG")]
        _, ex = _executor(sweep_problem, "stacked")
        tuner = get_tuner(HyperparameterTuningMode.BAYESIAN)
        search_result, sweep_result = tuner.sweep(4, dims, HyperparameterTuningMode.BAYESIAN, ex,
                                                  seed=3, batch_size=2)
        assert len(search_result.observations) == 4 and len(sweep_result.trials) == 4
        assert ex.rounds == 2 and sweep_result.winner_model is not None
        assert tuner.sweep(4, dims, HyperparameterTuningMode.NONE, ex) is None
        assert tuner.sweep(0, dims, HyperparameterTuningMode.RANDOM, ex) is None

    def test_timing_entry_has_the_trial_keys(self):
        rec = TrialRecord(trial=0, round=0, mode="serial", seconds=0.123456, value=0.5,
                          diverged_steps=0, point=np.zeros(2))
        assert tuple(rec.timing_entry()) == contracts.SWEEP_TRIAL_KEYS
        assert rec.timing_entry()["seconds"] == 0.1235


class TestRefusals:
    def test_sweep_executor_refusals(self, sweep_problem):
        train, val = sweep_problem
        base = {"fixed": _opt_config(_PortPkg), "re": _opt_config(_PortPkg)}
        est = GameEstimator(TaskType.LOGISTIC_REGRESSION, _data_configs(_PortPkg))
        with pytest.raises(ValueError, match="validation data"):
            est.sweep_executor(train, None, base)
        with pytest.raises(ValueError, match="missing coordinates"):
            est.sweep_executor(train, val, {"fixed": base["fixed"]})
        locked = GameEstimator(TaskType.LOGISTIC_REGRESSION, _data_configs(_PortPkg),
                               locked_coordinates={"re"})
        with pytest.raises(ValueError, match="locked"):
            locked.sweep_executor(train, val, base)
        with pytest.raises(ValueError, match="unknown coordinates"):
            est.sweep_executor(train, val, base, tuned_ids=["nope"])

    @pytest.fixture()
    def sharded_re(self):
        """Rank 1 of 2 of a random effect, set up in this process (building
        and training it runs no collective)."""
        Xf, Xe, entity, y = _arrays(96, 6, seed=1)
        cfg = RandomEffectDataConfig("entityId", "per_entity", min_bucket=4)
        layout = entity_layout(factorize_tag(entity), cfg, CPU)
        owner = pmesh.entity_owners(layout, 2)
        rows = np.nonzero(owner[layout.codes] == 1)[0]
        ds = GameDataset.build({"per_entity": Xe[rows]}, y[rows],
                               id_tags={"entityId": entity[rows]}, device="cpu")
        ds.sharding = pmesh.RowSharding(pmesh.RankMesh(1, 2, "gloo", CPU), torch.from_numpy(rows),
                                        len(y), cfg, layout, owner)
        red = build_random_effect_dataset(ds, cfg)
        return RandomEffectCoordinate(ds, red, _opt_config(_PortPkg), TaskType.LOGISTIC_REGRESSION)

    def test_a_sharded_random_effect_says_so(self, sharded_re, sweep_problem):
        assert sharded_re.entity_sharded
        ex = _executor(sweep_problem, "serial")[1]
        assert not ex.coordinates["re"].entity_sharded and ex._stackable()

    def test_forced_stacking_over_a_sharded_store_raises(self, sharded_re, monkeypatch):
        ex = SweepExecutor({"re": sharded_re}, ["re"], 1, task=TaskType.LOGISTIC_REGRESSION,
                           base_reg_weights={"re": 1.0}, validation_suite=None,
                           validation_offsets=None, num_validation_samples=0, trial_scorers={})
        assert ex._choose_mode(2) == "serial"  # auto: not stackable, one device
        monkeypatch.setenv("PHOTON_SWEEP_TRIAL_STACK", "1")
        with pytest.raises(ValueError, match="entity-sharded"):
            ex._choose_mode(2)
        with pytest.raises(ValueError, match="entity-sharded"):
            ex.evaluate_batch(np.ones((1, 1)))


# ------------------------------------------------------- against the JAX package


def _jax_executor(problem, mode="serial", seed=4):
    train, val = problem
    est = JaxGameEstimator(JaxTaskType.LOGISTIC_REGRESSION, _data_configs(_JaxPkg), seed=seed)
    base = {"fixed": _opt_config(_JaxPkg), "re": _opt_config(_JaxPkg)}
    return est.sweep_executor(train, val, base, mode=mode)


@pytest.fixture(scope="module")
def jax_problem():
    return _jax_data(96, 6, 1), _jax_data(64, 6, 2)


def _close_models(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a["fixed"]["w"].numpy(), np.asarray(b["fixed"]["w"]),
                                   atol=TOL["coef_atol"], rtol=0)
        np.testing.assert_allclose(a["re"]["m"].numpy(), np.asarray(b["re"]["m"]),
                                   atol=TOL["coef_atol"], rtol=0)


@pytest.mark.parametrize("mode", ("serial", "stacked"))
def test_trials_and_winner_agree_with_the_jax_executor(sweep_problem, jax_problem, mode):
    ref = _jax_executor(jax_problem)
    _, ours = _executor(sweep_problem, mode)
    for pts in (_POINTS, _POINTS2):  # cold, then warm from each package's incumbent
        np.testing.assert_allclose(ours.evaluate_batch(pts), ref.evaluate_batch(pts),
                                   atol=TOL["auc_atol"], rtol=0)
        _close_models(ours.last_trial_models, ref.last_trial_models)
    a, b = ours.finalize(), ref.finalize()
    assert a.best_trial == b.best_trial
    np.testing.assert_array_equal(a.best_point, b.best_point)
    assert abs(a.winner_value - b.winner_value) <= TOL["auc_atol"]
    np.testing.assert_allclose(a.winner_model["fixed"].coefficients.means.numpy(),
                               np.asarray(b.winner_model["fixed"].coefficients.means),
                               atol=TOL["coef_atol"], rtol=0)
    np.testing.assert_allclose(a.winner_model["re"].coefficients_matrix.numpy(),
                               np.asarray(b.winner_model["re"].coefficients_matrix),
                               atol=TOL["coef_atol"], rtol=0)


def test_random_sweeps_propose_the_same_points(sweep_problem, jax_problem):
    _, ours = _executor(sweep_problem, "stacked")
    ref = _jax_executor(jax_problem)
    dims = [HyperparameterConfig("fixed", 1e-2, 1e2, transform="LOG"),
            HyperparameterConfig("re", 1e-2, 1e2, transform="LOG")]
    jdims = [JaxHyperparameterConfig("fixed", 1e-2, 1e2, transform="LOG"),
             JaxHyperparameterConfig("re", 1e-2, 1e2, transform="LOG")]
    _, a = get_tuner(HyperparameterTuningMode.RANDOM).sweep(
        4, dims, HyperparameterTuningMode.RANDOM, ours, seed=5, batch_size=2)
    _, b = jax_get_tuner(JaxTuningMode.RANDOM).sweep(4, jdims, JaxTuningMode.RANDOM, ref, seed=5,
                                                     batch_size=2)
    np.testing.assert_array_equal(np.stack([t.point for t in a.trials]),
                                  np.stack([t.point for t in b.trials]))
    np.testing.assert_allclose([t.value for t in a.trials], [t.value for t in b.trials],
                               atol=TOL["auc_atol"], rtol=0)
    assert [t.round for t in a.trials] == [t.round for t in b.trials] == [0, 0, 1, 1]


def test_warm_start_from_a_converted_model(sweep_problem, jax_problem):
    """A model trained by the JAX package, carried over by convert.py, seeds
    the port's stacked and serial rounds as it seeds the JAX executor's."""
    ref = _jax_executor(jax_problem)
    ref.evaluate_batch(_POINTS[:1])
    jax_model = ref.finalize().winner_model
    w = np.asarray(jax_model["fixed"].coefficients.means)
    m = np.asarray(jax_model["re"].coefficients_matrix)
    _, probe = _executor(sweep_problem, "serial")
    model, _ = game_model_from_numpy({
        "fixed": FixedEffectArrays("global", w),
        "re": RandomEffectArrays("per_entity", "entityId", m,
                                 probe.coordinates["re"].re_dataset.entity_index),
    }, TaskType.LOGISTIC_REGRESSION, device="cpu")
    warm = {"fixed": {"w": model["fixed"].coefficients.means, "var": None},
            "re": {"m": model["re"].coefficients_matrix, "v": None}}
    runs = {}
    for mode in ("serial", "stacked"):
        _, ex = _executor(sweep_problem, mode)
        ex._best = {"value": 0.0, "trial": 0, "point": _POINTS[0], "arrays": warm}
        runs[mode] = (ex.evaluate_batch(_POINTS2), ex.last_trial_models)
    assert runs["serial"][0] == runs["stacked"][0]
    _assert_models_equal(runs["serial"][1], runs["stacked"][1], "converted warm start")
    # The JAX executor warm-starts from its incumbent: the same model.
    np.testing.assert_allclose(runs["stacked"][0], ref.evaluate_batch(_POINTS2),
                               atol=TOL["auc_atol"], rtol=0)
    _close_models(runs["stacked"][1], ref.last_trial_models)


# --------------------------------------------------------------- the contracts


def test_sweep_contracts_are_the_references():
    assert contracts.SWEEP_SECTION_KEYS == jax_contracts.SWEEP_SECTION_KEYS
    assert contracts.SWEEP_TRIAL_KEYS == jax_contracts.SWEEP_TRIAL_KEYS
    for etype in ("trial_start", "trial_finish"):
        assert contracts.JOURNAL_EVENT_SCHEMAS[etype] == jax_contracts.JOURNAL_EVENT_SCHEMAS[etype]


@pytest.mark.parametrize("name", ["PHOTON_SOLVE_RETRIES", "PHOTON_SWEEP_TRIAL_STACK",
                                  "PHOTON_SWEEP_MAX_STACK", "PHOTON_SWEEP_SHARD_GROUPS"])
def test_sweep_knobs_are_the_references(name, monkeypatch):
    ours, theirs = knobs.KNOBS[name], jax_knobs.KNOBS[name]
    assert (ours.type, ours.default, ours.choices) == (theirs.type, theirs.default, theirs.choices)
    for raw in ("", " 1 ", "ON", "off", "3", "bogus", "-2"):
        assert knobs.get_knob(name, raw) == jax_knobs.get_knob(name, raw), raw
    assert "PHOTON_SWEEP_SCAN" not in knobs.KNOBS


def test_launch_counts_stay_exact_across_threads():
    """Shard-group workers launch at once: no count may be lost."""
    table = {"k": 0}

    def bump():
        for _ in range(2000):
            cuda_build.count_launch(table, "k")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert table["k"] == 32000
