"""The `solve` fault site and the divergence guard's bounded retry in the
port's coordinate descent, against the JAX loop on the same numpy data.

  * `solve:1`, armed through the port's `faults`, costs one
    `diverged_steps` and the retry re-solves to a model bit-equal to the
    clean fit's (a down-sampled fixed effect draws the same sample again);
    the JAX loop counts the same.
  * A deterministic NaN (one non-finite random-effect feature) costs
    1 + PHOTON_SOLVE_RETRIES, in the port as in the JAX loop, and the
    coordinate keeps its last good model.
  * Every update runs under a `coordinate_update` span with `accepted` set,
    and records `coordinate_update_s`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.game import coordinate as jax_coordinate
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import faults as jax_faults
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

TASK, JTASK = TaskType.LOGISTIC_REGRESSION, JaxTaskType.LOGISTIC_REGRESSION


@pytest.fixture(autouse=True)
def _fault_hygiene():
    faults.clear()
    jax_faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    jax_faults.clear()
    telemetry.METRICS.reset()


def _arrays(seed=0, n=400, d_fixed=6, d_re=3, n_entities=12, nan=False):
    rng = np.random.default_rng(seed)
    Xf = rng.normal(size=(n, d_fixed)).astype(np.float32)
    Xe = rng.normal(size=(n, d_re)).astype(np.float32)
    entity = rng.integers(0, n_entities, size=n)
    margin = Xf @ rng.normal(size=d_fixed).astype(np.float32) * 0.3
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    if nan:
        Xe[7, 1] = np.nan  # every random-effect solve over this row is non-finite
    return Xf, Xe, entity, y


def _opt(pkg, **kw):
    return pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=20, tolerance=1e-7),
        regularization=pkg.L2, reg_weight=1.0, **kw)


def _port_coords(arrays, fe_kw=None):
    Xf, Xe, entity, y = arrays
    ds = gd.GameDataset.build({"global": Xf, "per_entity": Xe}, y, id_tags={"entityId": entity},
                              device="cpu")
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("entityId", "per_entity",
                                                                       min_bucket=4))
    return {"fixed": FixedEffectCoordinate(ds, "global", _opt(config, **(fe_kw or {})), TASK),
            "per-entity": RandomEffectCoordinate(ds, red, _opt(config), TASK)}


def _jax_coords(arrays):
    Xf, Xe, entity, y = arrays
    ds = jax_gd.GameDataset.build({"global": jnp.asarray(Xf), "per_entity": jnp.asarray(Xe)}, y,
                                  id_tags={"entityId": entity})
    red = jax_gd.build_random_effect_dataset(
        ds, jax_gd.RandomEffectDataConfig("entityId", "per_entity", min_bucket=4))
    return {"fixed": jax_coordinate.FixedEffectCoordinate(ds, "global", _opt(jax_config), JTASK),
            "per-entity": jax_coordinate.RandomEffectCoordinate(ds, red, _opt(jax_config), JTASK)}


def _models(result):
    return {"fixed": result.model["fixed"].coefficients.means,
            "per-entity": result.model["per-entity"].coefficients_matrix}


@pytest.mark.parametrize("spec", ["solve:1", "solve@2", "solve@2+5"])
@pytest.mark.parametrize("fe_kw", [{}, {"down_sampling_rate": 0.5}], ids=["full", "down_sampled"])
def test_an_injected_solve_fault_is_retried_to_the_clean_model(spec, fe_kw):
    """Each listed invocation fails one attempt; the retry's solve is the
    clean one's (a down-sampled draw is seeded by (seed, step) again)."""
    arrays = _arrays(1)
    clean = run_coordinate_descent(_port_coords(arrays, fe_kw), 2, seed=3)
    with faults.inject(spec) as inj:
        faulted = run_coordinate_descent(_port_coords(arrays, fe_kw), 2, seed=3)
    fired = inj.injected.get("solve", 0)
    assert fired == len(spec.split("@")[-1].split("+")) if "@" in spec else fired == 1
    assert clean.diverged_steps == 0 and faulted.diverged_steps == fired
    assert inj.invocations["solve"] == 4 + fired  # 2 iterations x 2 coordinates, plus retries
    for cid, a in _models(clean).items():
        assert torch.equal(a, _models(faulted)[cid]), cid


@pytest.mark.parametrize("spec", ["solve:1", "solve@3+4"])
def test_the_jax_loop_counts_an_injected_fault_the_same(spec):
    arrays = _arrays(1)
    with faults.inject(spec):
        ours = run_coordinate_descent(_port_coords(arrays), 2)
    with jax_faults.inject(spec):
        theirs = jax_run_cd(_jax_coords(arrays), 2)
    assert ours.diverged_steps == theirs.diverged_steps > 0


def test_retries_exhausted_by_injection_keep_the_last_good_model(monkeypatch):
    """With no retry granted, an injected fault rejects the update itself:
    the coordinate keeps its model from the update before."""
    monkeypatch.setenv("PHOTON_SOLVE_RETRIES", "0")
    arrays = _arrays(2)
    one = run_coordinate_descent(_port_coords(arrays), 1)
    with faults.inject("solve@3+4"):  # both updates of the second iteration
        two = run_coordinate_descent(_port_coords(arrays), 2)
    assert two.diverged_steps == 2
    for cid, a in _models(one).items():
        assert torch.equal(a, _models(two)[cid]), cid


@pytest.mark.parametrize("retries", ["0", "1", "2"])
def test_a_deterministic_nan_costs_one_plus_the_retries(retries, monkeypatch):
    monkeypatch.setenv("PHOTON_SOLVE_RETRIES", retries)
    arrays = _arrays(3, nan=True)
    ours = run_coordinate_descent(_port_coords(arrays), 1)
    theirs = jax_run_cd(_jax_coords(arrays), 1)
    assert ours.diverged_steps == theirs.diverged_steps == 1 + int(retries)
    assert sorted(ours.model.coordinate_ids) == ["fixed"]  # the random effect was rejected
    assert faults.solve_retry_attempts() == int(retries)


def test_the_retry_knob_reads_like_the_reference(monkeypatch):
    from photon_ml_tpu.utils import faults as ref

    for raw in ("", "3", "-1", "x"):
        monkeypatch.setenv("PHOTON_SOLVE_RETRIES", raw)
        assert faults.solve_retry_attempts() == ref.solve_retry_attempts(), raw


def test_every_update_is_a_span_and_a_metric():
    tracer = telemetry.install_tracer(telemetry.Tracer())
    try:
        with faults.inject("solve:1"):
            run_coordinate_descent(_port_coords(_arrays(4)), 2)
    finally:
        telemetry.uninstall_tracer()
    spans = [s for s in tracer.spans() if s["name"] == "coordinate_update"]
    assert [(s["args"]["coordinate"], s["args"]["iteration"]) for s in spans] == [
        ("fixed", 0), ("per-entity", 0), ("fixed", 1), ("per-entity", 1)]
    assert all(s["args"]["accepted"] is True for s in spans)
    hist = telemetry.METRICS.snapshot()["histograms"]["coordinate_update_s"]
    assert hist["count"] == 4 and hist["min"] >= 0.0
    assert faults.COUNTERS.get("injected_faults") == 1


def test_a_rejected_update_span_says_so():
    tracer = telemetry.install_tracer(telemetry.Tracer())
    try:
        run_coordinate_descent(_port_coords(_arrays(3, nan=True)), 1)
    finally:
        telemetry.uninstall_tracer()
    spans = {s["args"]["coordinate"]: s["args"]["accepted"]
             for s in tracer.spans() if s["name"] == "coordinate_update"}
    assert spans == {"fixed": True, "per-entity": False}
