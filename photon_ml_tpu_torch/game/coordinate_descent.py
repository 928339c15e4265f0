"""Cyclic block coordinate descent over named GAME coordinates.

Port of the single-process loop of `photon_ml_tpu/game/coordinate_descent.py`.
Every coordinate scores the same fixed sample axis, so the residual for
coordinate c is (summed scores - c's previous scores), three elementwise ops:

  * update order is the insertion order of `coordinates`;
  * warm start from `initial_models`; locked coordinates only contribute
    scores;
  * divergence guard: an update whose model or scores hold a non-finite
    value is rejected and the coordinate keeps its last good model (the
    port has no fault injection, so a rejected solve is not retried). On
    ranks (parallel/mesh.py) the verdict is a cross-rank AND, so one rank's
    NaN rejects the update on every rank and the ranks cannot diverge;
  * optional validation after each update, with best-model selection on
    full passes by the primary evaluator;
  * `reg_weights` overrides coordinates' regularization weights (the
    estimator's configurations share coordinates); a down-sampled fixed
    effect draws a fresh sample per update from a generator seeded by
    (`seed`, update step), so a rerun draws the same samples.

Checkpoint/resume, the mesh-loss recovery, prefetch and telemetry are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Set, Tuple

import torch

from photon_ml_tpu_torch.evaluation.suite import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.model import GameModel

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    best_model: GameModel
    validation_history: List[Tuple[int, str, EvaluationResults]]
    timing: Dict[str, float]
    diverged_steps: int = 0
    # Last accepted update's training stats per coordinate: the OptResult
    # of a fixed effect, the bucket stats dict of a random effect.
    train_stats: Dict[str, object] = dataclasses.field(default_factory=dict)


def _all_finite(model, scores: torch.Tensor, mesh) -> bool:
    arrays = [scores]
    coeffs = getattr(model, "coefficients", None)
    if coeffs is not None:
        arrays.append(coeffs.means)
    matrix = getattr(model, "coefficients_matrix", None)
    if matrix is not None:
        arrays.append(matrix)
    ok = torch.ones((), dtype=torch.bool, device=scores.device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return bool(ok) if mesh is None else mesh.all_true(bool(ok))


def gather_game_model(coordinates: Mapping[str, object], model: GameModel) -> GameModel:
    """The GameModel of all ranks from each rank's own (`gather_model` of
    every coordinate, in order; a collective on ranks, so every rank calls
    it). Without a mesh, the model itself."""
    return GameModel({cid: coordinates[cid].gather_model(m) for cid, m in model.models.items()})


def run_coordinate_descent(
    coordinates: Mapping[str, object],
    num_iterations: int,
    *,
    initial_models: Optional[GameModel] = None,
    locked_coordinates: Optional[Set[str]] = None,
    validation_scorer=None,
    validation_suite: Optional[EvaluationSuite] = None,
    validation_offsets: Optional[torch.Tensor] = None,
    reg_weights: Optional[Mapping[str, float]] = None,
    seed: int = 0,
) -> CoordinateDescentResult:
    """`coordinates`: ordered id -> Fixed/RandomEffectCoordinate.
    `validation_scorer(cid, model) -> scores` scores one coordinate's model
    on the validation set; the suite evaluates the summed scores."""
    locked = locked_coordinates or set()
    ids = list(coordinates.keys())
    unlocked = [c for c in ids if c not in locked]
    if not unlocked:
        raise ValueError("At least one coordinate must be trainable")
    for c in locked:
        if initial_models is None or c not in initial_models:
            raise ValueError(f"Locked coordinate {c!r} needs an initial model")

    first = next(iter(coordinates.values()))
    mesh = first.dataset.mesh
    if any(c.dataset.sharding is not first.dataset.sharding for c in coordinates.values()):
        raise ValueError("every coordinate must train on the same rows (one dataset's sharding)")
    base_offsets = first.dataset.offsets
    n = first.dataset.num_samples
    zeros = lambda: torch.zeros(n, dtype=base_offsets.dtype, device=base_offsets.device)

    models: Dict[str, object] = dict(initial_models.models) if initial_models else {}
    timing: Dict[str, float] = {}
    train_stats: Dict[str, object] = {}
    diverged_steps = 0
    validation_history: List[Tuple[int, str, EvaluationResults]] = []
    best_results: Optional[EvaluationResults] = None
    best_models: Dict[str, object] = dict(models)

    scores: Dict[str, torch.Tensor] = {}
    summed = zeros()
    for cid in ids:
        if cid in models:
            s = coordinates[cid].score(models[cid])
            scores[cid] = s
            summed = summed + s
    val_scores: Dict[str, torch.Tensor] = {}
    if validation_scorer is not None:
        for cid in ids:
            if cid in models:
                val_scores[cid] = validation_scorer(cid, models[cid])

    pass_results: Optional[EvaluationResults] = None
    last_unlocked = unlocked[-1]
    for it in range(num_iterations):
        for ci, cid in enumerate(ids):
            if cid in locked:
                continue
            coord = coordinates[cid]
            t0 = time.perf_counter()
            residual = summed - scores.get(cid, zeros())
            offsets = base_offsets + residual
            kwargs = {}
            if reg_weights and cid in reg_weights:
                kwargs["reg_weight"] = reg_weights[cid]
            if coord.config.down_sampling_rate < 1.0:
                step = it * len(ids) + ci
                # The CPU generator keeps 32 bits of its seed: mix (seed, step) into them.
                kwargs["generator"] = torch.Generator(device=base_offsets.device).manual_seed(
                    (int(seed) * 0x9E3779B1 + step) % (1 << 32))
            model, stats = coord.train(offsets, models.get(cid), **kwargs)
            new_scores = coord.score(model)
            accepted = _all_finite(model, new_scores, mesh)
            if accepted:
                summed = residual + new_scores
                scores[cid] = new_scores
                models[cid] = model
                train_stats[cid] = stats
            else:
                diverged_steps += 1
                logger.error(
                    "iteration %d coordinate %s: non-finite update rejected; "
                    "keeping the last good model", it, cid,
                )
            timing[f"{cid}/iter{it}"] = time.perf_counter() - t0

            if accepted and validation_scorer is not None and validation_suite is not None:
                val_scores[cid] = validation_scorer(cid, model)
                total = validation_offsets
                for s in val_scores.values():
                    total = s if total is None else total + s
                results = validation_suite.evaluate(total)
                validation_history.append((it, cid, results))
                pass_results = results
            if (
                cid == last_unlocked
                and pass_results is not None
                and pass_results.better_than(best_results)
            ):
                best_results = pass_results
                best_models = dict(models)

    final = GameModel(dict(models))
    best = GameModel(dict(best_models)) if best_results is not None else final
    return CoordinateDescentResult(
        model=final,
        best_model=best,
        validation_history=validation_history,
        timing=timing,
        diverged_steps=diverged_steps,
        train_stats=train_stats,
    )
