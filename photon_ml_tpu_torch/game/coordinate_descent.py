"""Cyclic block coordinate descent over named GAME coordinates.

Port of the single-process loop of `photon_ml_tpu/game/coordinate_descent.py`.
Every coordinate scores the same fixed sample axis, so the residual for
coordinate c is (summed scores - c's previous scores), three elementwise ops:

  * update order is the insertion order of `coordinates`;
  * warm start from `initial_models`; locked coordinates only contribute
    scores;
  * divergence guard with a bounded retry: an update whose coefficients
    or scores hold a non-finite value is rejected, and the update is
    solved again up to `PHOTON_SOLVE_RETRIES` more times
    (utils/faults.solve_retry_attempts, default 1); every rejected attempt
    adds one to `diverged_steps`. A transient cause (an injected fault, a
    flaky card) re-solves to the fault-free result bit for bit; a
    deterministic divergence reproduces and the coordinate keeps its last
    good model. Each attempt first fires the `solve` fault site, and an
    `InjectedFault` there reads as a non-finite attempt. On ranks
    (parallel/mesh.py) the verdict is a cross-rank AND, so one rank's NaN
    rejects the update on every rank and the ranks cannot diverge; a rank
    whose `solve` site fires still trains and scores like the others (the
    fixed effect's solve sums across the ranks) and votes false;
  * optional validation after each update, with best-model selection on
    full passes by the primary evaluator;
  * `reg_weights` overrides coordinates' regularization weights (the
    estimator's configurations share coordinates); a down-sampled fixed
    effect draws a fresh sample per update from a generator seeded by
    (`seed`, update step), so a rerun draws the same samples;
  * `checkpoint_dir` checkpoints the loop after every update
    (game/checkpoint.py) and a rerun resumes from it: it skips the
    completed steps, recomputes the scores from the saved models and takes
    the best models, best results and validation history from the
    checkpoint. The run's fingerprint (`run_config_key`) is the JAX
    package's, hashed the same way, so either package resumes the other's
    checkpoint; a checkpoint of another configuration is refused
    (`stale_checkpoint="error"`) or cleared (`"discard"`), and one written
    with another seed is refused. On ranks the checkpoint is a
    `RankCheckpoint` (each rank writes its row block of every random
    effect in the reference's elastic layout; `checkpoint_factory`
    substitutes another, as the multi-host worker passes its
    `MultihostCheckpoint`), the fingerprint is taken over all rows, the
    same on every rank, at every world size and in one process, and a
    resume loads the models of all ranks and cuts each rank's store out of
    them (`local_model`): a checkpoint of any world size resumes on any;
  * the `mesh_loss` fault site fires once per coordinate update and raises
    `MeshLoss`, which propagates after counting `mesh_losses` (the
    reference's `max_mesh_losses=0`): on ranks a lost device is a lost
    process, and only the supervisor's relaunch of the survivors
    (parallel/hostmesh.py) recovers, from the checkpoint.

  * `on_event(etype, **fields)` is the lifecycle hook: ("coordinate",
    iteration, coordinate, seconds, accepted) after every update and
    ("checkpoint", step, coordinate) after every durable save; the
    estimator forwards them as typed events into the run journal;
  * `prefetch` is the host overlap's switch (the estimator's `pipeline`).
    The reference also starts the next coordinate's shard upload with it;
    the port's shards live on their device from ingest on, so here it
    gates only the staged checkpoint write: when an accepted update is
    checkpointed and validated, its model write runs on a thread
    (`begin_model_write`) while the validation evaluates, and the save
    joins it before the commit. The models and files do not change.

Each update runs under a `coordinate_update` span (utils/telemetry.py,
with `accepted` set) and records its wall in the `coordinate_update_s`
histogram. The in-process mesh-loss recovery (the reference's
`mesh_rebuilder`) is not ported: a rank holds the only copy of its rows.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Dict, List, Mapping, Optional, Set, Tuple

import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.evaluation.suite import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.checkpoint import CoordinateDescentCheckpoint, RankCheckpoint
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.optimize.config import static_config_key
from photon_ml_tpu_torch.utils import faults, telemetry

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


def _all_finite(model, scores: torch.Tensor, mesh, vote: bool = True) -> bool:
    """The guard's verdict on an update's scores and coefficients; on
    ranks, the AND of every rank's (`vote` False makes this rank's vote
    false whatever its arrays hold). Variances are not vetted: SIMPLE
    variances are inf by design where a column's Hessian diagonal is 0."""
    coeffs = getattr(model, "coefficients", None)
    arrays = (scores, coeffs.means if coeffs is not None else model.coefficients_matrix)
    ok = torch.ones((), dtype=torch.bool, device=scores.device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    ok = vote and bool(ok)
    return ok if mesh is None else mesh.all_true(ok)


def gather_game_model(coordinates: Mapping[str, object], model: GameModel) -> GameModel:
    """The GameModel of all ranks from each rank's own (`gather_model` of
    every coordinate, in order; a collective on ranks, so every rank calls
    it). Without a mesh, the model itself."""
    return GameModel({cid: coordinates[cid].gather_model(m) for cid, m in model.models.items()})


def _shard_identity(feats, num_rows: int) -> tuple:
    """A shard's identity in the fingerprint, over `num_rows` rows (all
    rows, where a rank holds part of them)."""
    if isinstance(feats, SparseFeatures):
        shape = (num_rows,) + tuple(int(s) for s in feats.indices.shape[1:])
        # The reference stores a projected shard's planes as (K, N).
        return ("sparse", shape[::-1] if feats.projected else shape, feats.dim)
    return ("dense", (num_rows,) + tuple(int(s) for s in feats.shape[1:]))


def _num_rows(dataset) -> int:
    """The dataset's rows over all ranks."""
    return dataset.num_samples if dataset.sharding is None else dataset.sharding.num_global


def run_config_key(coordinates: Mapping[str, object], locked: Set[str],
                   reg_weights: Optional[Mapping[str, float]]) -> str:
    """The run's fingerprint, built as the JAX package builds it: the ids,
    the locked ids, each config's static key, each effective weight, and
    each dataset's sample count and shard shapes, as the sha256 of their
    repr. On ranks the count and shapes are those of all rows (a rank's
    ELL planes keep the width of all rows), so every rank, at every world
    size, takes the key one process takes over the same data. A resume
    under another fingerprint is refused."""
    ids = list(coordinates.keys())
    fp = (
        tuple(ids),
        tuple(sorted(locked)),
        tuple(static_config_key(coordinates[c].config) for c in ids),
        tuple((c, float((reg_weights or {}).get(c, coordinates[c].config.reg_weight)))
              for c in ids),
        tuple(
            (c, _num_rows(coordinates[c].dataset),
             tuple(sorted((name, _shard_identity(f, _num_rows(coordinates[c].dataset)))
                          for name, f in coordinates[c].dataset.shards.items())))
            for c in ids
        ),
    )
    return hashlib.sha256(repr(fp).encode()).hexdigest()


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
    checkpoint_dir: Optional[str] = None,
    stale_checkpoint: str = "error",
    checkpoint_factory=None,
    prefetch: bool = False,
    on_event=None,
) -> CoordinateDescentResult:
    """`coordinates`: ordered id -> Fixed/RandomEffectCoordinate.
    `validation_scorer(cid, model) -> scores` scores one coordinate's model
    on the validation set; the suite evaluates the summed scores.
    `checkpoint_dir` saves after every update and resumes from what is
    there; `stale_checkpoint` ("error" or "discard") is the policy for a
    checkpoint of another configuration; `checkpoint_factory(checkpoint_dir)`
    builds the checkpoint (default: `CoordinateDescentCheckpoint`, or a
    `RankCheckpoint` on ranks). `prefetch` stages each validated step's
    model write on a thread, and `on_event` is the lifecycle hook (see the
    module docstring)."""
    if stale_checkpoint not in ("error", "discard"):
        raise ValueError(f"stale_checkpoint must be 'error' or 'discard', got {stale_checkpoint!r}")
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
    completed_steps = 0

    ckpt = None
    ckpt_config_key = None
    if checkpoint_dir is not None:
        ckpt_config_key = run_config_key(coordinates, locked, reg_weights)
        if checkpoint_factory is not None:
            ckpt = checkpoint_factory(checkpoint_dir)
        elif mesh is not None:
            ckpt = RankCheckpoint(checkpoint_dir, coordinates)
        else:
            ckpt = CoordinateDescentCheckpoint(checkpoint_dir)
        if (stale_checkpoint == "discard" and ckpt.exists()
                and ckpt.stored_config_key() != ckpt_config_key):
            logger.info("checkpoint at %s was written for a different run configuration — "
                        "discarding and starting fresh", checkpoint_dir)
            ckpt.clear()
        if ckpt.exists():
            state = ckpt.load(first.task, config_key=ckpt_config_key, device=base_offsets.device)
            if state.seed != seed:
                raise ValueError(f"checkpoint at {checkpoint_dir} was written with seed "
                                 f"{state.seed}, not {seed} — refusing to resume")
            # The models of all ranks, each cut to this rank's store.
            models = {cid: coordinates[cid].local_model(m) for cid, m in state.models.items()}
            best_models = {cid: coordinates[cid].local_model(m)
                           for cid, m in state.best_models.items()} or dict(models)
            best_results = state.best_results
            validation_history = list(state.validation_history)
            completed_steps = state.completed_steps
            logger.info("resuming coordinate descent from %s at step %d", checkpoint_dir,
                        completed_steps)

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

    # On resume, the last results of the history stand where the
    # uninterrupted run's last evaluation stood.
    pass_results: Optional[EvaluationResults] = (
        validation_history[-1][2] if validation_history else None)
    last_unlocked = unlocked[-1]
    for it in range(num_iterations):
        for ci, cid in enumerate(ids):
            if cid in locked:
                continue
            step = it * len(ids) + ci
            if step < completed_steps:
                continue  # done before the checkpoint
            coord = coordinates[cid]
            t0 = time.perf_counter()
            residual = summed - scores.get(cid, zeros())
            offsets = base_offsets + residual
            kwargs = {}
            if reg_weights and cid in reg_weights:
                kwargs["reg_weight"] = reg_weights[cid]
            sampled = coord.config.down_sampling_rate < 1.0
            try:
                faults.fault_point("mesh_loss")
            except faults.InjectedFault as exc:
                faults.COUNTERS.increment("mesh_losses")
                telemetry.emit_event("mesh_loss", iteration=it, coordinate=cid,
                                     surviving_devices=None, source="raised")
                raise faults.MeshLoss(f"injected mesh loss at iteration {it} coordinate "
                                      f"{cid!r}") from exc
            model = None
            with telemetry.span("coordinate_update", coordinate=cid, iteration=it) as span:
                for attempt in range(1 + faults.solve_retry_attempts()):
                    try:
                        faults.fault_point("solve")
                        vote = True
                    except faults.InjectedFault:
                        # Only the site's own injection reads as a divergence.
                        # Without ranks the attempt ends here; on ranks this
                        # rank still solves (the fixed effect's sums cross the
                        # ranks) and votes false.
                        vote = False
                        if mesh is None:
                            diverged_steps += 1
                            logger.warning("iteration %d coordinate %s: injected solve fault "
                                           "(attempt %d)", it, cid, attempt + 1)
                            continue
                    if sampled:
                        # A fresh generator each attempt, so a retry draws the same
                        # sample; the CPU generator keeps 32 bits of its seed, so
                        # (seed, step) are mixed into them.
                        kwargs["generator"] = torch.Generator(
                            device=base_offsets.device).manual_seed(
                                (int(seed) * 0x9E3779B1 + step) % (1 << 32))
                    cand, cand_stats = coord.train(offsets, models.get(cid), **kwargs)
                    cand_scores = coord.score(cand)
                    if _all_finite(cand, cand_scores, mesh, vote):
                        model, stats, new_scores = cand, cand_stats, cand_scores
                        break
                    diverged_steps += 1
                    logger.warning("iteration %d coordinate %s: non-finite update rejected "
                                   "(attempt %d)", it, cid, attempt + 1)
                span.set(accepted=model is not None)
            accepted = model is not None
            if accepted:
                summed = residual + new_scores
                scores[cid] = new_scores
                models[cid] = model
                train_stats[cid] = stats
            else:
                logger.error(
                    "iteration %d coordinate %s diverged on every attempt; "
                    "keeping the last good model", it, cid,
                )
            timing[f"{cid}/iter{it}"] = time.perf_counter() - t0
            telemetry.METRICS.observe("coordinate_update_s", timing[f"{cid}/iter{it}"])
            if on_event is not None:
                on_event("coordinate", iteration=it, coordinate=cid,
                         seconds=timing[f"{cid}/iter{it}"], accepted=accepted)

            # The step's model write overlaps its validation below; save()
            # joins it before the commit.
            validates = validation_scorer is not None and validation_suite is not None
            staged = None
            if accepted and ckpt is not None and prefetch and validates:
                staged = ckpt.begin_model_write(completed_steps=step + 1, cid=cid, model=model)

            if accepted and validates:
                val_scores[cid] = validation_scorer(cid, model)
                total = validation_offsets
                for s in val_scores.values():
                    total = s if total is None else total + s
                results = validation_suite.evaluate(total)
                validation_history.append((it, cid, results))
                pass_results = results
            best_updated = False
            if (
                cid == last_unlocked
                and pass_results is not None
                and pass_results.better_than(best_results)
            ):
                best_results = pass_results
                best_models = dict(models)
                best_updated = True
            if ckpt is not None:
                # A rejected update advances the cursor but writes no model.
                ckpt.save(completed_steps=step + 1, seed=seed, config_key=ckpt_config_key,
                          models=models, trained_cid=cid if accepted else None,
                          best_is_current=best_updated, best_results=best_results,
                          validation_history=validation_history, staged=staged)
                if on_event is not None:
                    on_event("checkpoint", step=step + 1, coordinate=cid)

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
