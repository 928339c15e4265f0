"""Incremental (delta) fits: re-solve only what a delta batch changed.

Port of `photon_ml_tpu/game/incremental.py`, the training half of
continuous refresh:

1. `fingerprint_dataset` digests (data/fingerprints.py) decide per
   coordinate, and per entity for a random effect, whether the merged
   dataset's training inputs changed since the previous fit.
2. `incremental_fit` re-solves only the changed coordinates, warm-started
   from the previous model. An unchanged coordinate's model is carried
   over as the same object, so its tensors are the previous fit's bits. A
   changed random effect takes the entity fast path where it may: the
   changed entities' rows are carved out (`take_rows`), solved as a small
   problem warm-started from their previous rows, and the solved rows are
   scattered back into the grown matrix. The untouched entities' rows are
   never re-solved, so they are the previous fit's bits too.
3. `grow_random_effect_model` extends a previous (E + 1, d) matrix and its
   entity index to the merged index by a key-mapped row copy on the
   device (new entities may re-sort into the middle of the index), new
   rows at zero.

Parity contract (journaled as `delta_fit_start`/`delta_fit_finish`, and
written with `checkpoint_dir` to `delta_records.jsonl`): carried
coordinates and unchanged entities are bit-equal to the previous model;
re-solved entities report the largest relative coefficient movement
(`max_rel_diff`), the churn the new data caused.

Scope, as in the reference: coordinates built straight from data configs
(no projectors, no estimator). A config with active-row bounds or Pearson
selection, or with a normalization, re-solves its whole coordinate
(warm-started) instead of taking the entity fast path: its row selection
keys on global sample indices, which a carved sub-dataset renumbers.

The mode's escape hatch is the planner's `refresh_max_delta_fraction`
(PHOTON_REFRESH_MAX_DELTA_FRACTION, else the plan's, else 0.5).
`IncrementalFitResult.stage_s` (the port's
own field) times the fit's stages apart, each stopping once the device
has finished: `fingerprint_copy` and `fingerprint_hash`, `plan`,
`build` (coordinates and random-effect layouts), `offsets` (the residual
offsets of each changed coordinate, from the transformer's margins: on
the card, a sparse fixed effect's through the `sparse_matvec` kernel) and
`solve` by coordinate.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Mapping, Optional, Set, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.data.fingerprints import (
    DatasetFingerprints,
    diff_fingerprints,
    fingerprint_dataset,
)
from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
    build_random_effect_dataset,
    take_rows,
)
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.game.model import GameModel, RandomEffectModel
from photon_ml_tpu_torch.timing import StageTimes
from photon_ml_tpu_torch.transformers.game_transformer import (
    CoordinateScoringSpec,
    coordinate_margins,
    prepare_coordinate_data,
)
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


# ------------------------------------------------------------------ planning


@dataclasses.dataclass(frozen=True)
class DeltaFitPlan:
    """What an incremental fit re-solves. `mode` is "none" (nothing
    changed: carry the previous model), "delta" (the changed coordinates
    only, the entity fast path where eligible) or "full" (churn past the
    max-delta-fraction escape hatch: one warm-started full refit)."""

    mode: str
    changed_coordinates: Tuple[str, ...]
    changed_entities: Dict[str, Tuple[object, ...]]
    new_entities: Dict[str, Tuple[object, ...]]
    delta_rows: int
    total_rows: int

    @property
    def delta_fraction(self) -> float:
        return self.delta_rows / max(self.total_rows, 1)


def plan_delta_fit(prev: DatasetFingerprints, new: DatasetFingerprints, *,
                   max_delta_fraction: Optional[float] = None) -> DeltaFitPlan:
    """Diff two fingerprint snapshots into a re-solve plan; past
    `max_delta_fraction` (default PHOTON_REFRESH_MAX_DELTA_FRACTION) of
    the merged rows the mode is "full"."""
    diffs = diff_fingerprints(prev, new)
    changed = tuple(cid for cid, d in diffs.items() if d.changed)
    changed_entities: Dict[str, Tuple[object, ...]] = {}
    new_entities: Dict[str, Tuple[object, ...]] = {}
    delta_rows = max(new.num_samples - prev.num_samples, 0)
    fe_changed = False
    for cid in changed:
        d = diffs[cid]
        if prev.coordinates[cid].is_random_effect:
            changed_entities[cid] = d.changed_entities
            new_entities[cid] = d.new_entities
            delta_rows = max(delta_rows, d.delta_rows)
        else:
            fe_changed = True
    if delta_rows == 0 and fe_changed:
        # Rows edited in place in the fixed effect's shard alone: the digest
        # cannot localize the edit, so the whole dataset is charged.
        delta_rows = new.num_samples
    if not changed:
        mode = "none"
    else:
        if max_delta_fraction is None:
            max_delta_fraction = float(planner.planned_value("refresh_max_delta_fraction"))
        frac = delta_rows / max(new.num_samples, 1)
        mode = "full" if frac > max_delta_fraction else "delta"
    return DeltaFitPlan(mode, changed, changed_entities, new_entities, int(delta_rows),
                        int(new.num_samples))


# ------------------------------------------------------------- model growth


def _positions(prev_index: Mapping[object, int], new_index: Mapping[object, int], device
               ) -> Tuple[Tensor, Tensor]:
    """(rows in the new index, rows in the previous index) of the keys both
    hold, on `device`."""
    shared = [k for k in new_index if k in prev_index]
    new_pos = np.fromiter((new_index[k] for k in shared), np.int64, len(shared))
    prev_pos = np.fromiter((prev_index[k] for k in shared), np.int64, len(shared))
    return torch.as_tensor(new_pos).to(device), torch.as_tensor(prev_pos).to(device)


def grow_random_effect_model(model: RandomEffectModel, prev_index: Mapping[object, int],
                             new_index: Mapping[object, int]) -> RandomEffectModel:
    """A previous random-effect model extended to a new entity index: rows
    move by key (new entities can re-sort the sorted index), new entities
    start at zero, the pinned zero row lands at the new E. Pure data
    movement on the model's device: a carried row's floats are copied."""
    prev_mat = model.coefficients_matrix
    new_pos, prev_pos = _positions(prev_index, new_index, prev_mat.device)
    mat = prev_mat.new_zeros((len(new_index) + 1, prev_mat.shape[1]))
    mat[new_pos] = prev_mat[prev_pos]
    var = None
    if model.variances_matrix is not None:
        var = torch.zeros_like(mat)
        var[new_pos] = model.variances_matrix[prev_pos]
    return RandomEffectModel(mat, var, model.task)


# --------------------------------------------------------------- fit driver


@dataclasses.dataclass
class FitState:
    """What the next refresh round needs from a fit: the model, the data
    fingerprints it was trained on and each coordinate's entity index (None
    for a fixed effect)."""

    model: GameModel
    fingerprints: DatasetFingerprints
    entity_indices: Dict[str, Optional[Dict[object, int]]]


@dataclasses.dataclass
class IncrementalFitResult:
    state: FitState
    plan: DeltaFitPlan
    seconds: float
    # The largest relative coefficient movement of the re-solved parameters
    # against their warm start (carried ones are bit-equal and add 0).
    max_rel_diff: float
    carried_coordinates: Tuple[str, ...]
    # The port's stage seconds (module docstring); "solve" maps coordinate
    # id -> seconds.
    stage_s: Dict[str, object] = dataclasses.field(default_factory=dict)


def build_coordinates(dataset: GameDataset, data_configs: Mapping[str, object],
                      opt_configs: Mapping[str, object], task: TaskType, *,
                      norms: Optional[Mapping[str, object]] = None):
    """(coordinate id -> coordinate, id -> entity index)."""
    coords: Dict[str, object] = {}
    indices: Dict[str, Optional[Dict[object, int]]] = {}
    for cid, cfg in data_configs.items():
        opt = opt_configs[cid]
        norm = (norms or {}).get(cid)
        if isinstance(cfg, RandomEffectDataConfig):
            red = build_random_effect_dataset(dataset, cfg)
            coords[cid] = RandomEffectCoordinate(dataset, red, opt, task, norm)
            indices[cid] = dict(red.entity_index)
        elif isinstance(cfg, FixedEffectDataConfig):
            coords[cid] = FixedEffectCoordinate(dataset, cfg.feature_shard, opt, task, norm)
            indices[cid] = None
        else:
            raise TypeError(f"coordinate {cid!r}: unknown config {type(cfg)}")
    return coords, indices


def scoring_specs(data_configs: Mapping[str, object],
                  entity_indices: Mapping[str, Optional[Dict[object, int]]], *,
                  norms: Optional[Mapping[str, object]] = None) -> Dict[str, CoordinateScoringSpec]:
    """Projector-free scoring specs of this layer's coordinates (what
    `ServingBundle.from_model` stages from)."""
    specs: Dict[str, CoordinateScoringSpec] = {}
    for cid, cfg in data_configs.items():
        norm = (norms or {}).get(cid)
        if isinstance(cfg, RandomEffectDataConfig):
            specs[cid] = CoordinateScoringSpec(shard=cfg.feature_shard, norm=norm,
                                               random_effect_type=cfg.random_effect_type,
                                               entity_index=entity_indices[cid])
        else:
            specs[cid] = CoordinateScoringSpec(shard=cfg.feature_shard, norm=norm)
    return specs


def full_fit(dataset: GameDataset, data_configs: Mapping[str, object],
             opt_configs: Mapping[str, object], task: TaskType, *, num_iterations: int = 1,
             initial_models: Optional[GameModel] = None,
             locked_coordinates: Optional[Set[str]] = None,
             norms: Optional[Mapping[str, object]] = None, seed: int = 0,
             checkpoint_dir: Optional[str] = None) -> FitState:
    """A from-scratch (or warm-started) fit at this layer: every coordinate
    built on `dataset`, cyclic coordinate descent. A refresh loop's round
    0 and the baseline the delta path is held against."""
    coords, indices = build_coordinates(dataset, data_configs, opt_configs, task, norms=norms)
    result = run_coordinate_descent(
        coords, num_iterations, initial_models=initial_models,
        locked_coordinates=locked_coordinates,
        reg_weights={cid: opt_configs[cid].reg_weight for cid in coords}, seed=seed,
        checkpoint_dir=checkpoint_dir)
    return FitState(result.model, fingerprint_dataset(dataset, data_configs), indices)


def _entity_fast_path_eligible(cfg: RandomEffectDataConfig, norm: Optional[object]) -> bool:
    """Row carving renumbers global sample indices, so a config whose
    active-row or feature selection keys on them re-solves the whole
    coordinate instead (still warm-started)."""
    return (cfg.active_upper_bound is None and cfg.active_lower_bound is None
            and cfg.num_features_to_samples_ratio_upper_bound is None and norm is None)


def _offsets_for(dataset: GameDataset, cid: str, models: Mapping[str, object],
                 specs: Mapping[str, CoordinateScoringSpec], prepared: Optional[dict] = None) -> Tensor:
    """The dataset's offsets plus the margins of every other coordinate's
    current model: the residual offsets coordinate `cid` solves against.
    `prepared` caches each coordinate's scoring view of `dataset` across
    calls (the views do not depend on the models)."""
    prepared = {} if prepared is None else prepared
    total = dataset.offsets
    for other, model in models.items():
        if other == cid:
            continue
        if other not in prepared:
            prepared[other] = prepare_coordinate_data(specs[other], dataset)
        total = total + coordinate_margins(specs[other], model, prepared[other])
    return total


def incremental_fit(dataset: GameDataset, data_configs: Mapping[str, object],
                    opt_configs: Mapping[str, object], task: TaskType, *, prev: FitState,
                    max_delta_fraction: Optional[float] = None,
                    norms: Optional[Mapping[str, object]] = None, seed: int = 0,
                    checkpoint_dir: Optional[str] = None) -> IncrementalFitResult:
    """Warm-started delta fit of `dataset` (the merged previous and delta
    rows) against the previous fit's state; the plan's mode decides the
    work:

    * "none": the previous model, carried as it is;
    * "full": one warm-started refit of every coordinate (each random
      effect grown to the merged index first), discarding a checkpoint a
      previous round left in `checkpoint_dir`;
    * "delta": the changed coordinates, in config order, each against
      offsets from the freshest models; random effects by the entity fast
      path where eligible.
    """
    t0 = time.perf_counter()
    times = StageTimes()
    dev = dataset.device
    new_fp = fingerprint_dataset(dataset, data_configs, times)
    with times.stage("plan"):
        plan = plan_delta_fit(prev.fingerprints, new_fp, max_delta_fraction=max_delta_fraction)
    telemetry.emit_event("delta_fit_start", mode=plan.mode,
                         changed_coordinates=list(plan.changed_coordinates),
                         delta_rows=plan.delta_rows, total_rows=plan.total_rows)
    carried = tuple(cid for cid in data_configs if cid not in plan.changed_coordinates)
    max_rel_diff = 0.0
    solve_s: Dict[str, float] = {}
    if plan.mode == "none":
        state = FitState(prev.model, new_fp, dict(prev.entity_indices))
    elif plan.mode == "full":
        state, max_rel_diff = _warm_full_refit(dataset, data_configs, opt_configs, task, prev,
                                               new_fp, times, solve_s, norms=norms, seed=seed,
                                               checkpoint_dir=checkpoint_dir)
    else:
        state, max_rel_diff = _delta_solve(dataset, data_configs, opt_configs, task, prev, new_fp,
                                           plan, times, solve_s, norms=norms)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    telemetry.emit_event("delta_fit_finish", mode=plan.mode,
                         changed_coordinates=list(plan.changed_coordinates),
                         carried_coordinates=list(carried), seconds=round(seconds, 4),
                         max_rel_diff=float(max_rel_diff))
    if checkpoint_dir is not None:
        from photon_ml_tpu_torch.game.checkpoint import append_delta_record

        append_delta_record(checkpoint_dir, {
            "mode": plan.mode,
            "changed_coordinates": list(plan.changed_coordinates),
            "carried_coordinates": list(carried),
            "delta_rows": plan.delta_rows,
            "total_rows": plan.total_rows,
            "max_rel_diff": float(max_rel_diff),
            "seconds": round(seconds, 4),
        })
    stage_s: Dict[str, object] = {k: times.get(k) for k in
                                  ("fingerprint_copy", "fingerprint_hash", "plan", "build", "offsets")}
    stage_s["solve"] = solve_s
    return IncrementalFitResult(state, plan, seconds, float(max_rel_diff), carried, stage_s)


def _grown_models(prev: FitState, merged_indices: Mapping[str, Optional[Dict[object, int]]]
                  ) -> Dict[str, object]:
    """Every previous model, random effects grown to the merged entity
    index (the same model where the index is unchanged)."""
    models: Dict[str, object] = {}
    for cid, model in prev.model.models.items():
        prev_idx = prev.entity_indices.get(cid)
        new_idx = merged_indices.get(cid)
        if prev_idx is not None and new_idx is not None and prev_idx != new_idx:
            models[cid] = grow_random_effect_model(model, prev_idx, new_idx)
        else:
            models[cid] = model
    return models


def _rel_diff(new, old) -> float:
    """Largest relative coefficient movement, churn-characterizing: rows
    whose warm start is all zero (new entities) are left out, having no
    previous value to move from."""
    new = new.detach().cpu().numpy() if isinstance(new, Tensor) else np.asarray(new)
    old = old.detach().cpu().numpy() if isinstance(old, Tensor) else np.asarray(old)
    if new.size == 0:
        return 0.0
    if new.ndim == 2:
        keep = np.any(old != 0, axis=1)
        new, old = new[keep], old[keep]
        if new.size == 0:
            return 0.0
    return float(np.max(np.abs(new - old) / (np.abs(old) + 1e-12)))


def _model_rel_diff(model, old) -> float:
    if isinstance(model, RandomEffectModel):
        e = min(model.coefficients_matrix.shape[0], old.coefficients_matrix.shape[0]) - 1
        return _rel_diff(model.coefficients_matrix[:e], old.coefficients_matrix[:e])
    return _rel_diff(model.coefficients.means, old.coefficients.means)


def _warm_full_refit(dataset, data_configs, opt_configs, task, prev, new_fp, times, solve_s, *,
                     norms, seed, checkpoint_dir):
    with times.stage("build", dataset.device):
        coords, indices = build_coordinates(dataset, data_configs, opt_configs, task, norms=norms)
        warm = GameModel(_grown_models(prev, indices))
    result = run_coordinate_descent(
        coords, 1, initial_models=warm,
        reg_weights={cid: opt_configs[cid].reg_weight for cid in coords}, seed=seed,
        checkpoint_dir=checkpoint_dir,
        # Each round's merged dataset is a new configuration; a checkpoint a
        # previous round's full refit left is stale by construction (a crash
        # resume of this round still resumes: same fingerprint).
        stale_checkpoint="discard")
    for cid in coords:
        solve_s[cid] = result.timing[f"{cid}/iter0"]
    max_rel = max((_model_rel_diff(m, warm[cid]) for cid, m in result.model.models.items()),
                  default=0.0)
    return FitState(result.model, new_fp, indices), max_rel


def _delta_solve(dataset, data_configs, opt_configs, task, prev, new_fp, plan, times, solve_s, *,
                 norms):
    """Mode "delta": the changed coordinates only, in config order."""
    dev = dataset.device
    # Changed random effects take the merged tags' sorted index (what a
    # from-scratch build assigns); unchanged ones keep theirs (same
    # entities, same order).
    merged_indices: Dict[str, Optional[Dict[object, int]]] = {}
    for cid, cfg in data_configs.items():
        if not isinstance(cfg, RandomEffectDataConfig):
            merged_indices[cid] = None
        elif cid in plan.changed_coordinates:
            merged_indices[cid] = _merged_entity_index(dataset, cfg.random_effect_type)
        else:
            merged_indices[cid] = prev.entity_indices[cid]
    models = _grown_models(prev, merged_indices)
    specs = scoring_specs(data_configs, merged_indices, norms=norms)
    prepared: dict = {}
    max_rel = 0.0
    for cid, cfg in data_configs.items():
        if cid not in plan.changed_coordinates:
            continue
        opt = opt_configs[cid]
        norm = (norms or {}).get(cid)
        with times.stage("offsets", dev):
            offsets = _offsets_for(dataset, cid, models, specs, prepared)
        t_solve, build_before = time.perf_counter(), times.get("build")
        if isinstance(cfg, FixedEffectDataConfig):
            with times.stage("build", dev):
                coord = FixedEffectCoordinate(dataset, cfg.feature_shard, opt, task, norm)
            new_model, _ = coord.train(offsets, models[cid], reg_weight=opt.reg_weight)
        elif not _entity_fast_path_eligible(cfg, norm):
            with times.stage("build", dev):
                red = build_random_effect_dataset(dataset, cfg)
                coord = RandomEffectCoordinate(dataset, red, opt, task, norm)
            new_model, _ = coord.train(offsets, models[cid], reg_weight=opt.reg_weight)
        else:
            new_model = _entity_fast_path(dataset, cid, cfg, opt, task, norm, offsets, models[cid],
                                          merged_indices[cid], plan.changed_entities[cid], times)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        solve_s[cid] = time.perf_counter() - t_solve - (times.get("build") - build_before)
        max_rel = max(max_rel, _model_rel_diff(new_model, models[cid]))
        models[cid] = new_model
    return FitState(GameModel(models), new_fp, merged_indices), max_rel


def _entity_fast_path(dataset, cid, cfg, opt, task, norm, offsets, grown, merged_index,
                      changed_keys, times) -> RandomEffectModel:
    """Carve the changed entities' rows, solve that small problem warm
    from their rows of `grown`, and scatter the solved rows back into a
    copy of `grown`: no other row is touched."""
    dev = dataset.device
    with times.stage("build", dev):
        changed_pos = np.fromiter((merged_index[k] for k in changed_keys), np.int64,
                                  len(changed_keys))
        sample_pos = _sample_entity_positions(dataset, cfg.random_effect_type, merged_index)
        rows = np.nonzero(np.isin(sample_pos, changed_pos))[0]
        sub_ds = take_rows(dataset, rows)
        sub_red = build_random_effect_dataset(sub_ds, cfg)
        sub_index = sub_red.entity_index
        sub_keys = list(sub_index.keys())
        sub_pos = torch.as_tensor(np.fromiter((sub_index[k] for k in sub_keys), np.int64,
                                              len(sub_keys))).to(dev)
        from_pos = torch.as_tensor(np.fromiter((merged_index[k] for k in sub_keys), np.int64,
                                               len(sub_keys))).to(dev)
        grown_mat = grown.coefficients_matrix
        sub_warm = grown_mat.new_zeros((len(sub_index) + 1, grown_mat.shape[1]))
        sub_warm[sub_pos] = grown_mat[from_pos]
        coord = RandomEffectCoordinate(sub_ds, sub_red, opt, task, norm)
    sub_model, _ = coord.train(offsets[torch.as_tensor(rows).to(dev)],
                               RandomEffectModel(sub_warm, None, task), reg_weight=opt.reg_weight)
    new_mat = grown_mat.clone()
    new_mat[from_pos] = sub_model.coefficients_matrix[sub_pos]
    logger.info("delta fit %s: re-solved %d/%d entities (%d/%d rows)", cid, len(changed_keys),
                len(merged_index), len(rows), dataset.num_samples)
    return RandomEffectModel(new_mat, None, task)


def _merged_entity_index(dataset: GameDataset, tag: str) -> Dict[object, int]:
    """The sorted entity index of a dataset's tag: the values of its
    factorized table that some sample uses, as the layout assigns them."""
    codes, table = dataset.tag_codes[tag]
    used = np.bincount(codes, minlength=len(table)) > 0
    return {(k.item() if hasattr(k, "item") else k): i for i, k in enumerate(table[used])}


def _sample_entity_positions(dataset: GameDataset, tag: str, index: Mapping[object, int]) -> np.ndarray:
    """Each sample's row in `index` (every tag value a sample uses is in it
    by construction), resolved once per value of the tag's table."""
    codes, table = dataset.tag_codes[tag]
    table_pos = np.fromiter((index.get(k.item() if hasattr(k, "item") else k, -1) for k in table),
                            np.int64, count=len(table))
    return table_pos[codes]
