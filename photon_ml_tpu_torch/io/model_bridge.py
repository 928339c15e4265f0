"""Trained GAME models <-> persisted model artifacts.

Port of `photon_ml_tpu/io/model_bridge.py`. The reference saves models in
the ORIGINAL feature space with names resolved through the index maps
(ModelProcessingUtils.scala:77-141); training happens in normalized and,
for random effects, projected space. This module owns the conversions:

  save:  trained matrices on the model's device -> original-space numpy
         rows: normalization folded out (NormalizationContext.scala:73-90,
         one batched expression over a random effect's rows), projections
         reversed through the projector, the pinned zero row dropped, the
         entities in index order.
  load:  original-space artifact -> a GameModel scoring in original space
         (no normalization or projector), or -> warm-start matrices in an
         estimator's training representation, aligned to its entity index
         by the ids' string form (GameTrainingDriver.scala:370-378).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.io.model_store import FixedEffectArtifact, GameModelArtifact, RandomEffectArtifact
from photon_ml_tpu_torch.ops.normalization import PerEntityNormalization
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def _with_pinned_row(a: torch.Tensor) -> torch.Tensor:
    """(E, D) -> (E + 1, D): the zero row unseen entities score on."""
    return torch.cat([a, a.new_zeros((1, a.shape[1]))])


def _ordered_entity_ids(entity_index: Mapping[object, int]) -> list:
    out = [None] * len(entity_index)
    for k, i in entity_index.items():
        out[i] = k
    return out


def artifact_from_game_model(
    model: GameModel,
    specs: Mapping[str, CoordinateScoringSpec],
    task: TaskType,
    *,
    opt_configs: Optional[Dict[str, dict]] = None,
) -> GameModelArtifact:
    """A trained GameModel (and its scoring specs) as the persistable
    original-space artifact."""
    coords: Dict[str, object] = {}
    for cid, m in model.models.items():
        spec = specs[cid]
        norm = spec.norm
        if isinstance(m, FixedEffectModel):
            means, variances = m.coefficients.means, m.coefficients.variances
            if norm is not None:
                means, variances = norm.coefficients_to_original_space(means, variances)
            coords[cid] = FixedEffectArtifact(spec.shard, _host(means), _host(variances))
        elif isinstance(m, RandomEffectModel):
            matrix, variances = m.coefficients_matrix, m.variances_matrix
            if isinstance(norm, PerEntityNormalization):
                # Per-entity (factor, shift) rows in the projected space; the
                # projector below maps the slots to global indices.
                matrix, variances = norm.matrix_to_original_space(matrix, variances)
            elif norm is not None:
                matrix, variances = norm.coefficients_to_original_space(matrix, variances)
            if spec.projector is not None:
                matrix = spec.projector.back_project_matrix(matrix)
                if variances is not None:
                    variances = spec.projector.back_project_matrix(variances)
            e = len(spec.entity_index)  # the pinned zero row (row e) is dropped
            coords[cid] = RandomEffectArtifact(
                spec.random_effect_type, spec.shard,
                [str(k) for k in _ordered_entity_ids(spec.entity_index)],
                _host(matrix[:e]), None if variances is None else _host(variances[:e]))
        else:
            raise TypeError(f"unknown model type {type(m)} for coordinate {cid!r}")
    return GameModelArtifact(task=task, coordinates=coords, opt_configs=opt_configs or {})


def game_model_from_artifact(
    artifact: GameModelArtifact, device: DeviceLike = "cuda",
) -> Tuple[GameModel, Dict[str, CoordinateScoringSpec]]:
    """Artifact -> (GameModel on `device`, scoring specs) in the ORIGINAL
    feature space: the scoring driver's path (GameScoringDriver loadModel ->
    GameTransformer)."""
    dev = resolve_device(device)
    f32 = lambda a: None if a is None else torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)
    models: Dict[str, object] = {}
    specs: Dict[str, CoordinateScoringSpec] = {}
    for cid, coord in artifact.coordinates.items():
        if isinstance(coord, FixedEffectArtifact):
            models[cid] = FixedEffectModel(Coefficients(f32(coord.means), f32(coord.variances)),
                                           artifact.task)
            specs[cid] = CoordinateScoringSpec(shard=coord.feature_shard)
        elif isinstance(coord, RandomEffectArtifact):
            variances = f32(coord.variances)
            models[cid] = RandomEffectModel(
                _with_pinned_row(f32(coord.means)),
                None if variances is None else _with_pinned_row(variances), artifact.task)
            specs[cid] = CoordinateScoringSpec(
                shard=coord.feature_shard, random_effect_type=coord.random_effect_type,
                entity_index={k: i for i, k in enumerate(coord.entity_ids)})
        else:
            raise TypeError(f"unknown artifact type {type(coord)} for {cid!r}")
    return GameModel(models), specs


def warm_start_model_for_estimator(
    artifact: GameModelArtifact,
    specs: Mapping[str, CoordinateScoringSpec],
    device: DeviceLike = "cuda",
) -> GameModel:
    """Artifact -> GameModel in the ESTIMATOR's training representation
    (normalized, projected), aligned to the training dataset's entity index,
    on `device` (the training dataset's). The reference's per-entity
    leftOuterJoin warm start (RandomEffectCoordinate.scala:110-121):
    entities in both keep their coefficients, training-only entities start
    at zero, artifact-only entities are dropped."""
    dev = resolve_device(device)
    models: Dict[str, object] = {}
    for cid, coord in artifact.coordinates.items():
        if cid not in specs:
            continue
        spec = specs[cid]
        norm = spec.norm
        if isinstance(coord, FixedEffectArtifact):
            means = torch.as_tensor(np.asarray(coord.means), dtype=torch.float32).to(dev)
            if norm is not None and not norm.is_identity:
                means = norm.model_to_transformed_space(means)
            models[cid] = FixedEffectModel(Coefficients(means), artifact.task)
        elif isinstance(coord, RandomEffectArtifact):
            art_rows = {k: i for i, k in enumerate(coord.entity_ids)}
            keys = _ordered_entity_ids(spec.entity_index)
            src = np.fromiter((art_rows.get(str(k), -1) for k in keys), np.int64, count=len(keys))
            means = np.asarray(coord.means, np.float32)
            aligned = np.zeros((len(keys) + 1, means.shape[1]), np.float32)
            hit = np.flatnonzero(src >= 0)
            aligned[hit] = means[src[hit]]
            matrix = torch.from_numpy(aligned).to(dev)
            if spec.projector is not None:
                matrix = spec.projector.project_matrix(matrix)
            if isinstance(norm, PerEntityNormalization):
                matrix = norm.matrix_to_transformed_space(matrix)
            elif norm is not None and not norm.is_identity:
                matrix = norm.model_to_transformed_space(matrix)
            models[cid] = RandomEffectModel(matrix, None, artifact.task)
    return GameModel(models)
