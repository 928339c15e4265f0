"""Batch scoring of a GAME model over a GameDataset.

Port of the scoring path of `photon_ml_tpu/transformers/game_transformer.py`:
dense fixed effects score with `dense_margins` (a per-row reduction, not a
matvec, so a row's score does not depend on how many rows ride along);
sparse fixed effects score through the sparse layout's matvec (its CUDA
kernel on the card; a row's sum is over its own entries only, so it is
batch-invariant too); random effects map each sample's entity key through
the training-time entity index (unseen entities -> the pinned zero row),
project the shard through the training-time projector (a random effect
scores in its projected space, as it trained; an unseen entity's entries
project to zeros) and gather coefficient rows (over a sparse shard, the
coefficients each row's ELL entries name, from the planes themselves).
That preparation (`prepare_coordinate_data`) is done once per (coordinate,
dataset) and reused by every scoring of it. On a dataset
sharded over ranks, `transform` scores this rank's rows with the (replicated
or assembled) model; `dataset.sharding.gather` brings the scores of all rows
together where they are needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import Features, SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout
from photon_ml_tpu_torch.evaluation.suite import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    random_effect_margins,
    row_sum,
)
from photon_ml_tpu_torch.ops import objective, sparse_kernels
from photon_ml_tpu_torch.ops.losses import mean_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class CoordinateScoringSpec:
    """What scoring one coordinate on a fresh dataset needs: the feature
    shard's name (the original shard, as incoming datasets name it), the
    normalization, and for a random effect its id tag, training-time entity
    index and projector."""

    shard: str
    norm: Optional[NormalizationContext] = None  # or a PerEntityNormalization
    random_effect_type: Optional[str] = None
    entity_index: Optional[Dict[object, int]] = None
    projector: Optional[object] = None

    @property
    def is_random_effect(self) -> bool:
        return self.random_effect_type is not None


def dense_margins(features: Tensor, w: Tensor, norm: Optional[NormalizationContext],
                  reduce: Callable[[Tensor], Tensor] = row_sum) -> Tensor:
    """Row-stable dense margins: multiply-broadcast and `reduce`: `row_sum`,
    whose order depends on the width alone, so a row scores to the same bits
    in a serving bucket of any size as in a whole dataset (the training
    path passes `library_row_sum`). bf16 features are widened to f32 first."""
    w_eff, shift = objective.margin_params(w, norm)
    X = features if features.dtype == w_eff.dtype else features.to(w_eff.dtype)
    return reduce(X * w_eff) + shift


def fixed_effect_margins(features, w: Tensor, norm: Optional[NormalizationContext],
                         reduce: Callable[[Tensor], Tensor] = row_sum) -> Tensor:
    """A fixed effect's margins over a dense matrix (rows reduced by
    `reduce`) or a sparse layout."""
    if isinstance(features, SparseLayout):
        w_eff, shift = objective.margin_params(w, norm)
        return sparse_kernels.matvec(features, w_eff) + shift
    return dense_margins(features, w, norm, reduce)


@dataclasses.dataclass
class PreparedCoordinateData:
    """One coordinate's scoring view of one dataset: the features it scores
    (a fixed effect's dense matrix or sparse layout; a random effect's
    projected shard) and, for a random effect, each sample's entity row."""

    features: Features
    entity_rows: Optional[Tensor]


def entity_rows_for_dataset(dataset: GameDataset, spec: CoordinateScoringSpec) -> Tensor:
    """Per-sample coefficient rows through the training entity index, on the
    dataset's device; unseen entities get the pinned zero row. Resolved
    over the tag's value table (`tag_codes`), then gathered by code. Entity
    keys that are strings in the index resolve numeric tags through str()."""
    codes, table = dataset.tag_codes[spec.random_effect_type]
    index = spec.entity_index
    unseen = len(index)
    coerce = bool(index) and isinstance(next(iter(index)), str) and table.dtype.kind not in "USO"
    table_rows = np.fromiter(
        (index.get(str(k) if coerce else k, unseen) for k in table.tolist()),
        np.int64,
        count=len(table),
    )
    dev = dataset.device
    return torch.as_tensor(table_rows).to(dev)[torch.as_tensor(codes).to(dev)]


def prepare_coordinate_data(spec: CoordinateScoringSpec, dataset: GameDataset) -> PreparedCoordinateData:
    """Once per (coordinate, dataset): a fixed effect's scoring features, or
    a random effect's entity rows and its shard through the projector."""
    features = dataset.shards[spec.shard]
    if not spec.is_random_effect:
        if isinstance(features, SparseFeatures):
            features = dataset.sparse_layout(spec.shard)
        return PreparedCoordinateData(features, None)
    rows = entity_rows_for_dataset(dataset, spec)
    if spec.projector is not None:
        features = spec.projector.project_features(features, rows)
    return PreparedCoordinateData(features, rows)


def coordinate_margins(spec: CoordinateScoringSpec, model, prepared: PreparedCoordinateData) -> Tensor:
    """One coordinate's margins over prepared data (no offsets)."""
    if spec.is_random_effect:
        if not isinstance(model, RandomEffectModel):
            raise TypeError(f"random-effect spec needs a RandomEffectModel, got {type(model)}")
        return random_effect_margins(prepared.features, prepared.entity_rows,
                                     model.coefficients_matrix, spec.norm)
    if not isinstance(model, FixedEffectModel):
        raise TypeError(f"fixed-effect spec needs a FixedEffectModel, got {type(model)}")
    return fixed_effect_margins(prepared.features, model.coefficients.means, spec.norm)


@dataclasses.dataclass
class TransformResult:
    scores: Tensor  # summed margins, offsets included
    means: Tensor  # link-function mean response
    per_coordinate: Dict[str, Tensor]


class GameTransformer:
    """Scores GameDatasets with a trained GAME model; `specs` covers every
    coordinate of the model."""

    def __init__(self, model: GameModel, specs: Mapping[str, CoordinateScoringSpec],
                 task: TaskType):
        missing = [c for c in model.coordinate_ids if c not in specs]
        if missing:
            raise ValueError(f"No scoring spec for coordinates {missing}")
        self.model = model
        self.specs = dict(specs)
        self.task = task

    def prepare(self, dataset: GameDataset) -> Dict[str, PreparedCoordinateData]:
        """Every coordinate's scoring view of `dataset`; pass it to
        `transform` when scoring the same dataset again."""
        return {cid: prepare_coordinate_data(self.specs[cid], dataset)
                for cid in self.model.coordinate_ids}

    def transform(self, dataset: GameDataset,
                  prepared: Optional[Dict[str, PreparedCoordinateData]] = None) -> TransformResult:
        """Summed margins plus offsets, and the task's mean response."""
        if prepared is None:
            prepared = self.prepare(dataset)
        per_coordinate = {
            cid: coordinate_margins(self.specs[cid], self.model[cid], prepared[cid])
            for cid in self.model.coordinate_ids
        }
        total = dataset.offsets
        for s in per_coordinate.values():
            total = total + s
        return TransformResult(total, mean_for_task(self.task, total), per_coordinate)

    def evaluate(self, dataset: GameDataset, suite: EvaluationSuite,
                 prepared: Optional[Dict[str, PreparedCoordinateData]] = None) -> EvaluationResults:
        return suite.evaluate(self.transform(dataset, prepared).scores)
