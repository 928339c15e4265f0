"""Batch scoring of a GAME model over a GameDataset.

Port of the scoring path of `photon_ml_tpu/transformers/game_transformer.py`:
dense fixed effects score with `dense_margins` (a per-row reduction, not a
matvec, so a row's score does not depend on how many rows ride along);
sparse fixed effects score through the sparse layout's matvec (its CUDA
kernel on the card; a row's sum is over its own entries only, so it is
batch-invariant too); random effects map each sample's entity key through
the training-time entity index (unseen entities -> the pinned zero row) and
gather coefficient rows (over a sparse shard, the coefficients each row's
ELL entries name, from the planes themselves). Projectors are not ported
yet. On a dataset
sharded over ranks, `transform` scores this rank's rows with the (replicated
or assembled) model; `dataset.sharding.gather` brings the scores of all rows
together where they are needed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    random_effect_margins,
)
from photon_ml_tpu_torch.ops import objective, sparse_kernels
from photon_ml_tpu_torch.ops.losses import mean_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class CoordinateScoringSpec:
    """What scoring one coordinate on a fresh dataset needs: the feature
    shard's name, the normalization, and for a random effect its id tag and
    training-time entity index."""

    shard: str
    norm: Optional[NormalizationContext] = None
    random_effect_type: Optional[str] = None
    entity_index: Optional[Dict[object, int]] = None

    @property
    def is_random_effect(self) -> bool:
        return self.random_effect_type is not None


def dense_margins(features: Tensor, w: Tensor, norm: Optional[NormalizationContext]) -> Tensor:
    """Row-stable dense margins: multiply-broadcast and a per-row sum.
    bf16 features are widened to f32 first."""
    w_eff, shift = objective.margin_params(w, norm)
    X = features if features.dtype == w_eff.dtype else features.to(w_eff.dtype)
    return torch.sum(X * w_eff, dim=-1) + shift


def fixed_effect_margins(features, w: Tensor, norm: Optional[NormalizationContext]) -> Tensor:
    """A fixed effect's margins over a dense matrix or a sparse layout."""
    if isinstance(features, SparseLayout):
        w_eff, shift = objective.margin_params(w, norm)
        return sparse_kernels.matvec(features, w_eff) + shift
    return dense_margins(features, w, norm)


def entity_rows_for_dataset(dataset: GameDataset, spec: CoordinateScoringSpec) -> np.ndarray:
    """Per-sample coefficient rows through the training entity index;
    unseen entities get the pinned zero row. Entity keys that are strings in
    the index resolve numeric tags through str()."""
    keys = dataset.id_tags[spec.random_effect_type]
    index = spec.entity_index
    unseen = len(index)
    coerce = bool(index) and isinstance(next(iter(index)), str) and keys.dtype.kind not in "USO"
    uniq, inv = np.unique(keys, return_inverse=True)
    uniq_rows = np.fromiter(
        (index.get(str(k) if coerce else k, unseen) for k in uniq.tolist()),
        np.int64,
        count=len(uniq),
    )
    return uniq_rows[inv.reshape(-1)]


def coordinate_margins(
    spec: CoordinateScoringSpec, model, features: Tensor, entity_rows: Optional[Tensor]
) -> Tensor:
    if spec.is_random_effect:
        if not isinstance(model, RandomEffectModel):
            raise TypeError(f"random-effect spec needs a RandomEffectModel, got {type(model)}")
        return random_effect_margins(features, entity_rows, model.coefficients_matrix, spec.norm)
    if not isinstance(model, FixedEffectModel):
        raise TypeError(f"fixed-effect spec needs a FixedEffectModel, got {type(model)}")
    return fixed_effect_margins(features, model.coefficients.means, spec.norm)


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

    def transform(self, dataset: GameDataset) -> TransformResult:
        per_coordinate = {}
        for cid in self.model.coordinate_ids:
            spec = self.specs[cid]
            rows = None
            if spec.is_random_effect:
                rows = torch.as_tensor(entity_rows_for_dataset(dataset, spec)).to(dataset.device)
            features = dataset.shards[spec.shard]
            if isinstance(features, SparseFeatures) and not spec.is_random_effect:
                features = dataset.sparse_layout(spec.shard)
            per_coordinate[cid] = coordinate_margins(spec, self.model[cid], features, rows)
        total = dataset.offsets
        for s in per_coordinate.values():
            total = total + s
        return TransformResult(total, mean_for_task(self.task, total), per_coordinate)
