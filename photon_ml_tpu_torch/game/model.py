"""GAME model containers.

Port of the single-device part of `photon_ml_tpu/game/model.py`: a fixed
effect is one coefficient vector; a random effect is one dense
(num_entities + 1, D) coefficient matrix whose last row is pinned to zero
and scores entities unseen at training time; a GameModel maps coordinate ids
to models. Scoring sums per-coordinate margins over one shared sample axis.
On a rank (parallel/mesh.py) that axis is the rank's own rows, and a random
effect's model is the rank's store, its own entities' rows and the pinned
row: the counterpart of the JAX package's `random_effect_margins_sharded`
(:99) needs no collective, because no rank scores another rank's entities.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from photon_ml_tpu_torch.data.containers import Features, SparseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    means: Tensor
    variances: Optional[Tensor] = None


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    coefficients: Coefficients
    task: TaskType


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Row e holds entity e's coefficients; the last row is the pinned zero
    row. On a rank, the rows are those of its store (RandomEffectDataset.
    owned_entities)."""

    coefficients_matrix: Tensor  # (E + 1, D); on a rank (entities owned + 1, D)
    variances_matrix: Optional[Tensor]
    task: TaskType


def random_effect_margins(
    features: Features,
    entity_rows: Tensor,
    matrix: Tensor,
    norm: Optional[NormalizationContext],
) -> Tensor:
    """Per-sample margins: gather each sample's coefficient row and reduce
    per row (batch-size invariant, unlike a batched matmul), with
    normalization folded into the rows once (a global context, or a
    projected shard's per-entity one: a row of factors and shifts per
    coefficient row). Over an ELL shard the margin
    of sample i is sum_k values[i, k] matrix[entity_rows[i], indices[i, k]]:
    a gather of the coefficients the row names, with no scatter, so it is
    deterministic on the card as on the CPU."""
    shift = None
    if norm is not None and not norm.is_identity:
        matrix = norm.effective_coefficients(matrix)
        if norm.shifts is not None:
            shift = -torch.sum(matrix * norm.shifts, dim=-1)  # (E + 1,)
    if isinstance(features, SparseFeatures):
        coef = matrix[entity_rows[:, None], features.indices.long()]
        out = torch.sum(features.values.to(matrix.dtype) * coef, dim=-1)
    else:
        X = features if features.dtype == matrix.dtype else features.to(matrix.dtype)
        out = torch.sum(X * matrix[entity_rows], dim=-1)
    if shift is not None:
        out = out + shift[entity_rows]
    return out


@dataclasses.dataclass
class GameModel:
    """coordinate id -> model."""

    models: Dict[str, object]

    def __getitem__(self, cid: str):
        return self.models[cid]

    def __contains__(self, cid: str) -> bool:
        return cid in self.models

    @property
    def coordinate_ids(self):
        return list(self.models.keys())
