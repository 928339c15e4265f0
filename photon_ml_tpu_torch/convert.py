"""Carry a trained GAME model across from numpy arrays.

`game_model_from_numpy` builds the port's `GameModel` and its scoring specs
from plain numpy arrays: a model trained by the JAX package, exported with
`np.asarray` on its fields by the caller (this module imports nothing of
that package). Per coordinate it carries the fixed-effect means, or the
random-effect coefficient matrix with its pinned zero row and the entity
index, plus the normalization factors and shifts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import optional_tensor
from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.game.model import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass
class FixedEffectArrays:
    shard: str
    means: np.ndarray  # (D,)
    factors: Optional[np.ndarray] = None
    shifts: Optional[np.ndarray] = None
    intercept_index: Optional[int] = None


@dataclasses.dataclass
class RandomEffectArrays:
    shard: str
    random_effect_type: str
    matrix: np.ndarray  # (E + 1, D); row E is the pinned zero row
    entity_index: Mapping[object, int]  # entity key -> row in [0, E)
    factors: Optional[np.ndarray] = None
    shifts: Optional[np.ndarray] = None


CoordinateArrays = Union[FixedEffectArrays, RandomEffectArrays]


def _norm(arrays: CoordinateArrays, device: torch.device) -> Optional[NormalizationContext]:
    if arrays.factors is None and arrays.shifts is None:
        return None
    return NormalizationContext(
        optional_tensor(arrays.factors, device),
        optional_tensor(arrays.shifts, device),
        getattr(arrays, "intercept_index", None),
    )


def _check_random_effect(cid: str, re: RandomEffectArrays) -> None:
    e = len(re.entity_index)
    if re.matrix.ndim != 2 or re.matrix.shape[0] != e + 1:
        raise ValueError(
            f"{cid}: matrix must be ({e} + 1, D) for {e} entities, got {re.matrix.shape}"
        )
    if sorted(re.entity_index.values()) != list(range(e)):
        raise ValueError(f"{cid}: entity_index rows must be a permutation of 0..{e - 1}")
    if np.any(re.matrix[e] != 0):
        raise ValueError(f"{cid}: row {e} (the unseen-entity row) must be zero")


def game_model_from_numpy(
    coordinates: Mapping[str, CoordinateArrays],
    task: TaskType,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[GameModel, Dict[str, CoordinateScoringSpec]]:
    """(GameModel, scoring specs) for `GameTransformer`, on `device`."""
    dev = resolve_device(device)
    models: Dict[str, object] = {}
    specs: Dict[str, CoordinateScoringSpec] = {}
    for cid, arrays in coordinates.items():
        norm = _norm(arrays, dev)
        if isinstance(arrays, FixedEffectArrays):
            means = torch.tensor(np.asarray(arrays.means, np.float32), device=dev)
            models[cid] = FixedEffectModel(Coefficients(means), task)
            specs[cid] = CoordinateScoringSpec(arrays.shard, norm)
        elif isinstance(arrays, RandomEffectArrays):
            _check_random_effect(cid, arrays)
            matrix = torch.tensor(np.asarray(arrays.matrix, np.float32), device=dev)
            models[cid] = RandomEffectModel(matrix, None, task)
            specs[cid] = CoordinateScoringSpec(
                arrays.shard, norm, arrays.random_effect_type, dict(arrays.entity_index)
            )
        else:
            raise TypeError(f"{cid}: unsupported coordinate arrays {type(arrays).__name__}")
    return GameModel(models), specs
