"""Carry a trained GAME model and sparse features across from numpy arrays.

`game_model_from_numpy` builds the port's `GameModel` and its scoring specs
from plain numpy arrays: a model trained by the JAX package, exported with
`np.asarray` on its fields by the caller (this module imports nothing of
that package). Per coordinate it carries the fixed-effect means and
variances, or the random-effect coefficient matrix with its pinned zero row
and the entity index, plus the normalization factors and shifts.
`sparse_features_from_numpy` takes the JAX package's `SparseFeatures` as its
numpy planes into the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures, optional_tensor
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
    variances: Optional[np.ndarray] = None  # (D,)
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
            variances = None
            if arrays.variances is not None:
                variances = torch.tensor(np.asarray(arrays.variances, np.float32), device=dev)
                if variances.shape != means.shape:
                    raise ValueError(f"{cid}: variances {tuple(variances.shape)} do not match "
                                     f"means {tuple(means.shape)}")
            models[cid] = FixedEffectModel(Coefficients(means, variances), task)
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


def sparse_features_from_numpy(
    indices: np.ndarray,
    values: np.ndarray,
    dim: int,
    *,
    device: DeviceLike = "cuda",
) -> SparseFeatures:
    """The port's ELL features from the (N, K) numpy planes of the JAX
    package's standard layout (`ell_axis=-1`)."""
    idx, val = np.asarray(indices), np.asarray(values)
    if idx.ndim != 2 or idx.shape != val.shape:
        raise ValueError(f"indices {idx.shape} and values {val.shape} must be one (N, K) shape")
    dev = resolve_device(device)
    return SparseFeatures(
        torch.tensor(np.ascontiguousarray(idx, np.int32), device=dev),
        torch.tensor(np.ascontiguousarray(val, np.float32), device=dev),
        int(dim),
    )
