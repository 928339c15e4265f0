"""Carry a trained GAME model and sparse features across from numpy arrays.

`game_model_from_numpy` builds the port's `GameModel` and its scoring specs
from plain numpy arrays: a model trained by the JAX package, exported with
`np.asarray` on its fields by the caller (this module imports nothing of
that package). Per coordinate it carries the fixed-effect means and
variances, or the random-effect coefficient matrix with its pinned zero row
and the entity index, plus the normalization factors and shifts. A random
effect trained over a sparse shard carries over the same way: its (E + 1,
D) matrix over the shard's full width, rows in the JAX entity order (the
sorted order of the id-tag strings), scored by the port from the ELL
planes. A random effect trained in a projected space carries its projector
(an index map's slot tables, or a random projection's matrix) and its
matrix in that space, its variances, and a per-entity normalization's
(E + 1, D_proj) factors, shifts and intercept slots. The port cannot redraw
the reference's jax.random bits, so a random projection crosses over as its
matrix. `sparse_features_from_numpy` takes the JAX package's
`SparseFeatures` as its numpy planes into the port's.
`fit_state_from_numpy` carries a JAX refresh state (`FitState`: the model,
its entity indices, the fingerprints recomputed here) across, so a port
refresh round continues from a JAX fit.
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
from photon_ml_tpu_torch.game.projector import IndexMapProjector, RandomProjector
from photon_ml_tpu_torch.ops.normalization import NormalizationContext, PerEntityNormalization
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
    """`matrix` is in the projected space when a projector is given: an
    index map's `slot_tables` (E + 1, D_proj) with its `original_dim`, or a
    random projection's `projection_matrix` (D, d). `factors`/`shifts` are
    (D,) for a global context; with `intercept_slots` they are a per-entity
    normalization's (E + 1, D_proj) rows."""

    shard: str
    random_effect_type: str
    matrix: np.ndarray  # (E + 1, D); row E is the pinned zero row
    entity_index: Mapping[object, int]  # entity key -> row in [0, E)
    factors: Optional[np.ndarray] = None
    shifts: Optional[np.ndarray] = None
    variances: Optional[np.ndarray] = None  # like matrix
    slot_tables: Optional[np.ndarray] = None
    original_dim: Optional[int] = None
    projection_matrix: Optional[np.ndarray] = None
    intercept_slots: Optional[np.ndarray] = None


CoordinateArrays = Union[FixedEffectArrays, RandomEffectArrays]


def _norm(arrays: CoordinateArrays, device: torch.device):
    if arrays.factors is None and arrays.shifts is None:
        return None
    if getattr(arrays, "intercept_slots", None) is not None or (
            arrays.factors is not None and np.ndim(arrays.factors) == 2):
        return per_entity_normalization_from_numpy(arrays.factors, arrays.shifts,
                                                   getattr(arrays, "intercept_slots", None),
                                                   device=device)
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
            variances = None
            if arrays.variances is not None:
                variances = torch.tensor(np.asarray(arrays.variances, np.float32), device=dev)
                if variances.shape != matrix.shape:
                    raise ValueError(f"{cid}: variances {tuple(variances.shape)} do not match "
                                     f"the matrix {tuple(matrix.shape)}")
            projector = None
            if arrays.slot_tables is not None:
                projector = index_map_projector_from_numpy(arrays.slot_tables, arrays.original_dim,
                                                           device=dev)
            elif arrays.projection_matrix is not None:
                projector = random_projector_from_numpy(arrays.projection_matrix, device=dev)
            if projector is not None and projector.projected_dim != matrix.shape[1]:
                raise ValueError(f"{cid}: the projector's width {projector.projected_dim} is not "
                                 f"the matrix's {matrix.shape[1]}")
            models[cid] = RandomEffectModel(matrix, variances, task)
            specs[cid] = CoordinateScoringSpec(
                arrays.shard, norm, arrays.random_effect_type, dict(arrays.entity_index), projector
            )
        else:
            raise TypeError(f"{cid}: unsupported coordinate arrays {type(arrays).__name__}")
    return GameModel(models), specs


def fit_state_from_numpy(
    coordinates: Mapping[str, CoordinateArrays],
    task: TaskType,
    dataset,
    data_configs: Mapping[str, object],
    *,
    device: DeviceLike = "cuda",
):
    """The port's refresh state (`game.incremental.FitState`) of a fit the
    JAX package made, so a port refresh round continues from it: the
    models and each random effect's entity index as `game_model_from_numpy`
    carries them (`coordinates` in the order of `data_configs`), and the
    data fingerprints recomputed by the port from `dataset` (the port's
    copy of the rows that fit trained on). The digests hash the same bytes
    as the reference's, so on the same planes in the same dtypes they equal
    the JAX fit's byte for byte."""
    from photon_ml_tpu_torch.data.fingerprints import fingerprint_dataset
    from photon_ml_tpu_torch.game.incremental import FitState

    model, _ = game_model_from_numpy(coordinates, task, device=device)
    indices = {cid: dict(a.entity_index) if isinstance(a, RandomEffectArrays) else None
               for cid, a in coordinates.items()}
    return FitState(model, fingerprint_dataset(dataset, data_configs), indices)


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


def index_map_projector_from_numpy(slot_tables: np.ndarray, original_dim: int, *,
                                   device: DeviceLike = "cuda") -> IndexMapProjector:
    """The port's index-map projector from the reference's (E + 1, D_proj)
    slot tables (-1 = padding; each valid row prefix increasing)."""
    tables = np.asarray(slot_tables)
    if tables.ndim != 2 or original_dim is None:
        raise ValueError(f"slot tables must be (E + 1, D_proj) with an original_dim, got {tables.shape}")
    if tables.size and (tables.max() >= original_dim or tables.min() < -1):
        raise ValueError("slot tables name features outside [0, original_dim) or padding other than -1")
    valid = tables >= 0
    if np.any(valid[:, 1:] & ~valid[:, :-1]) or np.any(np.diff(tables, axis=1)[valid[:, 1:]] <= 0):
        raise ValueError("each slot table row must list increasing features, then padding")
    return IndexMapProjector(torch.tensor(tables.astype(np.int64), device=resolve_device(device)),
                             int(original_dim))


def random_projector_from_numpy(matrix: np.ndarray, *, device: DeviceLike = "cuda") -> RandomProjector:
    """A random projection from its (D, d) matrix."""
    p = np.asarray(matrix, np.float32)
    if p.ndim != 2:
        raise ValueError(f"a projection matrix is (D, d), got {p.shape}")
    return RandomProjector(torch.tensor(p, device=resolve_device(device)))


def per_entity_normalization_from_numpy(factors: Optional[np.ndarray], shifts: Optional[np.ndarray],
                                        intercept_slots: Optional[np.ndarray], *,
                                        device: DeviceLike = "cuda") -> PerEntityNormalization:
    """A per-entity normalization from its (E + 1, D_proj) rows and (E + 1,)
    intercept slots (-1: none)."""
    dev = resolve_device(device)
    if shifts is not None and intercept_slots is None:
        raise ValueError("Per-entity shifts require intercept slots")
    slots = None if intercept_slots is None else torch.tensor(np.asarray(intercept_slots, np.int64), device=dev)
    return PerEntityNormalization(optional_tensor(factors, dev), optional_tensor(shifts, dev), slots)
