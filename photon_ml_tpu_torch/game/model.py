"""GAME model containers.

Port of the single-device part of `photon_ml_tpu/game/model.py`: a fixed
effect is one coefficient vector; a random effect is one dense
(num_entities + 1, D) coefficient matrix whose last row is pinned to zero
and scores entities unseen at training time; a GameModel maps coordinate ids
to models. Scoring sums per-coordinate margins over one shared sample axis.
A shard group's random effect holds its matrices as RowShardedMatrix
blocks over the group's cards; `RandomEffectModel.on_device` gives their
exact (E + 1, D) rows on one device.
On a rank (parallel/mesh.py) that axis is the rank's own rows, and a random
effect's model is the rank's store, its own entities' rows and the pinned
row: the counterpart of the JAX package's `random_effect_margins_sharded`
(:99) needs no collective, because no rank scores another rank's entities.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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

    def on_device(self, device) -> "RandomEffectModel":
        """This model with (E + 1, D) tensors on `device`: a
        RowShardedMatrix (a shard group's store, parallel/mesh.py) gives its
        logical rows, copied block by block from its cards (exact), a
        tensor is moved."""
        from photon_ml_tpu_torch.parallel.mesh import RowShardedMatrix

        def rows(m):
            if m is None or not isinstance(m, RowShardedMatrix):
                return None if m is None else m.to(device)
            return torch.cat([b.to(device) for b in m.blocks])[:m.logical_rows]

        return RandomEffectModel(rows(self.coefficients_matrix), rows(self.variances_matrix),
                                 self.task)


def row_sum(P: Tensor) -> Tensor:
    """Sum over the last dimension in an order set by its width alone:
    zero-pad it to a power of two, then add the upper half onto the lower
    half until one column is left. Each step is an elementwise add, so a
    row's sum has the same bits however many rows ride along, on the card
    as on the CPU (the library reduction, `library_row_sum`, picks its split
    on the card from the number of rows too). Scoring (the transformer and
    the serving engine) reduces with it."""
    width = 1
    while width < P.shape[-1]:
        width <<= 1
    if width != P.shape[-1]:
        P = torch.nn.functional.pad(P, (0, width - P.shape[-1]))
    while width > 1:
        width >>= 1
        P = P[..., :width] + P[..., width:]
    return P[..., 0]


def library_row_sum(P: Tensor) -> Tensor:
    """The library's sum over the last dimension: the training path's row
    reduction (the coordinates' residual scores), whose bits the solvers'
    results and checkpoints were established on."""
    return torch.sum(P, dim=-1)


def random_effect_margins(
    features: Features,
    entity_rows: Tensor,
    matrix: Tensor,
    norm: Optional[NormalizationContext],
    reduce: Callable[[Tensor], Tensor] = row_sum,
) -> Tensor:
    """Per-sample margins: gather each sample's coefficient row and reduce
    it with `reduce` (`row_sum`, batch-size invariant, unlike a batched
    matmul; the training path passes `library_row_sum`), with
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
            shift = -reduce(matrix * norm.shifts)  # (E + 1,)
    if isinstance(features, SparseFeatures):
        coef = matrix[entity_rows[:, None], features.indices.long()]
        out = reduce(features.values.to(matrix.dtype) * coef)
    else:
        X = features if features.dtype == matrix.dtype else features.to(matrix.dtype)
        out = reduce(X * matrix[entity_rows])
    if shift is not None:
        out = out + shift[entity_rows]
    return out


def gathered_row_margins(features: Features, w_rows: Tensor, norm) -> Tensor:
    """Margins from per-sample coefficient rows already gathered (B, D):
    normalization folded per row, then `row_sum` (over an ELL shard, of the
    coefficients each row's entries name). The same bits as
    `random_effect_margins` over the same rows (folding before or after the
    gather is the same elementwise work), which is what keeps the serving
    engine's two-tier and row-sharded kinds, the transformer's row-sharded
    branch and the tenancy co-batch bit-equal to the single-tier matrix. A
    per-entity normalization is refused: its tables are indexed by
    entity."""
    from photon_ml_tpu_torch.ops.normalization import PerEntityNormalization

    if isinstance(norm, PerEntityNormalization) and not norm.is_identity:
        raise NotImplementedError("gathered-row margins with per-entity normalization: its "
                                  "factor/shift tables are entity-indexed; use the replicated path")
    shift = None
    if norm is not None and not norm.is_identity:
        w_rows = norm.effective_coefficients(w_rows)
        if norm.shifts is not None:
            shift = -row_sum(w_rows * norm.shifts)
    if isinstance(features, SparseFeatures):
        out = row_sum(features.values.to(w_rows.dtype) * w_rows.gather(1, features.indices.long()))
    else:
        X = features if features.dtype == w_rows.dtype else features.to(w_rows.dtype)
        out = row_sum(X * w_rows)
    if shift is not None:
        out = out + shift
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
