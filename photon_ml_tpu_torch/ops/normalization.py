"""Feature normalization as coefficient algebra.

Port of `photon_ml_tpu/ops/normalization.py` for the identity transform and
STANDARDIZATION (and the factor-only scalings): training never rewrites the
data. For x' = (x - shift) * factor, margins over the raw data are

    z = x . (w * factor) - shift . (w * factor)

so normalization costs one elementwise product of the coefficients per
objective evaluation. The batched objective takes a context whose factors
and shifts are (E, D), one row per lane: a random-effect bucket in a
projected space gets its entities' rows of a `PerEntityNormalization`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from photon_ml_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


class NormalizationContext(NamedTuple):
    """Affine transform x' = (x - shifts) * factors; None fields = identity.
    The intercept column, if any, has factor 1 and shift 0."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def effective_coefficients(self, w: Tensor) -> Tensor:
        """w * factors (rank-generic over leading batch axes)."""
        return w if self.factors is None else w * self.factors

    def margin_shift(self, w: Tensor) -> Tensor:
        """-shifts . (w * factors), one scalar per problem in the batch."""
        if self.shifts is None:
            return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
        return -torch.sum(self.shifts * self.effective_coefficients(w), dim=-1)

    def model_to_original_space(self, w: Tensor) -> Tensor:
        """Coefficients trained in normalized space -> original space; the
        shift contribution folds into the intercept."""
        if self.is_identity:
            return w
        w_orig = self.effective_coefficients(w)
        if self.shifts is not None:
            if self.intercept_index is None:
                raise ValueError("Normalization with shifts requires an intercept")
            w_orig = w_orig.clone()
            w_orig[self.intercept_index] -= torch.dot(self.shifts, w_orig)
        return w_orig

    def to(self, device) -> "NormalizationContext":
        move = lambda t: None if t is None else t.to(device)
        return NormalizationContext(move(self.factors), move(self.shifts), self.intercept_index)


def no_normalization() -> NormalizationContext:
    return NormalizationContext(None, None, None)


def from_feature_stats(
    norm_type: NormalizationType,
    *,
    mean: Tensor,
    variance: Tensor,
    max_abs: Tensor,
    intercept_index: Optional[int] = None,
) -> NormalizationContext:
    """SCALE_WITH_STANDARD_DEVIATION: factor 1/std; SCALE_WITH_MAX_MAGNITUDE:
    factor 1/max|x|; STANDARDIZATION: factor 1/std, shift mean. Zero std or
    max gets factor 1; the intercept column is exempt."""
    if norm_type == NormalizationType.NONE:
        return no_normalization()
    std = torch.sqrt(variance)
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = _safe_inv(std), None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = _safe_inv(max_abs), None
    elif norm_type == NormalizationType.STANDARDIZATION:
        if intercept_index is None:
            raise ValueError("STANDARDIZATION requires an intercept column")
        factors, shifts = _safe_inv(std), mean.clone()
    else:
        raise ValueError(f"Unknown normalization type {norm_type}")
    if intercept_index is not None:
        factors = factors.clone()
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    return NormalizationContext(factors, shifts, intercept_index)


def _safe_inv(x: Tensor) -> Tensor:
    pos = x > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)), torch.ones_like(x))


class PerEntityNormalization(NamedTuple):
    """The global context mapped into every entity's projected slots
    (`project_normalization`): factors[e, j] = global_factors[slot_tables[e, j]]
    and likewise shifts, as (E + 1, D_proj) matrices, with padding slots at
    (factor 1, shift 0). `intercept_slots[e]` is entity e's local slot of the
    global intercept (-1 where it has none)."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_slots: Optional[Tensor] = None  # (E + 1,) int64

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def rows_context(self, entity_rows: Tensor) -> NormalizationContext:
        """The context of a bucket's lanes: one (factors, shifts) row each.
        The intercept index plays no part in the objective's algebra."""
        take = lambda t: None if t is None else t[entity_rows]
        return NormalizationContext(take(self.factors), take(self.shifts), None)

    def effective_coefficients(self, matrix: Tensor) -> Tensor:
        """(E + 1, D_proj) coefficients -> effective (factor-folded) ones."""
        return matrix if self.factors is None else matrix * self.factors

    def _fold_intercept(self, m: Tensor, fold: Tensor) -> Tensor:
        if self.intercept_slots is None:
            raise ValueError("Per-entity shifts require intercept slots")
        rows = torch.arange(m.shape[0], device=m.device)
        add = torch.where(self.intercept_slots >= 0, fold, torch.zeros_like(fold))
        return m.index_put((rows, self.intercept_slots.clamp_min(0)), add, accumulate=True)

    def matrix_to_original_space(self, matrix: Tensor, variances: Optional[Tensor] = None):
        """Row-wise `model_to_original_space` over the entity axis; the
        variances scale by factor^2."""
        if self.is_identity:
            return matrix, variances
        m = self.effective_coefficients(matrix)
        if self.shifts is not None:
            m = self._fold_intercept(m, -torch.sum(self.shifts * m, dim=1))
        if variances is not None and self.factors is not None:
            variances = variances * self.factors * self.factors
        return m, variances

    def matrix_to_transformed_space(self, matrix: Tensor) -> Tensor:
        """Row-wise inverse of `matrix_to_original_space` (the warm-start
        direction)."""
        if self.is_identity:
            return matrix
        m = matrix
        if self.shifts is not None:
            m = self._fold_intercept(m, torch.sum(self.shifts * matrix, dim=1))
        return m / self.factors if self.factors is not None else m

    def to(self, device) -> "PerEntityNormalization":
        move = lambda t: None if t is None else t.to(device)
        return PerEntityNormalization(move(self.factors), move(self.shifts), move(self.intercept_slots))


def project_normalization(norm: NormalizationContext, slot_tables: Tensor) -> PerEntityNormalization:
    """Map a global context through per-entity index tables ((E + 1, D_proj)
    global indices, -1 = padding) into a `PerEntityNormalization`."""
    cols = slot_tables.clamp_min(0)
    pad = slot_tables < 0
    factors = shifts = intercept_slots = None
    if norm.factors is not None:
        factors = norm.factors.to(slot_tables.device)[cols].masked_fill(pad, 1.0)
    if norm.shifts is not None:
        if norm.intercept_index is None:
            raise ValueError("Normalization with shifts requires an intercept")
        shifts = norm.shifts.to(slot_tables.device)[cols].masked_fill(pad, 0.0)
        hits = slot_tables == norm.intercept_index
        intercept_slots = torch.where(hits.any(dim=1), hits.long().argmax(dim=1),
                                      torch.full_like(slot_tables[:, 0], -1))
    return PerEntityNormalization(factors, shifts, intercept_slots)
