"""Feature normalization as coefficient algebra.

Port of `photon_ml_tpu/ops/normalization.py` for the identity transform and
STANDARDIZATION (and the factor-only scalings): training never rewrites the
data. For x' = (x - shift) * factor, margins over the raw data are

    z = x . (w * factor) - shift . (w * factor)

so normalization costs one elementwise product of the coefficients per
objective evaluation. Per-entity (projected) contexts are not ported yet.
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
