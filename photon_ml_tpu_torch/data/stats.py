"""Per-feature summary statistics.

Port of `photon_ml_tpu/data/stats.py`: count, mean, variance, nonzeros,
max, min, L1 and L2 norms and mean |x| per feature, unweighted, feeding the
normalization contexts (ops/normalization.py). The sums are taken in
float64 and the results returned in float32: the reference's float32 sums
lose the low bits of the variance to cancellation (sum x^2 - n mean^2), and
float64 keeps the port's factors within `PORT_TOLERANCES["stats"]` of the
exact ones, which is where the reference's are too. A sparse shard is
summarized from its ELL planes without densifying: absent entries are
zeros, and min/max count an implicit zero wherever a feature misses a row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from photon_ml_tpu_torch.data.containers import Features, SparseFeatures

Tensor = torch.Tensor


class FeatureDataStatistics(NamedTuple):
    count: Tensor  # scalar: number of rows
    mean: Tensor  # (D,)
    variance: Tensor  # (D,), the unbiased (n - 1) sample variance
    num_nonzeros: Tensor  # (D,)
    max: Tensor  # (D,)
    min: Tensor  # (D,)
    norm_l1: Tensor  # (D,)
    norm_l2: Tensor  # (D,)
    mean_abs: Tensor  # (D,)
    intercept_index: Optional[int] = None

    @property
    def max_abs(self) -> Tensor:
        return torch.maximum(self.max.abs(), self.min.abs())


def summarize(features: Features, *, intercept_index: Optional[int] = None) -> FeatureDataStatistics:
    """The summary of a dense (N, D) tensor or an ELL shard."""
    if isinstance(features, SparseFeatures):
        stats = sparse_summary_arrays(features.indices, features.values, features.dim)
        return stats._replace(intercept_index=intercept_index)
    X = features.to(torch.float64)
    n = X.shape[0]
    f32 = lambda t: t.to(torch.float32)
    mean = X.mean(dim=0)
    var = ((X - mean) ** 2).sum(dim=0) / max(n - 1, 1)
    return FeatureDataStatistics(
        count=torch.tensor(float(n), dtype=torch.float32, device=X.device),
        mean=f32(mean),
        variance=f32(var),
        num_nonzeros=f32((X != 0.0).sum(dim=0)),
        max=f32(X.amax(dim=0)),
        min=f32(X.amin(dim=0)),
        norm_l1=f32(X.abs().sum(dim=0)),
        norm_l2=f32(torch.sqrt((X * X).sum(dim=0))),
        mean_abs=f32(X.abs().mean(dim=0)),
        intercept_index=intercept_index,
    )


def sparse_summary_arrays(indices: Tensor, values: Tensor, dim: int) -> FeatureDataStatistics:
    """The summary over raw (N, K) ELL planes; padding entries (value 0)
    drop out of every sum and of the nonzero max/min."""
    n = int(indices.shape[0])
    dev = values.device
    idx = indices.reshape(-1).long()
    val = values.reshape(-1).to(torch.float64)
    nonzero = val != 0.0

    def seg(v: Tensor) -> Tensor:
        return torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(0, idx, v)

    sum_x, sum_x2, sum_abs = seg(val), seg(val * val), seg(val.abs())
    nnz = seg(nonzero.to(torch.float64))
    neg_inf = torch.full((dim,), float("-inf"), dtype=torch.float64, device=dev)
    max_nz = neg_inf.scatter_reduce(0, idx, torch.where(nonzero, val, float("-inf")), "amax")
    min_nz = -neg_inf.scatter_reduce(0, idx, torch.where(nonzero, -val, float("-inf")), "amax")
    has_implicit_zero, has_nz = nnz < n, nnz > 0
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    maximum = torch.where(has_nz, torch.where(has_implicit_zero, torch.maximum(max_nz, zero), max_nz), zero)
    minimum = torch.where(has_nz, torch.where(has_implicit_zero, torch.minimum(min_nz, zero), min_nz), zero)
    mean = sum_x / n
    var = torch.clamp_min((sum_x2 - n * mean * mean) / max(n - 1, 1), 0.0)
    f32 = lambda t: t.to(torch.float32)
    return FeatureDataStatistics(
        count=torch.tensor(float(n), dtype=torch.float32, device=dev),
        mean=f32(mean),
        variance=f32(var),
        num_nonzeros=f32(nnz),
        max=f32(maximum),
        min=f32(minimum),
        norm_l1=f32(sum_abs),
        norm_l2=f32(torch.sqrt(sum_x2)),
        mean_abs=f32(sum_abs / n),
    )
