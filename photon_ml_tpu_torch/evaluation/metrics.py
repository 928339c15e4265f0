"""Weighted, mask-aware metrics.

Port of the global metrics of `photon_ml_tpu/evaluation/metrics.py`: AUC as
a tie-corrected rank statistic from one sort (equal to the weighted
trapezoid AUC), and the mean pointwise losses. A weight of 0 masks a row.
On ranks, `area_under_roc_curve_over_ranks` takes every rank's rows: AUC is
not a sum, so scores, labels and weights are first assembled exactly
(`RowSharding.gather`, parallel/mesh.py) and the AUC taken over all rows.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from photon_ml_tpu_torch.ops import losses

if TYPE_CHECKING:
    from photon_ml_tpu_torch.parallel.mesh import RowSharding

Tensor = torch.Tensor


def _weights(weights: Optional[Tensor], like: Tensor) -> Tensor:
    return torch.ones_like(like) if weights is None else weights.to(like.dtype)


def area_under_roc_curve(
    scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None
) -> Tensor:
    """AUC = sum over positives of (negative weight strictly below + half
    the tied negative weight), over W+ W-; 0.5 when a class is empty."""
    w = _weights(weights, scores)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    pos = torch.where(labels > 0.5, w, zero)
    neg = torch.where(labels > 0.5, zero, w)
    order = torch.argsort(scores, stable=True)
    s, p, ng = scores[order], pos[order], neg[order]
    n = s.shape[0]
    cneg = torch.cumsum(ng, dim=0)
    is_new = torch.ones(n, dtype=torch.bool, device=s.device)
    is_new[1:] = s[1:] > s[:-1]
    run_id = torch.cumsum(is_new.to(torch.int64), dim=0) - 1
    # Negative weight strictly below each run, and the run's own negatives.
    run_start = torch.where(is_new, cneg - ng, torch.full_like(ng, float("-inf")))
    below = torch.full((n,), float("-inf"), dtype=s.dtype, device=s.device)
    below = below.scatter_reduce(0, run_id, run_start, reduce="amax")[run_id]
    tied = torch.zeros((n,), dtype=s.dtype, device=s.device).index_add(0, run_id, ng)[run_id]
    num = torch.sum(p * (below + 0.5 * tied))
    denom = torch.sum(pos) * torch.sum(neg)
    return torch.where(denom > 0.0, num / denom, torch.full_like(num, 0.5))


def area_under_roc_curve_over_ranks(
    sharding: "RowSharding", scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None
) -> Tensor:
    """The AUC over every rank's rows, from this rank's (one collective;
    every rank calls it and gets the same value)."""
    cols = [scores, labels.to(scores.dtype)]
    if weights is not None:
        cols.append(weights.to(scores.dtype))
    g = sharding.gather(torch.stack(cols, dim=1))
    return area_under_roc_curve(g[:, 0], g[:, 1], None if weights is None else g[:, 2])


def _mean_pointwise(loss_fn, scores, labels, weights):
    w = _weights(weights, scores)
    return torch.sum(w * loss_fn(scores, labels)) / torch.clamp_min(torch.sum(w), 1e-30)


def rmse(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    w = _weights(weights, scores)
    mse = torch.sum(w * (scores - labels) ** 2) / torch.clamp_min(torch.sum(w), 1e-30)
    return torch.sqrt(mse)


def logistic_loss(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    return _mean_pointwise(losses.LOGISTIC.loss, scores, labels, weights)


def poisson_loss(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    return _mean_pointwise(losses.POISSON.loss, scores, labels, weights)


def squared_loss(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    return _mean_pointwise(losses.SQUARED.loss, scores, labels, weights)


def smoothed_hinge_loss(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    return _mean_pointwise(losses.SMOOTHED_HINGE.loss, scores, labels, weights)
