"""Weighted, mask-aware metrics.

Port of `photon_ml_tpu/evaluation/metrics.py`: AUC as a tie-corrected rank
statistic from one sort (equal to the weighted trapezoid AUC), the area
under the precision-recall curve, RMSE, R^2, peak F1, the mean pointwise
losses and precision@k. A weight of 0 masks a row. AUC and precision@k
take a batch of padded groups too ((G, S) inputs, one value a group), which
is how the grouped evaluators (evaluation/suite.py) run them.
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
    the tied negative weight), over W+ W-; 0.5 when a class is empty.
    Over the last axis: (S,) gives a scalar, (G, S) one AUC a row."""
    w = _weights(weights, scores)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    pos = torch.where(labels > 0.5, w, zero)
    neg = torch.where(labels > 0.5, zero, w)
    order = torch.argsort(scores, dim=-1, stable=True)
    s, p, ng = (torch.gather(a, -1, order) for a in (scores, pos, neg))
    cneg = torch.cumsum(ng, dim=-1)
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[..., 1:] = s[..., 1:] > s[..., :-1]
    # Runs of tied scores, numbered across all rows at once (every row starts one).
    run_id = (torch.cumsum(is_new.reshape(-1).to(torch.int64), dim=0) - 1).view(s.shape)
    flat_id = run_id.reshape(-1)
    m = flat_id.shape[0]
    # Negative weight strictly below each run, and the run's own negatives.
    run_start = torch.where(is_new, cneg - ng, torch.full_like(ng, float("-inf"))).reshape(-1)
    below = torch.full((m,), float("-inf"), dtype=s.dtype, device=s.device)
    below = below.scatter_reduce(0, flat_id, run_start, reduce="amax")[run_id]
    tied = torch.zeros((m,), dtype=s.dtype, device=s.device).index_add(0, flat_id, ng.reshape(-1))[run_id]
    num = torch.sum(p * (below + 0.5 * tied), dim=-1)
    denom = torch.sum(pos, dim=-1) * torch.sum(neg, dim=-1)
    return torch.where(denom > 0.0, num / denom, torch.full_like(num, 0.5))


def area_under_pr_curve(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Weighted area under the precision-recall curve: the trapezoid over
    recall steps with (0, first precision) prepended (spark mllib's)."""
    w = _weights(weights, scores)
    order = torch.argsort(-scores, stable=True)
    lab = labels[order] > 0.5
    ww = w[order]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    tp = torch.cumsum(torch.where(lab, ww, zero), dim=0)
    fp = torch.cumsum(torch.where(lab, zero, ww), dim=0)
    total_pos = tp[-1]
    precision = torch.where(tp + fp > 0.0, tp / (tp + fp), torch.ones_like(tp))
    recall = torch.where(total_pos > 0.0, tp / total_pos, torch.zeros_like(tp))
    prev_recall = torch.cat([torch.zeros(1, dtype=recall.dtype, device=recall.device), recall[:-1]])
    prev_precision = torch.cat([precision[:1], precision[:-1]])
    area = torch.sum((recall - prev_recall) * 0.5 * (precision + prev_precision))
    return torch.where(total_pos > 0.0, area, zero)


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


def precision_at_k(k: int, scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Precision@k over the last axis: the positives among the k best-scored
    rows, over k (a group of fewer than k rows is not renormalized). Weights
    only mask rows (masked rows rank last)."""
    w = _weights(weights, scores)
    masked = torch.where(w > 0.0, scores, torch.full_like(scores, float("-inf")))
    topk = torch.argsort(-masked, dim=-1, stable=True)[..., :k]
    valid = torch.gather(w, -1, topk) > 0.0
    hits = valid & (torch.gather(labels, -1, topk) > 0.5)
    return torch.sum(hits.to(scores.dtype), dim=-1) / k


def r_squared(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """1 - SS_res / SS_tot with the weighted label mean; 0 when SS_tot is 0."""
    w = _weights(weights, scores)
    y_bar = torch.sum(w * labels) / torch.sum(w)
    ss_res = torch.sum(w * (labels - scores) ** 2)
    ss_tot = torch.sum(w * (labels - y_bar) ** 2)
    return torch.where(ss_tot > 0.0, 1.0 - ss_res / ss_tot, torch.zeros_like(ss_tot))


def peak_f1(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """The largest F1 over distinct score thresholds (a tie is one cut)."""
    w = _weights(weights, scores)
    masked = torch.where(w > 0.0, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-masked, stable=True)
    y, ww, s = labels[order], w[order], masked[order]
    tp = torch.cumsum(ww * y, dim=0)
    fp = torch.cumsum(ww * (1.0 - y), dim=0)
    precision = tp / torch.clamp_min(tp + fp, 1e-12)
    recall = tp / torch.clamp_min(tp[-1], 1e-12)
    f1 = 2.0 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    nxt = torch.cat([s[1:], torch.full((1,), float("-inf"), dtype=s.dtype, device=s.device)])
    valid = (s != nxt) & (ww > 0.0)
    return torch.max(torch.where(valid, f1, torch.zeros_like(f1)))
