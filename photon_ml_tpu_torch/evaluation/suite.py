"""Evaluator types, results, grouped evaluators and the evaluation suite.

Port of `photon_ml_tpu/evaluation/suite.py`: plain evaluators (AUC, AUPR,
RMSE and the pointwise losses) and grouped ones ("AUC:<idTag>",
"PRECISION@<k>:<idTag>"), whose rows are gathered once into a padded
(groups, largest group) index (`build_grouped_index`) so a grouped metric
is the batched metric over it, averaged over the groups. An
`EvaluationSuite` computes every metric for a score vector with one
device-to-host copy; `EvaluationResults` compares by the primary
evaluator. `StreamingWindowEvaluator` runs the same metric functions over
windows whose labels arrive with the scores (the shadow controller's
online evaluation, serving/shadow.py), and `regression` is the signed,
direction-aware gap its tolerance is held to.

A suite over a dataset sharded over ranks takes its `sharding`: it then
holds the labels and weights of all rows, assembled once, and evaluates the
scores of all rows, assembled from every rank's own by one collective; a
grouped evaluator's groups come from the sharding's global codes of its id
tag, so every rank computes each metric over the same global arrays as one
process.
"""

from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.types import TaskType

if TYPE_CHECKING:
    from photon_ml_tpu_torch.parallel.mesh import RowSharding

Tensor = torch.Tensor

_METRIC_FNS: Dict[str, Callable] = {
    "AUC": metrics.area_under_roc_curve,
    "AUPR": metrics.area_under_pr_curve,
    "RMSE": metrics.rmse,
    "LOGISTIC_LOSS": metrics.logistic_loss,
    "POISSON_LOSS": metrics.poisson_loss,
    "SQUARED_LOSS": metrics.squared_loss,
    "SMOOTHED_HINGE_LOSS": metrics.smoothed_hinge_loss,
}
_LARGER_IS_BETTER = {"AUC", "AUPR", "PRECISION"}


@dataclasses.dataclass(frozen=True)
class EvaluatorType:
    """A parsed evaluator: a plain name, or a grouped one with its id tag
    (and k for PRECISION)."""

    name: str
    id_tag: Optional[str] = None
    k: Optional[int] = None

    @property
    def is_grouped(self) -> bool:
        return self.id_tag is not None

    def __str__(self) -> str:
        base = f"PRECISION@{self.k}" if self.name == "PRECISION" else self.name
        return f"{base}:{self.id_tag}" if self.id_tag else base

    @classmethod
    def parse(cls, spec: str) -> "EvaluatorType":
        spec = spec.strip()
        m = re.match(r"(?i)^PRECISION@(\d+):(.+)$", spec)
        if m:
            return cls("PRECISION", id_tag=m.group(2), k=int(m.group(1)))
        m = re.match(r"(?i)^AUC:(.+)$", spec)
        if m:
            return cls("AUC", id_tag=m.group(1))
        up = spec.upper()
        if up not in _METRIC_FNS:
            raise ValueError(f"Unrecognized evaluator type: {spec!r}")
        return cls(up)


def default_evaluator_for_task(task: TaskType) -> EvaluatorType:
    """The task's validation evaluator when none is named."""
    return {
        TaskType.LOGISTIC_REGRESSION: EvaluatorType("AUC"),
        TaskType.LINEAR_REGRESSION: EvaluatorType("RMSE"),
        TaskType.POISSON_REGRESSION: EvaluatorType("POISSON_LOSS"),
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: EvaluatorType("AUC"),
    }[task]


def better_than(evaluator: EvaluatorType, a: float, b: Optional[float]) -> bool:
    if b is None:
        return True
    return a > b if evaluator.name in _LARGER_IS_BETTER else a < b


def regression(evaluator: EvaluatorType, challenger: float, champion: float) -> float:
    """How much worse `challenger` is than `champion` (positive: worse),
    whichever direction the evaluator improves in."""
    if evaluator.name in _LARGER_IS_BETTER:
        return champion - challenger
    return challenger - champion


class GroupedIndex(NamedTuple):
    """The rows of each group of one id tag, padded: gather (G, S) row
    indices (padding gathers row 0) and mask (G, S) 1.0 / 0.0."""

    gather: Tensor
    mask: Tensor


def build_grouped_index(group_ids: np.ndarray, *, max_group_size: Optional[int] = None,
                        device: torch.device = torch.device("cpu")) -> GroupedIndex:
    """Each group's rows in row order, groups in sorted id order; a group
    longer than `max_group_size` keeps its first rows."""
    order = np.argsort(group_ids, kind="stable")
    _, starts, sizes = np.unique(group_ids[order], return_index=True, return_counts=True)
    s_max = int(sizes.max()) if max_group_size is None else int(max_group_size)
    kept = np.minimum(sizes, s_max)
    slot = np.arange(len(order)) - np.repeat(starts, sizes)
    group = np.repeat(np.arange(len(sizes)), sizes)
    take = slot < np.repeat(kept, sizes)
    gather = np.zeros((len(sizes), s_max), np.int64)
    mask = np.zeros((len(sizes), s_max), np.float32)
    gather[group[take], slot[take]] = order[take]
    mask[group[take], slot[take]] = 1.0
    return GroupedIndex(torch.as_tensor(gather).to(device), torch.as_tensor(mask).to(device))


def _grouped_metric(fn: Callable, idx: GroupedIndex, scores: Tensor, labels: Tensor,
                    weights: Tensor) -> Tensor:
    """The mean over groups of the metric of each group's rows (groups with
    one class count, at the metric's neutral value)."""
    w = weights[idx.gather] * idx.mask
    return torch.mean(fn(scores[idx.gather], labels[idx.gather], w))


def resolve_metric_fn(et: EvaluatorType, grouped: Optional[GroupedIndex] = None) -> Callable:
    """`(scores, labels, weights) -> scalar tensor` for one evaluator."""
    if et.name == "PRECISION":
        base = lambda s, l, w, _k=et.k: metrics.precision_at_k(_k, s, l, w)
    else:
        base = _METRIC_FNS[et.name]
    if et.is_grouped:
        if grouped is None:
            raise ValueError(f"Evaluator {et} is grouped and needs its GroupedIndex")
        return lambda s, l, w: _grouped_metric(base, grouped, s, l, w)
    return base


@dataclasses.dataclass(frozen=True)
class EvaluationResults:
    primary: EvaluatorType
    results: Dict[str, float]

    @property
    def primary_value(self) -> float:
        return self.results[str(self.primary)]

    def better_than(self, other: Optional["EvaluationResults"]) -> bool:
        return better_than(
            self.primary, self.primary_value, None if other is None else other.primary_value
        )


class EvaluationSuite:
    """Validation labels and weights plus evaluators; `evaluate(scores)`
    computes every metric. `id_tag_values` (tag -> per-sample keys, host
    numpy) serve the grouped evaluators. With a `sharding`, labels, weights
    and scores are this rank's rows, the metrics are over all ranks' rows,
    and the grouped evaluators' tags come from the sharding."""

    def __init__(
        self,
        evaluator_types: Sequence[EvaluatorType],
        labels: Tensor,
        weights: Optional[Tensor] = None,
        *,
        id_tag_values: Optional[Dict[str, np.ndarray]] = None,
        primary: Optional[EvaluatorType] = None,
        sharding: Optional["RowSharding"] = None,
    ):
        if not evaluator_types:
            raise ValueError("EvaluationSuite requires at least one evaluator")
        self.evaluator_types = list(evaluator_types)
        self.primary = primary or self.evaluator_types[0]
        self.sharding = sharding
        weights = weights if weights is not None else torch.ones_like(labels)
        if sharding is not None:
            labels, weights = sharding.gather(torch.stack([labels, weights.to(labels.dtype)], 1)).T
            # Codes order as the values do, so they group the rows alike.
            id_tag_values = {k: codes for k, (codes, _) in sharding.tag_codes.items()}
        self.labels = labels
        self.weights = weights
        self._grouped: Dict[str, GroupedIndex] = {}
        for et in self.evaluator_types:
            if et.is_grouped and et.id_tag not in self._grouped:
                if id_tag_values is None or et.id_tag not in id_tag_values:
                    raise ValueError(f"Evaluator {et} needs id tag values for {et.id_tag!r}")
                self._grouped[et.id_tag] = build_grouped_index(
                    np.asarray(id_tag_values[et.id_tag]), device=labels.device)

    def metric_fn(self, et: EvaluatorType) -> Callable:
        return resolve_metric_fn(et, self._grouped.get(et.id_tag))

    def evaluate(self, scores: Tensor) -> EvaluationResults:
        if self.sharding is not None:
            scores = self.sharding.gather(scores)
        vals = torch.stack([
            self.metric_fn(et)(scores, self.labels, self.weights).to(torch.float32)
            for et in self.evaluator_types
        ]).cpu()
        results = {str(et): float(v) for et, v in zip(self.evaluator_types, vals)}
        return EvaluationResults(primary=self.primary, results=results)


class StreamingWindowEvaluator:
    """Online windowed evaluation over the metric functions an
    `EvaluationSuite` uses (`resolve_metric_fn`), every metric of a window
    fetched in one device-to-host copy, so an online tolerance means what it
    means offline. Labels arrive with each window. Grouped evaluators are
    refused: their gathers assume one fixed sample order, which a stream
    has not got."""

    def __init__(self, evaluator_types: Sequence[EvaluatorType], *,
                 primary: Optional[EvaluatorType] = None):
        if not evaluator_types:
            raise ValueError("StreamingWindowEvaluator requires at least one evaluator")
        grouped = [str(et) for et in evaluator_types if et.is_grouped]
        if grouped:
            raise ValueError(f"StreamingWindowEvaluator does not support grouped evaluators (got "
                             f"{grouped}); grouped gathers assume a fixed validation sample order")
        self.evaluator_types = list(evaluator_types)
        self.primary = primary or self.evaluator_types[0]

    def evaluate_window(self, scores, labels, weights=None) -> EvaluationResults:
        """Every metric over one window (scores, labels and weights as
        tensors or arrays), as `EvaluationSuite.evaluate` computes them."""
        labels = torch.as_tensor(labels)
        if int(labels.shape[0]) == 0:
            raise ValueError("empty evaluation window: a windowed metric over zero rows is "
                             "undefined; the caller must skip or carry the window")
        scores = torch.as_tensor(scores, device=labels.device)
        w = torch.ones_like(labels) if weights is None else torch.as_tensor(weights, device=labels.device)
        vals = torch.stack([resolve_metric_fn(et)(scores, labels, w).to(torch.float32)
                            for et in self.evaluator_types]).cpu()
        return EvaluationResults(primary=self.primary,
                                 results={str(et): float(v) for et, v in zip(self.evaluator_types, vals)})
