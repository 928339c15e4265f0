"""Evaluator types, results and the evaluation suite.

Port of the part of `photon_ml_tpu/evaluation/suite.py` that coordinate
descent uses: plain (ungrouped) evaluators, an `EvaluationSuite` that
computes every metric for a score vector with one device-to-host copy, and
`EvaluationResults` with the primary evaluator's better-than. Grouped
evaluators (AUC:<tag>, PRECISION@k:<tag>) are not ported yet.

A suite over a dataset sharded over ranks takes its `sharding`: it then
holds the labels and weights of all rows, assembled once, and evaluates the
scores of all rows, assembled from every rank's own by one collective.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence

import torch

from photon_ml_tpu_torch.evaluation import metrics

if TYPE_CHECKING:
    from photon_ml_tpu_torch.parallel.mesh import RowSharding

Tensor = torch.Tensor

_METRIC_FNS: Dict[str, Callable] = {
    "AUC": metrics.area_under_roc_curve,
    "RMSE": metrics.rmse,
    "LOGISTIC_LOSS": metrics.logistic_loss,
    "POISSON_LOSS": metrics.poisson_loss,
    "SQUARED_LOSS": metrics.squared_loss,
    "SMOOTHED_HINGE_LOSS": metrics.smoothed_hinge_loss,
}
_LARGER_IS_BETTER = {"AUC"}


@dataclasses.dataclass(frozen=True)
class EvaluatorType:
    name: str

    def __str__(self) -> str:
        return self.name

    @classmethod
    def parse(cls, spec: str) -> "EvaluatorType":
        up = spec.strip().upper()
        if up not in _METRIC_FNS:
            raise ValueError(f"Unrecognized or not yet ported evaluator type: {spec!r}")
        return cls(up)


def better_than(evaluator: EvaluatorType, a: float, b: Optional[float]) -> bool:
    if b is None:
        return True
    return a > b if evaluator.name in _LARGER_IS_BETTER else a < b


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
    computes every metric. With a `sharding`, labels, weights and scores
    are this rank's rows and the metrics are over all ranks' rows."""

    def __init__(
        self,
        evaluator_types: Sequence[EvaluatorType],
        labels: Tensor,
        weights: Optional[Tensor] = None,
        *,
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
        self.labels = labels
        self.weights = weights

    def evaluate(self, scores: Tensor) -> EvaluationResults:
        if self.sharding is not None:
            scores = self.sharding.gather(scores)
        vals = torch.stack([
            _METRIC_FNS[et.name](scores, self.labels, self.weights).to(torch.float32)
            for et in self.evaluator_types
        ]).cpu()
        results = {str(et): float(v) for et, v in zip(self.evaluator_types, vals)}
        return EvaluationResults(primary=self.primary, results=results)
