"""Legacy single-GLM training: the regularization sweep and model selection.

Port of `photon_ml_tpu/models/training.py` (ModelTraining.scala:175-213,
ModelSelection.scala:26-92): one GLM per regularization weight, trained in
descending order of weight, each warm-started from the one before; the
models come back in the original feature space. `select_best_model` picks
the weight whose model scores best on validation data by the task's
default evaluator (AUC for binary tasks, a loss for regressions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.data.containers import LabeledData
from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite, better_than, default_evaluator_for_task
from photon_ml_tpu_torch.game.model import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, create_model
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize.common import OptResult
from photon_ml_tpu_torch.optimize.config import CoordinateOptimizationConfig
from photon_ml_tpu_torch.optimize.problem import compute_variances, solve
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass
class SweepResult:
    """Per-weight trained models and optimizer results."""

    models: Dict[float, GeneralizedLinearModel]
    results: Dict[float, OptResult]


def train_glm_sweep(
    data: LabeledData,
    task: TaskType,
    config: CoordinateOptimizationConfig,
    reg_weights: Sequence[float],
    *,
    norm: Optional[NormalizationContext] = None,
) -> SweepResult:
    """One GLM per weight, descending, each from the previous solution (the
    first from zeros). The solver works in the normalized space; the models
    are returned in the original one."""
    loss = loss_for_task(task)
    w = torch.zeros(data.features.shape[-1], dtype=torch.float32, device=data.labels.device)
    models: Dict[float, GeneralizedLinearModel] = {}
    results: Dict[float, OptResult] = {}
    for rw in sorted(reg_weights, reverse=True):
        cfg = dataclasses.replace(config, reg_weight=float(rw))
        res = solve(loss, data, cfg, w, norm)
        results[rw] = res
        variances = compute_variances(loss, data, cfg, res.coefficients, norm)
        means = res.coefficients
        if norm is not None:
            means, variances = norm.coefficients_to_original_space(means, variances)
        models[rw] = create_model(task, Coefficients(means, variances))
        w = res.coefficients
    return SweepResult(models=models, results=results)


def select_best_model(
    sweep: SweepResult, validation: LabeledData, task: TaskType
) -> Tuple[float, GeneralizedLinearModel, float]:
    """(weight, model, metric) of the best model on `validation` by the
    task's default evaluator, which reads raw margins."""
    et = default_evaluator_for_task(task)
    suite = EvaluationSuite([et], validation.labels, validation.weights)
    best: Optional[Tuple[float, GeneralizedLinearModel, float]] = None
    for rw, model in sweep.models.items():
        scores = model.compute_score(validation.features, validation.offsets)
        value = suite.evaluate(scores).primary_value
        if best is None or better_than(et, value, best[2]):
            best = (rw, model, value)
    assert best is not None
    return best
