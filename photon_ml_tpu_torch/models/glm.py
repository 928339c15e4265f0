"""Supervised GLM model classes with their link functions.

Port of `photon_ml_tpu/models/glm.py`, on tensors: a model is its
Coefficients and a task; `compute_score` is the raw margin x.w (+ offset),
over a dense matrix, an ELL shard (its plain product) or a sparse layout
(the X w kernel on the card); `compute_mean` applies the task's link
(sigmoid, exp, identity, or the raw margin for the smoothed hinge);
classifiers add `predict_class` at a posterior threshold. `create_model`
maps a task to its class.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from photon_ml_tpu_torch.data.containers import Features, SparseFeatures
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout
from photon_ml_tpu_torch.game.model import Coefficients
from photon_ml_tpu_torch.ops import sparse_kernels
from photon_ml_tpu_torch.ops.losses import mean_for_task
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor

# >= this posterior is the positive class (BinaryClassifier.scala).
DEFAULT_THRESHOLD = 0.5


def _margins(features, w: Tensor, offsets: Optional[Tensor]) -> Tensor:
    if isinstance(features, SparseLayout):
        z = sparse_kernels.matvec(features, w)
    elif isinstance(features, SparseFeatures):
        z = features.matvec(w)
    else:
        z = features.to(w.dtype) @ w
    return z if offsets is None else z + offsets


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """Coefficients + the task's mean link."""

    coefficients: Coefficients
    task: TaskType

    @property
    def dim(self) -> int:
        return int(self.coefficients.means.shape[-1])

    def compute_score(self, features: Union[Features, SparseLayout],
                      offsets: Optional[Tensor] = None) -> Tensor:
        return _margins(features, self.coefficients.means, offsets)

    def compute_mean(self, features, offsets: Optional[Tensor] = None) -> Tensor:
        return mean_for_task(self.task, self.compute_score(features, offsets))

    def predict(self, features, offsets: Optional[Tensor] = None) -> Tensor:
        """The mean response."""
        return self.compute_mean(features, offsets)


@dataclasses.dataclass(frozen=True)
class BinaryClassifier(GeneralizedLinearModel):
    def predict_class(self, features, offsets: Optional[Tensor] = None,
                      threshold: float = DEFAULT_THRESHOLD) -> Tensor:
        return (self.compute_mean(features, offsets) >= threshold).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class LogisticRegressionModel(BinaryClassifier):
    """Sigmoid link."""


@dataclasses.dataclass(frozen=True)
class SmoothedHingeLossLinearSVMModel(BinaryClassifier):
    """Margin classifier: its 'mean' is the raw margin."""


@dataclasses.dataclass(frozen=True)
class LinearRegressionModel(GeneralizedLinearModel):
    """Identity link."""


@dataclasses.dataclass(frozen=True)
class PoissonRegressionModel(GeneralizedLinearModel):
    """Exponential link."""


_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION: LogisticRegressionModel,
    TaskType.LINEAR_REGRESSION: LinearRegressionModel,
    TaskType.POISSON_REGRESSION: PoissonRegressionModel,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLossLinearSVMModel,
}


def create_model(task: TaskType, coefficients: Union[Coefficients, Tensor]) -> GeneralizedLinearModel:
    """TaskType -> its model class."""
    if not isinstance(coefficients, Coefficients):
        coefficients = Coefficients(torch.as_tensor(coefficients))
    return _MODEL_CLASS[task](coefficients=coefficients, task=task)
