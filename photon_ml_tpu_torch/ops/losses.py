"""Pointwise GLM losses l(z, y) with first and second derivatives in z.

Port of `photon_ml_tpu/ops/losses.py`: the same four losses, elementwise over
tensors of margins `z` and labels `y`. Classification labels are {0, 1}
(values > 0.5 count as positive). The CUDA kernels in `csrc/glm_fused.cu`
carry a `__device__` copy of each formula; `LOSS_IDS` is the integer id they
are selected by.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """l(z, y) plus dl/dz and d2l/dz2. `has_hessian=False` marks losses
    usable only with first-order optimizers (smoothed hinge)."""

    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    has_hessian: bool = True


def _sign(y: Tensor, like: Tensor) -> Tensor:
    return torch.where(y > 0.5, 1.0, -1.0).to(like.dtype)


def _softplus(x: Tensor) -> Tensor:
    # Stable log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|)) for every |x|
    # (the form of jax.nn.softplus; the kernels use the same expression).
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    # log(1 + exp(-s*z)) with s = +-1.
    return _softplus(-_sign(y, z) * z)


def _logistic_d1(z: Tensor, y: Tensor) -> Tensor:
    return torch.sigmoid(z) - torch.where(y > 0.5, 1.0, 0.0).to(z.dtype)


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


def _squared_loss(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


def _squared_d1(z: Tensor, y: Tensor) -> Tensor:
    return z - y


def _squared_d2(z: Tensor, y: Tensor) -> Tensor:
    return torch.ones_like(z)


def _poisson_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z) - y * z


def _poisson_d1(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z) - y


def _poisson_d2(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z)


def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    # Rennie's smoothed hinge on the signed margin m = s*z:
    #   m <= 0 -> 0.5 - m;  0 < m < 1 -> 0.5 (1 - m)^2;  m >= 1 -> 0
    m = _sign(y, z) * z
    return torch.where(
        m <= 0.0, 0.5 - m, torch.where(m < 1.0, 0.5 * (1.0 - m) ** 2, 0.0)
    )


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    s = _sign(y, z)
    m = s * z
    dm = torch.where(m < 0.0, -1.0, torch.where(m < 1.0, m - 1.0, 0.0))
    return s * dm


def _smoothed_hinge_d2(z: Tensor, y: Tensor) -> Tensor:
    m = _sign(y, z) * z
    return torch.where((m > 0.0) & (m < 1.0), 1.0, 0.0).to(z.dtype)


LOGISTIC = PointwiseLoss("logistic", _logistic_loss, _logistic_d1, _logistic_d2)
SQUARED = PointwiseLoss("squared", _squared_loss, _squared_d1, _squared_d2)
POISSON = PointwiseLoss("poisson", _poisson_loss, _poisson_d1, _poisson_d2)
SMOOTHED_HINGE = PointwiseLoss(
    "smoothed_hinge",
    _smoothed_hinge_loss,
    _smoothed_hinge_d1,
    _smoothed_hinge_d2,
    has_hessian=False,
)

# Integer ids the CUDA kernels select their __device__ loss by
# (csrc/glm_fused.cu, enum LossId).
LOSS_IDS = {"logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}

_TASK_LOSSES = {
    TaskType.LOGISTIC_REGRESSION: LOGISTIC,
    TaskType.LINEAR_REGRESSION: SQUARED,
    TaskType.POISSON_REGRESSION: POISSON,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SMOOTHED_HINGE,
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    return _TASK_LOSSES[task]


def mean_for_task(task: TaskType, z: Tensor) -> Tensor:
    """Link-function mean response: sigmoid (logistic), exp (Poisson), the
    raw margin otherwise."""
    if task == TaskType.LOGISTIC_REGRESSION:
        return torch.sigmoid(z)
    if task == TaskType.POISSON_REGRESSION:
        return torch.exp(z)
    return z
