"""Stationary GP kernels: RBF and Matern 5/2.

Port of `photon_ml_tpu/hyperparameter/kernels.py` (photon-lib
hyperparameter/estimators/kernels/: StationaryKernel.scala, RBF.scala,
Matern52.scala) as torch functions on tensors. Kernels carry (amplitude,
noise, length-scales) hyperparameters in log space; `gram` builds the Gram
matrix with noise on the diagonal, a kernel of (xa, xb) the cross
covariance. The GP runs on the CPU in float64 (see gp.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor

_JITTER = 1e-8


def _sq_dists(xa: Tensor, xb: Tensor, lengthscales: Tensor) -> Tensor:
    a = xa / lengthscales
    b = xb / lengthscales
    d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
    return d2.clamp_min(0.0)


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Log-space hyperparameters (positive by construction)."""

    log_amplitude: Tensor  # ()
    log_noise: Tensor  # ()
    log_lengthscales: Tensor  # (D,) ARD

    @property
    def amplitude(self) -> Tensor:
        return self.log_amplitude.exp()

    @property
    def noise(self) -> Tensor:
        return self.log_noise.exp()

    @property
    def lengthscales(self) -> Tensor:
        return self.log_lengthscales.exp()

    def as_vector(self) -> Tensor:
        return torch.cat([self.log_amplitude[None], self.log_noise[None], self.log_lengthscales])

    @classmethod
    def from_vector(cls, v: Tensor) -> "KernelParams":
        return cls(v[0], v[1], v[2:])

    @classmethod
    def default(cls, dim: int) -> "KernelParams":
        return cls(torch.tensor(0.0, dtype=torch.float64), torch.tensor(math.log(1e-2), dtype=torch.float64),
                   torch.zeros(dim, dtype=torch.float64))


def rbf(params: KernelParams, xa: Tensor, xb: Tensor) -> Tensor:
    return params.amplitude * torch.exp(-0.5 * _sq_dists(xa, xb, params.lengthscales))


def matern52(params: KernelParams, xa: Tensor, xb: Tensor) -> Tensor:
    d2 = _sq_dists(xa, xb, params.lengthscales)
    d = torch.sqrt(d2 + 1e-24)
    s5 = math.sqrt(5.0)
    return params.amplitude * (1.0 + s5 * d + (5.0 / 3.0) * d2) * torch.exp(-s5 * d)


KernelFn = Callable[[KernelParams, Tensor, Tensor], Tensor]

KERNELS = {"rbf": rbf, "matern52": matern52}


def gram(kernel: KernelFn, params: KernelParams, x: Tensor) -> Tensor:
    k = kernel(params, x, x)
    eye = torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    return k + (params.noise + _JITTER) * eye


def cholesky(K: Tensor) -> Tensor:
    """The lower Cholesky factor, NaN where K is not positive definite (as
    the reference's factorization reports a failed slice point: the caller
    reads a non-finite evidence, not an exception)."""
    chol, info = torch.linalg.cholesky_ex(K)
    return chol if int(info) == 0 else torch.full_like(K, float("nan"))


def log_marginal_likelihood(kernel: KernelFn, params: KernelParams, x: Tensor, y: Tensor) -> Tensor:
    """Standard GP evidence: -1/2 (y^T K^-1 y + log|K| + n log 2pi)."""
    chol = cholesky(gram(kernel, params, x))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    n = y.shape[0]
    return -0.5 * (y @ alpha + 2.0 * torch.log(torch.diagonal(chol)).sum() + n * math.log(2.0 * math.pi))
