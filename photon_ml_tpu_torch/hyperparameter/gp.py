"""Gaussian-process regression for Bayesian hyperparameter search.

Port of `photon_ml_tpu/hyperparameter/gp.py` (photon-lib
hyperparameter/estimators/: GaussianProcessEstimator.scala:36-96,
GaussianProcessModel.scala:34-99; criteria/: ExpectedImprovement.scala,
ConfidenceBound.scala). `fit_gp` integrates over kernel hyperparameters by
slice-sampling the log marginal likelihood (burn-in 100, 10 samples, as the
reference); the model averages predictions over the sampled kernels, one
Cholesky solve per kernel sample.

Where it runs: on the CPU, in float64, as the reference's
GaussianProcessEstimator runs on the Spark driver. It is host-side control
over at most a few dozen points; on the card, `fit_gp` would cost about 110
slice-sampler sweeps times several Cholesky solves, each a synchronised
launch, for every proposal. The trials themselves (the fits) run on the card.
The JAX package runs the same math in float32 under jit.

Metric direction: observations are standardized and NEGATED internally when
`maximize=True`, so the acquisition always minimizes, the reference's
GaussianProcessSearch convention.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.hyperparameter import kernels as K
from photon_ml_tpu_torch.hyperparameter.slice_sampler import slice_sample

Tensor = torch.Tensor

DTYPE = torch.float64


def _host(a) -> Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=DTYPE)


@torch.no_grad()
def _posterior(kernel_name: str, vec: Tensor, x: Tensor, y: Tensor, xt: Tensor) -> Tuple[Tensor, Tensor]:
    """Predictive (mean, variance) at `xt` under one kernel sample."""
    kernel = K.KERNELS[kernel_name]
    params = K.KernelParams.from_vector(vec)
    chol = K.cholesky(K.gram(kernel, params, x))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    kx = kernel(params, x, xt)
    mean = kx.T @ alpha
    v = torch.linalg.solve_triangular(chol, kx, upper=False)
    prior = kernel(params, xt, xt)
    var = (torch.diagonal(prior) - (v * v).sum(0)).clamp_min(1e-12)
    return mean, var


@torch.no_grad()
def _lml(kernel_name: str, vec: Tensor, x: Tensor, y: Tensor) -> Tensor:
    kernel = K.KERNELS[kernel_name]
    return K.log_marginal_likelihood(kernel, K.KernelParams.from_vector(vec), x, y)


@dataclasses.dataclass
class GaussianProcessModel:
    """Posterior predictive averaged over sampled kernel hyperparameters
    (GaussianProcessModel.scala:34-99)."""

    kernel_name: str
    param_vectors: np.ndarray  # (S, 2 + D)
    x: np.ndarray
    y: np.ndarray  # standardized (and sign-flipped if maximizing)
    y_mean: float
    y_std: float

    def predict(self, xt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, variance) in the standardized internal space."""
        x, y, xt = _host(self.x), _host(self.y), _host(np.atleast_2d(xt))
        means, variances = [], []
        for vec in self.param_vectors:
            m, v = _posterior(self.kernel_name, _host(vec), x, y, xt)
            means.append(m.numpy())
            variances.append(v.numpy())
        mean = np.mean(means, axis=0)
        # Law of total variance across kernel samples.
        var = np.mean(variances, axis=0) + np.var(means, axis=0)
        return mean, var

    def expected_improvement(self, xt: np.ndarray) -> np.ndarray:
        """EI for minimization of the standardized objective
        (ExpectedImprovement.scala)."""
        best = float(np.min(self.y))
        mean, var = self.predict(xt)
        std = np.sqrt(var)
        gamma = (best - mean) / std
        from scipy.stats import norm  # here: scipy.stats takes seconds to import

        return std * (gamma * norm.cdf(gamma) + norm.pdf(gamma))

    def confidence_bound(self, xt: np.ndarray, beta: float = 2.0) -> np.ndarray:
        """Lower confidence bound, negated so larger is better
        (ConfidenceBound.scala)."""
        mean, var = self.predict(xt)
        return -(mean - beta * np.sqrt(var))


def fit_gp(
    x: np.ndarray,
    y: np.ndarray,
    *,
    kernel: str = "matern52",
    maximize: bool = False,
    num_samples: int = 10,
    burn_in: int = 100,
    seed: int = 0,
) -> GaussianProcessModel:
    """GaussianProcessEstimator.fit (:54-96): standardize y, slice-sample the
    kernel hyperparameters under the evidence, keep `num_samples` draws."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    y = np.asarray(y, np.float64).ravel()
    sign = -1.0 if maximize else 1.0
    y_mean, y_std = float(np.mean(y)), float(np.std(y) + 1e-12)
    ys = sign * (y - y_mean) / y_std
    xt, yt = _host(x), _host(ys)

    def logpdf(vec: np.ndarray) -> float:
        # A weakly informative normal prior on the log-params keeps the
        # slice bounded (the reference bounds its ranges similarly).
        val = float(_lml(kernel, _host(vec), xt, yt))
        if not np.isfinite(val):
            return -1e30
        return val - 0.5 * float(np.sum((vec / 3.0) ** 2))

    rng = np.random.default_rng(seed)
    v0 = K.KernelParams.default(x.shape[1]).as_vector().numpy()
    samples = slice_sample(logpdf, v0, rng, num_samples=num_samples, burn_in=burn_in)
    return GaussianProcessModel(kernel, samples, x, ys, y_mean, y_std)
