"""Univariate step-out slice sampler, applied coordinate-wise.

The port's copy of `photon_ml_tpu/hyperparameter/slice_sampler.py`
(photon-lib hyperparameter/SliceSampler.scala:52; Neal 2003, the scheme the
reference uses to integrate the GP's kernel hyperparameters). Host-side
numpy: the target (the log marginal likelihood of gp.py) is a float64 torch
function on the CPU, so the sampler is a thin loop around its evaluations.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

LogPdf = Callable[[np.ndarray], float]


def _sample_coord(
    logpdf: LogPdf,
    x: np.ndarray,
    dim: int,
    rng: np.random.Generator,
    width: float,
    max_steps: int,
) -> np.ndarray:
    """One slice-sampling update of coordinate `dim` (step-out + shrink)."""
    x0 = x[dim]
    log_y = logpdf(x) + np.log(rng.uniform() + 1e-300)

    # Step out.
    u = rng.uniform()
    lo = x0 - u * width
    hi = lo + width

    def at(v: float) -> float:
        xx = x.copy()
        xx[dim] = v
        return logpdf(xx)

    steps = 0
    while steps < max_steps and at(lo) > log_y:
        lo -= width
        steps += 1
    steps = 0
    while steps < max_steps and at(hi) > log_y:
        hi += width
        steps += 1

    # Shrinkage.
    for _ in range(100):
        v = rng.uniform(lo, hi)
        if at(v) > log_y:
            out = x.copy()
            out[dim] = v
            return out
        if v < x0:
            lo = v
        else:
            hi = v
    return x  # a degenerate slice: keep the current point


def slice_sample(
    logpdf: LogPdf,
    x0: np.ndarray,
    rng: np.random.Generator,
    *,
    num_samples: int,
    burn_in: int = 100,
    width: float = 1.0,
    max_stepout: int = 32,
) -> np.ndarray:
    """Draw `num_samples` points after `burn_in` sweeps (the reference uses
    burn-in 100 and 10 samples, GaussianProcessEstimator.scala:96)."""
    x = np.asarray(x0, np.float64).copy()
    out = np.empty((num_samples, x.size), np.float64)
    for it in range(burn_in + num_samples):
        for d in range(x.size):
            x = _sample_coord(logpdf, x, d, rng, width, max_stepout)
        if it >= burn_in:
            out[it - burn_in] = x
    return out
