"""Optimization problems: configuration + objective + optimizer.

Port of `solve` and `compute_variances` from `photon_ml_tpu/optimize/
problem.py`. One solve serves both coordinate kinds: a fixed effect passes a
single coefficient vector (D,) over (N, D) or sparse data and gets an
unbatched result; a random-effect bucket passes (E, D) over (E, S, D)
blocks and gets one lane per entity. OWLQN (L1, elastic net), box
constraints and FULL variances are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.data.containers import LabeledData
from photon_ml_tpu_torch.ops import objective
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize.common import OptResult
from photon_ml_tpu_torch.optimize.config import CoordinateOptimizationConfig
from photon_ml_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimize.tron import minimize_tron
from photon_ml_tpu_torch.types import (
    OptimizerType,
    RegularizationType,
    VarianceComputationType,
)

Tensor = torch.Tensor


def _check_supported(config: CoordinateOptimizationConfig) -> None:
    opt = config.optimizer
    if opt.optimizer_type in (OptimizerType.OWLQN, OptimizerType.LBFGSB) or (
        config.regularization.reg_type
        in (RegularizationType.L1, RegularizationType.ELASTIC_NET)
    ):
        raise NotImplementedError("OWLQN / L1 / elastic net is not ported yet")
    if opt.box_constraints is not None:
        raise NotImplementedError("box-constrained L-BFGS is not ported yet")
    if config.variance_computation == VarianceComputationType.FULL:
        raise NotImplementedError("FULL coefficient variances are not ported yet")


def solve(
    loss: PointwiseLoss,
    data: LabeledData,
    config: CoordinateOptimizationConfig,
    w0: Tensor,
    norm: Optional[NormalizationContext] = None,
    use_kernel: Optional[bool] = None,
) -> OptResult:
    """Run the configured optimizer (L-BFGS or TRON, L2 or none).

    `w0` (D,) solves one problem and returns an unbatched OptResult;
    `w0` (E, D) solves E problems over (E, S, D) data, one lane each."""
    _check_supported(config)
    l2 = config.l2_weight
    single = w0.ndim == 1
    if single:

        def vg(W):
            f, g = objective.value_and_gradient(loss, W[0], data, norm, l2, use_kernel)
            return f[None], g[None]

        def hvp(W, V):
            return objective.hessian_vector(loss, W[0], V[0], data, norm, l2, use_kernel)[None]

        W0 = w0[None]
    else:
        vg = lambda W: objective.value_and_gradient(loss, W, data, norm, l2, use_kernel)
        hvp = lambda W, V: objective.hessian_vector(loss, W, V, data, norm, l2, use_kernel)
        W0 = w0

    opt = config.optimizer
    if opt.optimizer_type == OptimizerType.TRON:
        if not loss.has_hessian:
            raise ValueError(f"{loss.name} has no Hessian; TRON needs one (use LBFGS)")
        res = minimize_tron(
            vg, hvp, W0, max_iterations=opt.max_iterations, tolerance=opt.tolerance
        )
    else:
        res = minimize_lbfgs(
            vg, W0, max_iterations=opt.max_iterations, tolerance=opt.tolerance
        )
    return res.lane(0) if single else res


def compute_variances(
    loss: PointwiseLoss,
    data: LabeledData,
    config: CoordinateOptimizationConfig,
    w: Tensor,
    norm: Optional[NormalizationContext] = None,
) -> Optional[Tensor]:
    """Coefficient variances at the optimum; None for NONE.

    SIMPLE: 1 / diag(H), with inf where the diagonal is 0. FULL (diag of
    H^-1 by a Cholesky solve of the full Hessian) is not ported yet."""
    vc = config.variance_computation
    if vc == VarianceComputationType.NONE:
        return None
    if vc == VarianceComputationType.FULL:
        raise NotImplementedError("FULL coefficient variances are not ported yet")
    diag = objective.hessian_diagonal(loss, w, data, norm, config.l2_weight)
    return torch.where(diag.abs() > 0.0, 1.0 / diag, torch.full_like(diag, float("inf")))
