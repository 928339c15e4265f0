"""Optimization problems: configuration + objective + optimizer + variances.

Port of `solve` and `compute_variances` from `photon_ml_tpu/optimize/
problem.py`. One solve serves both coordinate kinds: a fixed effect passes a
single coefficient vector (D,) over (N, D) or sparse data and gets an
unbatched result; a random-effect bucket passes (E, D) over (E, S, D)
blocks and gets one lane per entity. The optimizer is the reference's
choice: TRON, or L-BFGS — in OWLQN mode when the optimizer is OWLQN or the
regularization is L1 or elastic net (l1 = the config's L1 weight), with the
config's box constraints when it has them.
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


def solve(
    loss: PointwiseLoss,
    data: LabeledData,
    config: CoordinateOptimizationConfig,
    w0: Tensor,
    norm: Optional[NormalizationContext] = None,
    use_kernel: Optional[bool] = None,
) -> OptResult:
    """Run the configured optimizer.

    `w0` (D,) solves one problem and returns an unbatched OptResult;
    `w0` (E, D) solves E problems over (E, S, D) data, one lane each."""
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
        lower = upper = None
        if opt.box_constraints is not None:
            lower, upper = opt.box_constraints
        # OWLQN follows the optimizer or the regularization type, as the
        # reference's OptimizerFactory chooses it.
        use_l1 = opt.optimizer_type == OptimizerType.OWLQN or config.regularization.reg_type in (
            RegularizationType.L1, RegularizationType.ELASTIC_NET)
        res = minimize_lbfgs(
            vg, W0, max_iterations=opt.max_iterations, tolerance=opt.tolerance,
            l1_weight=config.l1_weight if use_l1 else None,
            lower_bounds=lower, upper_bounds=upper,
        )
    return res.lane(0) if single else res


def _diag_of_inverse(H: Tensor) -> Tensor:
    """diag(H^-1) of each (D, D) matrix by a Cholesky solve against the
    identity; NaN where H is not positive definite (as the JAX package's
    Cholesky gives)."""
    L, info = torch.linalg.cholesky_ex(H)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device).expand_as(H)
    diag = torch.diagonal(torch.cholesky_solve(eye, L), dim1=-2, dim2=-1)
    return torch.where((info == 0)[..., None], diag, torch.full_like(diag, float("nan")))


def _lanes(t, lo: int, hi: int):
    return t if t is None or t.ndim < 2 else t[lo:hi]


def compute_variances(
    loss: PointwiseLoss,
    data: LabeledData,
    config: CoordinateOptimizationConfig,
    w: Tensor,
    norm: Optional[NormalizationContext] = None,
) -> Optional[Tensor]:
    """Coefficient variances at the optimum; None for NONE.

    SIMPLE: 1 / diag(H), with inf where the diagonal is 0. FULL: diag(H^-1)
    from the full Hessian (`objective.hessian_matrix`). E lanes form their
    (lanes, D, D) Hessians a chunk of lanes at a time, so at most about
    `objective.HESSIAN_CHUNK_BYTES` of blocks and products are held."""
    vc = config.variance_computation
    if vc == VarianceComputationType.NONE:
        return None
    l2 = config.l2_weight
    if vc == VarianceComputationType.SIMPLE:
        diag = objective.hessian_diagonal(loss, w, data, norm, l2)
        return torch.where(diag.abs() > 0.0, 1.0 / diag, torch.full_like(diag, float("inf")))
    if w.ndim == 1:
        return _diag_of_inverse(objective.hessian_matrix(loss, w, data, norm, l2))
    E, D = w.shape
    S = data.features.shape[-2]
    step = max(1, objective.HESSIAN_CHUNK_BYTES // ((D * D + S * D) * w.element_size()))
    out = []
    for lo in range(0, E, step):
        hi = min(E, lo + step)
        part = LabeledData(data.features[lo:hi], data.labels[lo:hi], data.offsets[lo:hi],
                           data.weights[lo:hi])
        lane_norm = None if norm is None else NormalizationContext(
            _lanes(norm.factors, lo, hi), _lanes(norm.shifts, lo, hi), norm.intercept_index)
        out.append(_diag_of_inverse(objective.hessian_matrix(loss, w[lo:hi], part, lane_norm, l2)))
    return torch.cat(out)
