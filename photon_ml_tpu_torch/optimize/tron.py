"""Batched trust-region Newton (TRON).

Port of `photon_ml_tpu/optimize/tron.py` (LIBLINEAR's TRON as in the
reference TRON.scala), written batched like `lbfgs.py`: a leading lane axis,
a per-lane reason that freezes finished lanes, a per-lane truncated
conjugate-gradient solve of the trust-region subproblem whose finished lanes
freeze too, and a host-side exit when no lane is running. The algorithm's
constants and update rules are the JAX version's:

  * trust radius starts at ||g0||
  * (eta0, eta1, eta2) = (1e-4, 0.25, 0.75), (sigma1, sigma2, sigma3) =
    (0.25, 0.5, 4.0)
  * CG: at most 20 iterations, tolerance 0.1 ||g||, boundary quadratic
  * a step is taken when actual > eta0 * predicted reduction; at most
    `_MAX_FAILURES` consecutive rejected steps

The Hessian-vector products come from the caller; for the fixed effect that
is `objective.hessian_vector`, whose kernel path is the fused CUDA kernel.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from photon_ml_tpu_torch.optimize.common import (
    ConvergenceReason,
    OptResult,
    check_convergence,
    empty_history,
    record,
    safe_div,
)

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
HessianVector = Callable[[Tensor, Tensor], Tensor]

DEFAULT_MAX_ITERATIONS = 15
DEFAULT_TOLERANCE = 1e-5
_MAX_FAILURES = 5
MAX_CG_ITERATIONS = 20

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _truncated_cg(
    hvp: Callable[[Tensor], Tensor], gradient: Tensor, boundary: Tensor, lanes: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per lane, approximately solve min_s g.s + 0.5 s.H.s, ||s|| <= boundary.
    Only `lanes` run; returns (Hessian-vector products per lane, step,
    residual)."""
    tol = 0.1 * torch.linalg.vector_norm(gradient, dim=-1)
    step = torch.zeros_like(gradient)
    residual = -gradient
    direction = -gradient
    rtr = _dot(gradient, gradient)
    iteration = torch.zeros(gradient.shape[0], dtype=torch.int32, device=gradient.device)
    hvps = torch.zeros_like(iteration)
    done = ~lanes
    for _ in range(MAX_CG_ITERATIONS + 1):
        running = (~done) & (iteration < MAX_CG_ITERATIONS)
        if not bool(running.any()):
            break
        converged = torch.linalg.vector_norm(residual, dim=-1) <= tol
        hd = hvp(direction)
        alpha = safe_div(rtr, _dot(direction, hd))
        step_try = step + alpha[:, None] * direction
        crossed = torch.linalg.vector_norm(step_try, dim=-1) > boundary

        # Boundary case: advance to the trust-region surface.
        std = _dot(step, direction)
        sts = _dot(step, step)
        dtd = _dot(direction, direction)
        dsq = boundary * boundary
        rad = torch.sqrt(torch.clamp_min(std * std + dtd * (dsq - sts), 0.0))
        alpha_b = torch.where(
            std >= 0.0, safe_div(dsq - sts, std + rad), safe_div(rad - std, dtd)
        )
        step_bound = step + alpha_b[:, None] * direction
        resid_bound = residual - alpha_b[:, None] * hd

        # Interior case: standard CG update.
        resid_in = residual - alpha[:, None] * hd
        rtr_new = _dot(resid_in, resid_in)
        beta = safe_div(rtr_new, rtr)
        dir_in = resid_in + beta[:, None] * direction

        sel = (~converged) & crossed
        keep = converged | sel
        step_n = torch.where(converged[:, None], step, torch.where(sel[:, None], step_bound, step_try))
        resid_n = torch.where(
            converged[:, None], residual, torch.where(sel[:, None], resid_bound, resid_in)
        )
        dir_n = torch.where(keep[:, None], direction, dir_in)
        rtr_n = torch.where(keep, rtr, rtr_new)
        it_n = torch.where(converged, iteration, iteration + 1)

        r2 = running[:, None]
        step = torch.where(r2, step_n, step)
        residual = torch.where(r2, resid_n, residual)
        direction = torch.where(r2, dir_n, direction)
        rtr = torch.where(running, rtr_n, rtr)
        iteration = torch.where(running, it_n, iteration)
        hvps = hvps + running.to(hvps.dtype)
        done = done | (running & keep)
    return hvps, step, residual


def minimize_tron(
    value_and_grad_fn: ValueAndGrad,
    hessian_vector_fn: HessianVector,
    w0: Tensor,
    *,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    tolerance: float = DEFAULT_TOLERANCE,
    tracking: bool = False,
) -> OptResult:
    """Minimize each lane from `w0` (B, D); `hessian_vector_fn(W, V) -> H(W) V`."""
    if w0.ndim != 2:
        raise ValueError(f"w0 must be (lanes, dim), got shape {tuple(w0.shape)}")
    B = w0.shape[0]
    dev = w0.device
    x = w0.clone()
    f, g = value_and_grad_fn(x)
    init_f = f
    init_gnorm = torch.linalg.vector_norm(g, dim=-1)
    delta = init_gnorm.clone()
    iteration = torch.zeros(B, dtype=torch.int32, device=dev)
    failures = torch.zeros(B, dtype=torch.int32, device=dev)
    reason = torch.where(
        init_gnorm == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED), 0
    ).to(torch.int32)
    evals = torch.ones(B, dtype=torch.int32, device=dev)
    all_lanes = torch.ones(B, dtype=torch.bool, device=dev)
    loss_hist = empty_history(B, max_iterations, tracking, x)
    gnorm_hist = empty_history(B, max_iterations, tracking, x)
    record(loss_hist, iteration, f, all_lanes)
    record(gnorm_hist, iteration, init_gnorm, all_lanes)

    # Every pass accepts a step (iteration + 1) or counts a failure; a lane
    # stops after max_iterations accepted steps or _MAX_FAILURES failures in
    # a row, so this bound is never what ends the loop.
    for _ in range(max_iterations * (_MAX_FAILURES + 1) + 1):
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        x_cur = x
        hvp_calls, step, residual = _truncated_cg(
            lambda v: hessian_vector_fn(x_cur, v), g, delta, active
        )
        gs = _dot(g, step)
        predicted = -0.5 * (gs - _dot(step, residual))
        x_try = x + step
        f_try, g_try = value_and_grad_fn(x_try)
        actual = f - f_try
        step_norm = torch.linalg.vector_norm(step, dim=-1)

        denom = f_try - f - gs
        sig3 = torch.full_like(denom, _SIGMA3)
        alpha = torch.where(
            denom <= 0.0, sig3, torch.clamp_min(-0.5 * safe_div(gs, denom), _SIGMA1)
        )
        a_step = alpha * step_norm
        new_delta = torch.where(
            actual < _ETA0 * predicted,
            torch.minimum(torch.clamp_min(alpha, _SIGMA1) * step_norm, _SIGMA2 * delta),
            torch.where(
                actual < _ETA1 * predicted,
                torch.maximum(_SIGMA1 * delta, torch.minimum(a_step, _SIGMA2 * delta)),
                torch.where(
                    actual < _ETA2 * predicted,
                    torch.maximum(_SIGMA1 * delta, torch.minimum(a_step, _SIGMA3 * delta)),
                    torch.maximum(delta, torch.minimum(a_step, _SIGMA3 * delta)),
                ),
            ),
        )

        improved = actual > _ETA0 * predicted
        x_new = torch.where(improved[:, None], x_try, x)
        f_new = torch.where(improved, f_try, f)
        g_new = torch.where(improved[:, None], g_try, g)
        it_new = torch.where(improved, iteration + 1, iteration)
        fail_new = torch.where(improved, 0, failures + 1).to(torch.int32)
        new_reason = check_convergence(
            loss=f_new,
            prev_loss=f,
            init_loss=init_f,
            grad_norm=torch.linalg.vector_norm(g_new, dim=-1),
            init_grad_norm=init_gnorm,
            iteration=it_new,
            max_iterations=max_iterations,
            tolerance=tolerance,
        )
        # A rejected step cannot converge on function values (the loss did
        # not move); it stops the lane only once the failures run out.
        new_reason = torch.where(
            improved,
            new_reason,
            torch.where(
                fail_new >= _MAX_FAILURES,
                int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
                int(ConvergenceReason.NOT_CONVERGED),
            ),
        ).to(torch.int32)

        a2 = active[:, None]
        x = torch.where(a2, x_new, x)
        f = torch.where(active, f_new, f)
        g = torch.where(a2, g_new, g)
        delta = torch.where(active, new_delta, delta)
        iteration = torch.where(active, it_new, iteration)
        failures = torch.where(active, fail_new, failures)
        reason = torch.where(active, new_reason, reason)
        evals = evals + torch.where(active, hvp_calls + 1, 0).to(torch.int32)
        record(loss_hist, iteration, f, active)
        record(gnorm_hist, iteration, torch.linalg.vector_norm(g, dim=-1), active)

    return OptResult(
        coefficients=x,
        loss=f,
        gradient_norm=torch.linalg.vector_norm(g, dim=-1),
        iterations=iteration,
        reason=reason,
        loss_history=loss_hist,
        gradient_norm_history=gnorm_hist,
        fn_evals=evals,
    )
