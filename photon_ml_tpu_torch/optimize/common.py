"""Optimizer results and convergence criteria.

Port of `photon_ml_tpu/optimize/common.py`. The optimizers here are batched:
every field of an `OptResult` has a leading lane axis (B,) — one lane per
problem — unless the caller solved a single unbatched problem, in which
case `problem.solve` hands back the lane-0 view. Convergence is an integer
reason per lane; a lane whose reason is set is frozen.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class ConvergenceReason(enum.IntEnum):
    """Why optimization stopped. Values are stable: stored in tensors."""

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4


class OptResult(NamedTuple):
    coefficients: Tensor
    loss: Tensor
    gradient_norm: Tensor
    iterations: Tensor
    reason: Tensor  # int32 ConvergenceReason codes
    # Per-iteration loss / gradient norm, NaN past `iterations`; zero-length
    # along the history axis when tracking is off.
    loss_history: Tensor
    gradient_norm_history: Optional[Tensor] = None
    # Objective passes: value/gradient evaluations (line-search trials
    # included) plus, for TRON, Hessian-vector products. On the kernel path
    # each is one read of X.
    fn_evals: Optional[Tensor] = None

    def lane(self, i: int) -> "OptResult":
        """The unbatched result of lane `i`."""
        return OptResult(*(None if f is None else f[i] for f in self))


def check_convergence(
    *,
    loss: Tensor,
    prev_loss: Tensor,
    init_loss: Tensor,
    grad_norm: Tensor,
    init_grad_norm: Tensor,
    iteration: Tensor,
    max_iterations: int,
    tolerance: float,
) -> Tensor:
    """Per-lane reason code, tested in the reference's order:
    FUNCTION_VALUES_CONVERGED (|f - f_prev| <= tol |f0|), then
    GRADIENT_CONVERGED (||g|| <= tol ||g0||), then MAX_ITERATIONS."""
    func_conv = (loss - prev_loss).abs() <= tolerance * init_loss.abs()
    grad_conv = grad_norm <= tolerance * init_grad_norm
    max_it = iteration >= max_iterations
    reason = torch.where(
        func_conv,
        int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
        torch.where(
            grad_conv,
            int(ConvergenceReason.GRADIENT_CONVERGED),
            torch.where(
                max_it,
                int(ConvergenceReason.MAX_ITERATIONS),
                int(ConvergenceReason.NOT_CONVERGED),
            ),
        ),
    )
    return reason.to(torch.int32)


def empty_history(lanes: int, max_iterations: int, tracking: bool, like: Tensor) -> Tensor:
    cols = max_iterations + 1 if tracking else 0
    return torch.full((lanes, cols), float("nan"), dtype=like.dtype, device=like.device)


def record(history: Tensor, iteration: Tensor, values: Tensor, mask: Tensor) -> None:
    """In place: history[b, iteration[b]] = values[b] where mask[b]."""
    if history.shape[-1] == 0:
        return
    lanes = torch.nonzero(mask).flatten()
    if lanes.numel():
        history[lanes, iteration[lanes].long()] = values[lanes].to(history.dtype)


def safe_div(a: Tensor, b: Tensor, eps: float = 0.0) -> Tensor:
    """a / b with 0 where |b| <= eps."""
    bad = b.abs() <= eps
    q = a / torch.where(bad, torch.ones_like(b), b)
    return torch.where(bad, torch.zeros_like(q), q)
