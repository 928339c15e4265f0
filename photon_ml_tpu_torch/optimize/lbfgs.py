"""Batched L-BFGS with a backtracking line search.

Port of the plain (L2/no-L1, unconstrained) mode of
`photon_ml_tpu/optimize/lbfgs.py`. The JAX version is one `lax.while_loop`
that the random-effect coordinate vmaps over entity blocks; PyTorch has no
vmap of data-dependent loops, so this one is written batched from the start:

  * every state tensor has a leading lane axis (B, ...); a fixed effect is
    the case B = 1;
  * a per-lane `reason` freezes a lane once it has stopped — its state is
    no longer updated, exactly as vmap's while-loop batching rule keeps a
    finished lane's carry;
  * the backtracking line search is per lane (Armijo, halving, at most
    `_MAX_LINE_SEARCH` trials); lanes whose search has succeeded sit out the
    remaining trials;
  * the host leaves each loop as soon as no lane is still running.

The two-loop recursion keeps the JAX circular-buffer semantics (slot
k mod m holds the newest pair) and `fn_evals` counts every objective
evaluation, line-search trials included.
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

DEFAULT_MAX_ITERATIONS = 100
DEFAULT_TOLERANCE = 1e-7
_HISTORY = 10
_CURVATURE_EPS = 1e-10
_MAX_LINE_SEARCH = 30
_ARMIJO_C1 = 1e-4


def _two_loop(q: Tensor, S: Tensor, Y: Tensor, rho: Tensor, k: Tensor) -> Tensor:
    """Two-loop recursion per lane over circular (s, y) buffers (B, m, D),
    newest pair at slot (k - 1) mod m, pairs past min(k, m) masked."""
    B, m, _ = S.shape
    ar = torch.arange(m, device=S.device)
    order = torch.remainder(k[:, None] - 1 - ar[None, :], m)  # newest first
    valid = ar[None, :] < torch.clamp_max(k, m)[:, None]
    lanes = torch.arange(B, device=S.device)[:, None]
    S_o, Y_o, rho_o = S[lanes, order], Y[lanes, order], rho[lanes, order]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    alphas = []
    for i in range(m):
        a = torch.where(valid[:, i], rho_o[:, i] * torch.sum(S_o[:, i] * q, dim=-1), zero)
        q = q - a[:, None] * Y_o[:, i]
        alphas.append(a)
    # S_o[:, 0] is the newest pair (slot (k - 1) mod m).
    sy = torch.sum(S_o[:, 0] * Y_o[:, 0], dim=-1)
    yy = torch.sum(Y_o[:, 0] * Y_o[:, 0], dim=-1)
    one = torch.ones((), dtype=q.dtype, device=q.device)
    gamma = torch.where(k > 0, safe_div(sy, yy), one)
    gamma = torch.where(gamma > 0.0, gamma, one)
    r = gamma[:, None] * q
    for i in range(m - 1, -1, -1):  # oldest first
        b = torch.where(valid[:, i], rho_o[:, i] * torch.sum(Y_o[:, i] * r, dim=-1), zero)
        r = r + S_o[:, i] * torch.where(valid[:, i], alphas[i] - b, zero)[:, None]
    return r


def minimize_lbfgs(
    value_and_grad_fn: ValueAndGrad,
    w0: Tensor,
    *,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    tolerance: float = DEFAULT_TOLERANCE,
    tracking: bool = False,
) -> OptResult:
    """Minimize each lane of `value_and_grad_fn` from `w0` (B, D).

    `value_and_grad_fn(W) -> (f (B,), g (B, D))`. Line-search trials take
    its value half too: on the kernel path value and gradient come from one
    read of X, so a value-only pass would cost the same."""
    if w0.ndim != 2:
        raise ValueError(f"w0 must be (lanes, dim), got shape {tuple(w0.shape)}")
    B, D = w0.shape
    m = _HISTORY
    dev, dtype = w0.device, w0.dtype

    x = w0.clone()
    f, g = value_and_grad_fn(x)
    init_f = f
    init_gnorm = torch.linalg.vector_norm(g, dim=-1)
    S = torch.zeros((B, m, D), dtype=dtype, device=dev)
    Y = torch.zeros((B, m, D), dtype=dtype, device=dev)
    rho = torch.zeros((B, m), dtype=dtype, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    iteration = torch.zeros(B, dtype=torch.int32, device=dev)
    reason = torch.where(
        init_gnorm == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED), 0
    ).to(torch.int32)
    evals = torch.ones(B, dtype=torch.int32, device=dev)
    all_lanes = torch.ones(B, dtype=torch.bool, device=dev)
    loss_hist = empty_history(B, max_iterations, tracking, x)
    gnorm_hist = empty_history(B, max_iterations, tracking, x)
    record(loss_hist, iteration, f, all_lanes)
    record(gnorm_hist, iteration, init_gnorm, all_lanes)
    lane_ids = torch.arange(B, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    for _ in range(max_iterations):
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        d = -_two_loop(g, S, Y, rho, k)
        t = torch.where(k == 0, safe_div(one, torch.linalg.vector_norm(d, dim=-1)), one)
        t = torch.where(t > 0.0, t, one)

        # Per-lane backtracking line search (Armijo on the step taken).
        x_new, f_new = x, f
        ls_ok = torch.zeros(B, dtype=torch.bool, device=dev)
        tries = torch.zeros(B, dtype=torch.int32, device=dev)
        searching = active
        for _ in range(_MAX_LINE_SEARCH):
            if not bool(searching.any()):
                break
            x_try = x + t[:, None] * d
            f_try, _ = value_and_grad_fn(x_try)
            ok = (f_try <= f + _ARMIJO_C1 * torch.sum(g * (x_try - x), dim=-1)) & torch.isfinite(f_try)
            x_new = torch.where(searching[:, None], x_try, x_new)
            f_new = torch.where(searching, f_try, f_new)
            tries = tries + searching.to(torch.int32)
            ls_ok = ls_ok | (searching & ok)
            t = torch.where(searching & ~ok, t * 0.5, t)
            searching = searching & ~ok

        _, g_new = value_and_grad_fn(x_new)
        s_vec = x_new - x
        y_vec = g_new - g
        sy = torch.sum(s_vec * y_vec, dim=-1)
        do_update = active & ls_ok & (sy > _CURVATURE_EPS)
        slot = torch.remainder(k, m)
        upd = lane_ids[do_update]
        if upd.numel():
            S[upd, slot[upd]] = s_vec[upd]
            Y[upd, slot[upd]] = y_vec[upd]
            rho[upd, slot[upd]] = safe_div(one, sy[upd])
        k = k + do_update.to(k.dtype)

        it_new = iteration + 1
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
        # A failed line search stops the lane at its previous point.
        new_reason = torch.where(
            ls_ok, new_reason, int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)
        ).to(torch.int32)
        take = active & ls_ok
        x = torch.where(take[:, None], x_new, x)
        f = torch.where(take, f_new, f)
        g = torch.where(take[:, None], g_new, g)
        iteration = torch.where(active, it_new, iteration)
        reason = torch.where(active, new_reason, reason)
        evals = evals + torch.where(active, tries + 1, 0).to(torch.int32)
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
