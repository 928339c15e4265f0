"""Batched L-BFGS / OWLQN / box-projected L-BFGS with a backtracking line
search.

Port of `photon_ml_tpu/optimize/lbfgs.py`. The JAX version is one
`lax.while_loop` that the random-effect coordinate vmaps over entity blocks;
PyTorch has no vmap of data-dependent loops, so this one is written batched
from the start:

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

OWLQN mode (`l1_weight` given, a scalar or one weight per lane) is the JAX
package's orthant-wise method, lane by lane: the objective includes
l1 ||x||_1, the pseudo-gradient seeds the two-loop recursion and the Armijo
test, the direction is zeroed where it disagrees with it, each trial is
projected onto the orthant (sign(x), or sign(-pg) at 0), convergence is
measured on the pseudo-gradient's norm, and the (s, y) pairs use the smooth
gradient. Box mode (`lower_bounds` / `upper_bounds`) clips `w0` and every
trial into the box (the reference's post-step projection, LBFGS.scala:70-75
/ LBFGSB). The two combine.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

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


def _pseudo_gradient(x: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """OWLQN pseudo-gradient of f(x) + l1 ||x||_1 per lane (l1 (B, 1)): the
    subgradient g + l1 sign(x) where x != 0; at x == 0 the direction of
    steepest descent if one exists, else 0."""
    right = g + l1
    left = g - l1
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    at_zero = torch.where(right < 0.0, right, torch.where(left > 0.0, left, zero))
    return torch.where(x > 0.0, right, torch.where(x < 0.0, left, at_zero))


def _lane_vector(v, B: int, like: Tensor) -> Tensor:
    """A scalar or (B,) per-lane value as a (B, 1) column."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return t.reshape(-1, 1).expand(B, 1) if t.numel() == 1 else t.reshape(B, 1)


def minimize_lbfgs(
    value_and_grad_fn: ValueAndGrad,
    w0: Tensor,
    *,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    tolerance: float = DEFAULT_TOLERANCE,
    tracking: bool = False,
    l1_weight: Optional[Union[float, Tensor]] = None,
    lower_bounds=None,
    upper_bounds=None,
) -> OptResult:
    """Minimize each lane of `value_and_grad_fn` (the smooth part) from
    `w0` (B, D).

    `value_and_grad_fn(W) -> (f (B,), g (B, D))`. Line-search trials take
    its value half too: on the kernel path value and gradient come from one
    read of X, so a value-only pass would cost the same.
    `l1_weight` not None selects OWLQN (a scalar or (B,) per lane; 0 is
    still OWLQN, as in the reference); `lower_bounds` / `upper_bounds`
    ((D,) or (B, D), host arrays or tensors; a missing side is unbounded)
    select the box."""
    if w0.ndim != 2:
        raise ValueError(f"w0 must be (lanes, dim), got shape {tuple(w0.shape)}")
    B, D = w0.shape
    m = _HISTORY
    dev, dtype = w0.device, w0.dtype
    use_l1 = l1_weight is not None
    l1 = _lane_vector(0.0 if l1_weight is None else l1_weight, B, w0)
    use_box = lower_bounds is not None or upper_bounds is not None
    if use_box:
        inf = torch.full((D,), float("inf"), dtype=dtype, device=dev)
        lower = -inf if lower_bounds is None else torch.as_tensor(lower_bounds).to(dev, dtype)
        upper = inf if upper_bounds is None else torch.as_tensor(upper_bounds).to(dev, dtype)

    def clip_box(x: Tensor) -> Tensor:  # jnp.clip's order: max with lower, then min with upper
        return torch.minimum(torch.maximum(x, lower), upper) if use_box else x

    def with_l1(f: Tensor, x: Tensor) -> Tensor:
        return f + l1[:, 0] * torch.sum(x.abs(), dim=-1) if use_l1 else f

    def pseudo(x: Tensor, g: Tensor) -> Tensor:
        return _pseudo_gradient(x, g, l1) if use_l1 else g

    x = clip_box(w0.clone())
    f, g = value_and_grad_fn(x)
    f = with_l1(f, x)
    pg = pseudo(x, g)
    init_f = f
    init_gnorm = torch.linalg.vector_norm(pg, dim=-1)
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
        d = -_two_loop(pg, S, Y, rho, k)
        if use_l1:
            # The direction stays in the pseudo-gradient's descent orthant;
            # the step's orthant is sign(x), or sign(-pg) where x == 0.
            d = torch.where(d * pg < 0.0, d, torch.zeros_like(d))
            orthant = torch.where(x != 0.0, torch.sign(x), torch.sign(-pg))
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
            if use_l1:
                x_try = torch.where(x_try * orthant >= 0.0, x_try, torch.zeros_like(x_try))
            x_try = clip_box(x_try)
            f_try = with_l1(value_and_grad_fn(x_try)[0], x_try)
            # Armijo on the projected step: f_new <= f + c1 pg.(x_new - x).
            ok = (f_try <= f + _ARMIJO_C1 * torch.sum(pg * (x_try - x), dim=-1)) & torch.isfinite(f_try)
            x_new = torch.where(searching[:, None], x_try, x_new)
            f_new = torch.where(searching, f_try, f_new)
            tries = tries + searching.to(torch.int32)
            ls_ok = ls_ok | (searching & ok)
            t = torch.where(searching & ~ok, t * 0.5, t)
            searching = searching & ~ok

        _, g_new = value_and_grad_fn(x_new)
        pg_new = pseudo(x_new, g_new)
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
            grad_norm=torch.linalg.vector_norm(pg_new, dim=-1),
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
        pg = torch.where(take[:, None], pg_new, pg)
        iteration = torch.where(active, it_new, iteration)
        reason = torch.where(active, new_reason, reason)
        evals = evals + torch.where(active, tries + 1, 0).to(torch.int32)
        record(loss_hist, iteration, f, active)
        record(gnorm_hist, iteration, torch.linalg.vector_norm(pg, dim=-1), active)

    return OptResult(
        coefficients=x,
        loss=f,
        gradient_norm=torch.linalg.vector_norm(pg, dim=-1),
        iterations=iteration,
        reason=reason,
        loss_history=loss_hist,
        gradient_norm_history=gnorm_hist,
        fn_evals=evals,
    )
