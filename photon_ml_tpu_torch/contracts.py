"""Parity tolerances of the port: the one place they live.

Each entry bounds how far the port may sit from what it is compared with,
with a one-line reason. "scale_rel" bounds max|a - b| / max|b| over a vector
(the form the JAX package's own kernel tests use: a small element of a
mixed-magnitude vector may miss a per-element rtol while the vector is right
to its scale). The CPU tests compare against the JAX package; chip_smoke.py
compares the CUDA kernels against their plain versions on the card.
"""

from __future__ import annotations

PORT_TOLERANCES = {
    # f32 elementwise formulas; XLA's and ATen's exp/log1p differ in the last ulp.
    "losses": {"rtol": 1e-6, "atol": 1e-6},
    # Pallas kernel (interpret mode) runs f32 X as a hi/lo bf16 split, ~2^-16 of the largest magnitudes.
    "kernel_sums_f32": {"scale_rel": 5e-5, "rtol": 2e-5, "atol": 2e-4},
    # bf16 X: the Pallas kernel hi/lo-splits the right-hand side (~2^-16); the port widens X to f32 exactly.
    "kernel_sums_bf16": {"scale_rel": 1e-4, "rtol": 5e-5, "atol": 5e-4},
    # Same formulas in f32; only the summation order of X w and X^T u differs.
    "objective": {"scale_rel": 1e-5, "rtol": 1e-5, "atol": 1e-4},
    # f32 noise in the Armijo test near the optimum moves the step count a little; the optimum does not move.
    "solver": {"coef_atol": 2e-4, "loss_rtol": 1e-5, "iterations": 2},
    # Two coordinate-descent sweeps carry FE and RE solver rounding through the residual offsets.
    "glmix": {"coef_atol": 5e-4, "score_atol": 1e-3, "auc_atol": 1e-4},
    # Same weights and data on both sides; only the order of the per-row dot products differs.
    "convert_scores": {"rtol": 1e-5, "atol": 1e-5},
    # On the card: the kernel sums each block's rows in f32 and the blocks in double; cuBLAS orders the plain version's sums differently.
    "kernel_vs_plain": {"scale_rel": 1e-4, "rtol": 1e-4},
    # On the card, sparse kernels vs their plain versions: the kernels sum each row, each column chunk
    # in f32 lane order and the chunks in double; the plain index_add_ adds in f32 atomic order, which on a
    # hot column (a million entries) drifts ~1e-5 of the vector's scale.
    "sparse_kernel_vs_plain": {"scale_rel": 1e-4},
    # On the card vs on the CPU, same small GLMix on the same (bf16-exact) data: solver f32 noise only.
    # The random effect is held on its objective, not its coefficients: an f32 lane stops once
    # |f - f_prev| <= tol |f0| (tol 1e-5), where the coefficients are still ~1e-2 from the float64
    # optimum but the objective is within ~1e-4 of it; a lane left at its cold start sits ~1e-2
    # above it. chip_smoke.py phase 5 prints both readings and fails unless this limit separates them.
    "card_vs_cpu_glmix": {"fe_coef_atol": 5e-4, "re_objective_rtol": 1e-3, "auc_atol": 1e-4},
}
