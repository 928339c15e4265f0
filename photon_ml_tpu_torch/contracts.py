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
    # On the card, sparse kernels vs their plain versions run on float64 copies of the vectors: the
    # kernels sum each row and each tile's column runs in f32 lane order and the rest in double. (The
    # f32 plain version's index_add_ adds in atomic order, which on the e2e intercept column, 4M
    # entries, drifts up to ~1e-4 of the vector's scale by itself and differs run to run.)
    "sparse_kernel_vs_plain": {"scale_rel": 1e-4},
    # On the card vs on the CPU, same small GLMix on the same (bf16-exact) data: solver f32 noise only.
    # The random effect is held on its objective, not its coefficients: an f32 lane stops once
    # |f - f_prev| <= tol |f0| (tol 1e-5), where the coefficients are still ~1e-2 from the float64
    # optimum but the objective is within ~1e-4 of it; a lane left at its cold start sits ~1e-2
    # above it. chip_smoke.py phase 5 prints both readings and fails unless this limit separates them.
    # SIMPLE variances (1/diag(H), sums of x^2 l''(z)) differ only by the f32 summation order of those
    # sums and the scores' solver noise: phase 5f reads 4.9e-6 (fixed effect) and 6.6e-6 (per-user)
    # relative on an H100, so a limit of 1e-4 leaves 15x room and still fails a wrong sum.
    "card_vs_cpu_glmix": {"fe_coef_atol": 5e-4, "re_objective_rtol": 1e-3, "auc_atol": 1e-4,
                          "variance_rtol": 1e-4},
    # Feature summaries: the port sums in float64, the reference in float32 (~1e-7 of the sums).
    "stats": {"rtol": 1e-5, "atol": 1e-6},
    # The estimator end to end against the reference's, two sweeps. Each f32 solve stops where f no
    # longer decreases in f32, within eps f of its optimum, so a lane's coefficients may sit anywhere
    # within ~sqrt(2 eps f / l2) of it: ~1.1e-3 for a 40-row entity at L2 5 (the CPU tests' users),
    # on either package's side; the port's dense (E, S, D_proj) blocks and the reference's ELL blocks
    # sum in other orders, so the two land at different points. A score sums three coordinates' such
    # errors. Variances are 1/diag(H), sums of c = l''(z): |l'''| <= 0.1 times a score's error moves c
    # by up to 0.1 * 4e-3 / c relative, ~8e-3 where c is small (|z| ~ 3).
    "estimator": {"coef_atol": 2e-3, "score_atol": 4e-3, "metric_atol": 1e-4, "variance_rtol": 1e-2},
}

# The stages of one Avro ingest (io/avro_data.read_game_dataset), in seconds.
# "stash" is kept for the reference's schema and always reads 0.0 here: the
# port builds its sparse layout on the device from the ELL planes.
INGEST_STAGES = ("decode", "assemble", "tags", "ell", "stash")

# Every key of a dataset's `ingest_timing`: the stages, the wall time they do
# not cover, the route taken and the chunk accounting.
INGEST_TIMING_REQUIRED_KEYS = (
    *INGEST_STAGES,
    "other",
    "ingest_path",
    "streaming",
    "chunks",
)

# The stages of an estimator's prepare, in seconds (GameEstimator.fit_timing):
# random-effect layouts, projection, feature statistics and coordinate
# construction ("compile"). "pack" and "upload" are kept for the reference's
# schema and read 0.0: a dataset lives on its device from ingest on, and the
# port has no bucketed pack.
PREPARE_STAGES = ("re_build", "projector", "stats", "pack", "upload", "compile")

# Every key of an estimator's `fit_timing` that the reference's schema also
# requires: the stages, the wall they do not cover, the two walls and where
# the random-effect assembly ran. (The reference's pack placement, sharding,
# robustness and plan blocks belong to layers the port has not got.)
FIT_TIMING_REQUIRED_KEYS = (
    *PREPARE_STAGES,
    "other",
    "prepare_s",
    "solve_s",
    "re_device_s",
    "re_host_s",
    "re_path",
)
