#!/usr/bin/env python3
"""Drive the PyTorch port (`photon_ml_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; there is no fallback anywhere):

1. Build the CUDA kernels (`photon_ml_tpu_torch/csrc/glm_fused.cu`,
   `csrc/sparse_glm.cu` and `csrc/exact_sum.cu`, one nvcc each) and the
   native Avro library
   (`photon_ml_tpu_torch/native/*.cc`, one g++, with deflate where the host
   has zlib), all started together, from the sources in this checkout;
   print the build times and ptxas' register/spill lines.
2. Kernel vs plain version on the card at the fixed effect's full width
   (1,048,576 x 512): `value_grad` and `hvp` for the four losses with f32
   and bf16 X, each called twice (bit-identical) and held against the plain
   PyTorch version (ops/glm_kernels.py) under PORT_TOLERANCES
   ["kernel_vs_plain"]; times are CUDA-event medians of 20 calls after
   warm-up, beside the plain version, one torch yardstick call pair
   (X @ w, then u @ X; the port never calls it) and the card's bound; each
   row names its route (rows or chunked, from d). Shapes off the main path
   are checked the same way (twice, against the plain version), untimed:
   on the rows route d = 1000 f32, d = 517 bf16 (rows not on 16 bytes) and
   d = 124 bf16 and f32 (examples/run_glmix.sh's width), n = 70,001 (not a
   multiple of a tile); on the wide route d = 1,536 bf16 and d = 2,100 f32;
   on the chunked route d = 20,000 bf16 and d = 16,500 f32.
3. GLMix training at the bench's full width: a 1,048,576 x 512 dense logistic
   fixed effect (L-BFGS, 40 iterations, tol 1e-8, L2 1.0) and a per-entity
   random effect of 8,192 entities x 16 features (active_upper_bound 128,
   min_bucket 32; L-BFGS, 20 iterations, tol 1e-7, L2 10.0), one
   coordinate-descent sweep, then scoring and training AUC.
4. The fixed effect again with TRON (15 iterations, tol 1e-6, L2 1.0): the
   Hessian-vector kernel's path. Then one more GLMix sweep under
   torch.profiler: device busy time by kernel and the device's idle share.
5. Reference check, on three seeds: a small GLMix fit on the card (kernel
   path) and on the CPU (plain path) on the same data must agree under
   PORT_TOLERANCES["card_vs_cpu_glmix"]: fixed-effect coefficients, AUC,
   and each entity's random-effect objective against a float64 polish of
   its optimum (with the reading of a lane left at its cold start beside
   it, which the limit must stay below).

The sparse fixed effect (bench.py's sparse shape: 1,048,576 rows x 64
uniform feature ids, dim 16,384, normal values), its layout (CSR in row
tiles with each tile's column order and slabs; no CSC copy at this width,
which every kernel takes on its single stream) built on the card and
timed, then a second layout of the same entries with the CSC copy, for the
two-pass route and the cuSPARSE transposes of phase 2s alone:

2s. Each sparse kernel (ops/sparse_kernels.py) against its plain version
   (run on float64 copies of the vectors) on the main path's layout under
   PORT_TOLERANCES["sparse_kernel_vs_plain"],
   called twice (bit-identical), timed beside its plain version, one
   cuSPARSE call (torch.sparse_csr_tensor; the port never calls it) and its
   bound; each row names its route (single_stream or two_pass, chosen from
   dim), and each kernel is also checked and timed on the two-pass route
   (`two_pass_ms`, on the layout with the CSC copy), in turns with the
   chosen one. The set-up line times the row tiles and the tile
   permutation apart. Then four untimed shapes off the main path: a
   skewed one (~30% of entries on 16 columns, empty rows), a wide one (dim
   200,003: the two-pass route, whose layout carries the CSC copy; empty
   columns), one at X^T u's widest single stream (dim 27,648; the fused
   sums there take the two-pass route) and one with rows longer than a
   row tile, empty rows and empty columns, where empty rows and columns
   must give exact zeros.
3s. GLMix with the sparse fixed effect (L-BFGS, 20 iterations, tol 1e-7,
   L2 1.0; bench.py:2717-2726) and phase 3's random effect: one sweep,
   scoring, training AUC.
4s. The sparse fixed effect with TRON (15 iterations, tol 1e-6, L2 1.0) and
   SIMPLE coefficient variances, which must be finite and positive; then
   one profiled sweep of 3s (4s-b) and one profiled TRON + variances solve
   (4s-c).
5s. Phase 5's card-vs-CPU check with a small sparse fixed effect.

bench.py's e2e_from_disk cell (bench.py:4657-4790) through the port, at
4,000,000 rows (r08 ran 20,000,000): bench's generator (seed 23; 27,586
users, 5,405 movies; 8 uniform ids a row over dim 200, normal values)
written as two Avro files with integer userId/movieId tags by the port's
native writer (photon_ml_tpu_torch/native/, built by g++), read by
io/avro_data.read_game_dataset onto the card as one sparse shard "g" (the
8 ids and the intercept column, dim 201):

2e. The sparse kernels (fused, X w, X^T u plain and squared) on the layout
   of the ingested shard, as in 2s (checked against the plain versions,
   twice, timed beside the plain version, cuSPARSE and the bound): a narrow
   shape with one hot column, the intercept, in every row. Then the same
   on two control shapes: the 8 ids alone, and the 8 ids with a 9th
   uniform id in place of the intercept.
3e. Writing (seconds, MB), ingest (seconds and every INGEST_STAGES key,
   `other`, `ingest_path`, `streaming`, `chunks`; the phase fails unless
   the route is native, streamed or not, with 2 chunks), the layout (seconds,
   MiB), then one coordinate-descent sweep of the bench's model with its
   configs (bench.py:4757-4789): the fixed effect (L-BFGS, 10 iterations,
   tol 1e-6, L2 1.0) and per-user and per-movie random effects on "g"
   (5 iterations, tol 1e-5, L2 10.0, min_bucket 8, active_upper_bound
   256/512; each bucket's ELL block made dense on the card for the batched
   solve), after a warm-up sweep: per-coordinate seconds, bucket shapes,
   the sparse launches (sparse_fused = the fixed effect's objective
   passes, sparse_matvec nonzero, dense kernels 0), peak memory and the
   training AUC (above 0.5); then one profiled sweep (3e-b).
5e. A small fit from files (12,000 rows: 80 users, 16 movies) on the card
   and on the CPU, two seeds, under PORT_TOLERANCES["card_vs_cpu_glmix"]:
   fixed-effect coefficients, AUC, and each random effect held on its
   objective as in phases 5 and 5s.
3f. Phase 3e's cell through the estimator, as bench.py trains it
   (bench.py:4745-4790): `GameEstimator.fit(ds, None, [configs])` on 3e's
   ingested dataset, with the default INDEX_MAP projector, so the random
   effects' layouts and projections are built by torch ops on the card.
   Prints `fit_timing` (every prepare stage, `re_path`), each random
   effect's D_proj, entities, buckets and projected shard (MiB), the sweep
   by coordinate, training AUC, peak memory and the launches. Fails unless
   the fixed effect is bit-equal to 3e's, the AUC within 1e-4 of 3e's, the
   sparse_fused launches equal 3e's (and no dense kernel runs), each
   random effect's back-projected matrix within PORT_TOLERANCES["glmix"]
   ["coef_atol"] of 3e's (or, where f32 stopping noise moves a lane past
   it, each entity's objective within PORT_TOLERANCES["card_vs_cpu_glmix"]
   ["re_objective_rtol"] of 3e's; the row says which held), and the card's
   layouts and slot tables bit-equal to a CPU build from the same tag codes.
5f. Two small estimator fits from arrays (12,000 training rows of the e2e
   generator, 80 users and 16 movies, and 2,000 validation rows, a fifth
   of them of users never seen), on the card and on the CPU: the e2e
   coordinates with INDEX_MAP, STANDARDIZATION with the intercept, SIMPLE
   variances on the fixed effect and per-user, Pearson masks on per-movie
   and AUC and AUPR on the validation rows; then a dense fixed effect
   trained by TRON beside per-user, so kernels #1 and #2 run through the
   estimator (#4 and #5 run in the first fit, #6 in its variances). Under
   PORT_TOLERANCES["card_vs_cpu_glmix"], each random effect on its
   objective (with its projection, normalization and mask), the fixed
   effect's and per-user's variances within its "variance_rtol".
3c. The drivers at full width on phase 3e's Avro files (kept until 3c
   ends): `photon_ml_tpu_torch.cli.train.main` with the e2e cell's
   coordinates as DSL strings (one sweep, output mode BEST), then
   `cli.score.main` with AUC. The saved model (read back by the port's
   `load_game_model`) must equal 3f's fit in the original space
   (`model_bridge.artifact_from_game_model`): the fixed effect bit-equal,
   each random effect within PORT_TOLERANCES["glmix"]["coef_atol"] (the row
   says whether bit-equal); 3f's artifact saved and loaded back must be
   exact; 4,000,000 rows scored, the AUC within "auc_atol" of 3f's and the
   written scores (read back by `score_store.load_score_columns`) within
   "score_atol" of 3f's. Launches are counted from 0 around each driver:
   `sparse_fused` in train, `sparse_matvec` in score, no dense kernel.
   Prints each driver's `timings_s`, the model's and scores' MiB, entity
   counts, the store's save/load seconds, and device memory before and at
   the peak of each driver.
5c. examples/run_glmix.sh's data (its generator run as a script, then the
   port's libsvm_to_avro) and its train step with SIMPLE variances, on
   the card and on the CPU: the two saved models under
   PORT_TOLERANCES["card_vs_cpu_glmix"] (fixed effect, variances, each
   entity's random-effect objective at the CPU fixed effect's offsets) with
   both validation AUCs; the test file scored by each (AUCs within
   "auc_atol") and the CPU's model scored on the card within
   PORT_TOLERANCES["convert_scores"] of the CPU's scores; `sparse_rmatvec`
   nonzero in the card's train (the SIMPLE variances).

Data-parallel GLMix on ranks of torch.distributed (photon_ml_tpu_torch/
parallel/), each rank a process started by parallel/launch.py that loads
phase 1's library and never builds: 4 ranks share the card over gloo (the
rows of phase 3's data, handed over as shared memory, owned by the random
effect's entities); NCCL runs with a card a rank (phases 2d-4d) where the
machine has 2 or more, and with world size 1 in this process. The phases
print which backend each used.

2d. Kernel #3, the sharded sums (ops/glm_kernels.py: #1/#2 on each rank's
   rows, one exact cross-rank sum: one all_gather of each rank's sums and
   the rank-order kernel of csrc/exact_sum.cu, first held bit for bit
   against its plain version at the sums' widths): value_grad (logistic)
   and hvp on bf16 X over each rank's quarter of phase 2's data, held
   against their plain version (the plain sums per rank, the same exact
   sum) under PORT_TOLERANCES["kernel_vs_plain"] and against the
   single-process kernel on all rows; every rank must hold the same bits.
   Per rank, CUDA-event medians behind a barrier of the kernel alone, the
   cross-rank sum, the whole call, the plain call, one all_reduce of the
   sums' size, and the library yardstick timed as the call is (the torch
   pair on the rank's rows, then one all_reduce of the float32 sums); the
   record takes the slowest rank's. The world-size-1 NCCL result must be
   the single-process kernel's bits.
3d. Phase 3's GLMix on the 4 ranks: a warm-up sweep, then one sweep; rows
   and lanes per rank, value_grad launches (= fn_evals) and cross-rank sums
   (= objective passes + one finiteness vote per update) per rank, sweep
   wall, AUC over all rows beside phase 3's, peak memory per rank, and
   rank-order kernel launches (= cross-rank sums) per rank. The fixed
   effect must be bit-identical on every rank, each rank's random-effect
   store must hold its own entities' rows alone, and every entity row of the
   assembled matrix must have one owner. Then the same sweep with world
   size 1 over NCCL here, which must give phase 3's bits.
4d. Phase 4's TRON fixed effect on the 4 ranks with SIMPLE variances:
   coefficients and variances bit-identical across ranks, variances finite
   and positive, one cross-rank sum per pass (+1 for the variances).
5d. Phase 5's small GLMix on three seeds: 4 ranks on the card against one
   CPU process, under PORT_TOLERANCES["card_vs_cpu_glmix"].

The kernels' launch counts are set to 0 just before each path (phases 3-4,
3s, 4s, 3e, 3f, 5f's card fits, 3c's two drivers, 5c's card runs, and 3d
and 4d in each rank) and read just after; the `kernels` line gives them by
phase (`launches_by_phase`). "wall:" lines give each group of phases'
seconds. The last three
lines of standard output are
the `kernels` JSON line, the card's name and power limit from nvidia-smi,
and `{"ok": true, "device": {...}}`. Data comes from numpy with --seed;
weights start at zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

N_ROWS = 1 << 20
D_FIXED = 512
D_RE = 16
N_ENTITIES = 8192
# The sparse fixed effect (bench.py:2656-2659): 64 entries per row, dim 16,384.
K_SPARSE = 64
D_SPARSE = 16384
SPARSE_SOURCE = "photon_ml_tpu_torch/csrc/sparse_glm.cu"
SPARSE_REPLACES = {"sparse_fused": "photon_ml_tpu/ops/pallas_sparse.py:690",
                   "sparse_matvec": "photon_ml_tpu/ops/pallas_sparse.py:216",
                   "sparse_rmatvec": "photon_ml_tpu/ops/pallas_sparse.py:255"}
# Kernel #3: #1/#2 on each rank's rows and one exact cross-rank sum.
DIST_REPLACES = {"sharded_value_grad": "photon_ml_tpu/ops/pallas_glm.py:705",
                 "sharded_hvp": "photon_ml_tpu/ops/pallas_glm.py:746"}

# Data-sheet rates (memory bytes/s, float32 FMA-pipe operations/s) by card,
# matched on the name nvidia-smi and torch report. SXM is the H100 default.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    raise SystemExit(f"no data-sheet rates for card {name!r}; add it to CARD_RATES")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare(got, ref):
    """(max abs error, worst scale-relative error) of tensors against references."""
    max_abs, worst_rel = 0.0, 0.0
    for g, r in zip(got, ref):
        g64, r64 = g.double(), r.double()
        err = float((g64 - r64).abs().max())
        scale = float(r64.abs().max())
        if r64.ndim == 0:  # a sum that may sit near zero: relative to max(|ref|, 1)
            scale = max(scale, 1.0)
        max_abs = max(max_abs, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
    return max_abs, worst_rel


def glmix_arrays(seed: int, n: int, d_fixed: int, d_re: int, n_entities: int):
    """bench.py's GLMix generator, in numpy."""
    rng = np.random.default_rng(seed)
    Xf = rng.standard_normal((n, d_fixed), dtype=np.float32)
    Xe = rng.standard_normal((n, d_re), dtype=np.float32)
    entity = rng.integers(0, n_entities, size=n)
    w = (rng.standard_normal(d_fixed, dtype=np.float32) * 0.1).astype(np.float32)
    u = (rng.standard_normal((n_entities, d_re), dtype=np.float32) * 0.5).astype(np.float32)
    margin = Xf @ w + np.einsum("nd,nd->n", Xe, u[entity])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return Xf, Xe, entity, y


def sparse_glmix_arrays(seed: int, n: int, k: int, dim: int, d_re: int, n_entities: int):
    """bench.py's sparse shard (bench.py:2656-2659: k uniform feature ids per
    row, duplicates kept, normal values) and a per-entity random effect as in
    `glmix_arrays`; labels from both, in numpy."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, k), dtype=np.int32)
    val = rng.standard_normal((n, k), dtype=np.float32)
    Xe = rng.standard_normal((n, d_re), dtype=np.float32)
    entity = rng.integers(0, n_entities, size=n)
    w = (rng.standard_normal(dim, dtype=np.float32) * 0.1).astype(np.float32)
    u = (rng.standard_normal((n_entities, d_re), dtype=np.float32) * 0.5).astype(np.float32)
    margin = np.einsum("nk,nk->n", val, w[idx]) + np.einsum("nd,nd->n", Xe, u[entity])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return idx, val, Xe, entity, y


def re_lane_blocks(ds, red, offsets):
    """Each bucket of a random effect at `offsets` (with the dataset's
    Pearson mask) as (entity rows of its real lanes, their dense float64
    LabeledData block); padding lanes hold no rows and are dropped."""
    from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures, ell_block_to_dense
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data

    for b in red.buckets:
        real = b.mask.sum(dim=1) > 0
        blk = gather_block_data(ds, red.feature_shard, b, offsets, red.feature_mask)
        if isinstance(blk.features, SparseFeatures):  # a sparse shard's block, made dense
            blk = dataclasses.replace(blk, features=ell_block_to_dense(blk.features))
        yield b.entity_rows[real], LabeledData(*(t[real].double() for t in
                                                 (blk.features, blk.labels, blk.offsets, blk.weights)))


def re_objective_readings(ds, red, offsets, loss, l2: float, matrices, norm=None):
    """Hold random-effect coefficient matrices (name -> (E+1, D)) to the
    per-entity objectives of the coordinate's last solve on `ds`, `offsets`
    (with the dataset's Pearson mask, and `norm`: a NormalizationContext or
    a per-entity one, as the coordinate trained).

    Each entity's objective is polished to the end of float64's resolution
    from matrices["cpu"] (L-BFGS, tolerance 0); every matrix is then read in
    float64 against that optimum. Returns the largest relative objective
    excess and the largest coefficient distance from the optimum per matrix,
    and `fault`: the smallest excess over entities of a lane that never left
    its cold start (its row zeroed), which a sound limit must stay below."""
    import torch

    from photon_ml_tpu_torch.ops import objective
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext, PerEntityNormalization
    from photon_ml_tpu_torch.optimize import problem
    from photon_ml_tpu_torch.optimize.config import (
        L2,
        CoordinateOptimizationConfig,
        OptimizerConfig,
    )

    polish = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=200, tolerance=0.0), regularization=L2, reg_weight=l2)
    excess = dict.fromkeys(matrices, -float("inf"))
    dist = dict.fromkeys(matrices, 0.0)
    fault = float("inf")
    for rows, blk in re_lane_blocks(ds, red, offsets):
        lane_norm = norm.rows_context(rows) if isinstance(norm, PerEntityNormalization) else norm
        if lane_norm is not None:
            f64 = lambda t: None if t is None else t.double()
            lane_norm = NormalizationContext(f64(lane_norm.factors), f64(lane_norm.shifts), None)
        f_of = lambda W: objective.value(loss, W, blk, lane_norm, l2)
        w_star = problem.solve(loss, blk, polish, matrices["cpu"][rows].double(), lane_norm,
                               use_kernel=False).coefficients
        f_star = f_of(w_star)
        scale = f_star.abs().clamp_min(1.0)
        for name, M in matrices.items():
            W = M[rows].double()
            excess[name] = max(excess[name], float(((f_of(W) - f_star) / scale).max()))
            dist[name] = max(dist[name], float((W - w_star).abs().max()))
        fault = min(fault, float(((f_of(torch.zeros_like(w_star)) - f_star) / scale).min()))
    return dict(excess=excess, coef_dist=dist, fault=fault)


def re_objective_gap(ds, red, offsets, loss, l2: float, a, b) -> float:
    """The largest relative gap, over entities, between the objectives of two
    (E+1, D) coefficient matrices of one random effect at `offsets`, in
    float64 (no normalization: the e2e cell has none)."""
    from photon_ml_tpu_torch.ops import objective

    gap = 0.0
    for rows, blk in re_lane_blocks(ds, red, offsets):
        fa = objective.value(loss, a[rows].double(), blk, None, l2)
        fb = objective.value(loss, b[rows].double(), blk, None, l2)
        gap = max(gap, float(((fa - fb).abs() / fb.abs().clamp_min(1.0)).max()))
    return gap


def profile_sweep(coords, wall_s: float) -> dict:
    """Device busy time per kernel name of one coordinate-descent sweep under
    torch.profiler, and the idle share against the unprofiled wall time."""
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent

    return profile_call(lambda: run_coordinate_descent(coords, 1), wall_s)


def profile_call(fn, wall_s: float) -> dict:
    """Device busy time per kernel name of one call of `fn` under
    torch.profiler, and the idle share against its unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched.
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy_ms = sum(t for _, t, _ in by_kernel)
    return dict(
        device_busy_ms=busy_ms, wall_ms=wall_s * 1e3,
        device_idle_share=1.0 - busy_ms / (wall_s * 1e3), device_ops=sum(c for _, _, c in by_kernel),
        top=[dict(name=k[:60], ms=t, calls=c) for k, t, c in by_kernel[:8]],
    )


SMALL_RE_LAYOUT = dict(active_upper_bound=96, min_bucket=16)
SMALL_RE_L2 = 10.0


def small_glmix_fit(ds, fe_shard: str) -> dict:
    """Phase 5's small GLMix (fixed effect on `fe_shard`, per-entity random
    effect on "per_entity") fit by two sweeps on `ds`: one process, or one
    rank's share of the rows (then the model and AUC are of all ranks)."""
    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig, build_random_effect_dataset
    from photon_ml_tpu_torch.evaluation.metrics import (
        area_under_roc_curve,
        area_under_roc_curve_over_ranks,
    )
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    small_fe = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-6), regularization=L2, reg_weight=1.0)
    small_re = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-5), regularization=L2,
        reg_weight=SMALL_RE_L2)
    red = build_random_effect_dataset(
        ds, RandomEffectDataConfig("entityId", "per_entity", **SMALL_RE_LAYOUT))
    sc = {"fixed": FixedEffectCoordinate(ds, fe_shard, small_fe, task),
          "per-entity": RandomEffectCoordinate(ds, red, small_re, task)}
    r = run_coordinate_descent(sc, 2)
    s = sum(sc[c].score(r.model[c]) for c in sc)
    auc = (area_under_roc_curve(s, ds.labels) if ds.sharding is None
           else area_under_roc_curve_over_ranks(ds.sharding, s, ds.labels))
    model = gather_game_model(sc, r.model)
    return dict(
        fe=model["fixed"].coefficients.means.cpu(), re=model["per-entity"].coefficients_matrix.cpu(),
        auc=float(auc),
        # The offsets the random effect's last solve ran on.
        re_offsets=ds.offsets + sc["fixed"].score(r.model["fixed"]), ds=ds, red=red,
    )


def small_glmix_compare(seed: int, card: dict, cpu: dict):
    """A small GLMix fit on the card against the CPU fit from the same host
    arrays; returns (log row, failures) under PORT_TOLERANCES
    ["card_vs_cpu_glmix"]."""
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.ops.losses import LOGISTIC

    ref_tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    re = re_objective_readings(cpu["ds"], cpu["red"], cpu["re_offsets"], LOGISTIC, SMALL_RE_L2,
                               {"card": card["re"], "cpu": cpu["re"]})
    fe_err = float((card["fe"] - cpu["fe"]).abs().max())
    auc_err = abs(card["auc"] - cpu["auc"])
    limit = ref_tol["re_objective_rtol"]
    ok = (fe_err <= ref_tol["fe_coef_atol"] and re["excess"]["card"] <= limit
          and auc_err <= ref_tol["auc_atol"])
    row = dict(
        seed=seed, fe_coef_err=fe_err, re_objective_excess=re["excess"],
        re_coef_dist_from_f64=re["coef_dist"], re_fault_excess=re["fault"],
        re_coef_card_vs_cpu=float((card["re"] - cpu["re"]).abs().max()),
        auc_card=card["auc"], auc_cpu=cpu["auc"], tol=ref_tol, ok=ok)
    failures = []
    if not ok:
        failures.append(f"seed {seed}: the card's small GLMix disagrees with the CPU's")
    if not (re["excess"]["cpu"] <= limit < re["fault"]):
        failures.append(f"seed {seed}: re_objective_rtol {limit} does not separate the CPU fit "
                        f"({re['excess']['cpu']:.3e}) from a cold-start lane ({re['fault']:.3e})")
    return row, failures


def small_glmix_card_vs_cpu(seed: int, shards: dict, fe_shard: str, sy, sent):
    """Phase 5's small GLMix on the card (kernel path) and on the CPU (plain
    path) from the same host arrays, compared."""
    from photon_ml_tpu_torch.data.game_dataset import GameDataset

    fits = {where: small_glmix_fit(
        GameDataset.build(shards, sy, id_tags={"entityId": sent}, device=where), fe_shard)
        for where in ("cuda", "cpu")}
    return small_glmix_compare(seed, fits["cuda"], fits["cpu"])


def long_row_layout(gen, dev, n: int, dim: int, k: int, empty_cols: int, empty_every: int,
                    long_rows: dict):
    """An off-path shape for the single-stream route: k uniform ids a row
    from columns at or above `empty_cols`, every `empty_every`-th row empty,
    and the rows of `long_rows` (row -> length) longer than a row tile, with
    distinct columns."""
    import torch

    from photon_ml_tpu_torch.data import sparse_layout

    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = torch.randint(empty_cols, dim, (n * k,), generator=gen, device=dev)
    vals = torch.randn(n * k, generator=gen, device=dev)
    vals[(rows % empty_every) == 0] = 0.0
    parts_r, parts_c, parts_v = [rows], [cols], [vals]
    for r, length in long_rows.items():
        perm = torch.randperm(dim - empty_cols, generator=gen, device=dev)[:length] + empty_cols
        parts_r.append(torch.full((length,), r, device=dev))
        parts_c.append(perm)
        parts_v.append(torch.randn(length, generator=gen, device=dev))
    return sparse_layout.from_coo(torch.cat(parts_r), torch.cat(parts_c), torch.cat(parts_v), n, dim)


def sparse_kernel_checks(layout, layout_csc, dev, seed: int, bw: float, f32_rate: float,
                         phase: str = "2s", off_path: bool = True, shape: str = "main"):
    """Phase 2s (and 2e on the ingested shard): each sparse kernel against its
    plain version on `layout` (the main path's), twice (bit-identical), timed
    beside its plain version, a cuSPARSE call (torch.sparse_csr_tensor; the
    port never calls it), its bound and the two-pass route's time on
    `layout_csc` (the same entries with the CSC copy, which the cuSPARSE
    transposes read too); then, with `off_path`, four untimed shapes off the
    main path. Returns (rows by kernel name for the record line, failures)."""
    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data import sparse_layout
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.ops.losses import LOGISTIC, POISSON, SMOOTHED_HINGE, SQUARED

    tol = PORT_TOLERANCES["sparse_kernel_vs_plain"]["scale_rel"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    failures = []

    def vectors(L):
        n, d = L.shape
        return dict(
            w=0.05 * torch.randn(d, generator=gen, device=dev),
            u=torch.randn(n, generator=gen, device=dev),
            y=(torch.rand(n, generator=gen, device=dev) < 0.5).float(),
            off=0.1 * torch.randn(n, generator=gen, device=dev),
            wt=0.5 + torch.rand(n, generator=gen, device=dev),
            shift=torch.tensor(0.01, device=dev),
        )

    def variants(L, v, Lc=None):
        """(name, loss, route, kernel call, two-pass call on Lc, plain call,
        bytes, operations) per check."""
        nnz, (n, d) = L.nnz, L.shape
        entry_bytes = nnz * 8  # a 4-byte index and a 4-byte value per entry, read once
        out = [
            ("sparse_matvec", None, sk.matvec_route(d), lambda: (sk.matvec(L, v["w"]),),
             lambda: (sk.matvec_two_pass(Lc, v["w"]),),
             lambda: (sk.matvec_plain(L, v["w"]),), entry_bytes + 4 * (d + n), 2 * nnz),
            ("sparse_rmatvec", None, sk.rmatvec_route(d), lambda: (sk.rmatvec(L, v["u"]),),
             lambda: (sk.rmatvec_two_pass(Lc, v["u"]),),
             lambda: (sk.rmatvec_plain(L, v["u"]),), entry_bytes + 4 * (n + d), 2 * nnz),
            ("sparse_rmatvec_square", None, sk.rmatvec_route(d),
             lambda: (sk.rmatvec(L, v["u"], square=True),),
             lambda: (sk.rmatvec_two_pass(Lc, v["u"], True),),
             lambda: (sk.rmatvec_plain(L, v["u"], True),), entry_bytes + 4 * (n + d), 3 * nnz),
        ]
        for loss in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE):
            args = (loss, v["w"], v["shift"], L, v["y"], v["off"], v["wt"])
            args_c = (loss, v["w"], v["shift"], Lc, v["y"], v["off"], v["wt"])
            out.append(("sparse_fused", loss, sk.fused_route(d),
                        lambda a=args: sk.fused_value_gradient_sums(*a),
                        lambda a=args_c: sk.fused_value_gradient_sums_two_pass(*a),
                        lambda a=args: sk.fused_value_gradient_sums_plain(*a),
                        entry_bytes + 4 * (3 * n + 2 * d + 2), 4 * nnz))
        return out

    def references(L, v):
        """Each check's plain version on float64 copies of its vectors: what
        the kernels are held to. (The float32 plain version adds X^T u with
        index_add_ in atomic order, whose error on a hot column, the e2e
        shape's intercept with 4M entries, reaches the tolerance by
        itself and differs run to run; it is still what `plain_ms` times.)"""
        v64 = {k: t.double() for k, t in v.items()}
        return [run_p for _, _, _, _, _, run_p, _, _ in variants(L, v64)]

    def check(tag, got, again, ref):
        max_abs, rel = compare(got, ref)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not rel <= tol:
            failures.append(f"{tag}: rel err {rel:.3e} > {tol}")
        if not same:
            failures.append(f"{tag}: two calls on the same inputs differ")
        return dict(max_abs_err=max_abs, scale_rel_err=rel, tol_scale_rel=tol, bit_identical=same,
                    ok=rel <= tol and same)

    # The main path's layout, timed.
    v = vectors(layout)
    n, d = layout.shape
    Lc = layout_csc
    X = torch.sparse_csr_tensor(layout.row_ptr.int(), layout.col_idx, layout.row_val, size=(n, d))
    XT = torch.sparse_csr_tensor(Lc.col_ptr.int(), Lc.row_idx, Lc.col_val, size=(d, n))
    XT2 = torch.sparse_csr_tensor(Lc.col_ptr.int(), Lc.row_idx, Lc.col_val ** 2, size=(d, n))
    library = {"sparse_matvec": lambda: torch.mv(X, v["w"]),
               "sparse_rmatvec": lambda: torch.mv(XT, v["u"]),
               "sparse_rmatvec_square": lambda: torch.mv(XT2, v["u"]),
               "sparse_fused": lambda: (torch.mv(X, v["w"]), torch.mv(XT, v["u"]))}
    rows = {}
    for (name, loss, route, run_k, run_2p, run_p, nbytes, ops), run_ref in zip(
            variants(layout, v, Lc), references(layout, v)):
        tag = name if loss is None else f"{name}/{loss.name}"
        got, again, ref = run_k(), run_k(), run_ref()
        torch.cuda.synchronize()
        row = dict(phase=phase, shape=shape, kernel=name, loss=None if loss is None else loss.name,
                   route=route, n=n, d=d, nnz=layout.nnz, **check(tag, got, again, ref))
        t_bytes, t_ops = nbytes / bw * 1e3, ops / f32_rate * 1e3
        # The two-pass route on the same inputs, checked and timed beside.
        row["two_pass"] = check(f"{tag}/two_pass", run_2p(), run_2p(), ref)
        # Turns (kernel, two-pass, two-pass, kernel), each a median of 20 calls.
        k_ms, p2_ms = [], []
        for turn in (run_k, run_2p, run_2p, run_k):
            (k_ms if turn is run_k else p2_ms).append(time_ms(torch, turn))
        row.update(kernel_ms=min(k_ms), kernel_ms_turns=k_ms,
                   two_pass_ms=min(p2_ms), two_pass_ms_turns=p2_ms,
                   plain_ms=time_ms(torch, run_p), library_ms=time_ms(torch, library[name]),
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        row.update(bound_share=row["bound_ms"] / row["kernel_ms"],
                   faster_than_library=row["kernel_ms"] < row["library_ms"],
                   faster_than_two_pass=row["kernel_ms"] < row["two_pass_ms"])
        log(json.dumps(row))
        if loss in (None, LOGISTIC):  # the main path runs the logistic loss
            rows.setdefault(name, row)
    del X, XT, XT2, Lc
    if not off_path:
        return rows, failures

    # Off the main path, untimed: a skewed shape (about 30% of entries on 16
    # columns, every 97th row empty); a wide one (dim 200,003, beyond every
    # single-stream width, so the two-pass route; columns below 1,000
    # empty; n not a multiple of the 16 rows a block takes); one at the
    # widest single stream of X^T u (columns below 500 empty); and one with
    # rows longer than a row tile (2,049 to 16,000 entries), every 41st row
    # empty and columns below 300 empty, n not a multiple of anything.
    def ell(n_x, d_x, skew, empty_cols):
        idx = torch.randint(empty_cols, d_x, (n_x, K_SPARSE), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.randn(n_x, K_SPARSE, generator=gen, device=dev)
        if skew:
            hot = torch.rand(n_x, K_SPARSE, generator=gen, device=dev) < 0.3
            idx = torch.where(hot, torch.randint(0, 16, (n_x, K_SPARSE), generator=gen, device=dev,
                                                 dtype=torch.int32), idx)
            val[::97] = 0.0
        return sparse_layout.from_ell(SparseFeatures(idx, val, d_x))

    shapes = (
        ("skewed", lambda: ell(262144, D_SPARSE, True, 0), 97, 0),
        ("wide", lambda: ell(100003, 200003, False, 1000), 0, 1000),
        ("rmatvec_widest", lambda: ell(100003, sk.RMATVEC_STREAM_MAX_DIM, False, 500), 0, 500),
        ("long_rows", lambda: long_row_layout(gen, dev, 60001, D_SPARSE, 16, 300, 41,
                                              {5: 2049, 777: 5000, 30000: 12000, 60000: 16000}),
         41, 300),
    )
    for tag, build, empty_every, empty_cols in shapes:
        L = build()
        vx = vectors(L)
        for (name, loss, route, run_k, _, _, _, _), run_ref in zip(variants(L, vx), references(L, vx)):
            vtag = f"{tag}/{name}" + ("" if loss is None else f"/{loss.name}")
            got, again, ref = run_k(), run_k(), run_ref()
            torch.cuda.synchronize()
            row = dict(phase="2s", shape=tag, kernel=name, loss=None if loss is None else loss.name,
                       route=route, layout_csc=L.has_csc, n=L.n_rows, d=L.dim, nnz=L.nnz,
                       tiles=L.n_tiles,
                       longest_tile=int((L.tile_ptr[1:] - L.tile_ptr[:-1]).max()),
                       **check(vtag, got, again, ref))
            if empty_every and name == "sparse_matvec":
                row["empty_rows_exact_zero"] = bool((got[0][::empty_every] == 0).all())
                if not row["empty_rows_exact_zero"]:
                    failures.append(f"{vtag}: an empty row is not an exact zero")
            if empty_cols and name != "sparse_matvec":
                g = got[0] if loss is None else got[1]
                row["empty_cols_exact_zero"] = bool((g[:empty_cols] == 0).all())
                if not row["empty_cols_exact_zero"]:
                    failures.append(f"{vtag}: an empty column is not an exact zero")
            log(json.dumps(row))
        del L, vx
    return rows, failures


def sparse_phases(seed: int, dev, bw: float, f32_rate: float):
    """Phases 2s-5s: the sparse fixed effect. Returns (phase 2s rows by
    kernel, launches by kernel over the main path's phases 3s and 4s)."""
    import torch

    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.data.game_dataset import (
        GameDataset,
        RandomEffectDataConfig,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.data import sparse_layout
    from photon_ml_tpu_torch.data.sparse_layout import SparseLayout, from_ell
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    # ---- data, upload and layout ---------------------------------------------------
    t0 = time.perf_counter()
    idx, val, Xe, entity, y = sparse_glmix_arrays(seed, N_ROWS, K_SPARSE, D_SPARSE, D_RE, N_ENTITIES)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = GameDataset.build(
        {"sparse": SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D_SPARSE),
         "per_entity": Xe}, y, id_tags={"entityId": entity}, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = ds.sparse_layout("sparse")  # first build: what the coordinates below reuse
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = from_ell(ds.shards["sparse"])  # a second build, past first-use costs
    torch.cuda.synchronize()
    layout_again_s = time.perf_counter() - t0
    def same(a, b):  # equal arrays, or both not built
        return a is None and b is None if a is None or b is None else torch.equal(a, b)

    same_layout = all(same(getattr(layout, f.name), getattr(again, f.name))
                      for f in dataclasses.fields(SparseLayout) if f.name not in ("n_rows", "dim"))
    del again
    # The same entries with the CSC copy: phase 2s's two-pass route and
    # cuSPARSE transposes read it; the main path does not.
    t0 = time.perf_counter()
    layout_csc = from_ell(ds.shards["sparse"], csc=True)
    torch.cuda.synchronize()
    layout_csc_s = time.perf_counter() - t0
    same_layout = same_layout and layout_csc.has_csc and all(
        torch.equal(getattr(layout, f.name), getattr(layout_csc, f.name))
        for f in dataclasses.fields(SparseLayout)
        if f.name not in ("n_rows", "dim") and getattr(layout, f.name) is not None)
    # The single-stream additions alone, rebuilt from the layout's CSR: row
    # tiles and slabs, then the column order within each tile.
    t0 = time.perf_counter()
    tile_row = sparse_layout.row_tiles(layout.row_ptr)
    tile_ptr = layout.row_ptr[tile_row]
    slab_tile = sparse_layout.slab_table(tile_row, tile_ptr, layout.n_slabs)
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = sparse_layout.tile_permutation(tile_ptr, layout.col_idx.long(), layout.dim)
    torch.cuda.synchronize()
    perm_s = time.perf_counter() - t0
    same_layout = same_layout and all(torch.equal(a, b) for a, b in (
        (tile_row, layout.tile_row), (slab_tile, layout.slab_tile), (perm, layout.tile_perm)))
    del tile_row, tile_ptr, slab_tile, perm
    log(json.dumps(dict(
        phase="2s-setup", data_host_s=data_s, upload_s=upload_s, layout_build_s=layout_s,
        layout_rebuild_s=layout_again_s, tiles_and_slabs_build_s=tiles_s, permutation_build_s=perm_s,
        layout_with_csc_build_s=layout_csc_s,
        layout_rebuild_identical=same_layout, ell_entries=N_ROWS * K_SPARSE, nnz=layout.nnz,
        layout_has_csc=layout.has_csc, chunks=layout_csc.n_chunks, tiles=layout.n_tiles,
        slabs=layout.n_slabs, tile_entries_mean=layout.nnz / max(layout.n_tiles, 1),
        layout_mib=layout.nbytes() / 2**20, layout_with_csc_mib=layout_csc.nbytes() / 2**20,
        permutation_mib=layout.tile_perm.numel() * layout.tile_perm.element_size() / 2**20,
        fused_route=sk.fused_route(layout.dim), matvec_route=sk.matvec_route(layout.dim),
        rmatvec_route=sk.rmatvec_route(layout.dim))))
    if not same_layout:
        raise SystemExit("phase 2s: two builds of the layout differ")
    if layout.has_csc:
        raise SystemExit("phase 2s: the main path's layout carries a CSC copy it never reads")

    # ---- phase 2s: kernels vs plain versions ----------------------------------------
    rows, failures = sparse_kernel_checks(layout, layout_csc, dev, seed, bw, f32_rate)
    if failures:
        raise SystemExit("phase 2s failed: " + "; ".join(failures))
    del layout_csc
    torch.cuda.empty_cache()

    # ---- phase 3s: sparse FE + dense RE GLMix at full width ----------------------------
    task = TaskType.LOGISTIC_REGRESSION
    red = build_random_effect_dataset(
        ds, RandomEffectDataConfig("entityId", "per_entity", active_upper_bound=128, min_bucket=32))
    cfg_f = CoordinateOptimizationConfig(  # bench.py:2717-2726
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-7), regularization=L2, reg_weight=1.0)
    cfg_r = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-7), regularization=L2, reg_weight=10.0)
    fixed = FixedEffectCoordinate(ds, "sparse", cfg_f, task)
    if fixed.training_features is not layout or not isinstance(layout, SparseLayout):
        raise SystemExit("phase 3s: the fixed effect does not train on the cached sparse layout")
    coords = {"fixed": fixed, "per-entity": RandomEffectCoordinate(ds, red, cfg_r, task)}
    t0 = time.perf_counter()
    run_coordinate_descent(coords, 1)  # warm-up: first-use costs
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()  # phase 3s starts here
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize()
    glmix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = sum(coords[c].score(result.model[c]) for c in coords) + ds.offsets
    auc = float(area_under_roc_curve(scores, ds.labels))
    score_auc_s = time.perf_counter() - t0
    launches3 = dict(sk.LAUNCHES)  # phase 3s ends here
    fe_res = result.train_stats["fixed"]
    re_stats = result.train_stats["per-entity"]
    log(json.dumps(dict(
        phase="3s", glmix_wall_s=glmix_s, score_auc_s=score_auc_s, warmup_wall_s=warm_s,
        fixed_s=result.timing["fixed/iter0"], random_s=result.timing["per-entity/iter0"],
        fe_iterations=int(fe_res.iterations), fe_fn_evals=int(fe_res.fn_evals),
        fe_reason=int(fe_res.reason), re_buckets=len(re_stats["buckets"]),
        re_total_iterations=re_stats["total_iterations"], train_auc=auc, launches=launches3,
        dense_launches=dict(glm_kernels.LAUNCHES), fe_layout_has_csc=layout.has_csc,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )))
    if not bool(torch.isfinite(scores).all()) or scores.shape != (N_ROWS,):
        raise SystemExit("phase 3s: scores are not finite (N,) values")
    if launches3["sparse_fused"] != int(fe_res.fn_evals) or launches3["sparse_fused"] == 0:
        raise SystemExit(f"phase 3s: {launches3['sparse_fused']} sparse_fused launches for "
                         f"{int(fe_res.fn_evals)} fixed-effect objective evaluations")
    if launches3["sparse_matvec"] == 0 or any(glm_kernels.LAUNCHES.values()):
        raise SystemExit(f"phase 3s: scoring launched no sparse_matvec, or a dense kernel ran "
                         f"({launches3}, {glm_kernels.LAUNCHES})")
    if not auc > 0.5:
        raise SystemExit(f"phase 3s: training AUC {auc} is not above 0.5")

    # ---- phase 4s: sparse FE TRON + SIMPLE variances ------------------------------------
    cfg_t = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(OptimizerType.TRON, 15, 1e-6), regularization=L2, reg_weight=1.0,
        variance_computation=VarianceComputationType.SIMPLE)
    tron = FixedEffectCoordinate(ds, "sparse", cfg_t, task)
    sk.reset_launch_counts()  # phase 4s starts here
    t0 = time.perf_counter()
    tron_model, tron_res = tron.train(ds.offsets)
    torch.cuda.synchronize()
    tron_s = time.perf_counter() - t0
    launches4 = dict(sk.LAUNCHES)  # phase 4s ends here
    var = tron_model.coefficients.variances
    var_ok = (var is not None and var.shape == (D_SPARSE,) and bool(torch.isfinite(var).all())
              and bool((var > 0).all()))
    log(json.dumps(dict(
        phase="4s", tron_wall_s=tron_s, iterations=int(tron_res.iterations),
        fn_evals=int(tron_res.fn_evals), reason=int(tron_res.reason), loss=float(tron_res.loss),
        launches=launches4, variances_finite_positive=var_ok,
        variance_min=None if var is None else float(var.min()),
        variance_max=None if var is None else float(var.max()),
    )))
    if not var_ok:
        raise SystemExit("phase 4s: SIMPLE variances are not finite positive (D,) values")
    # Each Hessian-vector product is two matvecs and one rmatvec; the
    # variances add one matvec and one squared rmatvec. TRON counts value/
    # gradient and Hessian-vector passes together in fn_evals.
    hv = launches4["sparse_rmatvec"] - 1
    if (min(launches4.values()) == 0 or launches4["sparse_fused"] + hv != int(tron_res.fn_evals)
            or launches4["sparse_matvec"] != 2 * hv + 1):
        raise SystemExit(f"phase 4s: launches {launches4} do not match {int(tron_res.fn_evals)} "
                         f"objective passes with {hv} Hessian-vector products")
    launches = {k: launches3[k] + launches4[k] for k in launches3}

    # Where one sparse GLMix sweep's device time goes, and one more TRON +
    # variances solve's (after the main path, so not counted).
    log(json.dumps(dict(phase="4s-b", **profile_sweep(coords, glmix_s))))
    log(json.dumps(dict(phase="4s-c", **profile_call(lambda: tron.train(ds.offsets), tron_s))))
    del ds, red, fixed, tron, coords, result, scores, layout
    torch.cuda.empty_cache()

    # ---- phase 5s: small sparse GLMix, card vs CPU --------------------------------------
    failures = []
    for s in (seed + 17, seed + 18, seed + 19):
        sidx, sval, sXe, sent, sy = sparse_glmix_arrays(s, 8192, 16, 700, 4, 64)
        shards = {"sparse": SparseFeatures(torch.from_numpy(sidx), torch.from_numpy(sval), 700),
                  "per_entity": sXe}
        row, bad = small_glmix_card_vs_cpu(s, shards, "sparse", sy, sent)
        log(json.dumps(dict(phase="5s", **row)))
        failures += bad
    if failures:
        raise SystemExit("phase 5s failed: " + "; ".join(failures))
    return rows, launches


# ---------------------------------------------------------------- phases 2e-5e
#
# bench.py's e2e_from_disk cell (bench.py:4657-4790) through the port: Avro
# files written by the port's native writer, read by the port's ingest into a
# GameDataset on the card, then a fixed effect plus per-user and per-movie
# random effects, all on the one sparse shard "g" (8 ids + an intercept,
# dim 201).

E2E_ROWS = 4_000_000  # r08's cell has 20,000,000; cut for the run's time limit
E2E_K, E2E_D = 8, 200
E2E_TAGS = ["userId", "movieId"]
E2E_RE = {"per-user": ("userId", 256), "per-movie": ("movieId", 512)}  # tag, active_upper_bound


def e2e_arrays(rows: int, seed: int = 23, n_users=None, n_movies=None):
    """bench.py's e2e generator (bench.py:4662-4685), in numpy: per-user and
    per-movie structure in the labels, 8 uniform ids a row over dim 200.
    The entity counts default to the bench's (rows // 145, rows // 740)."""
    n_users = max(200, rows // 145) if n_users is None else n_users
    n_movies = max(50, rows // 740) if n_movies is None else n_movies
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=rows)
    movies = rng.integers(0, n_movies, size=rows)
    indptr = np.arange(rows + 1, dtype=np.int64) * E2E_K
    ids = rng.integers(0, E2E_D, size=rows * E2E_K).astype(np.int32)
    vals = rng.normal(size=rows * E2E_K)
    w_true = rng.normal(size=E2E_D) * 0.3
    margin = ((vals * w_true[ids]).reshape(rows, E2E_K).sum(axis=1)
              + rng.normal(size=n_users)[users] * 0.7 + rng.normal(size=n_movies)[movies] * 0.7)
    labels = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return dict(users=users, movies=movies, indptr=indptr, ids=ids, vals=vals, labels=labels,
                n_users=n_users, n_movies=n_movies)


def write_e2e_files(root: str, a: dict) -> float:
    """Two part files (the multi-file path) with integer userId/movieId tags,
    by the port's native columnar writer, as bench.py writes them. Returns MB."""
    import os

    from photon_ml_tpu_torch.native.avro_writer import write_training_examples_columnar

    rows, ip = len(a["labels"]), a["indptr"]
    half = rows // 2
    for fi, (lo, hi) in enumerate([(0, half), (half, rows)]):
        write_training_examples_columnar(
            os.path.join(root, f"part-{fi}.avro"), a["labels"][lo:hi], ip[lo:hi + 1] - ip[lo],
            a["ids"][ip[lo]:ip[hi]], a["vals"][ip[lo]:ip[hi]], [f"f{i}" for i in range(E2E_D)],
            int_tags={"userId": a["users"][lo:hi], "movieId": a["movies"][lo:hi]})
    return sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e6


def read_e2e(root: str, device):
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset

    ds, _ = read_game_dataset(root, {"g": FeatureShardConfig(("features",), True)},
                              id_tag_fields=E2E_TAGS, device=device)
    return ds


def e2e_coordinates(ds, fe_cfg, re_cfg):
    """The bench's e2e coordinates: "global" on "g", then per-user and
    per-movie random effects on "g" (min_bucket 8). Returns (coordinates,
    seconds building each random effect's layout)."""
    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig, build_random_effect_dataset
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    coords = {"global": FixedEffectCoordinate(ds, "g", fe_cfg, task)}
    build_s = {}
    for cid, (tag, cap) in E2E_RE.items():
        t0 = time.perf_counter()
        red = build_random_effect_dataset(
            ds, RandomEffectDataConfig(tag, "g", active_upper_bound=cap, min_bucket=8))
        build_s[cid] = time.perf_counter() - t0
        coords[cid] = RandomEffectCoordinate(ds, red, re_cfg, task)
    return coords, build_s


def e2e_configs():
    """bench.py:4772-4788: FE L-BFGS 10 iterations, tol 1e-6, L2 1.0; each RE
    5 iterations, tol 1e-5, L2 10.0."""
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig

    fe = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=10, tolerance=1e-6), regularization=L2, reg_weight=1.0)
    re = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=5, tolerance=1e-5), regularization=L2, reg_weight=10.0)
    return fe, re


def small_e2e_fit(ds) -> dict:
    """Phase 5e's fit: the e2e coordinates with phase 5's converging solver
    settings, one sweep; the model, AUC and each random effect's offsets."""
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig

    fe = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-6), regularization=L2, reg_weight=1.0)
    re = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-5), regularization=L2,
        reg_weight=SMALL_RE_L2)
    coords, _ = e2e_coordinates(ds, fe, re)
    r = run_coordinate_descent(coords, 1)
    scores = {c: coords[c].score(r.model[c]) for c in coords}
    # One sweep in order: each random effect solved on the base offsets plus
    # the scores of the coordinates before it.
    re_offsets = {"per-user": ds.offsets + scores["global"],
                  "per-movie": ds.offsets + scores["global"] + scores["per-user"]}
    return dict(fe=r.model["global"].coefficients.means.cpu(),
                re={c: r.model[c].coefficients_matrix.cpu() for c in E2E_RE},
                auc=float(area_under_roc_curve(sum(scores.values()) + ds.offsets, ds.labels)),
                ds=ds, reds={c: coords[c].re_dataset for c in E2E_RE}, re_offsets=re_offsets)


def e2e_phases(seed: int, dev, bw: float, f32_rate: float):
    """Phases 2e, 3e and 5e. Returns (phase 2e rows by kernel, phase 3e's
    sparse launches by kernel)."""
    import os
    import tempfile

    import torch

    from photon_ml_tpu_torch.contracts import INGEST_STAGES, INGEST_TIMING_REQUIRED_KEYS, PORT_TOLERANCES
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.data.sparse_layout import from_ell
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.io import model_bridge
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.types import TaskType

    # ---- phase 3e set-up: write, ingest, layout -------------------------------------
    t0 = time.perf_counter()
    a = e2e_arrays(E2E_ROWS)
    gen_s = time.perf_counter() - t0
    # Phase 3e's Avro directory stays until phase 3c has read it twice.
    e2e_dir = tempfile.TemporaryDirectory(prefix="photon-e2e-")
    root = e2e_dir.name
    t0 = time.perf_counter()
    total_mb = write_e2e_files(root, a)
    write_s = time.perf_counter() - t0
    del a
    t0 = time.perf_counter()
    ds = read_e2e(root, dev)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    timing = ds.ingest_timing
    shard = ds.shards["g"]
    missing = [k for k in INGEST_TIMING_REQUIRED_KEYS if k not in timing]
    log(json.dumps(dict(
        phase="3e-ingest", rows=E2E_ROWS, data_host_s=gen_s, write_s=write_s, write_mb=total_mb,
        ingest_s=ingest_s, ingest_mb_per_s=total_mb / ingest_s, ingest_timing=timing,
        stage_sum_s=sum(timing[k] for k in INGEST_STAGES), ell_shape=list(shard.indices.shape),
        dim=shard.dim, users=len(np.unique(ds.tag_codes["userId"][0])),
        movies=len(np.unique(ds.tag_codes["movieId"][0])))))
    if missing or not str(timing["ingest_path"]).startswith("native") or timing["chunks"] != 2:
        raise SystemExit(f"phase 3e: ingest took route {timing.get('ingest_path')} with "
                         f"{timing.get('chunks')} chunks (want native, 2), missing keys {missing}")
    if shard.dim != E2E_D + 1 or tuple(shard.indices.shape) != (E2E_ROWS, E2E_K + 1):
        raise SystemExit(f"phase 3e: the shard is {tuple(shard.indices.shape)} over dim {shard.dim}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    layout = ds.sparse_layout("g")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0

    # ---- phase 2e: the sparse kernels on the ingested shard's layout -------------------
    t0 = time.perf_counter()
    layout_csc = from_ell(shard, csc=True)  # the two-pass route and cuSPARSE transposes only
    torch.cuda.synchronize()
    log(json.dumps(dict(
        phase="2e-setup", layout_build_s=layout_s, layout_mib=layout.nbytes() / 2**20,
        layout_has_csc=layout.has_csc, layout_with_csc_build_s=time.perf_counter() - t0,
        nnz=layout.nnz, ell_entries=int(shard.indices.numel()), tiles=layout.n_tiles,
        intercept_column_entries=int((shard.indices[:, E2E_K] == E2E_D).sum()),
        fused_route=sk.fused_route(layout.dim), matvec_route=sk.matvec_route(layout.dim),
        rmatvec_route=sk.rmatvec_route(layout.dim))))
    rows2e, failures = sparse_kernel_checks(layout, layout_csc, dev, seed + 31, bw, f32_rate,
                                            phase="2e", off_path=False)
    del layout_csc
    # Two control shapes, checked and timed the same way, to tell the hot
    # intercept column from the narrow width: the 8 ids alone, and the 8 ids
    # with a 9th uniform id in place of the intercept.
    gen = torch.Generator(device=dev).manual_seed(seed + 32)
    n_rows = shard.indices.shape[0]
    controls = {
        "no_intercept": SparseFeatures(shard.indices[:, :E2E_K].contiguous(),
                                       shard.values[:, :E2E_K].contiguous(), shard.dim),
        "uniform_9th_id": SparseFeatures(
            torch.cat([shard.indices[:, :E2E_K], torch.randint(0, E2E_D, (n_rows, 1), generator=gen,
                                                                device=dev, dtype=torch.int32)], 1),
            torch.cat([shard.values[:, :E2E_K], torch.randn(n_rows, 1, generator=gen, device=dev)], 1),
            shard.dim),
    }
    for tag, sf in controls.items():
        _, bad = sparse_kernel_checks(from_ell(sf), from_ell(sf, csc=True), dev, seed + 33, bw,
                                      f32_rate, phase="2e", off_path=False, shape=tag)
        failures += bad
    del controls, sf
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("phase 2e failed: " + "; ".join(failures))

    # ---- phase 3e: FE + per-user + per-movie, one sweep ---------------------------------
    fe_cfg, re_cfg = e2e_configs()
    coords, re_build_s = e2e_coordinates(ds, fe_cfg, re_cfg)
    t0 = time.perf_counter()
    run_coordinate_descent(coords, 1)  # warm-up: first-use costs
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()  # phase 3e starts here
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = sum(coords[c].score(result.model[c]) for c in coords) + ds.offsets
    auc = float(area_under_roc_curve(scores, ds.labels))
    score_auc_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)  # phase 3e ends here
    dense_launches = dict(glm_kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fe_res = result.train_stats["global"]
    log(json.dumps(dict(
        phase="3e", rows=E2E_ROWS, sweep_wall_s=sweep_s, warmup_wall_s=warm_s,
        score_auc_s=score_auc_s, fixed_s=result.timing["global/iter0"],
        per_user_s=result.timing["per-user/iter0"], per_movie_s=result.timing["per-movie/iter0"],
        re_build_s=re_build_s, fe_iterations=int(fe_res.iterations),
        fe_fn_evals=int(fe_res.fn_evals), fe_reason=int(fe_res.reason),
        re_buckets={c: result.train_stats[c]["buckets"] for c in E2E_RE},
        re_total_iterations={c: result.train_stats[c]["total_iterations"] for c in E2E_RE},
        re_active_passive={c: (coords[c].re_dataset.num_active_samples,
                               coords[c].re_dataset.num_passive_samples) for c in E2E_RE},
        re_entities={c: coords[c].re_dataset.num_entities for c in E2E_RE},
        train_auc=auc, launches=launches, dense_launches=dense_launches, peak_mem_gib=peak_gib,
        layout_mib=layout.nbytes() / 2**20,
        ell_mib=(shard.indices.numel() * 4 + shard.values.numel() * 4) / 2**20)))
    if not bool(torch.isfinite(scores).all()) or scores.shape != (E2E_ROWS,):
        raise SystemExit("phase 3e: scores are not finite (N,) values")
    if launches["sparse_fused"] != int(fe_res.fn_evals) or launches["sparse_fused"] == 0:
        raise SystemExit(f"phase 3e: {launches['sparse_fused']} sparse_fused launches for "
                         f"{int(fe_res.fn_evals)} fixed-effect objective evaluations")
    if launches["sparse_matvec"] == 0 or any(dense_launches.values()):
        raise SystemExit(f"phase 3e: no sparse_matvec launch, or a dense kernel ran "
                         f"({launches}, {dense_launches})")
    if not auc > 0.5:
        raise SystemExit(f"phase 3e: training AUC {auc} is not above 0.5")
    # Where the sweep's device time goes (after the counted run).
    log(json.dumps(dict(phase="3e-b", **profile_sweep(coords, sweep_s))))
    phase3e = dict(fe=result.model["global"].coefficients.means,
                   re={c: result.model[c].coefficients_matrix for c in E2E_RE},
                   reds={c: coords[c].re_dataset for c in E2E_RE}, auc=auc, launches=launches)
    del coords, result, scores, layout
    torch.cuda.empty_cache()
    launches3f, fit3f = estimator_e2e_phase(ds, phase3e)
    # 3f's model in the original space, as the train driver saves it.
    t0 = time.perf_counter()
    fit3f["artifact"] = model_bridge.artifact_from_game_model(
        fit3f.pop("model"), fit3f.pop("specs"), TaskType.LOGISTIC_REGRESSION)
    fit3f["bridge_s"] = time.perf_counter() - t0
    del ds, shard, phase3e
    torch.cuda.empty_cache()
    try:
        launches3c = driver_e2e_phase(root, fit3f)
    finally:
        e2e_dir.cleanup()
    del fit3f

    # ---- phase 5e: a small fit from files, card vs CPU ----------------------------------
    ref_tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    limit = ref_tol["re_objective_rtol"]
    failures = []
    for s in (seed + 41, seed + 42):
        small = e2e_arrays(12000, seed=s, n_users=80, n_movies=16)  # ~150 and ~750 rows an entity
        with tempfile.TemporaryDirectory(prefix="photon-e2e-small-") as root:
            write_e2e_files(root, small)
            fits = {where: small_e2e_fit(read_e2e(root, where)) for where in ("cuda", "cpu")}
        card, cpu = fits["cuda"], fits["cpu"]
        row = dict(phase="5e", seed=s, fe_coef_err=float((card["fe"] - cpu["fe"]).abs().max()),
                   auc_card=card["auc"], auc_cpu=cpu["auc"], tol=ref_tol)
        ok = row["fe_coef_err"] <= ref_tol["fe_coef_atol"] and abs(card["auc"] - cpu["auc"]) <= ref_tol["auc_atol"]
        for cid in E2E_RE:
            re = re_objective_readings(cpu["ds"], cpu["reds"][cid], cpu["re_offsets"][cid], LOGISTIC,
                                       SMALL_RE_L2, {"card": card["re"][cid], "cpu": cpu["re"][cid]})
            row[cid] = dict(re_objective_excess=re["excess"], re_coef_dist_from_f64=re["coef_dist"],
                            re_fault_excess=re["fault"],
                            re_coef_card_vs_cpu=float((card["re"][cid] - cpu["re"][cid]).abs().max()))
            ok = ok and re["excess"]["card"] <= limit
            if not (re["excess"]["cpu"] <= limit < re["fault"]):
                failures.append(f"seed {s} {cid}: re_objective_rtol {limit} does not separate the "
                                f"CPU fit ({re['excess']['cpu']:.3e}) from a cold-start lane "
                                f"({re['fault']:.3e})")
        row["ok"] = ok
        log(json.dumps(row))
        if not ok:
            failures.append(f"seed {s}: the card's small e2e fit disagrees with the CPU's")
    if failures:
        raise SystemExit("phase 5e failed: " + "; ".join(failures))
    return rows2e, {"3e": launches, "3f": launches3f, "3c": launches3c}


def small_estimator_fits(where: str, a: dict, n_train: int) -> dict:
    """Phase 5f's two estimator fits on `where` from the same host arrays:
    the e2e coordinates on the sparse shard "g" (INDEX_MAP, STANDARDIZATION
    with the intercept, SIMPLE variances on the fixed effect and per-user,
    Pearson masks on per-movie, AUC and AUPR on the validation rows), then
    a dense fixed effect on "d" with TRON beside per-user. Returns both
    fits' models and readings, and the kernels' launches (card only)."""
    import torch

    from photon_ml_tpu_torch.data.containers import SparseFeatures, pack_csr_to_ell
    from photon_ml_tpu_torch.data.game_dataset import (
        FixedEffectDataConfig,
        GameDataset,
        RandomEffectDataConfig,
    )
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.evaluation.suite import EvaluatorType
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
    from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
    from photon_ml_tpu_torch.types import (
        NormalizationType,
        OptimizerType,
        TaskType,
        VarianceComputationType,
    )

    task = TaskType.LOGISTIC_REGRESSION
    ell = pack_csr_to_ell(a["indptr"], a["ids"], a["vals"].astype(np.float32), E2E_D + 1,
                          extra_col=(E2E_D, 1.0))
    sets = {}
    for name, rows in (("train", slice(0, n_train)), ("validation", slice(n_train, None))):
        sf = SparseFeatures(ell.indices[rows], ell.values[rows], ell.dim)
        sets[name] = GameDataset.build(
            {"g": sf, "d": a["dense"][rows]}, a["labels"][rows],
            id_tags={"userId": a["users"][rows], "movieId": a["movies"][rows]}, device=where)
    train, val = sets["train"], sets["validation"]
    simple = VarianceComputationType.SIMPLE
    fe = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-6),
                                      regularization=L2, reg_weight=1.0, variance_computation=simple)
    re = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-5),
                                      regularization=L2, reg_weight=SMALL_RE_L2)
    tron = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(OptimizerType.TRON, max_iterations=15, tolerance=1e-6),
        regularization=L2, reg_weight=1.0)
    if where == "cuda":
        sk.reset_launch_counts()
        glm_kernels.reset_launch_counts()  # phase 5f's card fits start here
    est = GameEstimator(
        task,
        {"global": FixedEffectDataConfig("g"),
         "per-user": RandomEffectDataConfig("userId", "g", active_upper_bound=256, min_bucket=8),
         "per-movie": RandomEffectDataConfig("movieId", "g", active_upper_bound=512, min_bucket=8,
                                             num_features_to_samples_ratio_upper_bound=0.1)},
        normalization=NormalizationType.STANDARDIZATION, intercept_indices={"g": E2E_D},
        validation_evaluators=[EvaluatorType("AUC"), EvaluatorType("AUPR")])
    res = est.fit(train, val, [{"global": fe, "per-user": dataclasses.replace(re, variance_computation=simple),
                                "per-movie": re}])[0]
    est2 = GameEstimator(task, {"global": FixedEffectDataConfig("d"),
                                "per-user": RandomEffectDataConfig("userId", "g", active_upper_bound=256,
                                                                   min_bucket=8)})
    res2 = est2.fit(train, None, [{"global": tron, "per-user": re}])[0]
    out = {}
    for tag, e, r in (("sparse_fe", est, res), ("dense_fe", est2, res2)):
        per = GameTransformer(r.model, e.scoring_specs(), task).transform(train, e.training_prepared())
        out[tag] = dict(
            est=e, model=r.model, ds=train, evaluation=None if r.evaluation is None else r.evaluation.results,
            auc=float(area_under_roc_curve(per.scores, train.labels)),
            # Each random effect's last solve ran on the offsets of the coordinates before it.
            re_offsets={"per-user": train.offsets + per.per_coordinate["global"],
                        "per-movie": train.offsets + per.per_coordinate["global"]
                        + per.per_coordinate["per-user"]})
    if where == "cuda":
        torch.cuda.synchronize()
        out["launches"] = {"sparse": dict(sk.LAUNCHES), "dense": dict(glm_kernels.LAUNCHES)}  # ends here
    return out


def estimator_small_phase(seed: int) -> dict:
    """Phase 5f: small estimator fits on the card and on the CPU from the
    same arrays, under PORT_TOLERANCES["card_vs_cpu_glmix"] (each random
    effect on its objective, with its projection, normalization and mask;
    variances within its "variance_rtol"). Returns the card fits' launches
    by kernel."""
    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.ops.losses import LOGISTIC

    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    var_rtol = tol["variance_rtol"]
    n_train = 12000
    a = e2e_arrays(n_train + 2000, seed=seed, n_users=80, n_movies=16)
    # A fifth of the validation rows belong to users the training rows never saw.
    a["users"][n_train::5] = 80 + np.arange(len(a["users"][n_train::5])) % 20
    rng = np.random.default_rng(seed + 1)
    # bf16-exact dense features, so the card's bf16 storage loses nothing.
    a["dense"] = torch.from_numpy(rng.standard_normal((n_train + 2000, 16), dtype=np.float32)).to(
        torch.bfloat16).float().numpy()
    card = small_estimator_fits("cuda", a, n_train)
    cpu = small_estimator_fits("cpu", a, n_train)
    launches = card.pop("launches")
    failures = []
    limit = tol["re_objective_rtol"]
    for tag in ("sparse_fe", "dense_fe"):
        c, p = card[tag], cpu[tag]
        fe_c, fe_p = c["model"]["global"].coefficients, p["model"]["global"].coefficients
        row = dict(phase="5f", fit=tag, seed=seed, fe_coef_err=float((fe_c.means.cpu() - fe_p.means).abs().max()),
                   auc_card=c["auc"], auc_cpu=p["auc"], validation_card=c["evaluation"],
                   validation_cpu=p["evaluation"], tol=tol,
                   d_proj={cid: p["est"]._prepared[cid].projector.projected_dim
                           for cid in p["est"]._prepared if cid != "global"},
                   fit_timing_card={k: v for k, v in c["est"].fit_timing.items()})
        ok = row["fe_coef_err"] <= tol["fe_coef_atol"] and abs(c["auc"] - p["auc"]) <= tol["auc_atol"]
        if c["evaluation"] is not None:
            ok = ok and all(abs(c["evaluation"][k] - v) <= tol["auc_atol"] for k, v in p["evaluation"].items())
        if fe_p.variances is not None:
            row["fe_variance_rel_err"] = float(((fe_c.variances.cpu() - fe_p.variances).abs()
                                                / fe_p.variances.abs()).max())
            ok = ok and row["fe_variance_rel_err"] <= var_rtol
        for cid in [k for k in p["model"].models if k != "global"]:
            prep = p["est"]._prepared[cid]
            m_c, m_p = c["model"][cid], p["model"][cid]
            re = re_objective_readings(p["ds"], prep.re_dataset, p["re_offsets"][cid], LOGISTIC, SMALL_RE_L2,
                                       {"card": m_c.coefficients_matrix.cpu(), "cpu": m_p.coefficients_matrix},
                                       norm=prep.norm)
            row[cid] = dict(re_objective_excess=re["excess"], re_fault_excess=re["fault"],
                            masked=prep.re_dataset.feature_mask is not None,
                            normalized=prep.norm is not None)
            ok = ok and re["excess"]["card"] <= limit
            if not (re["excess"]["cpu"] <= limit < re["fault"]):
                failures.append(f"{tag} {cid}: re_objective_rtol {limit} does not separate the CPU fit "
                                f"({re['excess']['cpu']:.3e}) from a cold-start lane ({re['fault']:.3e})")
            if m_p.variances_matrix is not None:
                v_c, v_p = m_c.variances_matrix.cpu()[:-1], m_p.variances_matrix[:-1]
                row[cid]["variances_finite_positive"] = bool(torch.all(v_c > 0) and torch.all(torch.isfinite(v_c)))
                row[cid]["variance_rel_err"] = float(((v_c - v_p).abs() / v_p).max())
                ok = ok and row[cid]["variances_finite_positive"] and row[cid]["variance_rel_err"] <= var_rtol
        row["ok"] = ok
        log(json.dumps(row))
        if not ok:
            failures.append(f"{tag}: the card's estimator fit disagrees with the CPU's")
    log(json.dumps(dict(phase="5f", launches=launches)))
    sparse, dense = launches["sparse"], launches["dense"]
    if not (sparse["sparse_fused"] and sparse["sparse_rmatvec"] and dense["value_grad"] and dense["hvp"]):
        failures.append(f"a kernel did not run through the estimator: {launches}")
    if failures:
        raise SystemExit("phase 5f failed: " + "; ".join(failures))
    return launches


def e2e_estimator(task):
    """bench.py's e2e estimator (bench.py:4745-4771): "global" on "g", per-user
    and per-movie on "g" with caps 256 and 512, min_bucket 8, the default
    INDEX_MAP projector, one coordinate-descent iteration."""
    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig, RandomEffectDataConfig
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator

    configs = {"global": FixedEffectDataConfig("g")}
    for cid, (tag, cap) in E2E_RE.items():
        configs[cid] = RandomEffectDataConfig(tag, "g", active_upper_bound=cap, min_bucket=8)
    return GameEstimator(task, configs, coordinate_descent_iterations=1)


def estimator_e2e_phase(ds, phase3e: dict):
    """Phase 3f: phase 3e's cell through GameEstimator.fit on the same
    ingested dataset. Returns its launches by kernel, and the fit (model,
    scoring specs, host scores, AUC) for phase 3c."""
    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES, PREPARE_STAGES
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.data.game_dataset import entity_layout
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.game.projector import IndexMapProjector
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    fe_cfg, re_cfg = e2e_configs()
    cfgs = {"global": fe_cfg, **{c: re_cfg for c in E2E_RE}}
    shards_before = set(ds.shards)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()  # phase 3f starts here
    t0 = time.perf_counter()
    est = e2e_estimator(task)
    res = est.fit(ds, None, [cfgs])[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = GameTransformer(res.model, est.scoring_specs(), task).transform(
        ds, est.training_prepared()).scores
    auc = float(area_under_roc_curve(scores, ds.labels))
    score_auc_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)  # phase 3f ends here
    dense_launches = dict(glm_kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ft = dict(est.fit_timing)
    # The same fit again on the same estimator: prepare's views and the
    # coordinates are reused, so this is the solve without first-use costs
    # (allocator growth for the 208-wide blocks), as phase 3e's warm sweep.
    t0 = time.perf_counter()
    refit = est.fit(ds, None, [cfgs])[0]
    torch.cuda.synchronize()
    log(json.dumps(dict(phase="3f-refit", fit_wall_s=time.perf_counter() - t0,
                        prepare_s=est.fit_timing["prepare_s"], solve_s=est.fit_timing["solve_s"],
                        sweep_by_coordinate=refit.timing,
                        fe_bit_equal=torch.equal(refit.model["global"].coefficients.means,
                                                 res.model["global"].coefficients.means))))
    coords = {}
    for cid in E2E_RE:
        prep = est._prepared[cid]
        feats = ds.shards[prep.shard]
        coords[cid] = dict(
            d_proj=prep.projector.projected_dim, entities=prep.re_dataset.num_entities,
            buckets=[[b.num_entities, b.capacity] for b in prep.re_dataset.buckets],
            projected_shard=prep.shard,
            projected_shard_mib=(feats.indices.numel() * feats.indices.element_size()
                                 + feats.values.numel() * feats.values.element_size()) / 2**20)
    log(json.dumps(dict(
        phase="3f", rows=E2E_ROWS, fit_wall_s=fit_s, score_auc_s=score_auc_s,
        fit_timing={k: v for k, v in ft.items()}, stage_sum_s=sum(ft[k] for k in PREPARE_STAGES),
        sweep_by_coordinate=res.timing, coordinates=coords, train_auc=auc, auc_3e=phase3e["auc"],
        launches=launches, launches_3e=phase3e["launches"], dense_launches=dense_launches,
        peak_mem_gib=peak_gib, new_shards=sorted(set(ds.shards) - shards_before))))
    failures = []
    if ft["re_path"] != "device" or ft["re_host_s"] != 0.0 or not ft["re_device_s"] > 0:
        failures.append(f"the RE assembly did not run on the card ({ft['re_path']})")
    if not all(isinstance(est._prepared[c].projector, IndexMapProjector) for c in E2E_RE):
        failures.append("a random effect was not projected by INDEX_MAP")
    if not torch.equal(res.model["global"].coefficients.means, phase3e["fe"]):
        d = float((res.model["global"].coefficients.means - phase3e["fe"]).abs().max())
        failures.append(f"the fixed effect is not bit-equal to phase 3e's (max diff {d:.3e})")
    if abs(auc - phase3e["auc"]) > 1e-4:
        failures.append(f"training AUC {auc} is not within 1e-4 of phase 3e's {phase3e['auc']}")
    if launches["sparse_fused"] != phase3e["launches"]["sparse_fused"] or any(dense_launches.values()):
        failures.append(f"launches {launches} / dense {dense_launches} against phase 3e's "
                        f"{phase3e['launches']}")
    if not bool(torch.isfinite(scores).all()) or scores.shape != (E2E_ROWS,):
        failures.append("scores are not finite (N,) values")
    # The random effects against phase 3e's (identity projection, same data
    # and layout): on their coefficients, or where f32 stopping noise moves
    # a lane past that, on each entity's objective at phase 3e's offsets.
    coef_atol = PORT_TOLERANCES["glmix"]["coef_atol"]
    limit = PORT_TOLERANCES["card_vs_cpu_glmix"]["re_objective_rtol"]
    fe_scores = GameTransformer(res.model, est.scoring_specs(), task).transform(
        ds, est.training_prepared()).per_coordinate
    offsets = {"per-user": ds.offsets + fe_scores["global"],
               "per-movie": ds.offsets + fe_scores["global"] + fe_scores["per-user"]}
    for cid in E2E_RE:
        prep = est._prepared[cid]
        back = prep.projector.back_project_matrix(res.model[cid].coefficients_matrix)
        coef_err = float((back - phase3e["re"][cid]).abs().max())
        # The card's assembly and projector against a CPU build of the same tag codes.
        cfg = est.data_configs[cid]
        host = entity_layout(ds.tag_codes[cfg.random_effect_type], cfg, torch.device("cpu"))
        blocks_equal = len(host.blocks) == len(prep.re_dataset.buckets) and all(
            torch.equal(g, b.gather.cpu()) and torch.equal(m, b.mask.cpu()) and torch.equal(e, b.entity_rows.cpu())
            for (g, m, e), b in zip(host.blocks, prep.re_dataset.buckets))
        g = ds.shards["g"]
        cpu_proj = IndexMapProjector.build(SparseFeatures(g.indices.cpu(), g.values.cpu(), g.dim),
                                           host.codes, host.num_entities)
        tables_equal = torch.equal(cpu_proj.slot_tables, prep.projector.slot_tables.cpu())
        row = dict(phase="3f-re", coordinate=cid, coef_err_vs_3e=coef_err, coef_atol=coef_atol,
                   layout_bit_equal_to_cpu=blocks_equal, slot_tables_bit_equal_to_cpu=tables_equal)
        gap = re_objective_gap(ds, phase3e["reds"][cid], offsets[cid], LOGISTIC, re_cfg.reg_weight,
                               back, phase3e["re"][cid])
        row.update(objective_gap_vs_3e=gap, objective_rtol=limit,
                   held_on="coefficients" if coef_err <= coef_atol else "objective")
        if coef_err > coef_atol and gap > limit:
            failures.append(f"{cid}: {coef_err:.3e} from phase 3e's coefficients and {gap:.3e} "
                            f"from its objective")
        log(json.dumps(row))
        if not (blocks_equal and tables_equal):
            failures.append(f"{cid}: the card's layout or slot tables differ from the CPU build's")
    if failures:
        raise SystemExit("phase 3f failed: " + "; ".join(failures))
    fit = dict(model=res.model, specs=est.scoring_specs(), scores=scores.cpu(), auc=auc)
    return {"sparse": launches, "dense": dense_launches}, fit


# ------------------------------------------------------------- phases 3c and 5c
#
# The drivers, as a user runs them: cli.train from Avro files to a model
# directory, cli.score from the model directory to ScoringResultAvro files.

E2E_SHARD = "name=g,feature.bags=features,intercept=true"
E2E_COORDINATES = [
    "name=global,feature.shard=g,optimizer=LBFGS,tolerance=1e-6,max.iter=10,regularization=L2,reg.weights=1",
    "name=per-user,random.effect.type=userId,feature.shard=g,optimizer=LBFGS,tolerance=1e-5,max.iter=5,"
    "regularization=L2,reg.weights=10,min.bucket=8,active.data.upper.bound=256",
    "name=per-movie,random.effect.type=movieId,feature.shard=g,optimizer=LBFGS,tolerance=1e-5,max.iter=5,"
    "regularization=L2,reg.weights=10,min.bucket=8,active.data.upper.bound=512",
]


def dir_mib(path: str) -> float:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 2**20


def counted(torch, fn):
    """Run `fn` with the kernels' launch counts set to 0 just before it and
    read just after; returns (fn's result, sparse launches, dense launches,
    device GiB allocated before it and at its peak)."""
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk

    gc.collect()  # what earlier phases left behind is not the driver's
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(sk.LAUNCHES), dict(glm_kernels.LAUNCHES),
            dict(base=base / 2**30, peak=torch.cuda.max_memory_allocated() / 2**30))


def same_model(a, b) -> dict:
    """Max |a - b| of two artifacts' coefficients by coordinate (random
    effects aligned by entity id), and whether every one is bit-equal."""
    out = {}
    for cid, x in a.coordinates.items():
        y = b.coordinates[cid]
        if hasattr(x, "entity_ids"):
            rows = {k: i for i, k in enumerate(y.entity_ids)}
            if sorted(rows) != sorted(x.entity_ids):
                out[cid] = dict(err=float("inf"), bit_equal=False, entities=len(x.entity_ids))
                continue
            ym = y.means[[rows[k] for k in x.entity_ids]]
        else:
            ym = y.means
        xm = np.asarray(x.means, np.float64)
        ym = np.asarray(ym, np.float64)
        out[cid] = dict(err=float(np.abs(xm - ym).max()), bit_equal=bool(np.array_equal(xm, ym)))
        if hasattr(x, "entity_ids"):
            out[cid]["entities"] = len(x.entity_ids)
    return out


def driver_e2e_phase(root: str, fit3f: dict) -> dict:
    """Phase 3c: phase 3e's Avro files through cli.train (the e2e cell's
    coordinates as DSL strings) and cli.score, on the card. The saved model
    is held against 3f's fit in the original space, 3f's model saved and
    loaded back must be exact, and the written scores must decode to 3f's
    scores. Returns the launches of both drivers by kernel."""
    import os

    import torch

    from photon_ml_tpu_torch.cli import score as score_cli
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store, score_store

    tol = PORT_TOLERANCES["glmix"]
    work = os.path.join(root, "drivers")
    out = os.path.join(work, "train")
    t0 = time.perf_counter()
    summary, sparse_t, dense_t, mem_t = counted(torch, lambda: train_cli.main([
        "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
        "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
        "--coordinate-configurations", *E2E_COORDINATES, "--coordinate-descent-iterations", "1",
        "--output-mode", "BEST", "--logging-level", "WARNING"]))
    train_wall = time.perf_counter() - t0
    best = os.path.join(out, "models", "best")
    imaps = {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}
    t0 = time.perf_counter()
    saved = model_store.load_game_model(best, imaps)
    load_s = time.perf_counter() - t0
    vs_3f = same_model(saved, fit3f["artifact"])
    # 3f's own artifact through the store: save, then load back.
    again_dir = os.path.join(work, "model-3f")
    t0 = time.perf_counter()
    model_store.save_game_model(again_dir, fit3f["artifact"], imaps)
    save_3f_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = model_store.load_game_model(again_dir, imaps)
    load_3f_s = time.perf_counter() - t0
    round_trip = same_model(again, fit3f["artifact"])

    scored = os.path.join(work, "score")
    t0 = time.perf_counter()
    ssum, sparse_s, dense_s, mem_s = counted(torch, lambda: score_cli.main([
        "--input-data-directories", root, "--model-input-directory", best,
        "--root-output-directory", scored, "--feature-shard-configurations", E2E_SHARD,
        "--evaluators", "AUC", "--logging-level", "WARNING"]))
    score_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = score_store.load_score_columns(os.path.join(scored, "scores"))
    read_scores_s = time.perf_counter() - t0
    score_err = (float(np.abs(cols.scores - fit3f["scores"].double().numpy()).max())
                 if len(cols) == E2E_ROWS else float("inf"))
    auc = ssum["evaluation"]["AUC"]
    row = dict(
        phase="3c", rows=E2E_ROWS, train_wall_s=train_wall, train_timings_s=summary["timings_s"],
        train_fit_timing=summary["fit_timing"], score_wall_s=score_wall, score_timings_s=ssum["timings_s"],
        model_mib=dir_mib(best), model_entities={c: v.get("entities") for c, v in vs_3f.items()},
        model_vs_3f=vs_3f, coef_atol=tol["coef_atol"], load_s=load_s, bridge_3f_s=fit3f["bridge_s"],
        save_3f_s=save_3f_s, load_3f_s=load_3f_s, save_load_round_trip=round_trip,
        num_scored=ssum["num_scored"], scores_mib=dir_mib(os.path.join(scored, "scores")),
        read_scores_s=read_scores_s, score_err_vs_3f=score_err, score_atol=tol["score_atol"],
        auc=auc, auc_3f=fit3f["auc"], auc_atol=tol["auc_atol"],
        launches_train=sparse_t, dense_launches_train=dense_t, mem_gib_train=mem_t,
        launches_score=sparse_s, dense_launches_score=dense_s, mem_gib_score=mem_s)
    log(json.dumps(row))
    failures = []
    if not vs_3f["global"]["bit_equal"]:
        failures.append(f"the saved fixed effect is not bit-equal to 3f's ({vs_3f['global']['err']:.3e})")
    for cid in E2E_RE:
        if vs_3f[cid]["err"] > tol["coef_atol"]:
            failures.append(f"{cid}: {vs_3f[cid]['err']:.3e} from 3f's coefficients")
    if not all(v["bit_equal"] for v in round_trip.values()):
        failures.append(f"3f's model saved and loaded back is not exact: {round_trip}")
    if ssum["num_scored"] != E2E_ROWS or not score_err <= tol["score_atol"]:
        failures.append(f"{ssum['num_scored']} rows scored, {score_err:.3e} from 3f's scores")
    if not abs(auc - fit3f["auc"]) <= tol["auc_atol"]:
        failures.append(f"scoring AUC {auc} is not within {tol['auc_atol']} of 3f's {fit3f['auc']}")
    if not sparse_t["sparse_fused"] or not sparse_s["sparse_matvec"] or any(dense_t.values()) \
            or any(dense_s.values()):
        failures.append(f"launches: train {sparse_t} / {dense_t}, score {sparse_s} / {dense_s}")
    if failures:
        raise SystemExit("phase 3c failed: " + "; ".join(failures))
    return {"sparse": {k: sparse_t[k] + sparse_s[k] for k in sparse_t},
            "dense": {k: dense_t[k] + dense_s[k] for k in dense_t}}


GLMIX_SHARD = "name=globalShard,feature.bags=features,intercept=true"


def glmix_train_args(data: str, out: str, device: str):
    """examples/run_glmix.sh's train step, with SIMPLE variances."""
    import os

    return [
        "--training-task", "LOGISTIC_REGRESSION",
        "--input-data-directories", os.path.join(data, "train.avro"),
        "--validation-data-directories", os.path.join(data, "test.avro"),
        "--root-output-directory", out, "--override-output-directory",
        "--feature-shard-configurations", GLMIX_SHARD,
        "--coordinate-configurations",
        "name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1.0E-7,max.iter=50,"
        "regularization=L2,reg.weights=1",
        "name=per-member,random.effect.type=memberId,feature.shard=globalShard,optimizer=LBFGS,"
        "max.iter=30,regularization=L2,reg.weights=10,min.bucket=8",
        "--coordinate-descent-iterations", "2", "--validation-evaluators", "AUC", "--output-mode", "BEST",
        "--variance-computation-type", "SIMPLE", "--logging-level", "WARNING", "--device", device]


def re_objectives(data: str, artifact, fe_means: np.ndarray, l2: float) -> np.ndarray:
    """Each entity's random-effect objective at the artifact's coefficients
    (original space), in float64 on the host: the logistic loss of its
    training rows at offsets from `fe_means`, plus (l2 / 2) |beta|^2."""
    import os

    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset

    ds, imaps = read_game_dataset(os.path.join(data, "train.avro"),
                                  {"globalShard": FeatureShardConfig(("features",), True)},
                                  id_tag_fields=["memberId"], device="cpu")
    g = ds.shards["globalShard"]
    idx, val = g.indices.long().numpy(), g.values.double().numpy()
    y = ds.labels.double().numpy()
    re = artifact.coordinates["per-member"]
    row_of = {k: i for i, k in enumerate(re.entity_ids)}
    ent = np.asarray([row_of[str(k)] for k in ds.id_tags["memberId"]])
    means = np.asarray(re.means, np.float64)
    z = (val * fe_means[idx]).sum(1) + (val * means[ent[:, None], idx]).sum(1)
    loss = np.logaddexp(0.0, z) - y * z
    return np.bincount(ent, loss, minlength=len(re.entity_ids)) + 0.5 * l2 * (means ** 2).sum(1)


def driver_small_phase(seed: int) -> dict:
    """Phase 5c: examples/run_glmix.sh's data (its generator, run as a
    script) through the port's libsvm_to_avro, then its train step with
    SIMPLE variances on the card and on the CPU; the two saved models and
    validation AUCs under PORT_TOLERANCES["card_vs_cpu_glmix"], and the
    test file scored by each. Returns the card runs' launches by kernel."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from photon_ml_tpu_torch.cli import libsvm_to_avro
    from photon_ml_tpu_torch.cli import score as score_cli
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store, score_store

    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    conv = PORT_TOLERANCES["convert_scores"]
    with tempfile.TemporaryDirectory(prefix="photon-glmix-") as root:
        data = os.path.join(root, "data")
        subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "examples" / "generate_dataset.py"),
                        data, "--train", "2400", "--test", "800", "--entities", "24"],
                       check=True, capture_output=True, timeout=300)
        for split in ("train", "test"):
            libsvm_to_avro.main(["--tag-comments", os.path.join(data, f"{split}.libsvm"),
                                 os.path.join(data, f"{split}.avro")])
        runs, launches = {}, {"sparse": {}, "dense": {}}

        def add(sparse, dense):
            for k, v in sparse.items():
                launches["sparse"][k] = launches["sparse"].get(k, 0) + v
            for k, v in dense.items():
                launches["dense"][k] = launches["dense"].get(k, 0) + v

        for device in ("cuda", "cpu"):
            out = os.path.join(root, device)
            t0 = time.perf_counter()
            if device == "cuda":
                summary, sparse, dense, _ = counted(torch, lambda: train_cli.main(glmix_train_args(data, out, device)))
                add(sparse, dense)
                runs["train_launches"] = sparse
            else:
                summary = train_cli.main(glmix_train_args(data, out, device))
            runs[device] = dict(summary=summary, wall_s=time.perf_counter() - t0,
                                best=os.path.join(out, "models", "best"))
        imaps = {"globalShard": IndexMap.load(os.path.join(runs["cpu"]["best"], "feature-indexes",
                                                           "globalShard.json"))}
        card = model_store.load_game_model(runs["cuda"]["best"], imaps)
        cpu = model_store.load_game_model(runs["cpu"]["best"], imaps)
        fe_c, fe_p = card.coordinates["global"], cpu.coordinates["global"]
        re_c, re_p = card.coordinates["per-member"], cpu.coordinates["per-member"]
        obj = {k: re_objectives(data, a, fe_p.means, 10.0) for k, a in (("card", card), ("cpu", cpu))}
        rel = lambda a, b: float((np.abs(np.asarray(a, np.float64) - b) / np.abs(b)).max())
        row = dict(
            phase="5c", seed=seed, fe_coef_err=float(np.abs(fe_c.means - fe_p.means).max()),
            fe_variance_rel_err=rel(fe_c.variances, fe_p.variances),
            re_variance_rel_err=rel(re_c.variances, re_p.variances),
            re_coef_err=float(np.abs(re_c.means - re_p.means).max()),
            re_objective_rel_gap=float((np.abs(obj["card"] - obj["cpu"]) / obj["cpu"]).max()),
            auc_card=runs["cuda"]["summary"]["best_evaluation"]["AUC"],
            auc_cpu=runs["cpu"]["summary"]["best_evaluation"]["AUC"],
            train_wall_s={d: runs[d]["wall_s"] for d in ("cuda", "cpu")},
            train_timings_s_card=runs["cuda"]["summary"]["timings_s"], tol=tol)
        # The test file scored by each device: each one's own model, and the
        # CPU model on the card (same weights, only the row sums' order differs).
        scored = {}
        for device, model in (("cuda", "cuda"), ("cpu", "cpu"), ("cuda", "cpu")):
            out = os.path.join(root, f"score-{device}-{model}")
            args = ["--input-data-directories", os.path.join(data, "test.avro"),
                    "--model-input-directory", runs[model]["best"], "--root-output-directory", out,
                    "--feature-shard-configurations", GLMIX_SHARD, "--evaluators", "AUC",
                    "--logging-level", "WARNING", "--device", device]
            if device == "cuda":
                ssum, sparse, dense, _ = counted(torch, lambda: score_cli.main(args))
                add(sparse, dense)
            else:
                ssum = score_cli.main(args)
            scored[device, model] = (ssum, score_store.load_score_columns(os.path.join(out, "scores")))
        own_c, own_p = scored["cuda", "cuda"], scored["cpu", "cpu"]
        cross = np.abs(scored["cuda", "cpu"][1].scores - own_p[1].scores)
        row.update(score_auc_card=own_c[0]["evaluation"]["AUC"], score_auc_cpu=own_p[0]["evaluation"]["AUC"],
                   score_err_card_vs_cpu=float(np.abs(own_c[1].scores - own_p[1].scores).max()),
                   score_err_same_model=float(cross.max()), convert_scores_tol=conv,
                   launches=launches)
    log(json.dumps(row))
    failures = []
    if not row["fe_coef_err"] <= tol["fe_coef_atol"]:
        failures.append(f"fixed effect {row['fe_coef_err']:.3e} apart")
    if not max(row["fe_variance_rel_err"], row["re_variance_rel_err"]) <= tol["variance_rtol"]:
        failures.append(f"variances {row['fe_variance_rel_err']:.3e} / {row['re_variance_rel_err']:.3e} apart")
    if not row["re_objective_rel_gap"] <= tol["re_objective_rtol"]:
        failures.append(f"random-effect objectives {row['re_objective_rel_gap']:.3e} apart")
    if not (abs(row["auc_card"] - row["auc_cpu"]) <= tol["auc_atol"]
            and abs(row["score_auc_card"] - row["score_auc_cpu"]) <= tol["auc_atol"]):
        failures.append("validation or scoring AUCs apart")
    if not bool((cross <= conv["atol"] + conv["rtol"] * np.abs(own_p[1].scores)).all()):
        failures.append(f"the card scores the CPU's model {row['score_err_same_model']:.3e} away")
    if not runs["train_launches"]["sparse_rmatvec"] or any(launches["dense"].values()):
        failures.append(f"launches {launches}")
    if failures:
        raise SystemExit("phase 5c failed: " + "; ".join(failures))
    return launches


# ---------------------------------------------------------------- phases 2d-5d
#
# Data-parallel GLMix on ranks of torch.distributed (photon_ml_tpu_torch/
# parallel/): each rank is a process started by parallel/launch.py, with the
# host arrays handed over as shared-memory CPU tensors. On one card, 4 ranks
# share it over gloo, which all-reduces CUDA tensors through host memory;
# NCCL runs where each rank has a card of its own, and with world size 1 in
# this process. The rank_* functions run in the ranks and return host values.

RANKS_SHARED = 4
RANK_DEADLINE_S = 600.0
RE_LAYOUT = dict(active_upper_bound=128, min_bucket=32)  # phase 3's random effect


def glmix_configs(variances: bool = False):
    """Phase 3's fixed effect (L-BFGS) and random effect, phase 4's TRON
    fixed effect (with SIMPLE variances if asked)."""
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType

    cfg_f = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-8), regularization=L2, reg_weight=1.0)
    cfg_r = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-7), regularization=L2, reg_weight=10.0)
    cfg_t = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(OptimizerType.TRON, 15, 1e-6), regularization=L2, reg_weight=1.0,
        variance_computation=(VarianceComputationType.SIMPLE if variances
                              else VarianceComputationType.NONE))
    return cfg_f, cfg_r, cfg_t


def rank_time_ms(torch, dist, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of `fn` on this rank, each call started behind
    a barrier of all ranks."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def rank_kernel_checks(mesh, data) -> dict:
    """Phase 2d on one rank: kernel #3 (the sharded sums) on this rank's
    contiguous share of the rows, bf16 X, logistic, against its plain
    version (the plain sums per rank, then the same exact sum); whether every
    rank holds the same bits; per-rank kernel, collective and whole-call
    times, the plain call's, one all_reduce of the sums' size, and the
    library yardstick timed as the call is: the torch pair on this rank's
    rows, then one all_reduce of the float32 sums."""
    import torch
    import torch.distributed as dist

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.parallel.mesh import over_ranks

    dev = mesh.device
    n = int(data["y"].shape[0])
    lo, hi = n * mesh.rank // mesh.world_size, n * (mesh.rank + 1) // mesh.world_size
    Xl = data["X"][lo:hi].to(dev).to(torch.bfloat16)
    yl, offl, wtl = (data[k][lo:hi].to(dev) for k in ("y", "off", "wt"))
    wv, vv = data["w"].to(dev), data["v"].to(dev)
    shift, v_shift = torch.tensor(0.01, device=dev), torch.tensor(0.02, device=dev)
    vg_args = (LOGISTIC, wv, shift, Xl, yl, offl, wtl)
    hv_args = (LOGISTIC, wv, shift, vv, v_shift, Xl, yl, offl, wtl)
    w_l, u_l = wv.to(torch.bfloat16), wtl.to(torch.bfloat16)  # any (n,) vector serves as u
    wv_l = torch.stack([wv, vv], dim=1).to(torch.bfloat16)
    d = int(wv.shape[0])

    def library(rhs, width):
        sums = torch.empty(width, device=dev)

        def run():
            Xl @ rhs
            sums[:d] = u_l @ Xl
            dist.all_reduce(sums)
        return run

    checks = {
        "sharded_value_grad": (
            lambda: glm_kernels.sharded_value_gradient_sums(*vg_args, mesh=mesh),
            lambda: over_ranks(mesh, *glm_kernels.value_gradient_sums_plain(*vg_args)),
            lambda: glm_kernels.value_gradient_sums(*vg_args), library(w_l, d + 2)),
        "sharded_hvp": (
            lambda: glm_kernels.sharded_hessian_vector_sums(*hv_args, mesh=mesh),
            lambda: over_ranks(mesh, *glm_kernels.hessian_vector_sums_plain(*hv_args)),
            lambda: glm_kernels.hessian_vector_sums(*hv_args), library(wv_l, d + 1)),
    }
    tol = PORT_TOLERANCES["kernel_vs_plain"]["scale_rel"]
    rows = {}
    for name, (run_k, run_p, run_local, run_l) in checks.items():
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        max_abs, rel = compare(got, ref)
        flat = torch.cat([t.reshape(-1) for t in got])
        every = mesh.owned_to_global(flat[None], torch.tensor([mesh.rank], device=dev), mesh.world_size)
        local = run_local()
        buf = torch.zeros(flat.numel(), device=dev)
        rows[name] = dict(
            rows=hi - lo, max_abs_err=max_abs, scale_rel_err=rel, tol_scale_rel=tol, ok=rel <= tol,
            ranks_bit_identical=bool((every == every[0]).all()),
            kernel_ms=rank_time_ms(torch, dist, run_local),
            collective_ms=rank_time_ms(torch, dist, lambda: over_ranks(mesh, *local)),
            call_ms=rank_time_ms(torch, dist, run_k),
            plain_ms=rank_time_ms(torch, dist, run_p),
            all_reduce_ms=rank_time_ms(torch, dist, lambda: dist.all_reduce(buf)),
            library_ms=rank_time_ms(torch, dist, run_l),
            result=[t.cpu() for t in got],
        )
    return rows


def rank_glmix(mesh, data):
    """Phases 3d and 4d on one rank: phase 3's GLMix on this rank's rows (a
    warm-up sweep, then one sweep with the counts set to 0 just before it
    and read just after), the model assembled over ranks, the AUC over all
    rows; then phase 4's TRON fixed effect with SIMPLE variances."""
    import torch
    import torch.distributed as dist

    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig, build_random_effect_dataset
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve_over_ranks
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.parallel import mesh as pmesh
    from photon_ml_tpu_torch.parallel.mesh import shard_game_dataset
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    cfg_f, cfg_r, _ = glmix_configs()
    _, _, cfg_t = glmix_configs(variances=True)
    t0 = time.perf_counter()
    re_cfg = RandomEffectDataConfig("entityId", "per_entity", **RE_LAYOUT)
    ds = shard_game_dataset(mesh, {"global": data["X"], "per_entity": data["Xe"]}, data["y"],
                            id_tags={"entityId": data["entity"]}, owner=re_cfg)
    red = build_random_effect_dataset(ds, re_cfg)
    fixed = FixedEffectCoordinate(ds, "global", cfg_f, task)
    coords = {"fixed": fixed, "per-entity": RandomEffectCoordinate(ds, red, cfg_r, task)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_coordinate_descent(coords, 1)  # warm-up: first-use costs
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    glm_kernels.reset_launch_counts()
    pmesh.reset_launch_counts()
    mesh.reset_counts()  # phase 3d starts here
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, sums = dict(glm_kernels.LAUNCHES), dict(mesh.counts)  # phase 3d ends here
    launches.update(pmesh.LAUNCHES)
    sum_elements = dict(mesh.elements)
    collective_s = sum(mesh.seconds.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    scores = sum(coords[c].score(result.model[c]) for c in coords) + ds.offsets
    auc = float(area_under_roc_curve_over_ranks(ds.sharding, scores, ds.labels))
    model = gather_game_model(coords, result.model)
    owned = red.owned_entities
    owners = mesh.owned_to_global(torch.ones((len(owned), 1), device=mesh.device), owned,
                                  red.num_entities + 1)
    fe_res = result.train_stats["fixed"]
    out3 = dict(
        rows=ds.num_samples, entities=int(len(owned)),
        store_shape=list(result.model["per-entity"].coefficients_matrix.shape),
        lanes=[(b.capacity, b.num_entities) for b in red.buckets],
        active=red.num_active_samples, passive=red.num_passive_samples,
        fe_stored=str(fixed.training_features.dtype).replace("torch.", ""),
        setup_s=setup_s, warmup_wall_s=warm_s, glmix_wall_s=wall_s, collective_s=collective_s,
        collective_share=collective_s / wall_s,
        fixed_s=result.timing["fixed/iter0"], random_s=result.timing["per-entity/iter0"],
        fe_iterations=int(fe_res.iterations), fe_fn_evals=int(fe_res.fn_evals),
        fe_reason=int(fe_res.reason), launches=launches, collectives=sums,
        collective_elements=sum_elements,
        scores_finite=bool(torch.isfinite(scores).all()), train_auc=auc, peak_mem_gib=peak_gib,
        one_owner_per_entity=bool((owners[:-1] == 1).all() and (owners[-1] == 0).all()),
        fe=result.model["fixed"].coefficients.means.cpu(),
        re=model["per-entity"].coefficients_matrix.cpu(),
    )

    tron = FixedEffectCoordinate(ds, "global", cfg_t, task)
    dist.barrier()
    glm_kernels.reset_launch_counts()
    pmesh.reset_launch_counts()
    mesh.reset_counts()  # phase 4d starts here
    t0 = time.perf_counter()
    tron_model, tron_res = tron.train(ds.offsets)
    torch.cuda.synchronize()
    tron_s = time.perf_counter() - t0
    launches4, sums4 = dict(glm_kernels.LAUNCHES), dict(mesh.counts)  # phase 4d ends here
    launches4.update(pmesh.LAUNCHES)
    var = tron_model.coefficients.variances
    out4 = dict(
        tron_wall_s=tron_s, iterations=int(tron_res.iterations), fn_evals=int(tron_res.fn_evals),
        reason=int(tron_res.reason), loss=float(tron_res.loss), launches=launches4,
        collectives=sums4, coef=tron_model.coefficients.means.cpu(), variances=var.cpu(),
    )
    return out3, out4


def rank_small_glmix(mesh, seed: int) -> dict:
    """Phase 5d on one rank: phase 5's small GLMix on this rank's rows."""
    import torch

    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig
    from photon_ml_tpu_torch.parallel.mesh import shard_game_dataset

    sXf, sXe, sent, sy = glmix_arrays(seed, 8192, 32, 4, 64)
    sXf = torch.from_numpy(sXf).to(torch.bfloat16).float().numpy()  # as phase 5: bf16-exact
    ds = shard_game_dataset(mesh, {"global": sXf, "per_entity": sXe}, sy, id_tags={"entityId": sent},
                            owner=RandomEffectDataConfig("entityId", "per_entity", **SMALL_RE_LAYOUT))
    fit = small_glmix_fit(ds, "global")
    return dict(fe=fit["fe"], re=fit["re"], auc=fit["auc"])


def rank_phases(mesh, phases, data, seed: int) -> dict:
    """The distributed phases named in `phases`, on one rank. The kernels
    come from phase 1's library; a rank never builds."""
    import torch

    from photon_ml_tpu_torch.ops import cuda_build, glm_kernels
    from photon_ml_tpu_torch.parallel import mesh as pmesh

    for src in (glm_kernels.SOURCE, pmesh.SOURCE):
        if not cuda_build.library_path(src).exists():
            raise RuntimeError(f"phase 1's {src.stem} library is missing; ranks do not build")
    out = dict(rank=mesh.rank, world_size=mesh.world_size, backend=mesh.backend,
               device=str(mesh.device))
    if "2d" in phases:
        out["2d"] = rank_kernel_checks(mesh, data)
        torch.cuda.empty_cache()
    if "3d" in phases:
        out["3d"], out["4d"] = rank_glmix(mesh, data)
        torch.cuda.empty_cache()
    if "5d" in phases:
        out["5d"] = [rank_small_glmix(mesh, s) for s in (seed + 7, seed + 8, seed + 9)]
    return out


def shared_tensor(torch, a):
    """A CPU tensor in shared memory holding numpy array `a`: the ranks map
    it; no rank copies the host arrays."""
    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype).share_memory_()
    t.copy_(torch.from_numpy(a))
    return t


def single_process_sums(arrays: dict, dev):
    """Phase 2's logistic value_grad and hvp sums over all rows, bf16 X, from
    the single-process kernels: what kernel #3 is held against; and the
    arguments they were called with."""
    import torch

    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops.losses import LOGISTIC

    X = torch.from_numpy(arrays["X"]).to(dev).to(torch.bfloat16)
    y, off, wt, w, v = (torch.from_numpy(arrays[k]).to(dev) for k in ("y", "off", "wt", "w", "v"))
    shift, v_shift = torch.tensor(0.01, device=dev), torch.tensor(0.02, device=dev)
    args = {"sharded_value_grad": (LOGISTIC, w, shift, X, y, off, wt),
            "sharded_hvp": (LOGISTIC, w, shift, v, v_shift, X, y, off, wt)}
    single = {"sharded_value_grad": glm_kernels.value_gradient_sums(*args["sharded_value_grad"]),
              "sharded_hvp": glm_kernels.hessian_vector_sums(*args["sharded_hvp"])}
    return args, single


def check_2d(backend: str, outs, single: dict, dev, failures: list) -> None:
    """Log each rank's phase 2d rows and hold them to the single-process kernel."""
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES

    tol = PORT_TOLERANCES["kernel_vs_plain"]["scale_rel"]
    for o in outs:
        for name, r in o["2d"].items():
            vs_single = compare([t.to(dev) for t in r["result"]], single[name])
            row = {k: v for k, v in r.items() if k != "result"}
            log(json.dumps(dict(phase="2d", backend=backend, world_size=o["world_size"],
                                device=o["device"], rank=o["rank"], kernel=name, d=D_FIXED,
                                x_dtype="bfloat16",
                                vs_single_process_kernel=dict(max_abs_err=vs_single[0],
                                                              scale_rel_err=vs_single[1]),
                                **row)))
            if not (r["ok"] and r["ranks_bit_identical"] and vs_single[1] <= tol):
                failures.append(f"2d {backend} rank {o['rank']} {name}: {row} "
                                f"(vs single process {vs_single})")


def check_3d_4d(backend: str, outs, failures: list) -> dict:
    """Log each rank's phase 3d and 4d rows and check them: launches and
    collectives against the objective passes, one owner per entity, the
    same fixed-effect bits (and TRON coefficients and variances) on every
    rank, AUC above 0.5. Returns the 3d summary row."""
    import torch

    r3, r4 = [o["3d"] for o in outs], [o["4d"] for o in outs]
    world = outs[0]["world_size"]
    for o, r in zip(outs, r3):
        log(json.dumps(dict(phase="3d", backend=backend, world_size=world, device=o["device"],
                            rank=o["rank"], **{k: v for k, v in r.items() if k not in ("fe", "re")})))
    row = dict(
        phase="3d", backend=backend, world_size=world,
        glmix_wall_s=max(r["glmix_wall_s"] for r in r3),
        collective_share=max(r["collective_share"] for r in r3),
        fixed_s=max(r["fixed_s"] for r in r3), random_s=max(r["random_s"] for r in r3),
        train_auc=r3[0]["train_auc"],
        fe_bit_identical_on_every_rank=all(torch.equal(r["fe"], r3[0]["fe"]) for r in r3),
        re_matrix_identical_on_every_rank=all(torch.equal(r["re"], r3[0]["re"]) for r in r3),
    )
    for o, r in zip(outs, r3):
        passes = r["fe_fn_evals"]
        if not (r["launches"]["value_grad"] == r["launches"]["sharded_value_grad"] == passes > 0):
            failures.append(f"3d rank {o['rank']}: launches {r['launches']} for {passes} passes")
        # One cross-rank sum per objective pass, one finiteness vote per
        # update; each a launch of the rank-order kernel.
        if (r["collectives"] != {"exact_sum": passes + 2, "owned_to_global": 0}
                or r["launches"]["rank_sum"] != passes + 2):
            failures.append(f"3d rank {o['rank']}: collectives {r['collectives']}, launches "
                            f"{r['launches']} for {passes} objective passes and 2 updates")
        if not (r["one_owner_per_entity"] and r["scores_finite"] and r["fe_stored"] == "bfloat16"
                and r["store_shape"] == [r["entities"] + 1, D_RE]):
            failures.append(f"3d rank {o['rank']}: ownership, store, scores or storage wrong")
    if not (row["fe_bit_identical_on_every_rank"] and row["re_matrix_identical_on_every_rank"]):
        failures.append("3d: the ranks' fixed-effect coefficients or assembled matrices differ")
    if not row["train_auc"] > 0.5:
        failures.append(f"3d: training AUC {row['train_auc']} is not above 0.5")

    for o, r in zip(outs, r4):
        var = r["variances"]
        log(json.dumps(dict(phase="4d", backend=backend, world_size=world, rank=o["rank"],
                            variance_min=float(var.min()), variance_max=float(var.max()),
                            **{k: v for k, v in r.items() if k not in ("coef", "variances")})))
        ln, passes = r["launches"], r["fn_evals"]
        # TRON counts value/gradient and Hessian-vector passes together; the
        # variances' Hessian diagonal adds one cross-rank sum.
        if not (ln["sharded_hvp"] == ln["hvp"] > 0 and ln["sharded_value_grad"] == ln["value_grad"]
                and ln["sharded_value_grad"] + ln["sharded_hvp"] == passes
                and r["collectives"] == {"exact_sum": passes + 1, "owned_to_global": 0}
                and ln["rank_sum"] == passes + 1):
            failures.append(f"4d rank {o['rank']}: launches {ln}, collectives {r['collectives']} "
                            f"for {passes} TRON passes")
    same4 = all(torch.equal(r["coef"], r4[0]["coef"]) and torch.equal(r["variances"], r4[0]["variances"])
                for r in r4)
    var = r4[0]["variances"]
    var_ok = var.shape == (D_FIXED,) and bool(torch.isfinite(var).all()) and bool((var > 0).all())
    log(json.dumps(dict(phase="4d", backend=backend, world_size=world,
                        coef_and_variances_bit_identical_on_every_rank=same4,
                        variances_finite_positive=var_ok)))
    if not (same4 and var_ok):
        failures.append("4d: coefficients or variances differ across ranks, or are not finite positive")
    return row


def across_cards(seed: int, data: dict, single: dict, dev) -> None:
    """Phases 2d-4d over NCCL with one rank per card (up to 4 cards)."""
    import torch

    from photon_ml_tpu_torch.parallel.launch import launch

    world = min(4, torch.cuda.device_count())
    t0 = time.perf_counter()
    outs = launch(rank_phases, world, backend="nccl", devices=[f"cuda:{r}" for r in range(world)],
                  deadline_s=RANK_DEADLINE_S, args=(("2d", "3d"), data, seed))
    log(f"phases 2d-4d: {world} ranks, one card each, over NCCL, "
        f"{time.perf_counter() - t0:.2f} s from spawn to the last rank's return")
    failures = []
    check_2d("nccl", outs, single, dev, failures)
    log(json.dumps(check_3d_4d("nccl", outs, failures)))
    if failures:
        raise SystemExit("phases 2d-4d over NCCL failed: " + "; ".join(failures))


def distributed_phases(seed: int, dev, arrays: dict, kernel_rows: dict, phase3: dict):
    """Phases 2d-5d. Returns (record rows of kernel #3 by name, its launches
    on the main path: phases 3d and 4d, rank 0's count)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from photon_ml_tpu_torch.data.game_dataset import (
        GameDataset,
        RandomEffectDataConfig,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.parallel import mesh as pmesh
    from photon_ml_tpu_torch.parallel.launch import launch
    from photon_ml_tpu_torch.parallel.mesh import init_rank_mesh, shard_game_dataset
    from photon_ml_tpu_torch.types import TaskType

    t0 = time.perf_counter()
    data = {k: (v if k == "entity" else shared_tensor(torch, v)) for k, v in arrays.items()}
    log(f"phase 2d setup: {time.perf_counter() - t0:.2f} s to place the host arrays in shared memory")
    t0 = time.perf_counter()
    outs = launch(rank_phases, RANKS_SHARED, backend="gloo", devices=["cuda:0"] * RANKS_SHARED,
                  deadline_s=RANK_DEADLINE_S, args=(("2d", "3d", "5d"), data, seed))
    log(f"phases 2d-5d: {RANKS_SHARED} ranks sharing cuda:0 over gloo, "
        f"{time.perf_counter() - t0:.2f} s from spawn to the last rank's return")
    failures = []

    # ---- phase 2d: kernel #3 ------------------------------------------------------------
    # The rank-order kernel against its plain version at the sums' widths:
    # the same bits, in float32 and float64.
    gen = torch.Generator(device=dev).manual_seed(seed)
    for k in (D_FIXED + 2, D_FIXED + 1):
        rows_t = torch.randn(RANKS_SHARED, k, generator=gen, device=dev, dtype=torch.float64) * 1e3
        for dt in (torch.float32, torch.float64):
            same = torch.equal(pmesh.rank_order_sum(rows_t, dt).cpu(),
                               pmesh.rank_order_sum_plain(rows_t.cpu(), dt))
            log(json.dumps(dict(phase="2d", kernel="rank_sum", world_size=RANKS_SHARED, k=k,
                                dtype=str(dt).replace("torch.", ""), bit_equal_to_plain=same,
                                kernel_ms=time_ms(torch, lambda: pmesh.rank_order_sum(rows_t, dt)))))
            if not same:
                failures.append(f"2d: the rank-order kernel is not its plain version's bits ({k}, {dt})")
    args, single = single_process_sums(arrays, dev)
    check_2d("gloo", outs, single, dev, failures)
    if torch.cuda.device_count() >= 2:
        across_cards(seed, data, single, dev)
    else:
        log("phase 2d: this machine has 1 card, so NCCL runs with world size 1 only (below)")

    with tempfile.TemporaryDirectory(prefix="photon-nccl-") as tmp:
        mesh1 = init_rank_mesh(backend="nccl", rank=0, world_size=1, device="cuda:0",
                               store=dist.FileStore(os.path.join(tmp, "store"), 1),
                               timeout_s=RANK_DEADLINE_S)
        one = {"sharded_value_grad": glm_kernels.sharded_value_gradient_sums(
                   *args["sharded_value_grad"], mesh=mesh1),
               "sharded_hvp": glm_kernels.sharded_hessian_vector_sums(*args["sharded_hvp"], mesh=mesh1)}
        same = {k: all(torch.equal(a, b) for a, b in zip(one[k], single[k])) for k in one}
        log(json.dumps(dict(phase="2d", backend="nccl", world_size=1, device="cuda:0",
                            bit_identical_to_single_process_kernel=same)))
        if not all(same.values()):
            failures.append(f"2d: NCCL world size 1 is not the single-process kernel's bits: {same}")
        if failures:
            raise SystemExit("phase 2d failed: " + "; ".join(failures))
        del args, single, one
        torch.cuda.empty_cache()

        # ---- phases 3d and 4d on 4 ranks, then the 3d sweep with world size 1 over NCCL ----
        row = check_3d_4d("gloo", outs, failures)
        r3 = outs[0]["3d"]
        row.update(phase3_train_auc=phase3["auc"],
                   fe_vs_phase3_max_abs=float((r3["fe"] - phase3["fe"]).abs().max()),
                   re_vs_phase3_max_abs=float((r3["re"] - phase3["re"]).abs().max()))
        log(json.dumps(row))

        t0 = time.perf_counter()
        task = TaskType.LOGISTIC_REGRESSION
        cfg_f, cfg_r, _ = glmix_configs()
        re_cfg = RandomEffectDataConfig("entityId", "per_entity", **RE_LAYOUT)
        ds1 = shard_game_dataset(mesh1, {"global": arrays["X"], "per_entity": arrays["Xe"]},
                                 arrays["y"], id_tags={"entityId": arrays["entity"]}, owner=re_cfg)
        coords1 = {"fixed": FixedEffectCoordinate(ds1, "global", cfg_f, task),
                   "per-entity": RandomEffectCoordinate(
                       ds1, build_random_effect_dataset(ds1, re_cfg), cfg_r, task)}
        res1 = run_coordinate_descent(coords1, 1)
        model1 = gather_game_model(coords1, res1.model)
        torch.cuda.synchronize()
        same3 = dict(fe=torch.equal(model1["fixed"].coefficients.means.cpu(), phase3["fe"]),
                     re=torch.equal(model1["per-entity"].coefficients_matrix.cpu(), phase3["re"]))
        log(json.dumps(dict(phase="3d", backend="nccl", world_size=1, device="cuda:0",
                            setup_and_sweep_s=time.perf_counter() - t0,
                            bit_identical_to_phase3=same3)))
        if not all(same3.values()):
            failures.append(f"3d: the world-size-1 NCCL sweep is not phase 3's bits: {same3}")
        mesh1.close()
        del ds1, coords1, res1, model1
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit("phases 3d-4d failed: " + "; ".join(failures))

    # ---- phase 5d: small GLMix on 4 ranks (card) vs one CPU process ------------------------
    for i, s in enumerate((seed + 7, seed + 8, seed + 9)):
        fits = [o["5d"][i] for o in outs]
        sXf, sXe, sent, sy = glmix_arrays(s, 8192, 32, 4, 64)
        sXf = torch.from_numpy(sXf).to(torch.bfloat16).float().numpy()
        cpu = small_glmix_fit(GameDataset.build({"global": sXf, "per_entity": sXe}, sy,
                                                id_tags={"entityId": sent}, device="cpu"), "global")
        row, bad = small_glmix_compare(s, fits[0], cpu)
        row["ranks_identical"] = all(torch.equal(f["fe"], fits[0]["fe"]) and torch.equal(f["re"], fits[0]["re"])
                                     and f["auc"] == fits[0]["auc"] for f in fits)
        log(json.dumps(dict(phase="5d", backend="gloo", world_size=RANKS_SHARED, **row)))
        failures += bad + ([] if row["ranks_identical"] else [f"5d seed {s}: ranks differ"])
    if failures:
        raise SystemExit("phase 5d failed: " + "; ".join(failures))

    # The record rows of kernel #3: the whole call's time beside the plain
    # call's and the library yardstick's, each the slowest rank's median; the
    # bound of #1/#2 on all rows (the shared card reads all of X once).
    rows = {}
    for name, base in (("sharded_value_grad", "value_grad"), ("sharded_hvp", "hvp")):
        r2 = [o["2d"][name] for o in outs]
        rows[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in r2), ms=max(r["call_ms"] for r in r2),
            plain_ms=max(r["plain_ms"] for r in r2), bound_ms=kernel_rows[base]["bound_ms"],
            bound_by=kernel_rows[base]["bound_by"], library_ms=max(r["library_ms"] for r in r2),
            kernel_ms=max(r["kernel_ms"] for r in r2), collective_ms=max(r["collective_ms"] for r in r2))
    launches = {k: outs[0]["3d"]["launches"][k] + outs[0]["4d"]["launches"][k]
                for k in ("sharded_value_grad", "sharded_hvp", "rank_sum")}
    return rows, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.game_dataset import (
        GameDataset,
        RandomEffectDataConfig,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.native import build as native_build
    from photon_ml_tpu_torch.ops import cuda_build, glm_kernels, sparse_kernels
    from photon_ml_tpu_torch.ops.losses import LOGISTIC, POISSON, SMOOTHED_HINGE, SQUARED
    from photon_ml_tpu_torch.parallel import mesh as pmesh
    from photon_ml_tpu_torch.types import TaskType

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    bw, f32_rate = card_rates(card)
    log(f"card {card}; allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build ------------------------------------------------------
    # One nvcc per source, all started together.
    builds = {}

    def build(src):
        t = time.perf_counter()
        path, build_log = cuda_build.build_library(src, verbose=True)
        builds[src.name] = (path, time.perf_counter() - t, build_log)

    def build_native():  # the Avro decoder and writer of phases 3e and 5e, by g++
        t = time.perf_counter()
        path = native_build.build_library()
        builds[path.name] = (path, time.perf_counter() - t, "")

    threads = [threading.Thread(target=build, args=(src,))
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, pmesh.SOURCE)]
    threads.append(threading.Thread(target=build_native))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(builds) != len(threads):
        raise SystemExit("phase 1: a kernel source did not build (see the error above)")
    lib = sparse_kernels._library()
    widths = {k: lib.sparse_stream_max_dim(i) for k, i in sparse_kernels.STREAM_KERNELS.items()}
    want = dict(matvec=sparse_kernels.MATVEC_STREAM_MAX_DIM, fused=sparse_kernels.FUSED_STREAM_MAX_DIM,
                rmatvec=sparse_kernels.RMATVEC_STREAM_MAX_DIM)
    if widths != want:
        raise SystemExit(f"phase 1: the library's single-stream widths {widths} are not the "
                         f"wrapper's {want}")
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s for {len(builds)} sources in parallel")
    for name, (lib_path, build_s, build_log) in sorted(builds.items()):
        log(f"  {name}: {build_s:.2f} s -> {lib_path.name}")
        ptx = [l.strip() for l in build_log.splitlines() if "registers" in l or "spill" in l]
        for line in sorted(set(ptx)):
            log(f"    ptxas: {line}")

    # ---- data -----------------------------------------------------------------
    t0 = time.perf_counter()
    Xf, Xe, entity, y = glmix_arrays(args.seed, N_ROWS, D_FIXED, D_RE, N_ENTITIES)
    rng = np.random.default_rng(args.seed + 1)
    off_np = (rng.standard_normal(N_ROWS, dtype=np.float32) * 0.1).astype(np.float32)
    wt_np = rng.uniform(0.5, 2.0, size=N_ROWS).astype(np.float32)
    w_np = (rng.standard_normal(D_FIXED, dtype=np.float32) * 0.05).astype(np.float32)
    v_np = rng.standard_normal(D_FIXED, dtype=np.float32)
    log(f"data: {time.perf_counter() - t0:.2f} s on the host (numpy, seed {args.seed})")
    arrays = dict(X=Xf, Xe=Xe, entity=entity, y=y, off=off_np, wt=wt_np, w=w_np, v=v_np)

    # ---- phase 2: kernels vs plain versions -----------------------------------
    tol = PORT_TOLERANCES["kernel_vs_plain"]
    X32 = torch.from_numpy(Xf).to(dev)
    Xbf = X32.to(torch.bfloat16)
    yt = torch.from_numpy(y).to(dev)
    offt = torch.from_numpy(off_np).to(dev)
    wtt = torch.from_numpy(wt_np).to(dev)
    wv = torch.from_numpy(w_np).to(dev)
    vv = torch.from_numpy(v_np).to(dev)
    # The shifts are device scalars, as ops/objective.py passes them (a
    # Python float costs each call a blocking host-to-device copy).
    shift, v_shift = torch.tensor(0.01, device=dev), torch.tensor(0.02, device=dev)
    n, d = X32.shape

    def bound(X, extra_vectors, flops_per_elem):
        nbytes = X.numel() * X.element_size() + 3 * n * 4 + (extra_vectors + 1) * d * 4 + (d + 2) * 4
        t_bytes = nbytes / bw * 1e3
        t_ops = flops_per_elem * n * d / f32_rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    glm_kernels.reset_launch_counts()
    kernel_rows = {}
    failures = []
    variants = [(k, l, X) for k in ("value_grad", "hvp") for X in (X32, Xbf)
                for l in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE)]
    for kname, loss, X in variants:
        if kname == "value_grad":
            run_k = lambda: glm_kernels.value_gradient_sums(loss, wv, shift, X, yt, offt, wtt)
            run_p = lambda: glm_kernels.value_gradient_sums_plain(loss, wv, shift, X, yt, offt, wtt)
            w_l, u_l = wv.to(X.dtype), wtt.to(X.dtype)  # any (n,) vector serves as u
            run_l = lambda: (X @ w_l, u_l @ X)
            b_ms, b_by = bound(X, 0, 4)
        else:
            run_k = lambda: glm_kernels.hessian_vector_sums(loss, wv, shift, vv, v_shift, X, yt, offt, wtt)
            run_p = lambda: glm_kernels.hessian_vector_sums_plain(loss, wv, shift, vv, v_shift, X, yt, offt, wtt)
            wv_l, u_l = torch.stack([wv, vv], dim=1).to(X.dtype), wtt.to(X.dtype)
            run_l = lambda: (X @ wv_l, u_l @ X)
            b_ms, b_by = bound(X, 1, 6)
        got, again = run_k(), run_k()
        ref = run_p()
        torch.cuda.synchronize()
        max_abs, rel = compare(got, ref)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = rel <= tol["scale_rel"] and same
        k_ms = time_ms(torch, run_k)
        p_ms = time_ms(torch, run_p)
        l_ms = time_ms(torch, run_l)
        row = dict(phase=2, kernel=kname, loss=loss.name, x_dtype=str(X.dtype).replace("torch.", ""),
                   n=n, d=d, route=glm_kernels.route(X), max_abs_err=max_abs, scale_rel_err=rel,
                   tol_scale_rel=tol["scale_rel"], bit_identical_twice=same, kernel_ms=k_ms,
                   plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by, ok=ok)
        log(json.dumps(row))
        if not ok:
            failures.append(f"{kname}/{loss.name}/{X.dtype}: rel err {rel:.3e} > {tol['scale_rel']} "
                            f"or two calls differ ({same})")
        # The main path's kernels run on bf16-stored X with the logistic loss.
        if loss is LOGISTIC and X.dtype == torch.bfloat16:
            kernel_rows[kname] = row
    # Shapes off the main path, checked but not timed, n not a multiple of
    # a tile: on the rows route d = 1000 f32 (eight vectors a lane), d = 517
    # bf16 (1,034-byte rows: element loads) and d = 124 in both dtypes
    # (examples/run_glmix.sh's width; 248-byte bf16 rows: element loads);
    # on the wide route d = 1,536 bf16 and d = 2,100 f32; on the chunked
    # route d = 20,000 bf16 and d = 16,500 f32.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    for n_x, d_x, dt in ((70001, 1000, torch.float32), (70001, 517, torch.bfloat16),
                         (70001, 124, torch.bfloat16), (70001, 124, torch.float32),
                         (30001, 1536, torch.bfloat16), (20001, 2100, torch.float32),
                         (6001, 20000, torch.bfloat16), (6001, 16500, torch.float32)):
        X = rnd(n_x, d_x).to(dt)
        yx = (torch.rand(n_x, generator=gen, device=dev) < 0.5).float()
        ox, wtx = 0.1 * rnd(n_x), 0.5 + torch.rand(n_x, generator=gen, device=dev)
        wx, vx = 0.05 * rnd(d_x), rnd(d_x)
        pairs = (
            ("value_grad",
             lambda: glm_kernels.value_gradient_sums(LOGISTIC, wx, shift, X, yx, ox, wtx),
             glm_kernels.value_gradient_sums_plain(LOGISTIC, wx, shift, X, yx, ox, wtx)),
            ("hvp",
             lambda: glm_kernels.hessian_vector_sums(LOGISTIC, wx, shift, vx, 0.02, X, yx, ox, wtx),
             glm_kernels.hessian_vector_sums_plain(LOGISTIC, wx, shift, vx, 0.02, X, yx, ox, wtx)),
        )
        for kname, run_k, ref in pairs:
            got, again = run_k(), run_k()
            torch.cuda.synchronize()
            max_abs, rel = compare(got, ref)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = rel <= tol["scale_rel"] and same
            log(json.dumps(dict(phase=2, kernel=kname, loss=LOGISTIC.name, x_dtype=str(dt).replace("torch.", ""),
                                n=n_x, d=d_x, route=glm_kernels.route(X), max_abs_err=max_abs,
                                scale_rel_err=rel, tol_scale_rel=tol["scale_rel"],
                                bit_identical_twice=same, ok=ok)))
            if not ok:
                failures.append(f"{kname}/{n_x}x{d_x}/{dt}: rel err {rel:.3e} > {tol['scale_rel']} "
                                f"or two calls differ ({same})")
    if failures:
        raise SystemExit("phase 2 failed: " + "; ".join(failures))
    del X32, Xbf, offt, wtt, wv, vv
    torch.cuda.empty_cache()

    # ---- phase 3: GLMix training at full width --------------------------------
    task = TaskType.LOGISTIC_REGRESSION
    t0 = time.perf_counter()
    ds = GameDataset.build({"global": Xf, "per_entity": Xe}, y,
                           id_tags={"entityId": entity}, device=dev)
    red = build_random_effect_dataset(ds, RandomEffectDataConfig("entityId", "per_entity", **RE_LAYOUT))
    cfg_f, cfg_r, cfg_t = glmix_configs()
    fixed = FixedEffectCoordinate(ds, "global", cfg_f, task)
    rand = RandomEffectCoordinate(ds, red, cfg_r, task)
    tron = FixedEffectCoordinate(ds, "global", cfg_t, task)
    coords = {"fixed": fixed, "per-entity": rand}
    torch.cuda.synchronize()
    log(f"phase 3 setup: {time.perf_counter() - t0:.2f} s (upload, RE layout: "
        f"{len(red.buckets)} bucket(s) "
        f"{[(b.num_entities, b.capacity) for b in red.buckets]}, "
        f"{red.num_active_samples} active / {red.num_passive_samples} passive rows; "
        f"FE stored {fixed.training_features.dtype})")
    if fixed.training_features.dtype != torch.bfloat16:
        raise SystemExit("phase 3: the fixed effect is not stored bf16 on the card")

    t0 = time.perf_counter()
    run_coordinate_descent(coords, 1)  # warm-up: first-use costs (cuBLAS, allocator)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    glm_kernels.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize()
    glmix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = sum(coords[c].score(result.model[c]) for c in coords) + ds.offsets
    auc = float(area_under_roc_curve(scores, ds.labels))
    score_auc_s = time.perf_counter() - t0
    fe_res = result.train_stats["fixed"]
    re_stats = result.train_stats["per-entity"]
    vg_after_glmix = glm_kernels.LAUNCHES["value_grad"]
    phase3 = dict(fe=result.model["fixed"].coefficients.means.cpu(),
                  re=result.model["per-entity"].coefficients_matrix.cpu(), auc=auc)
    log(json.dumps(dict(
        phase=3, glmix_wall_s=glmix_s, score_auc_s=score_auc_s, warmup_wall_s=warm_s,
        fixed_s=result.timing["fixed/iter0"], random_s=result.timing["per-entity/iter0"],
        fe_iterations=int(fe_res.iterations), fe_fn_evals=int(fe_res.fn_evals),
        fe_reason=int(fe_res.reason), re_buckets=len(re_stats["buckets"]),
        re_total_iterations=re_stats["total_iterations"],
        re_mean_iterations=[b["mean_iterations"] for b in re_stats["buckets"]],
        train_auc=auc, value_grad_launches=vg_after_glmix,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )))
    if not bool(torch.isfinite(scores).all()) or scores.shape != (N_ROWS,):
        raise SystemExit("phase 3: scores are not finite (N,) values")
    if vg_after_glmix != int(fe_res.fn_evals) or vg_after_glmix == 0:
        raise SystemExit(f"phase 3: {vg_after_glmix} value_grad launches for "
                         f"{int(fe_res.fn_evals)} fixed-effect objective evaluations")
    if not auc > 0.5:
        raise SystemExit(f"phase 3: training AUC {auc} is not above 0.5")

    # ---- phase 4: fixed effect with TRON ----------------------------------------
    t0 = time.perf_counter()
    _, tron_res = tron.train(ds.offsets)
    torch.cuda.synchronize()
    tron_s = time.perf_counter() - t0
    launches = dict(glm_kernels.LAUNCHES)  # the main path ends here
    tron_launches = launches["hvp"] + launches["value_grad"] - vg_after_glmix
    log(json.dumps(dict(
        phase=4, tron_wall_s=tron_s, iterations=int(tron_res.iterations),
        fn_evals=int(tron_res.fn_evals), reason=int(tron_res.reason),
        loss=float(tron_res.loss), hvp_launches=launches["hvp"],
    )))
    if launches["hvp"] == 0 or tron_launches != int(tron_res.fn_evals):
        raise SystemExit(f"phase 4: {tron_launches} kernel launches for "
                         f"{int(tron_res.fn_evals)} TRON objective passes")

    # Where one GLMix sweep's device time goes (after the main path, so its
    # launches are not counted).
    log(json.dumps(dict(phase="4b", **profile_sweep(coords, glmix_s))))
    del ds, red, fixed, rand, tron, coords, result, scores
    torch.cuda.empty_cache()

    # ---- phase 5: small GLMix, card vs CPU ----------------------------------------
    failures = []
    for seed in (args.seed + 7, args.seed + 8, args.seed + 9):
        sXf, sXe, sent, sy = glmix_arrays(seed, 8192, 32, 4, 64)
        # bf16-exact fixed-effect data, so the card's bf16 storage loses nothing.
        sXf = torch.from_numpy(sXf).to(torch.bfloat16).float().numpy()
        row, bad = small_glmix_card_vs_cpu(seed, {"global": sXf, "per_entity": sXe}, "global", sy, sent)
        log(json.dumps(dict(phase=5, **row)))
        failures += bad
    if failures:
        raise SystemExit("phase 5 failed: " + "; ".join(failures))

    log(f"wall: phases 1-5 {time.perf_counter() - t_start:.1f} s")

    def walled(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log(f"wall: {name} {time.perf_counter() - t:.1f} s")
        return out

    # ---- phases 2s-5s: the sparse fixed effect ------------------------------------
    sparse_rows, sparse_launches = walled("phases 2s-5s", sparse_phases, args.seed, dev, bw, f32_rate)

    # ---- phases 2e-5e, 3f and 3c: the e2e cell from Avro files ----------------------
    e2e_rows, e2e_launches = walled("phases 2e-5e, 3f, 3c", e2e_phases, args.seed, dev, bw, f32_rate)

    # ---- phase 5f: small estimator fits, card vs CPU --------------------------------
    small_launches = walled("phase 5f", estimator_small_phase, args.seed + 51)

    # ---- phase 5c: run_glmix.sh's driver runs, card vs CPU ---------------------------
    driver_launches = walled("phase 5c", driver_small_phase, args.seed + 61)

    # ---- phases 2d-5d: data-parallel GLMix on ranks --------------------------------
    dist_rows, dist_launches = walled("phases 2d-5d", distributed_phases, args.seed, dev, arrays,
                                      kernel_rows, phase3)

    # ---- the record lines -------------------------------------------------------
    source = "photon_ml_tpu_torch/csrc/glm_fused.cu"
    replaces = {"value_grad": "photon_ml_tpu/ops/pallas_glm.py:506",
                "hvp": "photon_ml_tpu/ops/pallas_glm.py:542"}
    kernels = [
        dict(name=k, route="cuda", source=source, replaces=replaces[k],
             launches=(launches[k] + e2e_launches["3f"]["dense"][k] + small_launches["dense"][k]
                       + e2e_launches["3c"]["dense"][k] + driver_launches["dense"][k]),
             launches_by_phase={"3+4": launches[k], "3f": e2e_launches["3f"]["dense"][k],
                                "5f": small_launches["dense"][k], "3c": e2e_launches["3c"]["dense"][k],
                                "5c": driver_launches["dense"][k]},
             max_abs_err=kernel_rows[k]["max_abs_err"], ms=kernel_rows[k]["kernel_ms"],
             plain_ms=kernel_rows[k]["plain_ms"], bound_ms=kernel_rows[k]["bound_ms"],
             bound_by=kernel_rows[k]["bound_by"], library_ms=kernel_rows[k]["library_ms"])
        for k in ("value_grad", "hvp")
    ]
    # A kernel's launches are those of every path that runs it (phases 3-4,
    # 3s, 4s, 3e, 3f, 5f, 3c and 5c, each counted from 0); a sparse kernel's times are
    # phase 2s's, at the sparse fixed effect's shape, with phase 2e's on the
    # ingested shard beside.
    kernels += [
        dict(name=k, route="cuda", source=SPARSE_SOURCE, replaces=SPARSE_REPLACES[k],
             launches=(sparse_launches[k] + e2e_launches["3e"][k] + e2e_launches["3f"]["sparse"][k]
                       + small_launches["sparse"][k] + e2e_launches["3c"]["sparse"][k]
                       + driver_launches["sparse"][k]),
             launches_by_phase={"3s+4s": sparse_launches[k], "3e": e2e_launches["3e"][k],
                                "3f": e2e_launches["3f"]["sparse"][k], "5f": small_launches["sparse"][k],
                                "3c": e2e_launches["3c"]["sparse"][k], "5c": driver_launches["sparse"][k]},
             max_abs_err=sparse_rows[k]["max_abs_err"],
             ms=sparse_rows[k]["kernel_ms"], plain_ms=sparse_rows[k]["plain_ms"],
             bound_ms=sparse_rows[k]["bound_ms"], bound_by=sparse_rows[k]["bound_by"],
             library_ms=sparse_rows[k]["library_ms"],
             e2e_shape={f: e2e_rows[k][f] for f in ("n", "d", "nnz", "route", "max_abs_err", "kernel_ms",
                                                     "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for k in SPARSE_REPLACES
    ]
    # Kernel #3: #1/#2 on each rank's rows, one all_gather and the rank-order
    # kernel (launched once per cross-rank sum: rank_sum_launches, 3d + 4d).
    kernels += [
        dict(name=k, route="cuda", source="photon_ml_tpu_torch/csrc/exact_sum.cu",
             replaces=DIST_REPLACES[k], launches=dist_launches[k],
             rank_sum_launches=dist_launches["rank_sum"], **dist_rows[k])
        for k in DIST_REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
