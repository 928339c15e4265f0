#!/usr/bin/env python3
"""Drive the PyTorch port (`photon_ml_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; there is no fallback anywhere):

1. Build the CUDA kernels (`photon_ml_tpu_torch/csrc/glm_fused.cu`) from the
   sources in this checkout with nvcc; print the build time and ptxas'
   register/spill lines.
2. Kernel vs plain version on the card at the fixed effect's full width
   (1,048,576 x 512): `value_grad` for the four losses with f32 and bf16 X,
   and `hvp` for the logistic loss. Each result is held against the plain
   PyTorch version (ops/glm_kernels.py) under PORT_TOLERANCES
   ["kernel_vs_plain"]; times are CUDA-event medians of 20 calls after
   warm-up, beside the plain version, one torch yardstick call pair
   (X @ w, then u @ X; the port never calls it) and the card's bound.
   Two shapes off the main path (d = 1000 f32, d = 517 bf16) are checked
   against the plain version too, untimed.
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

The kernels' launch counts are set to 0 just before phases 3-4 (the main
path) and read just after. The last three lines of standard output are the
`kernels` JSON line, the card's name and power limit from nvidia-smi, and
`{"ok": true, "device": {...}}`. Data comes from numpy with --seed;
weights start at zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_ROWS = 1 << 20
D_FIXED = 512
D_RE = 16
N_ENTITIES = 8192

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


def re_objective_readings(ds, red, offsets, loss, l2: float, matrices):
    """Hold random-effect coefficient matrices (name -> (E+1, D)) to the
    per-entity objectives of the coordinate's last solve on `ds`, `offsets`.

    Each entity's objective is polished to the end of float64's resolution
    from matrices["cpu"] (L-BFGS, tolerance 0); every matrix is then read in
    float64 against that optimum. Returns the largest relative objective
    excess and the largest coefficient distance from the optimum per matrix,
    and `fault`: the smallest excess over entities of a lane that never left
    its cold start (its row zeroed), which a sound limit must stay below."""
    import torch

    from photon_ml_tpu_torch.data.containers import LabeledData
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data
    from photon_ml_tpu_torch.ops import objective
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
    for b in red.buckets:
        real = b.mask.sum(dim=1) > 0  # padding lanes hold no rows
        rows = b.entity_rows[real]
        blk = gather_block_data(ds, red.feature_shard, b, offsets)
        blk = LabeledData(*(t[real].double() for t in
                            (blk.features, blk.labels, blk.offsets, blk.weights)))
        f_of = lambda W: objective.value(loss, W, blk, None, l2)
        w_star = problem.solve(loss, blk, polish, matrices["cpu"][rows].double(),
                               use_kernel=False).coefficients
        f_star = f_of(w_star)
        scale = f_star.abs().clamp_min(1.0)
        for name, M in matrices.items():
            W = M[rows].double()
            excess[name] = max(excess[name], float(((f_of(W) - f_star) / scale).max()))
            dist[name] = max(dist[name], float((W - w_star).abs().max()))
        fault = min(fault, float(((f_of(torch.zeros_like(w_star)) - f_star) / scale).min()))
    return dict(excess=excess, coef_dist=dist, fault=fault)


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
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops.losses import LOGISTIC, POISSON, SMOOTHED_HINGE, SQUARED
    from photon_ml_tpu_torch.optimize.config import (
        L2,
        CoordinateOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    bw, f32_rate = card_rates(card)
    log(f"card {card}; allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, build_log = glm_kernels.build_library(verbose=True)
    build_s = time.perf_counter() - t0
    ptx = [l.strip() for l in build_log.splitlines() if "registers" in l or "spill" in l]
    log(f"phase 1 build: {build_s:.2f} s -> {lib_path.name}")
    for line in sorted(set(ptx)):
        log(f"  ptxas: {line}")

    # ---- data -----------------------------------------------------------------
    t0 = time.perf_counter()
    Xf, Xe, entity, y = glmix_arrays(args.seed, N_ROWS, D_FIXED, D_RE, N_ENTITIES)
    rng = np.random.default_rng(args.seed + 1)
    off_np = (rng.standard_normal(N_ROWS, dtype=np.float32) * 0.1).astype(np.float32)
    wt_np = rng.uniform(0.5, 2.0, size=N_ROWS).astype(np.float32)
    w_np = (rng.standard_normal(D_FIXED, dtype=np.float32) * 0.05).astype(np.float32)
    v_np = rng.standard_normal(D_FIXED, dtype=np.float32)
    log(f"data: {time.perf_counter() - t0:.2f} s on the host (numpy, seed {args.seed})")

    # ---- phase 2: kernels vs plain versions -----------------------------------
    tol = PORT_TOLERANCES["kernel_vs_plain"]
    X32 = torch.from_numpy(Xf).to(dev)
    Xbf = X32.to(torch.bfloat16)
    yt = torch.from_numpy(y).to(dev)
    offt = torch.from_numpy(off_np).to(dev)
    wtt = torch.from_numpy(wt_np).to(dev)
    wv = torch.from_numpy(w_np).to(dev)
    vv = torch.from_numpy(v_np).to(dev)
    shift = torch.tensor(0.01, device=dev)
    n, d = X32.shape

    def bound(X, extra_vectors, flops_per_elem):
        nbytes = X.numel() * X.element_size() + 3 * n * 4 + (extra_vectors + 1) * d * 4 + (d + 2) * 4
        t_bytes = nbytes / bw * 1e3
        t_ops = flops_per_elem * n * d / f32_rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def compare(got, ref):
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

    glm_kernels.reset_launch_counts()
    kernel_rows = {}
    failures = []
    variants = [("value_grad", l, X) for X in (X32, Xbf)
                for l in (LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE)]
    variants.append(("hvp", LOGISTIC, X32))
    variants.append(("hvp", LOGISTIC, Xbf))
    for kname, loss, X in variants:
        if kname == "value_grad":
            run_k = lambda: glm_kernels.value_gradient_sums(loss, wv, shift, X, yt, offt, wtt)
            run_p = lambda: glm_kernels.value_gradient_sums_plain(loss, wv, shift, X, yt, offt, wtt)
            w_l, u_l = wv.to(X.dtype), wtt.to(X.dtype)  # any (n,) vector serves as u
            run_l = lambda: (X @ w_l, u_l @ X)
            b_ms, b_by = bound(X, 0, 4)
        else:
            run_k = lambda: glm_kernels.hessian_vector_sums(loss, wv, shift, vv, 0.02, X, yt, offt, wtt)
            run_p = lambda: glm_kernels.hessian_vector_sums_plain(loss, wv, shift, vv, 0.02, X, yt, offt, wtt)
            wv_l, u_l = torch.stack([wv, vv], dim=1).to(X.dtype), wtt.to(X.dtype)
            run_l = lambda: (X @ wv_l, u_l @ X)
            b_ms, b_by = bound(X, 1, 6)
        got = run_k()
        ref = run_p()
        torch.cuda.synchronize()
        max_abs, rel = compare(got, ref)
        ok = rel <= tol["scale_rel"]
        k_ms = time_ms(torch, run_k)
        p_ms = time_ms(torch, run_p)
        l_ms = time_ms(torch, run_l)
        row = dict(phase=2, kernel=kname, loss=loss.name, x_dtype=str(X.dtype).replace("torch.", ""),
                   n=n, d=d, max_abs_err=max_abs, scale_rel_err=rel, tol_scale_rel=tol["scale_rel"],
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by, ok=ok)
        log(json.dumps(row))
        if not ok:
            failures.append(f"{kname}/{loss.name}/{X.dtype}: rel err {rel:.3e} > {tol['scale_rel']}")
        # The main path's kernels run on bf16-stored X with the logistic loss.
        if loss is LOGISTIC and X.dtype == torch.bfloat16:
            kernel_rows[kname] = row
    # Shapes off the main path, checked but not timed: d = 1000 f32 (several
    # column chunks, the earlier ones read again for the gradient) and
    # d = 517 bf16 (1,034-byte rows: the scalar load path), n not a multiple
    # of the tile.
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    for n_x, d_x, dt in ((70001, 1000, torch.float32), (70001, 517, torch.bfloat16)):
        X = rnd(n_x, d_x).to(dt)
        yx = (torch.rand(n_x, generator=gen, device=dev) < 0.5).float()
        ox, wtx = 0.1 * rnd(n_x), 0.5 + torch.rand(n_x, generator=gen, device=dev)
        wx, vx = 0.05 * rnd(d_x), rnd(d_x)
        pairs = (
            ("value_grad",
             glm_kernels.value_gradient_sums(LOGISTIC, wx, shift, X, yx, ox, wtx),
             glm_kernels.value_gradient_sums_plain(LOGISTIC, wx, shift, X, yx, ox, wtx)),
            ("hvp",
             glm_kernels.hessian_vector_sums(LOGISTIC, wx, shift, vx, 0.02, X, yx, ox, wtx),
             glm_kernels.hessian_vector_sums_plain(LOGISTIC, wx, shift, vx, 0.02, X, yx, ox, wtx)),
        )
        torch.cuda.synchronize()
        for kname, got, ref in pairs:
            max_abs, rel = compare(got, ref)
            ok = rel <= tol["scale_rel"]
            log(json.dumps(dict(phase=2, kernel=kname, loss=LOGISTIC.name, x_dtype=str(dt).replace("torch.", ""),
                                n=n_x, d=d_x, max_abs_err=max_abs, scale_rel_err=rel,
                                tol_scale_rel=tol["scale_rel"], ok=ok)))
            if not ok:
                failures.append(f"{kname}/{n_x}x{d_x}/{dt}: rel err {rel:.3e} > {tol['scale_rel']}")
    if failures:
        raise SystemExit("phase 2 failed: " + "; ".join(failures))
    del X32, Xbf, offt, wtt, wv, vv
    torch.cuda.empty_cache()

    # ---- phase 3: GLMix training at full width --------------------------------
    task = TaskType.LOGISTIC_REGRESSION
    t0 = time.perf_counter()
    ds = GameDataset.build({"global": Xf, "per_entity": Xe}, y,
                           id_tags={"entityId": entity}, device=dev)
    red = build_random_effect_dataset(
        ds, RandomEffectDataConfig("entityId", "per_entity", active_upper_bound=128, min_bucket=32)
    )
    cfg_f = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-8), regularization=L2, reg_weight=1.0)
    cfg_r = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-7), regularization=L2, reg_weight=10.0)
    cfg_t = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(OptimizerType.TRON, 15, 1e-6), regularization=L2, reg_weight=1.0)
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
    # launches are not counted): device busy time per kernel name under
    # torch.profiler, and the idle share against the unprofiled wall time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_coordinate_descent(coords, 1)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched.
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy_ms = sum(t for _, t, _ in by_kernel)
    log(json.dumps(dict(
        phase="4b", device_busy_ms=busy_ms, glmix_wall_ms=glmix_s * 1e3,
        device_idle_share=1.0 - busy_ms / (glmix_s * 1e3), device_ops=sum(c for _, _, c in by_kernel),
        top=[dict(name=k[:60], ms=t, calls=c) for k, t, c in by_kernel[:8]],
    )))
    del ds, red, fixed, rand, tron, coords, result, scores
    torch.cuda.empty_cache()

    # ---- phase 5: small GLMix, card vs CPU ----------------------------------------
    ref_tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    re_l2 = 10.0
    small_fe = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-6), regularization=L2, reg_weight=1.0)
    small_re = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-5), regularization=L2, reg_weight=re_l2)
    failures = []
    for seed in (args.seed + 7, args.seed + 8, args.seed + 9):
        sXf, sXe, sent, sy = glmix_arrays(seed, 8192, 32, 4, 64)
        # bf16-exact fixed-effect data, so the card's bf16 storage loses nothing.
        sXf = torch.from_numpy(sXf).to(torch.bfloat16).float().numpy()
        fits = {}
        for where in ("cuda", "cpu"):
            sds = GameDataset.build({"global": sXf, "per_entity": sXe}, sy,
                                    id_tags={"entityId": sent}, device=where)
            sred = build_random_effect_dataset(
                sds, RandomEffectDataConfig("entityId", "per_entity", active_upper_bound=96, min_bucket=16))
            sc = {"fixed": FixedEffectCoordinate(sds, "global", small_fe, task),
                  "per-entity": RandomEffectCoordinate(sds, sred, small_re, task)}
            r = run_coordinate_descent(sc, 2)
            s = sum(sc[c].score(r.model[c]) for c in sc)
            fits[where] = dict(
                fe=r.model["fixed"].coefficients.means.cpu(),
                re=r.model["per-entity"].coefficients_matrix.cpu(),
                auc=float(area_under_roc_curve(s, sds.labels)),
                # The offsets the random effect's last solve ran on.
                re_offsets=sds.offsets + sc["fixed"].score(r.model["fixed"]),
                ds=sds, red=sred,
            )
        cpu = fits["cpu"]
        re = re_objective_readings(cpu["ds"], cpu["red"], cpu["re_offsets"], LOGISTIC, re_l2,
                                   {"card": fits["cuda"]["re"], "cpu": cpu["re"]})
        fe_err = float((fits["cuda"]["fe"] - cpu["fe"]).abs().max())
        auc_err = abs(fits["cuda"]["auc"] - cpu["auc"])
        limit = ref_tol["re_objective_rtol"]
        ok5 = (fe_err <= ref_tol["fe_coef_atol"] and re["excess"]["card"] <= limit
               and auc_err <= ref_tol["auc_atol"])
        log(json.dumps(dict(
            phase=5, seed=seed, fe_coef_err=fe_err, re_objective_excess=re["excess"],
            re_coef_dist_from_f64=re["coef_dist"], re_fault_excess=re["fault"],
            re_coef_card_vs_cpu=float((fits["cuda"]["re"] - cpu["re"]).abs().max()),
            auc_card=fits["cuda"]["auc"], auc_cpu=cpu["auc"], tol=ref_tol, ok=ok5)))
        if not ok5:
            failures.append(f"seed {seed}: the card's small GLMix disagrees with the CPU's")
        if not (re["excess"]["cpu"] <= limit < re["fault"]):
            failures.append(f"seed {seed}: re_objective_rtol {limit} does not separate the CPU fit "
                            f"({re['excess']['cpu']:.3e}) from a cold-start lane ({re['fault']:.3e})")
    if failures:
        raise SystemExit("phase 5 failed: " + "; ".join(failures))

    # ---- the record lines -------------------------------------------------------
    source = "photon_ml_tpu_torch/csrc/glm_fused.cu"
    replaces = {"value_grad": "photon_ml_tpu/ops/pallas_glm.py:506",
                "hvp": "photon_ml_tpu/ops/pallas_glm.py:542"}
    kernels = [
        dict(name=k, route="cuda", source=source, replaces=replaces[k], launches=launches[k],
             max_abs_err=kernel_rows[k]["max_abs_err"], ms=kernel_rows[k]["kernel_ms"],
             plain_ms=kernel_rows[k]["plain_ms"], bound_ms=kernel_rows[k]["bound_ms"],
             bound_by=kernel_rows[k]["bound_by"], library_ms=kernel_rows[k]["library_ms"])
        for k in ("value_grad", "hvp")
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
