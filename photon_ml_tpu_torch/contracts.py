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
    # FULL variances, diag(H^-1), at the same coefficients: the port sums H's f32 row products over
    # row chunks (at most HESSIAN_CHUNK_BYTES densified at a time), the reference in one product, and
    # the two Choleskys round differently; the solve carries the sums' f32 error times H's condition
    # number. tests/test_torch_owlqn_box.py reads up to 9.0e-6 (a standardized shard), 11x below.
    "full_variance": {"rtol": 1e-4},
    # A resumed fit against the uninterrupted one: the JAX package's own bound (tests/test_checkpoint.py).
    # A resume recomputes scores from the saved models' exact bits, so in one package only the order of
    # the residual sums can differ.
    "checkpoint_resume": {"rtol": 1e-6, "atol": 1e-7},
    # The GP of Bayesian tuning at fixed kernel vectors: the port runs it in float64, the JAX package
    # in float32, whose Cholesky solves lose about cond(K) * 6e-8. tests/test_torch_hyperparameter.py
    # reads up to 1.5e-4 of the log evidence and 6.6e-5 of a posterior mean on standardized draws with
    # cond(K) up to 1e4 (20 points, noise 2e-3), 6.7x and 15x below.
    "gp_float32": {"lml_rtol": 1e-3, "posterior_atol": 1e-3},
    # One model trained through an off-heap index store and through the in-memory map (chip_smoke.py
    # 3x): the store numbers the features in its own order ((INTERCEPT) first), so every sum over a
    # row's columns rounds differently in f32. Same ids give the same bits. The e2e cell's random
    # effects stop after 5 iterations, unconverged, and that rounding flips a line-search step in a
    # few lanes: on an H100, 1 of 27,586 per-user lanes (0.0196, objective 69.790 against 69.800)
    # and 30 of 5,405 per-movie lanes moved past coef_atol. Such a lane is held on its objective,
    # as "card_vs_cpu_glmix" holds a lane; the fixed effect read 1.2e-7 and the AUC 1.2e-7.
    "offheap_index": {"coef_atol": 5e-4, "re_objective_rtol": 1e-3, "auc_atol": 1e-4},
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

# ------------------------------------------------------------------- serving
# Own copies of the reference's serving schemas (photon_ml_tpu/utils/
# contracts.py); tests/test_torch_platform.py holds each equal to the
# reference's tuple.

# Latency/quality metrics a serving run reports (MicroBatcher.metrics()).
SERVING_METRIC_KEYS = (
    "p50_ms",
    "p95_ms",
    "p99_ms",
    "qps",
    "cold_start_fraction",
    "recompiles_after_warmup",
)

# The sharding block inside serving metrics (engine._sharding_metrics), in
# the reference's order, on every bundle: replicated, two-tier, row blocks
# on one card, or row-sharded over cards.
SERVING_SHARDING_KEYS = (
    "entity_sharded",
    "axis_size",
    "rows_per_shard",
    "hot_set_fraction",
    "all_to_all_bytes_per_batch",
    "shards_lost",
    "shard_loss_fallbacks",
)

# Batcher events that must be zero on a clean serving run.
SERVING_CLEAN_ZERO_KEYS = (
    "shed",
    "deadline_missed",
    "circuit_opens",
    "fe_only_answers",
)

# Process-wide robustness counters that must be zero on a clean run;
# serving-summary.json's "robustness_counters" always carries every key.
ROBUSTNESS_CLEAN_ZERO_KEYS = (
    "collective_retries",
    "shard_upload_retries",
    "promote_failures",
    "watchdog_trips",
    "mesh_losses",
    "reshard_retries",
    "reshard_rollbacks",
    "delta_rollbacks",
    "host_losses",
    "host_heartbeat_misses",
    "shadow_mirror_failures",
    "label_join_failures",
    "shadow_rollbacks",
    "autopilot_rollbacks",
    "autopilot_quarantines",
    "tier_demotions",
    "tier_restores",
    "tier_rollbacks",
)

# Top-level serving-summary.json keys written by cli/serve.py.
SERVING_SUMMARY_KEYS = (
    "num_requests",
    "failed_requests",
    "malformed_records",
    "serving",
    "health",
    "robustness_counters",
    "plan",
    "tenants",
    "provenance",
    "shadow",
    "autopilot",
)

# A served bundle's lineage block (ServingBundle.provenance).
BUNDLE_PROVENANCE_KEYS = (
    "origin",
    "generation",
    "deltas_applied",
    "last_delta_source",
    "last_delta_ts",
)

# The delta-bundle manifest (serving/delta.DeltaBundle.manifest zips these):
# what an incremental fit shipped to serving; cli/refresh persists it.
DELTA_BUNDLE_KEYS = (
    "source",
    "mode",
    "coordinates",
    "delta_rows",
    "total_rows",
    "bytes",
)

# The continuous-refresh certificate (the reference bench's continuous_loop
# section; chip_smoke.py's phase 3r-loop prints every key): a full fit, a
# streamed delta batch, an incremental fit flipped into a live engine
# under replay, against a full refit and full restage of the same rows.
CONTINUOUS_SECTION_KEYS = (
    "n_devices",
    "total_rows",
    "delta_rows",
    "delta_fraction",
    "changed_coordinates",
    "full_fit_s",
    "incremental_fit_s",
    "delta_apply_s",
    "data_to_served_s",
    "full_refresh_baseline_s",
    "speedup_vs_full",
    "unchanged_entities_bitwise",
    "answered_during_refresh",
    "failed_requests",
    "generation",
)

# One tenant's block of the multi-tenant metrics (serving/tenancy.
# TenantRegistry.metrics, the serving summary's `tenants`), and its `tier`
# sub-block: the tenant's precision rung and its ladder history.
TENANT_BLOCK_KEYS = (
    "completed",
    "failed",
    "shed",
    "deadline_missed",
    "fe_only_answers",
    "degraded_batches",
    "cobatched_requests",
    "p50_ms",
    "p95_ms",
    "p99_ms",
    "state",
    "degraded_reasons",
    "circuit_state",
    "demoted",
    "device_bytes",
    "watchdog_trips",
    "tier",
)
TIER_BLOCK_KEYS = (
    "tier",
    "quantized_coords",
    "demotions",
    "restores",
    "rollbacks",
    "quant_error_max",
)

# The precision ladder's characterized parity (the reference's values, from
# its cells of small weights and narrow rows): the tolerance a tenant's
# answers served from quantized random-effect rows keep against its own f32
# answers, by rung. bf16's error follows the sum of |x w| over a row, so wide
# trained rows can pass it (ROADMAP, Queue 3). f32 is bitwise, and so is
# every restore to f32 (built from the retained original rows).
TIER_TOLERANCES = {
    "f32": {"rtol": 0.0, "atol": 0.0},
    "bf16": {"rtol": 1e-2, "atol": 1e-3},
    "int8": {"rtol": 8e-2, "atol": 3e-2},
}

# The serving summary's `shadow` block (serving/shadow.ShadowController.summary).
SHADOW_BLOCK_KEYS = (
    "champion",
    "challenger",
    "status",
    "windows",
    "mirrored_requests",
    "mirror_failures",
    "label_join_failures",
    "champion_metric",
    "challenger_metric",
    "evaluator",
    "score_drift_p50",
    "generation",
)

# The run journal (utils/telemetry.RunJournal): the keys of every line, and
# the schema of each event type the port emits (the reference's schemas).
JOURNAL_LINE_KEYS = ("ts", "type")
JOURNAL_EVENT_SCHEMAS = {
    # The training lifecycle (utils/observability.journal_listener).
    "setup": ("args",),
    "fit_start": ("num_samples",),
    "sweep_config": ("index", "total"),
    "coordinate_update": ("iteration", "coordinate", "seconds", "accepted"),
    "fit_finish": ("num_configs", "best_metric"),
    "failure": ("error",),
    "health_transition": ("from_state", "to_state", "reasons"),
    "bundle_swap": ("version", "outcome"),
    "fault_retry": ("label", "counter", "attempt", "error"),
    "fault_injected": ("site", "invocation"),
    "watchdog_trip": ("label",),
    "shard_loss": ("coordinate", "shard_index"),
    "shard_restage": ("coordinate", "shard_index", "bytes"),
    # The hyperparameter sweep's lifecycle (hyperparameter/sweep.py, cli/tune.py).
    "trial_start": ("round", "trial", "mode"),
    "trial_finish": ("round", "trial", "mode", "seconds", "value", "diverged_steps"),
    # Checkpoints, ranks and the multi-host supervisors (game/coordinate_descent.py,
    # parallel/hostmesh.py, cli/serve_multihost.py).
    "checkpoint": ("step", "coordinate"),
    "mesh_loss": ("iteration", "coordinate", "surviving_devices", "source"),
    "host_loss": ("host", "missed_beats", "num_hosts", "source"),
    "host_join": ("host", "num_hosts", "restaged_rows"),
    "multihost_barrier": ("name", "host", "num_hosts", "seconds"),
    # Incremental refresh (game/incremental.py, serving/delta.py, cli/refresh.py).
    "delta_fit_start": ("mode", "changed_coordinates", "delta_rows", "total_rows"),
    "delta_fit_finish": ("mode", "changed_coordinates", "carried_coordinates", "seconds",
                         "max_rel_diff"),
    "delta_apply": ("version", "coordinates", "rows", "bytes", "source"),
    "delta_rollback": ("version", "reason"),
    # The generation flips of a delta apply, a hot-row rebalance and a
    # reshard across cards (serving/lifecycle.py, serving/reshard.py).
    "reshard_start": ("old_shards", "new_shards", "moved_rows", "moved_bytes"),
    "reshard_commit": ("old_shards", "new_shards", "version", "restaged_bytes"),
    "reshard_rollback": ("old_shards", "new_shards", "reason"),
    # The runtime planner (planner/plan.install_plan, apply_online_decision).
    "plan_decision": ("decision", "value", "source", "fallback"),
    # Multi-tenant serving (serving/tenancy.TenantRegistry).
    "tenant_admit": ("tenant", "device_bytes", "demoted_tenants"),
    "tenant_evict": ("tenant", "reason", "freed_bytes", "hot_rows"),
    "tenant_restore": ("tenant", "reason", "device_bytes"),
    "tenant_degraded": ("tenant", "reasons"),
    # Shadow deployment and online evaluation (serving/shadow.py).
    "shadow_start": ("champion", "challenger", "window_size", "min_windows", "mirror_fraction"),
    "shadow_window": ("champion", "challenger", "window", "rows", "champion_metric",
                      "challenger_metric", "evaluator", "healthy"),
    "shadow_verdict": ("champion", "challenger", "decision", "windows", "champion_metric",
                       "challenger_metric", "evaluator", "reason"),
    "shadow_promote": ("champion", "challenger", "version"),
    "shadow_rollback": ("champion", "challenger", "reason"),
    # The closed-loop controller (autopilot/loop.py).
    "autopilot_decision": ("rule", "action", "evidence", "outcome"),
    "autopilot_rollback": ("rule", "action", "reason"),
    "rule_quarantined": ("rule", "reason", "rollbacks"),
    # The precision ladder (serving/tenancy.TenantRegistry.demote_tier, restore_tier).
    "tier_demote": ("tenant", "from_tier", "to_tier", "reason", "freed_bytes", "evidence"),
    "tier_restore": ("tenant", "from_tier", "to_tier", "reason", "repinned_bytes", "evidence"),
}

# The sweep record chip_smoke.py's phase 3w prints (the reference bench's
# `sweep` section): a BAYESIAN sweep through the batched trial executor
# against one `estimator.fit` per trial on the same points, the winner's
# cold refit bit-equal to a standalone fit, the clean-run counters zero.
SWEEP_SECTION_KEYS = (
    "trials",
    "rounds",
    "batch_size",
    "modes",
    "stack_decisions",
    "trial_timings",
    "sweep_wall_s",
    "winner_refit_s",
    "serial_baseline_wall_s",
    "speedup_vs_serial",
    "best_point",
    "winner_value",
    "winner_bitwise_vs_standalone",
    "robustness",
)

# One evaluated trial (hyperparameter/sweep.TrialRecord.timing_entry): its
# round, evaluation mode, wall seconds (a stacked chunk's wall split evenly
# over its trials), value and divergence-guard count.
SWEEP_TRIAL_KEYS = (
    "trial",
    "round",
    "mode",
    "seconds",
    "value",
    "diverged_steps",
)

# The persisted run profile (utils/telemetry.build_profile): the keys of
# every profile, and of a fit's and a serve run's.
PROFILE_REQUIRED_KEYS = (
    "kind",
    "wall_s",
    "stages",
    "dispatch",
    "bucket_shapes",
    "device_topology",
    "roofline",
    "metrics",
)
PROFILE_FIT_KEYS = (*PROFILE_REQUIRED_KEYS, "fit_timing", "ingest")
PROFILE_SERVE_KEYS = (*PROFILE_REQUIRED_KEYS, "serving")

# The runtime-plan block fit_timing, serving-summary.json, profile.json and
# refresh-summary.json carry (planner/plan.py), and each entry of its
# `decisions` list.
PLAN_BLOCK_KEYS = ("active", "source", "profile", "decisions")
PLAN_DECISION_KEYS = ("decision", "value", "source", "evidence", "fallback")

# The closed-loop controller's block (autopilot/loop.Autopilot.summary):
# serving-summary.json's "autopilot" ({} on a run without --autopilot).
AUTOPILOT_BLOCK_KEYS = (
    "status",
    "ticks",
    "rules",
    "decisions",
    "actions",
    "suppressed",
    "rollbacks",
    "quarantined",
    "tick_ms",
    "cooldown_s",
    "action_budget",
    "last_outcome",
)
