#!/usr/bin/env python3
"""Drive the PyTorch port (`photon_ml_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; there is no fallback anywhere):

1. Build the CUDA kernels (`photon_ml_tpu_torch/csrc/glm_fused.cu`,
   `csrc/sparse_glm.cu`, `csrc/exact_sum.cu` and `csrc/ell_block.cu`, one
   nvcc each) and the
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
   256/512; each bucket solved on its (E, S, K) ELL block, whose transposes
   are csrc/ell_block.cu's kernel), after a warm-up sweep: per-coordinate
   seconds, bucket shapes, the sparse launches (sparse_fused = the fixed
   effect's objective passes, sparse_matvec and ell_rmatvec nonzero, dense
   kernels 0), peak memory and the training AUC (above 0.5); then one
   profiled sweep (3e-b). Then the ELL kernel on per-user's largest chunk
   (`ell_kernel_check`): X^T u and (X o X)^T u twice (bit-identical),
   against the plain version on float64 copies under
   PORT_TOLERANCES["sparse_kernel_vs_plain"] and bit for bit against the
   float32 plain version on the CPU, timed beside the plain version, one
   index_add_ call, the batched torch route (torch.segment_reduce) and the
   dense route's einsum on the block made dense, and the bound.
3e-d. 3e's cell on ranks (parallel/): 3e's files read once by the port's
   reader onto the host, handed to 4 gloo ranks sharing the card as shared
   memory; rows follow the per-user entities, per-movie trains on a row
   view (its owned movies' rows, exchanged once at set-up), so its update
   exchanges the residual offsets to the view and its scores back. A
   warm-up sweep, one counted sweep, one more under torch.profiler on rank
   0 (its device idle share). Per rank: set-up, wall, seconds by
   coordinate, counts, elements and seconds of exact_sum and exchange
   (exact sums = objective passes + one vote per update; 2 exchanges, of
   the planned rows; no all_reduce), launches (sparse_fused = passes,
   rank_sum = exact sums), peak memory. Gates: the same fixed-effect bits
   on every rank, one owner per entity of each random effect, the fixed
   effect within card_vs_cpu_glmix's fe_coef_atol of 3e's, each random
   effect on 3e's objective within re_objective_rtol, the AUC over ranks
   within auc_atol. Then world size 1 over NCCL, which must give 3e's bits
   (fixed effect, both matrices, scores), and one rank a card over NCCL
   where the machine has 2 or more cards.
5e-d. In 3e-d's ranks: a small e2e fit from files (12,000 rows) with
   Pearson masks (ratio 0.2) against one CPU process under
   card_vs_cpu_glmix: fixed effect, AUC and per-user AUC (a grouped
   evaluator), each random effect on its objective, and every rank's masks
   bit-equal to the CPU's rows of its entities.
5e. A small fit from files (12,000 rows: 80 users, 16 movies) on the card
   and on the CPU, one seed (two until 3e-w), under
   PORT_TOLERANCES["card_vs_cpu_glmix"]:
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
3e-w. 3e's cell over a wide shard: the e2e generator with 8 ids a row over
   16,384 instead of 200 (dim 16,385 with the intercept), 4,000,000 rows
   built in memory (no Avro write), fit once by 3f's estimator (INDEX_MAP,
   one coordinate-descent iteration). Each random effect's largest chunk
   made dense would take tens of GB. Prints each random effect's D_proj,
   buckets, the largest chunk's ELL MiB beside its dense MiB, the sweep by
   coordinate, peak memory, the launches (#4-#6 and ell_rmatvec) and the
   training AUC; a second fit must give every coefficient's bits again;
   the ELL kernel on per-user's largest chunk as in 3e (without the dense
   einsum); then a small fit at the same width (12,000 rows, 80 users, 16
   movies) on the card and on the CPU within PORT_TOLERANCES["glmix"]
   (5e-w).
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
3r. Continuous refresh (game/incremental.py, serving/delta.py), after 3f,
   its launches counted from 0 around both parts. 3r-loop: bench.py's
   continuous_loop certificate (bench.py:1419-1646) on one card (the
   reference ran it on 8 devices; the row-sharded store is ROADMAP item
   9c): 16,384 entities x 12 rows, a dense fixed effect of width 8 (L-BFGS
   10 iterations, L2 1) and a per-entity random effect of width 12
   (min_bucket 8, 40 iterations, L2 1), logistic; a full fit, an engine
   (max_batch 64) warmed on 128 requests, both paths warmed, then under a
   replay thread through the batcher an incremental fit of 128 delta rows
   over 6 churned and 2 new entities, its delta bundle and apply_delta,
   against a full refit and a full restage under the same replay. Prints
   every CONTINUOUS_SECTION_KEYS key (n_devices 1) and the stages. Gates:
   mode delta, the unchanged entities bit-equal, 0 failed requests and
   some answered, generation 1, the engine's answers bit-equal to a cold
   engine of the new state, no recompile after warm-up. Then an in-place
   edit of one entity's rows, whose refresh must carry the fixed effect's
   tensor and every other entity bit for bit; a second delta with
   `shard_upload` armed, which must roll back under replay (0 failed, the
   generation unchanged, delta_rollbacks 1); and the same incremental fit
   on the CPU at 1/16 of the entities (a cut; bf16-exact fixed-effect
   data), which must give the card's plan, the fixed effect within
   PORT_TOLERANCES["card_vs_cpu_glmix"]["fe_coef_atol"] and the random
   effect within its "re_objective_rtol" on the objective. 3r-e2e: 3e's
   ingested dataset and its three coordinates (both random effects keep
   3e's active-row caps, so the plan re-solves each whole coordinate,
   warm-started; printed): a full fit (one sweep) and an engine of it,
   then one round (two until 3e-w), a 40,000-row Avro file (1% of the
   rows; users from 2,000 of 3e's plus 16 new ones, movies uniform,
   labelled by 3e's truth) read through 3e's index maps, merged, refit
   incrementally at max_delta_fraction 1.0 (uniform movies churn nearly
   every movie, so the default 0.5 would say "full": the default's mode
   is printed) and
   flipped into the live engine under replay of 3e's rows, against a full
   refit and restage of the merged rows. Prints each round's stages
   (read, merge, fingerprint copy and hash, plan, build, offsets, solve by
   coordinate, delta build, apply), data_to_served_s, the baseline and
   device memory. Gates: 0 failed requests, generation R_E2E_ROUNDS, the
   engine bit-equal to a cold engine of the final state on 4,096
   requests; #1 (3r-loop), #4 and #5 (3r-e2e) launched.
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
   the peak of each driver. The train run's journal, read by `cli.obs
   journal --validate`, must be valid with `setup`, `fit_start`,
   `sweep_config` and `fit_finish` once and `coordinate_update` three
   times; its `profile.json`, read by `telemetry.read_profile(kind="fit")`,
   must hold the summary's `fit_timing` and name the card.
5c. examples/run_glmix.sh's data (its generator run as a script, then the
   port's libsvm_to_avro) and its train step with SIMPLE variances, on
   the card and on the CPU: the two saved models under
   PORT_TOLERANCES["card_vs_cpu_glmix"] (fixed effect, variances, each
   entity's random-effect objective at the CPU fixed effect's offsets) with
   both validation AUCs; the test file scored by each (AUCs within
   "auc_atol") and the CPU's model scored on the card within
   PORT_TOLERANCES["convert_scores"] of the CPU's scores; `sparse_rmatvec`
   nonzero in the card's train (the SIMPLE variances).

The optimizers' other modes, checkpoint-restart and the legacy driver:

3o. On phase 3's dense fixed effect (1,048,576 x 512, bf16 X; after phase
   4): L1 through OWLQN (weight 1e4), and the box from the constraint string
   [{"name": "*", "term": "*", "upperBound": 0.5}] resolved by
   optimize/constraints.py (and at 0.05, which binds): iterations, fn evals,
   zeros, the largest bound violation (exactly 0), value_grad launches
   (= fn evals); FULL variances at D = 512 (margins on the plain route), and
   on phase 3e's fixed effect at D = 201 (margins through X w): seconds and
   peak memory, finite and positive.
3k. On part 0 of phase 3e's files (2,000,000 rows, cut from both parts
   for the time limit): the three DSL coordinates through cli.train with
   --checkpoint-directory, one sweep and then a resume to the second,
   against an uninterrupted two-sweep run; then, on both parts,
   GameEstimator.fit with two
   sweeps killed at the fixed effect of sweep 2 and resumed by a new
   estimator on a new read of the files, against an uninterrupted fit. The
   models must agree within rtol 1e-6, atol 1e-7 (the JAX package's bound;
   the row says whether bit-equal); each checkpoint save's seconds, the
   load's on resume and the checkpoint's MiB. Then the fixed effect alone
   with ELASTIC_NET (alpha 0.5, weight rows / 200) through cli.train on
   part 0: nonzeros and sparse_fused launches.
5k. The card's estimator checkpoint loaded on the CPU (bit-equal to the
   card's models), and the estimator resumed from it on the CPU on a CPU
   read of the files (bit-equal).
3g. cli.glm_driver (TRAINING_EXAMPLE) on phase 3e's files, validated on
   1,000,000 rows labelled by 3e's model (another seed's rows): the
   default L2 sweep 0.1,1,10,100 and L1 at weight 1, --max-iterations 50;
   walls, stage seconds, iterations and validation AUC for each weight, the
   best weight, sparse_fused and sparse_matvec launches; then the sweep by
   TRON with SIMPLE variances on 3e's layout (#4, #5, #6 and #6 squared).
3j. The training driver's telemetry (after 3g): 3c's cli.train on part 0
   of 3e's files (2,000,000 rows; every user, movie and column of 3e's,
   held against 3c's run) with 3g's validation file and a checkpoint
   directory, twice: (A) PHOTON_TRACE=1 PHOTON_PIPELINE=1, each step's
   model write staged on a thread behind its validation, (B)
   PHOTON_PIPELINE=0, untraced. The saved models and state.json's
   checksums bit-equal; both journals valid (`cli.obs journal --validate`)
   with the same lifecycle; A's `cli.obs trace --min-coverage 90` exits 0,
   with one `ckpt_write` span a step on the writer thread; B stages no
   write and writes no trace; `sparse_fused` and `sparse_matvec` in both,
   no dense kernel. Prints each run's wall, `timings_s` and each step's
   save seconds, the span count and trace MiB.
5g. cli.glm_driver at a9a's size (examples/generate_dataset.py: 32,561 +
   16,281 rows, 123 features), --format LIBSVM with a constraint string,
   then ELASTIC_NET (alpha 0.5), card against CPU under
   PORT_TOLERANCES["card_vs_cpu_glmix"]: each weight's model (coefficients,
   or where stopping noise moves them, the objective), AUC, the best weight.

The off-heap index stores and hyperparameter tuning, on phase 3e's files
(after 3g, before they are deleted):

3x. cli.build_index on the training files twice (PHIDX with 8
   partitions, PalDB with 4; each through the port's own code), then phase
   3c's cli.train and cli.score command lines with --offheap-indexmap-dir
   for each store: build_index seconds, store MiB and both drivers'
   `timings_s`. The store numbers the features in its own order
   ((INTERCEPT) first, where 3c's in-memory map puts it last), so each
   model must equal 3c's by feature name within
   PORT_TOLERANCES["offheap_index"]: bit-equal where the ids are 3c's,
   else on the coefficients or, for a random-effect lane that f32 rounding
   moved past them (the cell's REs stop unconverged after 5 iterations),
   on each entity's objective at 3c's offsets (float64, on the card, on a
   new read of the files); the scoring AUC within its "auc_atol" (the row
   prints the largest score difference beside it); sparse_fused in train
   and sparse_matvec in score, no dense kernel.
3x-scale. On the host: a PHIDX store of 262,144 synthetic name\x01term
   keys in 8 partitions (build seconds, a get_index sweep of every key and
   a get_feature_name sweep of every id, in keys a second, MiB on disk);
   then PalDB at 65,536 keys in 4 partitions (both halved for 3n's time
   and again for 3p's), the cut its pure-Python
   writer and loader force. Every id must come back once, and names must
   round-trip.
3m. Multi-host training (cli/train_multihost.py, parallel/hostmesh.py,
   the checkpoint on ranks): 3e's 4,000,000 rows regenerated and written
   as 8 part files in row order, a PHIDX store of them (cli.build_index),
   and 3c's coordinates with IDENTITY projectors and the random effects
   at tolerance 0 (every lane takes its 5 iterations, so a stop that the
   ranks' last bits tip cannot part the two fits), two sweeps,
   checkpointed. One process's cli.train on the card first; then
   `cli.train --multihost 4 --device cuda:0`, four worker processes
   sharing the card over gloo (each decodes its 2 files, the row planes
   are exchanged through the filesystem, rows follow the users); then the
   same job with worker 2 SIGKILLed once state.json shows step 3 committed,
   which the supervisor relaunches on 3 workers that resume from the
   4-shard checkpoint. Each worker's row: its files and rows, ingest by
   stage, set-up, each sweep's wall, each checkpoint save's exchange, write
   and commit seconds, peak memory, launches (counted from 0 inside the
   fit) and collectives; the drill's kill-to-exit and relaunch-to-first-
   update seconds. Gates: both models against theirs (the uninterrupted
   against one process, the drill against the uninterrupted) on the FE
   within card_vs_cpu_glmix's fe_coef_atol, each RE on its objective
   (re_objective_rtol) and the training AUC (auc_atol); the drill's
   summary 2 attempts, 1 host loss, 1 repeated sweep, 3 final hosts;
   every shard file written by the rank of its block, the blocks tiling
   the rows; every worker launched sparse_fused, sparse_matvec and the
   rank-order kernel, no dense kernel. `tools/chip_smoke_multihost.py`
   runs 3m alone, `tools/chip_smoke_nccl.py` over NCCL on 4 cards.
3t. cli.train on the training files with 3g's 1,000,000-row validation
   file, output mode ALL and --hyper-parameter-tuning RANDOM then
   BAYESIAN, 3 trials each (4 before 3n; --random-seed 0): each trial's weights,
   validation AUC, fit seconds and launches, and the seconds of the
   searcher's proposals with each GP fit's (the GP runs on the CPU). RANDOM's
   weights must be the port's searcher's proposals for the seed, computed on
   the CPU, and BAYESIAN's first two trials the same Sobol points; the best
   model must be the argmax over the explicit and tuned results, and its
   weights those of that result.
3w. Batched hyperparameter sweeps (hyperparameter/sweep.py, cli/tune.py),
   after 3t. 3w-bench: bench.py's sweep section at its own shape (768
   training and 256 validation rows, a 12-wide dense fixed effect stored
   bf16, so every trial launches value_grad; a 4-wide random effect over
   64 entities, min_bucket 16; estimator seed 7): the stacked executor
   (max_stack 8) warmed by two throwaway rounds and reset, then
   HyperparameterTuner.sweep (16 BAYESIAN trials in rounds of 8, seed 11)
   against one estimator.fit per trial on the same points; every
   SWEEP_SECTION_KEYS key, speedup_vs_serial beside the reference's 10x
   bar (printed, not gated). Gates: the winner bit-equal to a standalone
   fit, every robustness counter 0, a serial executor on the same rounds
   giving == values and bit-equal models, value_grad launches a trial the
   same in both modes. 3w-drills: `solve` armed once in serial mode (the
   trial reads diverged_steps 1, its model bit-equal to the clean one's);
   a NaN reg weight in serial, stacked and shard-group mode (the zeros
   fixed effect and the same count everywhere); shard groups of one card
   each (one group on a one-card machine) bit-equal to serial. 3w-e2e:
   cli.tune at full width (3e's training files, 3g's
   validation file, 3c's coordinates; BAYESIAN, 8 trials in rounds of 4,
   --random-seed 0): read seconds, each trial's seconds, value and
   launches, stack_decisions, each GP proposal's seconds, winner_refit_s,
   the save seconds and the summary's keys; then cli.train at the winner's
   weights, whose saved model must be bit-equal to models/tuned-best once
   both are loaded; then two cold points stacked and serial in process on
   3f's estimator (== values, bit-equal models). 3w-sg: on the same data
   and estimator, a shard group of SG_SHARDS (4) shards, one a card on a
   machine of several, else all on card 0 with card identities 0..3 (as
   3v-sh), built by `_sweep_group_builder` and run by the executor's
   shard-group worker: both random effects' stores (SIMPLE variances on)
   row-sharded over it, the sample data replicated, the fixed effect on
   the home card. Two rounds of two points (cold, then warm) against the
   serial executor: == values and bit-equal models (coefficients and
   variances), the kernels' launches a trial equal to serial's, and
   `collective` armed once (collective_retries 1, the same bits); and each
   random effect's largest bucket solved whole and with the lanes of 4
   slices, of one-lane and of 3-lane slices at odd offsets live in place
   (the group's solve), with 0 lanes differing (the same slices solved
   alone are printed beside, not gated). Printed:
   rows a shard, store bytes a card, collective_bytes_per_sweep, each
   trial's seconds in both. `tools/chip_smoke_sweep.py` on 4 cards also
   runs `cli.tune --sweep-mode shard_group --shard-groups 2` (two groups of
   two cards) against `--sweep-mode serial`: models/tuned-best bit-equal.
3v. Online serving (photon_ml_tpu_torch/serving/, cli/serve.py) on phase
   3c's model directory (after 3t, on 3g's validation rows). First the
   offline references, their launches counted apart: GameTransformer on
   the validation file (sparse_matvec), phase 3's dense model on 32,768 of
   its rows (cut from 65,536 for 3v-sh's time), and the library row
   reduction's differing rows by bucket (the
   bits before `game.model.row_sum`). Then, counted from 0: load_bundle
   (bytes, seconds), warmup (9 CUDA graphs for max_batch 256, seconds),
   each bucket's graph replay against the same program run eagerly
   (CUDA-event medians of 20); 4,096 e2e rows scored singly, in pairs and
   in odd triples and all 32,768 at bucket 256, bit-equal to each other and
   within PORT_TOLERANCES["convert_scores"] of the offline scores; phase
   3's model bit-equal to GameTransformer at every bucket; cli.serve on
   25,000 rows of the validation file and 1,000 with unseen ids (cut from
   100,000 for 3n's time, then from 50,000 for 3n-ladder's; 0 failed,
   health CLOSED, every clean-run counter 0, the journal valid); the
   device's idle share over one replay window (torch.profiler); and the
   drills: score:p0.05 (bit-equal answers, degraded batches counted), a
   persistent score fault past the breaker's threshold (FE-only answers
   bit-equal to the FE-only tier, then the probe closes the circuit), a
   watchdog trip (FE-only answer, device_hang reason cleared by the next
   guarded dispatch), shard loss and in-place restage (bit-equal, no
   recapture) and a hot-swap to the same directory under live traffic (0
   failed, bit-equal, 9 captures). The engine path must launch none of the
   six kernels.
3v-sh. The row-sharded serving store (parallel/mesh.py's CardMesh and
   RowShardedMatrix, serving/reshard.py) on 3c's model at full width (both
   random effects, 27,587 and 5,406 rows of 201, row-sharded over a mesh of
   4 shards: one a card over the first 4 cards where the machine has two
   or more, else all 4 on card 0, printed as "cards 1, shards 4": the
   gather, the plan and the orchestrator on CUDA without a cross-card
   copy). Offline (launches counted apart): GameTransformer over 3g's
   validation file with the sharded model, bit-equal to the replicated
   one, and once more under an armed `collective` fault (retried once,
   counted, bit-equal). Then, counted from 0, on 16,384 of 3v's requests
   and 512 with unseen ids: the sharded engine bit-equal to the replicated
   one at every bucket (its first 1,024 rows below bucket 64), 9 captures;
   the largest bucket's gather ms and graph replay ms against the
   replicated replay (CUDA-event medians of 20) and a 256-request batch's
   host ms on both; the analytic gather bytes a batch
   (`all_to_all_bytes_per_batch`) and the device bytes on each card; a lost
   card of per-user (exactly its entities FE-only, bit-equal) restaged in
   place; a live reshard of the replicated engine onto 4 shards, 2, and
   back to replicated under traffic (moved rows and bytes, seconds, 9
   pre-warm captures a step, bit-equal after each, 0 failed, no
   recompile); an injected `reshard_stage` failure rolled back with the
   old generation serving. The engine path must launch none of the six
   kernels. tools/chip_smoke_entity_shard.py runs it alone (on a machine
   with 4 cards, one shard a card).
3q. Quarantined ingest on the card: a copy of 3e's part-0.avro with its
   third block broken (3e's files are null-codec: the block's last 40
   bytes, so its records run off its end after some decode) read through
   the native route onto the card, against a read of the clean file: the
   clean rows less that block's, the same ELL planes and tags, and
   `quarantined_blocks` 1.
3mv. Multi-host serving (cli/serve_multihost.py) on 3c's model and 17,384
   of 3v's requests (its first 4 blocks of 4,096 rows and its 1,000
   unseen ids; cut from 101,000 for the run's time limit, and from 12
   blocks for 3n's): `cli.serve
   --multihost 2` (each worker cuts every
   random-effect matrix into 4 row blocks and owns every other one), both
   worker processes sharing the card; uninterrupted, then with worker 1
   SIGKILLed once its first window is durable and no retry budget, then
   the same kill with a budget of one (worker 1 rejoins from its progress
   marker through `host_join`). Per run: the wall, each worker's load,
   warm-up and replay seconds, p50/p99, owned rows, the FE-only answers and
   the share answered with no lost row (with two random effects about half
   the requests have no host owning both rows), kill-to-exit and
   relaunch-to-first-window seconds. Gates: no failed request; every
   merged answer with no lost row bit-equal to 3v's single-process scores;
   the merged output bit-equal to an in-process emulation on the card (two
   engines over bundles marked host-local for hosts 0 and 1, merged by the
   same rule); the rejoin's scores the uninterrupted ones; one `host_loss`
   line a drill, `host_join` once in the rejoin; no kernel launched by any
   worker attempt (its summary's count, or a killed worker's last
   progress marker's). `tools/
   chip_smoke_serve_multihost.py` runs 3q and 3mv alone.
3n. Multi-tenant serving and shadow deployment (serving/tenancy.py,
   serving/shadow.py) on 3c's model and 2,304 of 3v's requests (cut from
   4,352 for 3n-ladder's time): four
   tenants of one co-batch signature (3c's model and three variants of it,
   its coefficients scaled by a seeded draw and written by the port's model
   store) and a fifth, 3c's model in the two-tier store (2,048 hot rows a
   random effect), which dispatches solo. Gates: every answer bit-equal to
   the tenant's solo engine, co-batches dispatched; the co-batch graph's
   replay against a solo bucket's (CUDA-event medians); a member's swap
   under live traffic (each answer the old or the new generation's bits,
   then the new's; no capture after warm-up); chaos armed for one tenant
   (lookup and score faults, a flood past its quota) leaving the clean
   tenants at 0 failed, 0 degraded labelled counters and their bits; an
   admission over `hbm_budget_bytes` demoting the coldest tenant to the
   host tier with no hot rows, bit-equal there and after `restore`, then
   demoted by hand with 2,048 hot rows, bit-equal while its promotions run
   and after `restore` (demotion and restore seconds, hot and cold hits,
   promotions); the
   shadow rejecting a challenger whose fixed effect is a seeded draw (AUC
   on the validation labels), promoting one with the champion's weights
   through the generation flip, and counting armed mirror and join faults
   as champion-only serving, the champion with 0 failed and its bits each
   time; `cli.serve --tenant` x3 on 8,192 requests, `cli.serve --shadow
   --labels` on 2,048 JSON lines and one `cli.refresh --shadow-gate` round
   at 3r-loop's shape (must commit). The serving path must launch none of
   the six kernels; the refresh round's training launches are counted
   apart ("3n-refresh"). `tools/chip_smoke_tenancy.py` runs 3n alone.
3n-ladder. The precision ladder (serving/bundle.py's quantized planes,
   serving/engine.py's re_bf16 and re_i8 kinds, TenantRegistry.demote_tier
   and restore_tier), after 3n: 3c's model beside two of 3n's variants
   (co-batched) on 3n's requests, walked f32 -> bf16 -> f32 -> bf16 -> int8
   -> f32; each transition's seconds, device bytes freed or re-pinned and
   pre-warm captures; each quantized rung's worst |score - f32 score|,
   gated at TIER_TOLERANCES[rung], the quantized tenant served solo; each
   restore bit-equal to the f32 answers before the demotion, the variants
   bit-equal throughout; an int8 bucket graph's replay against the f32
   one's; a terminal `quantize_stage` fault leaving the f32 generation
   serving bit-equal; 0 recompiles after warm-up and 0 failed. Then the
   reference's squeeze cell (13 tenants of 64 entities x 32-wide rows under
   a budget of one f32 tenant beside int8 ones), the ladder off (host-tier
   demotions, bit-equal) and on (more tenants resident, every demoted
   tenant quantized first, answers within their rung's tolerance, the
   coldest restored to f32 bit-equal). Launches none of the six kernels.
   Paid for by halving 3v's replay (25,000 rows) and 3n's requests (2,048
   a tenant). `tools/chip_smoke_ladder.py` runs 3n-ladder alone.
3p. The runtime planner and the autopilot (planner/, autopilot/,
   serving/reshard.py), after 3n: 3c's cli.train command line with
   `--profile` 3c's own profile.json (3c's model bit for bit, its #4/#5
   launches 3c's train's, an active plan block from the profile); a copy
   of that profile with its device_kind edited, refused before the read;
   PHOTON_PLAN=1's calibration probe (upload GB/s, dispatch round trip);
   3v's cli.serve with `--profile` 3v's serve profile on 3v's first 8,192
   requests (3v's scores bit for bit; the planned ceiling and wait
   printed); the autopilot on 3n's fleet (3c's model and 3n's v0
   co-batched, 3c's model two-tier with 256 hot rows, cut from 3n's 2,048
   so rows evict and promotions repeat) driven by `tick()` through demote,
   restore, rebalance, retune and the one-card reshard, each applied with
   every answer of 1,024 requests a tenant bit-equal and 0 failed (its
   tick's seconds printed), then an armed `autopilot_act` rolled back and
   its rule quarantined; 3n's `cli.serve --tenant` x3 with `--autopilot`
   and `--profile` (3n's scores bit for bit, the `autopilot` block), and
   `cli.obs decisions` on its journal. The serving part must launch none
   of the six kernels ("3p" in the kernels line holds the planned fit's
   #4/#5). Paid for by cutting 3x's PHIDX store of 1 partition and halving
   3x-scale's keys. `tools/chip_smoke_autopilot.py` runs 3p alone.

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

lint. photon-lint over the port (photon_ml_tpu_torch/analysis/), in this
   process, over the tree this script ships in: the package, this script,
   tools/ and tests/test_torch_*.py. Any finding fails the run; the line
   gives the files linted, the findings (0) and the seconds. It launches
   no kernel.

The kernels' launch counts are set to 0 just before each path (phases 3-4,
3s, 4s, 3e, 3f, 3e-w, 3r, 5f's card fits, 3c's two drivers, 5c's card runs, each run
of 3o, 3k, 3g and 5g's card runs, each driver of 3x and 3t, 3w's bench
sweep and its cli.tune run, 3w-sg's group trials, 3v's engine path, 3q's reads and 3mv's
emulation in this process, each worker of 3mv's runs from its start,
3n's serving path and its refresh round, 3n-ladder's serving path, 3p's planned fit and its serving part,
and 3d, 4d, 3e-d and 3m's uninterrupted fit in each rank, whose counts
are rank 0's) and read just after; the `kernels` line gives them by
phase (`launches_by_phase`; "3mv" sums 3mv's workers over every attempt,
"3mv-emulation" is the emulation's). "wall:" lines give each group of phases'
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
# The ELL transposes of a random effect's block: no TPU kernel; the reference's
# SparseFeatures.rmatvec (XLA's scatter-add), vmapped per lane.
ELL_REPLACES = "photon_ml_tpu/data/containers.py:73"

# Data-sheet rates (memory bytes/s, float32 FMA-pipe operations/s) by card,
# matched on the name nvidia-smi and torch report. SXM is the H100 default.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
)


def walled(name, fn, *a):
    """fn(*a), with a "wall:" line of its seconds."""
    t = time.perf_counter()
    out = fn(*a)
    log(f"wall: {name} {time.perf_counter() - t:.1f} s")
    return out


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


def e2e_arrays(rows: int, seed: int = 23, n_users=None, n_movies=None, truth=None, dim: int = E2E_D):
    """bench.py's e2e generator (bench.py:4662-4685), in numpy: per-user and
    per-movie structure in the labels, 8 uniform ids a row over dim 200
    (`dim`: phase 3e-w's wide shard). The entity counts default to the
    bench's (rows // 145, rows // 740). `truth` (the `truth` of another
    draw: weights, user and movie effects) labels new rows by that draw's
    model, for a validation file."""
    n_users = max(200, rows // 145) if n_users is None else n_users
    n_movies = max(50, rows // 740) if n_movies is None else n_movies
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=rows)
    movies = rng.integers(0, n_movies, size=rows)
    indptr = np.arange(rows + 1, dtype=np.int64) * E2E_K
    ids = rng.integers(0, dim, size=rows * E2E_K).astype(np.int32)
    vals = rng.normal(size=rows * E2E_K)
    if truth is None:
        w_true = rng.normal(size=dim) * 0.3
        truth = (w_true, rng.normal(size=n_users), rng.normal(size=n_movies))
    w_true, user_eff, movie_eff = truth
    margin = ((vals * w_true[ids]).reshape(rows, E2E_K).sum(axis=1)
              + user_eff[users] * 0.7 + movie_eff[movies] * 0.7)
    labels = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return dict(users=users, movies=movies, indptr=indptr, ids=ids, vals=vals, labels=labels,
                n_users=n_users, n_movies=n_movies, truth=truth)


def write_e2e_files(root: str, a: dict, parts: int = 2) -> float:
    """`parts` part files in row order (two: the multi-file path) with
    integer userId/movieId tags, by the port's native columnar writer, as
    bench.py writes them. Returns MB."""
    import os

    from photon_ml_tpu_torch.native.avro_writer import write_training_examples_columnar

    rows, ip = len(a["labels"]), a["indptr"]
    bounds = [rows * k // parts for k in range(parts + 1)]
    for fi, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        write_training_examples_columnar(
            os.path.join(root, f"part-{fi}.avro"), a["labels"][lo:hi], ip[lo:hi + 1] - ip[lo],
            a["ids"][ip[lo]:ip[hi]], a["vals"][ip[lo]:ip[hi]], [f"f{i}" for i in range(E2E_D)],
            int_tags={"userId": a["users"][lo:hi], "movieId": a["movies"][lo:hi]})
    return sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e6


def read_e2e(root: str, device, index_maps=None, with_maps: bool = False):
    """3e's files (or one file like them) as a dataset on `device`; with
    `index_maps`, read through those maps; `with_maps` returns them too."""
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset

    ds, maps = read_game_dataset(root, {"g": FeatureShardConfig(("features",), True)},
                                 index_maps=index_maps, id_tag_fields=E2E_TAGS, device=device)
    return (ds, maps) if with_maps else ds


def e2e_re_config(cid: str, mask_ratio=None):
    """The bench's e2e random effect `cid` on "g" (min_bucket 8), with
    Pearson selection at `mask_ratio` if given."""
    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig

    tag, cap = E2E_RE[cid]
    return RandomEffectDataConfig(tag, "g", active_upper_bound=cap, min_bucket=8,
                                  num_features_to_samples_ratio_upper_bound=mask_ratio)


def e2e_coordinates(ds, fe_cfg, re_cfg, mask_ratio=None):
    """The bench's e2e coordinates: "global" on "g", then per-user and
    per-movie random effects on "g" (`e2e_re_config`). Returns
    (coordinates, seconds building each random effect's layout)."""
    from photon_ml_tpu_torch.data.game_dataset import build_random_effect_dataset
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    coords = {"global": FixedEffectCoordinate(ds, "g", fe_cfg, task)}
    build_s = {}
    for cid in E2E_RE:
        t0 = time.perf_counter()
        red = build_random_effect_dataset(ds, e2e_re_config(cid, mask_ratio))
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


def e2e_result(ds, coords, result) -> dict:
    """Phase 3e's record of one sweep (`result` of `coords` on `ds`): the
    model, the scores with offsets and their AUC, the random effects'
    datasets and the offsets each random effect's solve ran on."""
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve

    coord_scores = {c: coords[c].score(result.model[c]) for c in coords}
    scores = sum(coord_scores.values()) + ds.offsets
    return dict(fe=result.model["global"].coefficients.means,
                re={c: result.model[c].coefficients_matrix for c in E2E_RE},
                reds={c: coords[c].re_dataset for c in E2E_RE},
                auc=float(area_under_roc_curve(scores, ds.labels)), scores=scores,
                re_offsets={"per-user": ds.offsets + coord_scores["global"],
                            "per-movie": (ds.offsets + coord_scores["global"]
                                          + coord_scores["per-user"])})


def small_e2e_fit(ds, mask_ratio=None) -> dict:
    """Phase 5e's fit: the e2e coordinates (with Pearson selection at
    `mask_ratio`, if given) with phase 5's converging solver settings, one
    sweep; the model, AUC, per-user AUC, each random effect's offsets and
    mask. On ranks (5e-d) the model and metrics are of all ranks, and the
    offsets and datasets this rank's."""
    from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorType
    from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig

    fe = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-6), regularization=L2, reg_weight=1.0)
    re = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-5), regularization=L2,
        reg_weight=SMALL_RE_L2)
    coords, _ = e2e_coordinates(ds, fe, re, mask_ratio)
    r = run_coordinate_descent(coords, 1)
    scores = {c: coords[c].score(r.model[c]) for c in coords}
    # One sweep in order: each random effect solved on the base offsets plus
    # the scores of the coordinates before it.
    re_offsets = {"per-user": ds.offsets + scores["global"],
                  "per-movie": ds.offsets + scores["global"] + scores["per-user"]}
    evaluators = [EvaluatorType("AUC"), EvaluatorType.parse("AUC:userId")]
    metrics = EvaluationSuite(evaluators, ds.labels, id_tag_values=ds.id_tags,
                              sharding=ds.sharding).evaluate(sum(scores.values()) + ds.offsets)
    model = gather_game_model(coords, r.model)
    reds = {c: coords[c].re_dataset for c in E2E_RE}
    return dict(fe=model["global"].coefficients.means.cpu(),
                re={c: model[c].coefficients_matrix.cpu() for c in E2E_RE},
                auc=metrics.results["AUC"], user_auc=metrics.results["AUC:userId"],
                ds=ds, reds=reds, re_offsets=re_offsets,
                masks={c: None if red.feature_mask is None else (
                    red.feature_mask.cpu(), None if red.owned_entities is None
                    else red.owned_entities.cpu()) for c, red in reds.items()})


def ell_kernel_check(blk, dev, seed: int, bw: float, f32_rate: float, phase: str, dense: bool):
    """The ELL transposes' kernel (ops/ell_kernels.py, csrc/ell_block.cu) on
    one random-effect block of the main path (`blk`: gather_block_data's
    LabeledData, whose features carry the transpose plan): X^T u and
    (X o X)^T u, u random on the block's live rows (weight != 0) and 0
    elsewhere, as every u of the objective is. Each is called twice
    (bit-identical), held against the plain version on float64 copies under
    PORT_TOLERANCES["sparse_kernel_vs_plain"] and, bit for bit, against the
    float32 plain version on the CPU (scatter_add_ there adds in the
    kernel's (k, s) order); timed beside the plain version on the card
    (atomic order), one index_add_ call over the entries' terms (library_ms;
    the port never calls it), the batched torch route the kernel stands in
    for (the plan's entries gathered in order, torch.segment_reduce, the
    sums written to their cells; two calls bit-identical or not) and, with
    `dense`, the einsum of the dense route it replaced, on the block made
    dense. The bound: each live entry's 4-byte index and value and each row's
    u read once, the (E, D) output written once. Returns (rows by kernel
    name, failures)."""
    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.containers import SparseFeatures, ell_block_to_dense
    from photon_ml_tpu_torch.ops import ell_kernels

    tol = PORT_TOLERANCES["sparse_kernel_vs_plain"]["scale_rel"]
    block, plan = blk.features, blk.features.plan
    E, S, K = plan.shape
    D = block.dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn(E, S, generator=gen, device=dev) * (blk.weights != 0)
    cpu_block = SparseFeatures(block.indices.cpu(), block.values.cpu(), D)
    block64 = SparseFeatures(block.indices, block.values.double(), D)
    cells = (torch.arange(E, device=dev)[:, None, None] * D + block.indices.long()).reshape(-1)
    order, ptr, run_out = plan.order.long(), plan.run_ptr.long(), plan.run_out
    dense_x = ell_block_to_dense(block) if dense else None
    entries = int(plan.order.numel())
    rows, failures = {}, []
    for square in (False, True):
        name = "ell_rmatvec_square" if square else "ell_rmatvec"
        v = block.values * block.values if square else block.values
        terms = (v * u[..., None]).reshape(-1)
        out = torch.zeros(E * D, device=dev)

        def run_torch_route():
            x = v.reshape(-1)[order] * u.reshape(-1)[order // K]
            res = torch.zeros(E * D, device=dev)
            res[run_out] = torch.segment_reduce(x, "sum", offsets=ptr, unsafe=True)
            return res.view(E, D)

        run_k = lambda: ell_kernels.rmatvec(block, u, square=square)
        run_p = lambda: ell_kernels.rmatvec_plain(block, u, square)
        got, again = run_k(), run_k()
        ref = ell_kernels.rmatvec_plain(block64, u.double(), square)
        cpu_plain = ell_kernels.rmatvec_plain(cpu_block, u.cpu(), square)
        route_a, route_b = run_torch_route(), run_torch_route()
        torch.cuda.synchronize()
        max_abs, rel = compare((got,), (ref,))
        same = torch.equal(got, again)
        cpu_bits = torch.equal(got.cpu(), cpu_plain)
        t_bytes = (entries * 8 + E * S * 4 + E * D * 4) / bw * 1e3
        t_ops = (3 if square else 2) * entries / f32_rate * 1e3
        row = dict(phase=phase, kernel=name, lanes=E, rows_a_lane=S, k=K, dim=D, entries=entries,
                   live_rows=int((blk.weights != 0).sum()), runs=plan.runs, plan_mib=plan.nbytes() / 2**20,
                   max_abs_err=max_abs, scale_rel_err=rel, tol_scale_rel=tol, bit_identical=same,
                   bit_equal_to_cpu_plain=cpu_bits,
                   torch_route_bit_identical=torch.equal(route_a, route_b),
                   torch_route_scale_rel_err=compare((route_a,), (ref,))[1])
        k_ms = [time_ms(torch, turn) for turn in (run_k, run_torch_route, run_torch_route, run_k)]
        row.update(kernel_ms=min(k_ms[0], k_ms[3]), torch_route_ms=min(k_ms[1], k_ms[2]), turns_ms=k_ms,
                   plain_ms=time_ms(torch, run_p),
                   library_ms=time_ms(torch, lambda: out.zero_().index_add_(0, cells, terms)),
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        if dense:
            dx = dense_x * dense_x if square else dense_x
            row["dense_einsum_ms"] = time_ms(torch, lambda: torch.einsum("es,esd->ed", u, dx))
            row["dense_block_gib"] = dense_x.numel() * 4 / 2**30
            del dx
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        log(json.dumps(row))
        rows[name] = row
        if not (rel <= tol and same and cpu_bits):
            failures.append(f"{phase} {name}: rel err {rel:.3e} (limit {tol}), two calls equal {same}, "
                            f"bit-equal to the CPU's plain version {cpu_bits}")
    return rows, failures


# ---------------------------------------------------------------- phase 3e-w
#
# 3e's cell over a wide shard: bench.py's e2e generator with 8 ids a row over
# 16,384 (the sparse fixed effect's width, phases 2s-4s) instead of 200,
# built in memory (no Avro write), at E2E_ROWS rows, through GameEstimator
# with INDEX_MAP. A random effect's largest chunk made dense would take tens
# of GB; the coordinate solves it on its (E, S, K) ELL block.

WIDE_D = 16_384


def wide_e2e_dataset(rows: int, dev, seed: int = 23, **kw):
    """e2e_arrays at dim WIDE_D as a GameDataset on `dev`: shard "g" (the 8
    ids, duplicates summed, and the intercept: dim WIDE_D + 1), userId and
    movieId tags."""
    from photon_ml_tpu_torch.data.containers import pack_csr_to_ell
    from photon_ml_tpu_torch.data.game_dataset import GameDataset

    a = e2e_arrays(rows, seed=seed, dim=WIDE_D, **kw)
    sf = pack_csr_to_ell(a["indptr"], a["ids"], a["vals"], WIDE_D + 1, extra_col=(WIDE_D, 1.0))
    return GameDataset.build({"g": sf}, a["labels"], id_tags={"userId": a["users"], "movieId": a["movies"]},
                             device=dev)


def wide_fit(ds, cfgs):
    """The e2e estimator (INDEX_MAP) fit once on `ds`: (estimator, result,
    scores, AUC)."""
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    est = e2e_estimator(task)
    res = est.fit(ds, None, [cfgs])[0]
    specs = est.scoring_specs()
    scores = GameTransformer(res.model, specs, task).transform(ds, est.training_prepared()).scores
    return est, res, scores, float(area_under_roc_curve(scores, ds.labels))


def wide_e2e_phase(seed: int, dev, bw: float, f32_rate: float) -> dict:
    """Phase 3e-w: the fit (counted), each random effect's D_proj and its
    largest chunk's ELL bytes beside the dense bytes it would take, peak
    memory, the sweep by coordinate, the launches, AUC; a second fit whose
    random effects must be bit-identical to the first's; the ELL kernel on
    per-user's largest chunk (`ell_kernel_check`); then a small fit (12,000
    rows, 80 users, 16 movies, same width) on the card and on the CPU within
    PORT_TOLERANCES["glmix"]. Returns the launches by kernel and the kernel
    check's rows."""
    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data
    from photon_ml_tpu_torch.ops import ell_kernels, glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk

    fe_cfg, re_cfg = e2e_configs()
    cfgs = {"global": fe_cfg, **{c: re_cfg for c in E2E_RE}}
    t0 = time.perf_counter()
    ds = wide_e2e_dataset(E2E_ROWS, dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()
    ell_kernels.reset_launch_counts()  # phase 3e-w starts here
    t0 = time.perf_counter()
    est, res, scores, auc = wide_fit(ds, cfgs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches, dense_launches = dict(sk.LAUNCHES), dict(glm_kernels.LAUNCHES)
    ell_launches = dict(ell_kernels.LAUNCHES)  # phase 3e-w ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ft = dict(est.fit_timing)
    coords = {}
    for cid in E2E_RE:
        prep = est._prepared[cid]
        red, feats = prep.re_dataset, ds.shards[prep.shard]
        big = max(red.buckets, key=lambda b: b.num_entities * b.capacity)
        cells, k = big.num_entities * big.capacity, int(feats.indices.shape[-1])
        d_proj = prep.projector.projected_dim
        coords[cid] = dict(d_proj=d_proj, entities=red.num_entities,
                           buckets=[[b.num_entities, b.capacity] for b in red.buckets],
                           largest_chunk_cells=cells, largest_chunk_ell_mib=cells * k * 8 / 2**20,
                           largest_chunk_dense_mib=cells * d_proj * 4 / 2**20)
    # A second fit on the same estimator (prepare's views reused): every
    # random effect's solve again, which must give the same bits.
    t0 = time.perf_counter()
    refit = est.fit(ds, None, [cfgs])[0]
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    rerun_equal = {c: torch.equal(refit.model[c].coefficients_matrix, res.model[c].coefficients_matrix)
                   for c in E2E_RE}
    rerun_equal["global"] = torch.equal(refit.model["global"].coefficients.means,
                                        res.model["global"].coefficients.means)
    log(json.dumps(dict(
        phase="3e-w", rows=E2E_ROWS, dim=WIDE_D + 1, data_s=data_s, fit_wall_s=fit_s,
        prepare_s=ft["prepare_s"], solve_s=ft["solve_s"], sweep_by_coordinate=res.timing,
        refit_wall_s=refit_s, refit_sweep_by_coordinate=refit.timing, coordinates=coords, train_auc=auc,
        launches=launches, ell_launches=ell_launches, dense_launches=dense_launches, peak_mem_gib=peak_gib,
        rerun_bit_identical=rerun_equal, card=card_line())))
    failures = []
    if not all(rerun_equal.values()):
        failures.append(f"a second fit differs: {rerun_equal}")
    if not ell_launches["ell_rmatvec"] or not launches["sparse_fused"] or any(dense_launches.values()):
        failures.append(f"launches {ell_launches} {launches}, dense {dense_launches}")
    if not bool(torch.isfinite(scores).all()) or scores.shape != (E2E_ROWS,) or not auc > 0.5:
        failures.append(f"scores not finite (N,) values, or training AUC {auc} not above 0.5")
    # The kernel on per-user's largest chunk, as the coordinate gathers it.
    prep = est._prepared["per-user"]
    big = max(prep.re_dataset.buckets, key=lambda b: b.num_entities * b.capacity)
    del refit, scores
    torch.cuda.empty_cache()
    rows, bad = ell_kernel_check(gather_block_data(ds, prep.shard, big), dev, seed + 35, bw, f32_rate,
                                 "3e-w", dense=False)
    failures += bad
    del est, res, ds, prep, big
    gc.collect()
    torch.cuda.empty_cache()
    # A small fit at the same width, card against CPU.
    tol = PORT_TOLERANCES["glmix"]
    fits = {}
    for where in ("cuda", "cpu"):
        d = wide_e2e_dataset(12000, torch.device(where), seed=seed + 45, n_users=80, n_movies=16)
        e, r, sc, a = wide_fit(d, cfgs)
        fits[where] = dict(fe=r.model["global"].coefficients.means.cpu(), scores=sc.cpu(), auc=a,
                           re={c: r.model[c].coefficients_matrix.cpu() for c in E2E_RE},
                           d_proj={c: e._prepared[c].projector.projected_dim for c in E2E_RE})
    card, cpu = fits["cuda"], fits["cpu"]
    row = dict(phase="5e-w", fe_coef_err=float((card["fe"] - cpu["fe"]).abs().max()),
               re_coef_err={c: float((card["re"][c] - cpu["re"][c]).abs().max()) for c in E2E_RE},
               score_err=float((card["scores"] - cpu["scores"]).abs().max()),
               auc_card=card["auc"], auc_cpu=cpu["auc"], d_proj=card["d_proj"], tol=tol)
    row["ok"] = (card["d_proj"] == cpu["d_proj"] and row["fe_coef_err"] <= tol["coef_atol"]
                 and max(row["re_coef_err"].values()) <= tol["coef_atol"]
                 and row["score_err"] <= tol["score_atol"]
                 and abs(card["auc"] - cpu["auc"]) <= tol["auc_atol"])
    log(json.dumps(row))
    if not row["ok"]:
        failures.append("the card's small wide fit is not within PORT_TOLERANCES['glmix'] of the CPU's")
    if failures:
        raise SystemExit("phase 3e-w failed: " + "; ".join(failures))
    return {"sparse": launches, "ell": ell_launches, "rows": rows}


# ---------------------------------------------------------------- phase 3r
# Continuous refresh (game/incremental.py, serving/delta.py). 3r-loop is the
# reference bench's certificate at its shape (bench.py:1419-1646) on one card;
# 3r-e2e refreshes 3e's cell at full width. Both flip a live engine under a
# replay thread.

R_ENTITIES = 16_384  # 3r-loop: the bench's 2,048 entities a device x 8 devices
R_ROWS_PER_ENTITY = 12
R_CPU_CUT = 16  # 3r-loop's card-vs-CPU check runs at 1/16 of the entities
R_E2E_BATCH = 40_000  # 3r-e2e: rows a round (1% of 3e's)
R_E2E_POOL = 2_000  # 3e's users a round's rows come from, plus R_E2E_NEW new ones
R_E2E_NEW = 16
R_E2E_ROUNDS = 1  # cut from 2 for 3e-w's time
R_E2E_CHECK = 4_096  # requests held against a cold engine of the final state


class Replay:
    """`reqs` sent one at a time through `batcher` from a thread, with a
    short pause between them (the bench's throttle, so the refresh it races
    keeps the host), until the block ends; counts answers and failures."""

    def __init__(self, batcher, reqs, pause_s: float = 0.002):
        self.batcher, self.reqs, self.pause_s = batcher, reqs, pause_s
        self.answered, self.failures = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="photon-refresh-replay")

    def _run(self):
        j = 0
        while not self._stop.is_set():
            try:
                self.batcher.submit(self.reqs[j % len(self.reqs)], block=True).result(timeout=120)
                self.answered += 1
            except Exception as exc:  # noqa: BLE001 - counted, the gate reads it
                self.failures.append(repr(exc))
            j += 1
            time.sleep(self.pause_s)

    def __enter__(self):
        self._thread.start()
        time.sleep(0.1)
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=300)
        if self._thread.is_alive():
            raise SystemExit("phase 3r: the replay thread did not stop")
        return False


def refresh_loop_configs():
    """The bench's continuous_loop configuration: a dense fixed effect "g"
    (L-BFGS 10 iterations, L2 1) and a per-entity random effect on "re"
    (min_bucket 8; 40 iterations, L2 1)."""
    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig, RandomEffectDataConfig
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig

    data = {"fixed": FixedEffectDataConfig("g"),
            "per-entity": RandomEffectDataConfig("eid", "re", min_bucket=8)}
    opt = {"fixed": CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=10),
                                                 regularization=L2, reg_weight=1.0),
           "per-entity": CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=40),
                                                      regularization=L2, reg_weight=1.0)}
    return data, opt


def refresh_loop_data(n_ent: int, dev, bf16_exact: bool = False):
    """The bench's draws (seed 61) at `n_ent` entities: the base rows (12 an
    entity), 128 requests, and the delta batch of 128 rows over 6 churned
    and 2 new entities (ids past the base's, so they append). `bf16_exact`
    rounds the fixed effect's shard through bf16, so the card's bf16 copy
    of it loses nothing (the card-vs-CPU check)."""
    import torch

    from photon_ml_tpu_torch.data.game_dataset import GameDataset
    from photon_ml_tpu_torch.serving import ScoreRequest

    rng = np.random.default_rng(61)
    d_fe, d_re = 8, 12

    def make_batch(n, pool):
        ent = np.resize(np.asarray(pool, np.int64), n)
        g = rng.normal(size=(n, d_fe)).astype(np.float32)
        if bf16_exact:
            g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
        arrays = dict(g=g,
                      re=rng.normal(size=(n, d_re)).astype(np.float32),
                      y=(rng.uniform(size=n) < 0.5).astype(np.float32), eid=ent)
        return arrays, GameDataset.build({"g": arrays["g"], "re": arrays["re"]}, arrays["y"],
                                         id_tags={"eid": ent}, device=dev)

    base = make_batch(n_ent * R_ROWS_PER_ENTITY, np.arange(n_ent))
    n_req = 128
    Xf = rng.normal(size=(n_req, d_fe)).astype(np.float32)
    Xr = rng.normal(size=(n_req, d_re)).astype(np.float32)
    reqs = [ScoreRequest(features={"g": Xf[i], "re": Xr[i]}, entity_ids={"eid": int(v)}, uid=str(i))
            for i, v in enumerate(rng.integers(0, n_ent, size=n_req))]
    churn = rng.choice(n_ent, size=6, replace=False)
    fresh = np.arange(n_ent, n_ent + 2)
    delta = make_batch(128, np.concatenate([churn, fresh]))
    return base, reqs, delta


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def refresh_loop_phase(dev) -> dict:
    """3r-loop: the bench's continuous_loop certificate on one card, its
    every CONTINUOUS_SECTION_KEYS key, then a carried-coordinate round, the
    rollback drill and the card-vs-CPU fit at 1/16 of the entities."""
    import torch

    from photon_ml_tpu_torch.contracts import CONTINUOUS_SECTION_KEYS, PORT_TOLERANCES
    from photon_ml_tpu_torch.data.game_dataset import (
        GameDataset,
        build_random_effect_dataset,
        concat_datasets,
    )
    from photon_ml_tpu_torch.game import incremental
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.serving import ServingBundle, ServingEngine
    from photon_ml_tpu_torch.serving.delta import apply_delta, build_delta_bundle
    from photon_ml_tpu_torch.transformers.game_transformer import coordinate_margins, prepare_coordinate_data
    from photon_ml_tpu_torch.types import TaskType
    from photon_ml_tpu_torch.utils import faults

    task = TaskType.LOGISTIC_REGRESSION
    data_configs, opt_configs = refresh_loop_configs()
    failures = []
    faults.clear()
    (base_np, base), reqs, (delta_np, delta_ds) = refresh_loop_data(R_ENTITIES, dev)
    specs_of = lambda st: incremental.scoring_specs(data_configs, st.entity_indices)
    bundle_of = lambda st: ServingBundle.from_model(st.model, specs_of(st), task, device=dev)

    # ---- round 0: a full fit and a warmed engine
    t0 = time.perf_counter()
    state = incremental.full_fit(base, data_configs, opt_configs, task)
    torch.cuda.synchronize()
    full_fit_s = time.perf_counter() - t0
    engine = ServingEngine(bundle_of(state), max_batch=64)
    engine.warmup()
    engine.score_batch(reqs)
    merged = concat_datasets(base, delta_ds)
    # Both paths warmed before the clocks, as the bench warms them.
    incremental.incremental_fit(merged, data_configs, opt_configs, task, prev=state)
    warm = incremental.full_fit(merged, data_configs, opt_configs, task)
    bundle_of(warm).release()
    del warm
    torch.cuda.synchronize()

    # photon-lint: disable=planner-constant — the phase pins the batcher's wait, as bench.py's
    # continuous_loop section does: a measurement's setting, not a runtime default
    with engine, engine.batcher(max_wait_ms=0.5) as batcher:
        with Replay(batcher, reqs) as replay:
            t_data = time.perf_counter()
            result = incremental.incremental_fit(merged, data_configs, opt_configs, task, prev=state)
            t_build = time.perf_counter()
            delta = build_delta_bundle(state, result.state, source="3r-loop", mode=result.plan.mode,
                                       delta_rows=result.plan.delta_rows,
                                       total_rows=result.plan.total_rows)
            t_apply = time.perf_counter()
            info = apply_delta(engine, delta)
            delta_apply_s = time.perf_counter() - t_apply
            data_to_served_s = time.perf_counter() - t_data
            # The baseline under the same replay: a full refit and a full restage.
            t_base = time.perf_counter()
            cold_state = incremental.full_fit(merged, data_configs, opt_configs, task)
            bundle_of(cold_state).release()
            torch.cuda.synchronize()
            full_refresh_baseline_s = time.perf_counter() - t_base
            del cold_state
        answered, failed = replay.answered, list(replay.failures)
        recompiles = engine.recompiles_after_warmup
        live = [r.score for r in engine.score_batch(reqs)]
        changed = set(result.plan.changed_entities.get("per-entity", ()))
        prev_idx = state.entity_indices["per-entity"]
        new_idx = result.state.entity_indices["per-entity"]
        pm = state.model["per-entity"].coefficients_matrix
        nm = result.state.model["per-entity"].coefficients_matrix
        keep = [k for k in prev_idx if k not in changed]
        unchanged_bitwise = same_bits(pm[[prev_idx[k] for k in keep]], nm[[new_idx[k] for k in keep]])
        with ServingEngine(bundle_of(result.state), max_batch=64) as cold:
            cold_scores = [r.score for r in cold.score_batch(reqs)]
            cold.bundle.release()

        # ---- the rollback drill: a second round's delta with shard_upload armed
        state1 = result.state
        rng = np.random.default_rng(62)
        pool = np.concatenate([rng.choice(R_ENTITIES, size=6, replace=False),
                               np.arange(R_ENTITIES + 2, R_ENTITIES + 4)])
        ent = np.resize(pool, 128)
        drill_ds = GameDataset.build({"g": rng.normal(size=(128, 8)).astype(np.float32),
                                      "re": rng.normal(size=(128, 12)).astype(np.float32)},
                                     (rng.uniform(size=128) < 0.5).astype(np.float32),
                                     id_tags={"eid": ent}, device=dev)
        merged2 = concat_datasets(merged, drill_ds)
        res2 = incremental.incremental_fit(merged2, data_configs, opt_configs, task, prev=state1)
        delta2 = build_delta_bundle(state1, res2.state, source="3r-drill", mode=res2.plan.mode)
        rollbacks_before = faults.COUNTERS.get("delta_rollbacks")
        with Replay(batcher, reqs) as drill:
            try:
                with faults.inject("shard_upload:9999"):
                    apply_delta(engine, delta2)
                raised = None
            except faults.InjectedFault as exc:
                raised = exc
        drill_row = dict(raised=repr(raised), answered=drill.answered, failed=len(drill.failures),
                         generation=engine.bundle_version,
                         delta_rollbacks=faults.COUNTERS.get("delta_rollbacks") - rollbacks_before,
                         scores_unchanged=[r.score for r in engine.score_batch(reqs)] == live)
        if raised is None or drill.failures or drill.answered == 0 or engine.bundle_version != 1 \
                or drill_row["delta_rollbacks"] != 1 or not drill_row["scores_unchanged"]:
            failures.append(f"the shard_upload drill did not roll back cleanly: {drill_row}")
    engine.bundle.release()

    record = dict(zip(CONTINUOUS_SECTION_KEYS, (
        1, int(result.plan.total_rows), int(result.plan.delta_rows), result.plan.delta_fraction,
        list(result.plan.changed_coordinates), full_fit_s, result.seconds, delta_apply_s,
        data_to_served_s, full_refresh_baseline_s, full_refresh_baseline_s / max(data_to_served_s, 1e-9),
        bool(unchanged_bitwise), answered, len(failed), int(info["version"]))))
    log(json.dumps(dict(phase="3r-loop", **record, mode=result.plan.mode,
                        entities=R_ENTITIES, rows=base.num_samples,
                        changed_entities=len(changed), new_entities=len(result.plan.new_entities.get(
                            "per-entity", ())),
                        stages_s=dict(result.stage_s, delta_build=t_apply - t_build,
                                      apply={k: info[f"{k}_s"] for k in ("upload", "prewarm", "flip")}),
                        delta=delta.manifest(), recompiles_after_warmup=recompiles,
                        bit_equal_to_cold_engine=live == cold_scores, drill=drill_row,
                        max_rel_diff=result.max_rel_diff)))
    if result.plan.mode != "delta" or not unchanged_bitwise or failed or answered == 0 \
            or info["version"] != 1 or live != cold_scores or recompiles != 0:
        failures.append(f"the certificate failed: mode {result.plan.mode}, unchanged bit-equal "
                        f"{unchanged_bitwise}, {len(failed)} failed of {answered} answered, generation "
                        f"{info['version']}, bit-equal to a cold engine {live == cold_scores}, "
                        f"recompiles {recompiles}")

    # ---- a carried coordinate: one entity's rows edited in place, the
    # fixed effect's inputs untouched, so its tensor is carried.
    target = int(base_np["eid"][0])
    edited = dict(base_np, re=base_np["re"].copy())
    edited["re"][base_np["eid"] == target] *= 1.5
    edited_ds = GameDataset.build({"g": edited["g"], "re": edited["re"]}, edited["y"],
                                  id_tags={"eid": edited["eid"]}, device=dev)
    carry = incremental.incremental_fit(edited_ds, data_configs, opt_configs, task, prev=state)
    fe_carried = same_bits(carry.state.model["fixed"].coefficients.means,
                           state.model["fixed"].coefficients.means)
    row = state.entity_indices["per-entity"][target]
    others = torch.ones(pm.shape[0], dtype=torch.bool, device=pm.device)
    others[row] = False
    re_carried = same_bits(carry.state.model["per-entity"].coefficients_matrix[others], pm[others])
    log(json.dumps(dict(phase="3r-loop-carry", mode=carry.plan.mode,
                        changed=list(carry.plan.changed_coordinates),
                        carried=list(carry.carried_coordinates), fixed_bit_equal=fe_carried,
                        other_entities_bit_equal=re_carried, seconds=carry.seconds)))
    if carry.plan.changed_coordinates != ("per-entity",) or not fe_carried or not re_carried:
        failures.append("an in-place random-effect edit did not carry the fixed effect and the other "
                        "entities bit for bit")

    # ---- card vs CPU, at 1/16 of the entities
    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    fits = {}
    for where in (dev, torch.device("cpu")):
        (_, b), _, (_, d) = refresh_loop_data(R_ENTITIES // R_CPU_CUT, where, bf16_exact=True)
        st = incremental.full_fit(b, data_configs, opt_configs, task)
        m = concat_datasets(b, d)
        fits[where.type] = (m, incremental.incremental_fit(m, data_configs, opt_configs, task, prev=st))
    (_, card), (m_cpu, cpu) = fits["cuda" if dev.type == "cuda" else "cpu"], fits["cpu"]
    plan_fields = lambda p: (p.mode, p.changed_coordinates, p.changed_entities, p.new_entities,
                             p.delta_rows, p.total_rows)
    fe_err = float((card.state.model["fixed"].coefficients.means.cpu()
                    - cpu.state.model["fixed"].coefficients.means).abs().max())
    red = build_random_effect_dataset(m_cpu, data_configs["per-entity"])
    spec = incremental.scoring_specs(data_configs, cpu.state.entity_indices)["fixed"]
    offsets = m_cpu.offsets + coordinate_margins(spec, cpu.state.model["fixed"],
                                                 prepare_coordinate_data(spec, m_cpu))
    re_gap = re_objective_gap(m_cpu, red, offsets, LOGISTIC, 1.0,
                              card.state.model["per-entity"].coefficients_matrix.cpu(),
                              cpu.state.model["per-entity"].coefficients_matrix)
    same_plan = plan_fields(card.plan) == plan_fields(cpu.plan)
    log(json.dumps(dict(phase="3r-loop-cpu", entities=R_ENTITIES // R_CPU_CUT, same_plan=same_plan,
                        mode=cpu.plan.mode, fe_coef_err=fe_err, re_objective_gap=re_gap, tol=tol)))
    if not same_plan or fe_err > tol["fe_coef_atol"] or re_gap > tol["re_objective_rtol"]:
        failures.append(f"card vs CPU: same plan {same_plan}, fixed effect {fe_err:.3e}, random "
                        f"effect objective gap {re_gap:.3e} (tolerance {tol})")
    if failures:
        raise SystemExit("phase 3r-loop failed: " + "; ".join(failures))
    return record


def e2e_batch_arrays(rows: int, seed: int, pool: np.ndarray, n_movies: int, truth, user_effect: dict):
    """One refresh round's rows in e2e_arrays' form (its draws, in its
    order): users from `pool`, movies uniform, 8 uniform ids a row, labels
    by 3e's `truth` (`user_effect` gives the new users' effects)."""
    rng = np.random.default_rng(seed)
    users = rng.choice(pool, size=rows)
    movies = rng.integers(0, n_movies, size=rows)
    indptr = np.arange(rows + 1, dtype=np.int64) * E2E_K
    ids = rng.integers(0, E2E_D, size=rows * E2E_K).astype(np.int32)
    vals = rng.normal(size=rows * E2E_K)
    w_true, user_eff, movie_eff = truth
    u_eff = np.array([user_effect[u] if u in user_effect else user_eff[u] for u in users.tolist()])
    margin = (vals * w_true[ids]).reshape(rows, E2E_K).sum(axis=1) + u_eff * 0.7 + movie_eff[movies] * 0.7
    labels = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return dict(users=users, movies=movies, indptr=indptr, ids=ids, vals=vals, labels=labels)


def e2e_requests(ds, n: int, seed: int):
    """`n` of `ds`'s rows as serving requests: the row's ELL entries and its
    user and movie ids."""
    from photon_ml_tpu_torch.serving import ScoreRequest

    rows = np.random.default_rng(seed).choice(ds.num_samples, size=n, replace=False)
    sf = ds.shards["g"]
    idx, val = sf.indices[rows].cpu().numpy(), sf.values[rows].cpu().numpy()
    tags = {t: ds.id_tags[t][rows] for t in E2E_TAGS}
    return [ScoreRequest(features={"g": (idx[i], val[i])},
                         entity_ids={t: str(tags[t][i]) for t in E2E_TAGS}, uid=str(int(r)))
            for i, r in enumerate(rows)]


def refresh_e2e_phase(ds, maps, truth, n_users: int, n_movies: int, dev) -> dict:
    """3r-e2e: 3e's cell refreshed R_E2E_ROUNDS times at full width into a
    live engine under replay (the module docstring); each round's batch is
    an Avro file read through 3e's index maps."""
    import os
    import tempfile

    import torch

    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig, concat_datasets
    from photon_ml_tpu_torch.game import incremental
    from photon_ml_tpu_torch.serving import ServingBundle, ServingEngine
    from photon_ml_tpu_torch.serving.delta import apply_delta, build_delta_bundle
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    fe, re = e2e_configs()
    data_configs = {"global": FixedEffectDataConfig("g"),
                    **{cid: e2e_re_config(cid) for cid in E2E_RE}}
    opt_configs = {"global": fe, "per-user": re, "per-movie": re}
    specs_of = lambda st: incremental.scoring_specs(data_configs, st.entity_indices)
    failures = []
    # 3e's rows and shard "g" alone (3f registered its projected shards on
    # the dataset), sharing its tensors and its layout of "g".
    key = ("sparse_layout", "g")
    ds = dataclasses.replace(ds, shards={"g": ds.shards["g"]},
                             cache={key: ds.cache[key]} if key in ds.cache else {})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = incremental.full_fit(ds, data_configs, opt_configs, task)
    torch.cuda.synchronize()
    full_fit_s = time.perf_counter() - t0
    engine = ServingEngine(ServingBundle.from_model(state.model, specs_of(state), task, device=dev))
    engine.warmup()
    reqs = e2e_requests(ds, R_E2E_CHECK, seed=71)
    log(json.dumps(dict(phase="3r-e2e-setup", rows=ds.num_samples, full_fit_s=full_fit_s,
                        fast_path_eligible={c: incremental._entity_fast_path_eligible(
                            data_configs[c], None) for c in E2E_RE},
                        engine_buckets=list(engine.buckets),
                        mem_gib=torch.cuda.memory_allocated() / 2**30)))
    dataset = ds
    rounds = []
    batches = tempfile.TemporaryDirectory(prefix="photon-refresh-")
    # photon-lint: disable=planner-constant — the phase pins the batcher's wait, as bench.py's
    # continuous_loop section does: a measurement's setting, not a runtime default
    with batches, engine, engine.batcher(max_wait_ms=0.5) as batcher:
        for r in range(1, R_E2E_ROUNDS + 1):
            rng = np.random.default_rng(300 + r)
            new_users = np.arange(n_users + R_E2E_NEW * (r - 1), n_users + R_E2E_NEW * r)
            pool = np.concatenate([rng.choice(n_users, size=R_E2E_POOL, replace=False), new_users])
            a = e2e_batch_arrays(R_E2E_BATCH, 400 + r, pool, n_movies, truth,
                                 dict(zip(new_users.tolist(), rng.normal(size=R_E2E_NEW))))
            batch_dir = os.path.join(batches.name, f"round-{r}")
            os.makedirs(batch_dir)
            write_e2e_files(batch_dir, a, parts=1)
            torch.cuda.reset_peak_memory_stats()
            with Replay(batcher, reqs) as replay:
                # The freshness clock: the batch's file in hand -> new generation live.
                t_data = time.perf_counter()
                batch = read_e2e(batch_dir, dev, index_maps=maps)
                torch.cuda.synchronize()
                read_s = time.perf_counter() - t_data
                merged = concat_datasets(dataset, batch, keep_last=("g",))
                torch.cuda.synchronize()
                merge_s = time.perf_counter() - t_data - read_s
                # The bench's 1% batch churns nearly every movie (uniform), so
                # the reference's 0.5 escape hatch would send it to a full
                # refit; the delta path runs at max_delta_fraction 1.0, and
                # the default's mode is printed beside it.
                result = incremental.incremental_fit(merged, data_configs, opt_configs, task,
                                                     prev=state, max_delta_fraction=1.0)
                t_build = time.perf_counter()
                delta = build_delta_bundle(state, result.state, source=f"3r-e2e-{r}",
                                           mode=result.plan.mode, delta_rows=result.plan.delta_rows,
                                           total_rows=result.plan.total_rows)
                delta_build_s = time.perf_counter() - t_build
                info = apply_delta(engine, delta)
                data_to_served_s = time.perf_counter() - t_data
                t_base = time.perf_counter()
                cold_state = incremental.full_fit(merged, data_configs, opt_configs, task)
                ServingBundle.from_model(cold_state.model, specs_of(cold_state), task,
                                         device=dev).release()
                torch.cuda.synchronize()
                baseline_s = time.perf_counter() - t_base
                del cold_state
            default_mode = incremental.plan_delta_fit(state.fingerprints, result.state.fingerprints).mode
            row = dict(phase="3r-e2e", round=r, rows=merged.num_samples, batch_rows=R_E2E_BATCH,
                       mode=result.plan.mode, default_knob_mode=default_mode,
                       delta_rows=result.plan.delta_rows, delta_fraction=result.plan.delta_fraction,
                       changed_entities={c: len(v) for c, v in result.plan.changed_entities.items()},
                       new_entities={c: len(v) for c, v in result.plan.new_entities.items()},
                       stages_s=dict(read=read_s, merge=merge_s, **result.stage_s,
                                     delta_build=delta_build_s,
                                     apply={k: info[f"{k}_s"] for k in ("upload", "prewarm", "flip")}),
                       incremental_fit_s=result.seconds, data_to_served_s=data_to_served_s,
                       full_refresh_baseline_s=baseline_s,
                       speedup_vs_full=baseline_s / data_to_served_s, delta=delta.manifest(),
                       generation=info["version"], answered=replay.answered,
                       failed=len(replay.failures), max_rel_diff=result.max_rel_diff,
                       mem_gib=torch.cuda.memory_allocated() / 2**30,
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(json.dumps(row))
            rounds.append(row)
            if replay.failures or replay.answered == 0:
                failures.append(f"round {r}: {len(replay.failures)} failed of {replay.answered} "
                                f"answered ({replay.failures[:2]})")
            state, dataset = result.state, merged
            del batch, merged, result, delta
        live = [s.score for s in engine.score_batch(reqs)]
        generation = engine.bundle_version
        recompiles = engine.recompiles_after_warmup
    engine.bundle.release()
    with ServingEngine(ServingBundle.from_model(state.model, specs_of(state), task, device=dev)) as cold:
        cold_scores = [s.score for s in cold.score_batch(reqs)]
        cold.bundle.release()
    log(json.dumps(dict(phase="3r-e2e-final", generation=generation, recompiles_after_warmup=recompiles,
                        requests=len(reqs), bit_equal_to_cold_engine=live == cold_scores)))
    if generation != R_E2E_ROUNDS or live != cold_scores:
        failures.append(f"generation {generation} (want {R_E2E_ROUNDS}); bit-equal to a cold engine of "
                        f"the final state: {live == cold_scores}")
    if failures:
        raise SystemExit("phase 3r-e2e failed: " + "; ".join(failures))
    return dict(rounds=rounds, full_fit_s=full_fit_s)


def refresh_phase(ds, maps, truth, n_users: int, n_movies: int, dev) -> dict:
    """Phase 3r (3r-loop, then 3r-e2e on 3e's ingested dataset), its
    kernels' launches counted from 0 around it; #1 (3r-loop's dense fixed
    effect), #4 and #5 (3r-e2e's sparse fixed effect, its offsets and
    margins) must each launch."""
    import torch

    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk

    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()  # phase 3r starts here
    walled("phase 3r-loop", refresh_loop_phase, dev)
    walled("phase 3r-e2e", refresh_e2e_phase, ds, maps, truth, n_users, n_movies, dev)
    launches = {"dense": dict(glm_kernels.LAUNCHES), "sparse": dict(sk.LAUNCHES)}  # 3r ends here
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps(dict(phase="3r-launches", **launches)))
    missing = [k for k, n in (("value_grad", launches["dense"]["value_grad"]),
                              ("sparse_fused", launches["sparse"]["sparse_fused"]),
                              ("sparse_matvec", launches["sparse"]["sparse_matvec"])) if n == 0]
    if missing:
        raise SystemExit(f"phase 3r: {missing} never launched ({launches})")
    return launches


def e2e_phases(seed: int, dev, bw: float, f32_rate: float, dense: dict):
    """Phases 2e, 3e, 3e-d, 5e-d, 3f, 3r, 3c, 3k, 5k, 3o's e2e part, 3g, 3x,
    3x-scale, 3m, 3t, 3w, 3v, 3v-sh, 3q, 3mv, 3n, 3p and 5e (`dense`: phase 3's arrays and model, for 3v). Returns
    (phase 2e rows by kernel, 3e's ELL kernel rows, the launches by kernel of each path)."""
    import os
    import tempfile

    import torch

    from photon_ml_tpu_torch.contracts import INGEST_STAGES, INGEST_TIMING_REQUIRED_KEYS, PORT_TOLERANCES
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.data.sparse_layout import from_ell
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data
    from photon_ml_tpu_torch.io import model_bridge
    from photon_ml_tpu_torch.ops import ell_kernels, glm_kernels
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
    truth, n_users, n_movies = a["truth"], a["n_users"], a["n_movies"]
    del a
    t0 = time.perf_counter()
    ds, e2e_maps = read_e2e(root, dev, with_maps=True)
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
    ell_kernels.reset_launch_counts()
    glm_kernels.reset_launch_counts()  # phase 3e starts here
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase3e = e2e_result(ds, coords, result)
    scores, auc = phase3e["scores"], phase3e["auc"]
    score_auc_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)  # phase 3e ends here
    ell_launches = dict(ell_kernels.LAUNCHES)
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
        train_auc=auc, launches=launches, ell_launches=ell_launches, dense_launches=dense_launches,
        peak_mem_gib=peak_gib,
        layout_mib=layout.nbytes() / 2**20,
        ell_mib=(shard.indices.numel() * 4 + shard.values.numel() * 4) / 2**20)))
    if not bool(torch.isfinite(scores).all()) or scores.shape != (E2E_ROWS,):
        raise SystemExit("phase 3e: scores are not finite (N,) values")
    if launches["sparse_fused"] != int(fe_res.fn_evals) or launches["sparse_fused"] == 0:
        raise SystemExit(f"phase 3e: {launches['sparse_fused']} sparse_fused launches for "
                         f"{int(fe_res.fn_evals)} fixed-effect objective evaluations")
    if launches["sparse_matvec"] == 0 or not ell_launches["ell_rmatvec"] or any(dense_launches.values()):
        raise SystemExit(f"phase 3e: no sparse_matvec or ell_rmatvec launch, or a dense kernel ran "
                         f"({launches}, {ell_launches}, {dense_launches})")
    if not auc > 0.5:
        raise SystemExit(f"phase 3e: training AUC {auc} is not above 0.5")
    # Where the sweep's device time goes (after the counted run).
    log(json.dumps(dict(phase="3e-b", **profile_sweep(coords, sweep_s))))
    # The ELL transposes' kernel on per-user's largest chunk, beside the
    # dense route's einsum on the same block made dense.
    red = coords["per-user"].re_dataset
    big = max(red.buckets, key=lambda b: b.num_entities * b.capacity)
    ell_rows, failures = ell_kernel_check(gather_block_data(ds, "g", big), dev, seed + 34, bw, f32_rate,
                                          "3e", dense=True)
    if failures:
        raise SystemExit("phase 3e failed: " + "; ".join(failures))
    phase3e["launches"] = launches
    del coords, result, scores, layout, red, big
    torch.cuda.empty_cache()
    launches3ed = walled("phases 3e-d, 5e-d", e2e_rank_phases, root, seed, ds, phase3e)
    del phase3e["scores"], phase3e["re_offsets"]
    torch.cuda.empty_cache()
    launches3f, fit3f = estimator_e2e_phase(ds, phase3e)
    # 3f's model in the original space, as the train driver saves it.
    t0 = time.perf_counter()
    fit3f["artifact"] = model_bridge.artifact_from_game_model(
        fit3f.pop("model"), fit3f.pop("specs"), TaskType.LOGISTIC_REGRESSION)
    fit3f["bridge_s"] = time.perf_counter() - t0
    del phase3e
    gc.collect()
    torch.cuda.empty_cache()
    launches3r = walled("phase 3r", refresh_phase, ds, e2e_maps, truth, n_users, n_movies, dev)
    del ds, shard
    torch.cuda.empty_cache()
    try:
        launches3c = driver_e2e_phase(root, fit3f)
        del fit3f
        gc.collect()
        torch.cuda.empty_cache()
        work = os.path.join(root, "slice")
        launches3k = walled("phases 3k, 5k, 3o (e2e)", checkpoint_phase, root, work)
        launches3g = walled("phase 3g", legacy_driver_e2e_phase, root, work, truth, n_users, n_movies)
        launches3j = walled("phase 3j", telemetry_phase, root, work)
        launches3x = walled("phase 3x", offheap_phase, root, work)
        walled("phase 3x-scale", offheap_scale_phase, work)
        launches3m = walled("phase 3m", multihost_phase, work)
        launches3t = walled("phase 3t", tuning_phase, root, os.path.join(work, "validation"), work)
        launches3w = walled("phase 3w", sweep_phase, root, os.path.join(work, "validation"), work)
        launches3v = walled("phase 3v", serving_phase, root, work, truth, n_users, n_movies, dense,
                            dev)
        launches3vsh = walled("phase 3v-sh", entity_shard_phase, root, work, dev)
        launches3q = walled("phase 3q", quarantine_phase, root, work, dev)
        launches3mv = walled("phase 3mv", serve_multihost_phase, root, work, dev)
        launches3n = walled("phase 3n", tenancy_phase, root, work, dev)
        launches3nl = walled("phase 3n-ladder", ladder_phase, root, work, dev)
        launches3p = walled("phase 3p", planner_autopilot_phase, root, work, dev, launches3c["train"])
    finally:
        e2e_dir.cleanup()

    # ---- phase 5e: a small fit from files, card vs CPU ----------------------------------
    ref_tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    limit = ref_tol["re_objective_rtol"]
    failures = []
    for s in (seed + 41,):  # a second seed, seed + 42, cut for 3e-w's time
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
    return rows2e, ell_rows, {"3e": launches, "3e-ell": ell_launches,
                    "3e-d": launches3ed, "3f": launches3f, "3c": launches3c,
                    "3k": launches3k, "3g": launches3g, "3j": launches3j, "3x": launches3x, "3t": launches3t,
                    "3w": launches3w, "3v": launches3v, "3v-sh": launches3vsh, "3m": launches3m,
                    "3q": launches3q,
                    "3mv": launches3mv, "3r": launches3r, "3n": launches3n, "3n-ladder": launches3nl,
                    "3p": launches3p}


# ---------------------------------------------------------------- phases 3e-d and 5e-d
# The e2e cell on ranks (parallel/): rows follow the per-user entities, and
# per-movie trains on a row view, the rows of the movies a rank owns, so each
# of its updates exchanges the residual offsets to the view and its scores
# back (`RankMesh.exchange`). The host arrays are read once from the Avro
# files by the port's reader, onto the CPU, and handed to the ranks as
# shared memory; the rank_e2e* functions run in the ranks and return host
# values.

E2E_MASK_RATIO = 0.2  # 5e-d's Pearson selection: ~30 of a user's 201 features, ~103 of a movie's


def e2e_host_arrays(ds) -> dict:
    """A dataset read onto the CPU as the host arrays `rank_e2e_dataset`
    takes, in shared memory."""
    import torch

    sf = ds.shards["g"]
    out = dict(indices=sf.indices.share_memory_(), values=sf.values.share_memory_(), dim=sf.dim,
               labels=ds.labels.share_memory_())
    for tag in E2E_TAGS:  # factorized: codes into ingest's (string-sorted) value table
        codes, table = ds.tag_codes[tag]
        out[tag] = (shared_tensor(torch, np.asarray(codes, np.int64)), table)
    return out


def rank_e2e_dataset(mesh, data: dict, mask_ratio=None):
    """This rank's rows of the e2e cell, which follow the per-user entities."""
    from photon_ml_tpu_torch.data.containers import SparseFeatures
    from photon_ml_tpu_torch.parallel.mesh import shard_game_dataset

    return shard_game_dataset(
        mesh, {"g": SparseFeatures(data["indices"], data["values"], data["dim"])}, data["labels"],
        tag_codes={tag: (np.asarray(data[tag][0]), data[tag][1]) for tag in E2E_TAGS},
        owner=e2e_re_config("per-user", mask_ratio))


def rank_e2e_sweep(mesh, data: dict, warmup: bool) -> dict:
    """Phase 3e-d on one rank: 3e's sweep on this rank's rows (with
    `warmup`, one sweep first and one more under torch.profiler on rank 0
    after), counted from 0 just before it and read just after."""
    import torch
    import torch.distributed as dist

    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve_over_ranks
    from photon_ml_tpu_torch.game.coordinate_descent import gather_game_model, run_coordinate_descent
    from photon_ml_tpu_torch.ops import glm_kernels
    from photon_ml_tpu_torch.ops import sparse_kernels as sk
    from photon_ml_tpu_torch.parallel import mesh as pmesh

    dev = mesh.device
    t0 = time.perf_counter()
    ds = rank_e2e_dataset(mesh, data)
    fe_cfg, re_cfg = e2e_configs()
    coords, re_build_s = e2e_coordinates(ds, fe_cfg, re_cfg)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    warm_s = None
    if warmup:
        t0 = time.perf_counter()
        run_coordinate_descent(coords, 1)  # first-use costs
        torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t0

    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    sk.reset_launch_counts()
    glm_kernels.reset_launch_counts()
    pmesh.reset_launch_counts()
    mesh.reset_counts()  # phase 3e-d starts here
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES, **glm_kernels.LAUNCHES, **pmesh.LAUNCHES)
    counts, elements = dict(mesh.counts), dict(mesh.elements)
    seconds = dict(mesh.seconds)  # phase 3e-d ends here
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    scores = sum(coords[c].score(result.model[c]) for c in coords) + ds.offsets
    auc = float(area_under_roc_curve_over_ranks(ds.sharding, scores, ds.labels))
    all_scores = ds.sharding.gather(scores)
    model = gather_game_model(coords, result.model)
    one_owner = {}
    for cid in E2E_RE:
        red = coords[cid].re_dataset
        owners = mesh.owned_to_global(torch.ones((len(red.owned_entities), 1), device=dev),
                                      red.owned_entities, red.num_entities + 1)
        one_owner[cid] = bool((owners[:-1] == 1).all() and (owners[-1] == 0).all())
    profile = None
    if warmup:  # every rank sweeps; rank 0 under the profiler
        if mesh.rank == 0:
            profile = profile_sweep(coords, wall_s)
        else:
            run_coordinate_descent(coords, 1)
            torch.cuda.synchronize(dev)
    fe_res = result.train_stats["global"]
    movie = coords["per-movie"].re_dataset
    row = dict(
        rows=ds.num_samples, setup_s=setup_s, re_build_s=re_build_s, warmup_wall_s=warm_s,
        sweep_wall_s=wall_s, fixed_s=result.timing["global/iter0"],
        per_user_s=result.timing["per-user/iter0"], per_movie_s=result.timing["per-movie/iter0"],
        fe_iterations=int(fe_res.iterations), fe_fn_evals=int(fe_res.fn_evals),
        collectives=counts, collective_elements=elements, collective_s=seconds,
        collective_share=sum(seconds.values()) / wall_s, exchange_share=seconds["exchange"] / wall_s,
        launches=launches, peak_mem_gib=peak_gib, train_auc=auc, one_owner_per_entity=one_owner,
        view_rows=movie.view.dataset.num_samples,
        rows_sent=dict(to_view=movie.view.to_view.rows_sent,
                       from_view=movie.view.from_view.rows_sent),
        entities={c: len(coords[c].re_dataset.owned_entities) for c in E2E_RE},
        lanes={c: [(b.capacity, b.num_entities) for b in coords[c].re_dataset.buckets]
               for c in E2E_RE},
        re_active_passive={c: (coords[c].re_dataset.num_active_samples,
                               coords[c].re_dataset.num_passive_samples) for c in E2E_RE},
        profile=profile, fe=model["global"].coefficients.means.cpu(),
    )
    if mesh.rank == 0:
        row.update(re={c: model[c].coefficients_matrix.cpu() for c in E2E_RE},
                   scores=all_scores.cpu())
    return row


def rank_e2e_phases(mesh, data: dict, small, warmup: bool) -> dict:
    """Phases 3e-d and, given `small` host arrays, 5e-d on one rank. The
    kernels come from phase 1's libraries; a rank never builds."""
    import torch

    from photon_ml_tpu_torch.ops import cuda_build, sparse_kernels
    from photon_ml_tpu_torch.parallel import mesh as pmesh

    for src in (sparse_kernels.SOURCE, pmesh.SOURCE):
        if not cuda_build.library_path(src).exists():
            raise RuntimeError(f"phase 1's {src.stem} library is missing; ranks do not build")
    out = dict(rank=mesh.rank, world_size=mesh.world_size, backend=mesh.backend,
               device=str(mesh.device), **{"3e-d": rank_e2e_sweep(mesh, data, warmup)})
    torch.cuda.empty_cache()
    if small is not None:
        fit = small_e2e_fit(rank_e2e_dataset(mesh, small, E2E_MASK_RATIO), E2E_MASK_RATIO)
        out["5e-d"] = {k: fit[k] for k in ("fe", "re", "auc", "user_auc", "masks")}
    return out


def check_3e_d(outs, label: str, ds, phase3e: dict, failures: list) -> dict:
    """Log each rank's 3e-d row and gate it: launches and collectives
    against the objective passes and the updates, the exchange's elements
    against its plan, one owner per entity, the same fixed-effect bits on
    every rank; the model against 3e's: the fixed effect within
    `fe_coef_atol`, each random effect on 3e's objective within
    `re_objective_rtol`, the AUC within `auc_atol`. Returns the summary row."""
    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.ops.losses import LOGISTIC

    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    rows = [o["3e-d"] for o in outs]
    for o, r in zip(outs, rows):
        log(json.dumps(dict(phase="3e-d", ranks=label, rank=o["rank"], device=o["device"],
                            **{k: v for k, v in r.items() if k not in ("fe", "re", "scores")})))
        passes, ln, c = r["fe_fn_evals"], r["launches"], r["collectives"]
        # One cross-rank sum per objective pass and one finiteness vote per
        # update (each a rank-order launch); per-movie exchanges its offsets
        # to the view and its scores back.
        want = {"exact_sum": passes + 3, "owned_to_global": 0,
                "exchange": 2 if o["world_size"] > 1 else 0}
        sent = r["rows_sent"]["to_view"] + r["rows_sent"]["from_view"]
        if (c != want or ln["rank_sum"] != passes + 3 or ln["sparse_fused"] != passes
                or ln["sparse_matvec"] == 0 or ln["value_grad"] or ln["hvp"]
                or r["collective_elements"]["exchange"] != (sent if o["world_size"] > 1 else 0)):
            failures.append(f"3e-d {label} rank {o['rank']}: collectives {c} (want {want}), "
                            f"elements {r['collective_elements']} ({sent} rows planned), launches "
                            f"{ln} for {passes} objective passes")
        if not all(r["one_owner_per_entity"].values()):
            failures.append(f"3e-d {label} rank {o['rank']}: an entity has no owner or two")
    r0 = rows[0]
    re_gap = {cid: re_objective_gap(ds, phase3e["reds"][cid], phase3e["re_offsets"][cid], LOGISTIC,
                                    10.0, r0["re"][cid].to(ds.device), phase3e["re"][cid])
              for cid in E2E_RE}
    summary = dict(
        phase="3e-d", ranks=label, world_size=outs[0]["world_size"],
        sweep_wall_s=max(r["sweep_wall_s"] for r in rows),
        fixed_s=max(r["fixed_s"] for r in rows), per_user_s=max(r["per_user_s"] for r in rows),
        per_movie_s=max(r["per_movie_s"] for r in rows),
        setup_s=max(r["setup_s"] for r in rows), peak_mem_gib=max(r["peak_mem_gib"] for r in rows),
        collective_share=max(r["collective_share"] for r in rows),
        exchange_share=max(r["exchange_share"] for r in rows),
        exchange_s=max(r["collective_s"]["exchange"] for r in rows),
        exact_sum_s=max(r["collective_s"]["exact_sum"] for r in rows),
        rank0_device_idle_share=None if r0["profile"] is None else r0["profile"]["device_idle_share"],
        train_auc=r0["train_auc"], phase3e_train_auc=phase3e["auc"],
        fe_vs_3e_max_abs=float((r0["fe"] - phase3e["fe"].cpu()).abs().max()),
        re_objective_gap_vs_3e=re_gap,
        fe_bit_identical_on_every_rank=all(torch.equal(r["fe"], r0["fe"]) for r in rows), tol=tol)
    log(json.dumps(summary))
    if not summary["fe_bit_identical_on_every_rank"]:
        failures.append(f"3e-d {label}: the ranks' fixed-effect coefficients differ")
    if (summary["fe_vs_3e_max_abs"] > tol["fe_coef_atol"]
            or any(g > tol["re_objective_rtol"] for g in re_gap.values())
            or abs(r0["train_auc"] - phase3e["auc"]) > tol["auc_atol"]):
        failures.append(f"3e-d {label}: the model is not 3e's within card_vs_cpu_glmix: {summary}")
    if not torch.isfinite(r0["scores"]).all():
        failures.append(f"3e-d {label}: scores are not finite")
    return summary


def e2e_rank_phases(root: str, seed: int, ds, phase3e: dict) -> dict:
    """Phases 3e-d and 5e-d: 3e's cell on 4 ranks sharing the card over gloo
    (with 5e-d in the same ranks), then at world size 1 over NCCL, which
    must give 3e's bits, and on up to 4 cards over NCCL where the machine
    has them. Returns rank 0's launches of 3e-d on the shared card."""
    import tempfile

    import torch

    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    data = e2e_host_arrays(read_e2e(root, "cpu"))
    small_arrays = e2e_arrays(12000, seed=seed + 43, n_users=80, n_movies=16)
    with tempfile.TemporaryDirectory(prefix="photon-e2e-small-") as small_root:
        write_e2e_files(small_root, small_arrays)
        small_cpu = read_e2e(small_root, "cpu")
    small = e2e_host_arrays(small_cpu)
    log(f"phase 3e-d setup: {time.perf_counter() - t0:.2f} s to read 3e's files onto the host "
        f"(shared memory) and 5e-d's")
    failures = []
    t0 = time.perf_counter()
    outs = launch(rank_e2e_phases, RANKS_SHARED, backend="gloo", devices=["cuda:0"] * RANKS_SHARED,
                  deadline_s=RANK_DEADLINE_S, args=(data, small, True))
    log(f"phases 3e-d, 5e-d: {RANKS_SHARED} ranks sharing cuda:0 over gloo, "
        f"{time.perf_counter() - t0:.2f} s from spawn to the last rank's return")
    check_3e_d(outs, "gloo, 4 ranks, one card", ds, phase3e, failures)
    launches = dict(outs[0]["3e-d"]["launches"])

    # ---- phase 5e-d: the small fit on the ranks against one CPU process ---------------
    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    cpu = small_e2e_fit(small_cpu, E2E_MASK_RATIO)
    fits = [o["5e-d"] for o in outs]
    card = fits[0]
    row = dict(phase="5e-d", seed=seed + 43, world_size=RANKS_SHARED,
               fe_coef_err=float((card["fe"] - cpu["fe"]).abs().max()), auc_card=card["auc"],
               auc_cpu=cpu["auc"], user_auc_card=card["user_auc"], user_auc_cpu=cpu["user_auc"],
               ranks_identical=all(torch.equal(f["fe"], card["fe"]) and f["auc"] == card["auc"]
                                   and f["user_auc"] == card["user_auc"] for f in fits), tol=tol)
    ok = (row["fe_coef_err"] <= tol["fe_coef_atol"] and row["ranks_identical"]
          and abs(card["auc"] - cpu["auc"]) <= tol["auc_atol"]
          and abs(card["user_auc"] - cpu["user_auc"]) <= tol["auc_atol"])
    for cid in E2E_RE:
        re = re_objective_readings(cpu["ds"], cpu["reds"][cid], cpu["re_offsets"][cid], LOGISTIC,
                                   SMALL_RE_L2, {"card": card["re"][cid], "cpu": cpu["re"][cid]})
        cpu_mask = cpu["masks"][cid][0]
        # Each rank's mask rows are its owned entities' rows of one process's masks.
        masks_equal = all(torch.equal(f["masks"][cid][0][:-1], cpu_mask[f["masks"][cid][1]])
                          and bool((f["masks"][cid][0][-1] == 1).all()) for f in fits)
        dropped = float((cpu_mask[:-1] == 0).float().mean())
        row[cid] = dict(re_objective_excess=re["excess"], re_fault_excess=re["fault"],
                        masks_bit_equal=masks_equal, mask_share_dropped=dropped)
        ok = ok and re["excess"]["card"] <= tol["re_objective_rtol"] and masks_equal and dropped > 0
        if not (re["excess"]["cpu"] <= tol["re_objective_rtol"] < re["fault"]):
            failures.append(f"5e-d {cid}: re_objective_rtol does not separate the CPU fit "
                            f"({re['excess']['cpu']:.3e}) from a cold-start lane ({re['fault']:.3e})")
    row["ok"] = ok
    log(json.dumps(row))
    if not ok:
        failures.append("5e-d: the small e2e fit on 4 ranks disagrees with one CPU process")
    del outs, fits, cpu, small_cpu
    torch.cuda.empty_cache()

    # ---- 3e-d at world size 1 over NCCL: 3e's bits -------------------------------------
    t0 = time.perf_counter()
    (one,) = launch(rank_e2e_phases, 1, backend="nccl", devices=["cuda:0"],
                    deadline_s=RANK_DEADLINE_S, args=(data, None, False))
    r1 = one["3e-d"]
    same = dict(fe=torch.equal(r1["fe"], phase3e["fe"].cpu()),
                scores=torch.equal(r1["scores"], phase3e["scores"].cpu()),
                **{cid: torch.equal(r1["re"][cid], phase3e["re"][cid].cpu()) for cid in E2E_RE})
    log(json.dumps(dict(phase="3e-d", backend="nccl", world_size=1, device="cuda:0",
                        spawn_to_return_s=time.perf_counter() - t0, setup_s=r1["setup_s"],
                        sweep_wall_s=r1["sweep_wall_s"], collectives=r1["collectives"],
                        bit_identical_to_3e=same)))
    if not all(same.values()):
        failures.append(f"3e-d: world size 1 over NCCL is not 3e's bits: {same}")
    check_3e_d([one], "nccl, world size 1", ds, phase3e, failures)
    del one, r1

    if torch.cuda.device_count() >= 2:
        e2e_across_cards(data, ds, phase3e, failures)
    else:
        log("phase 3e-d: this machine has 1 card, so NCCL runs with world size 1 only")
    if failures:
        raise SystemExit("phases 3e-d, 5e-d failed: " + "; ".join(failures))
    return launches


def e2e_across_cards(data: dict, ds, phase3e: dict, failures: list) -> None:
    """Phase 3e-d over NCCL with one rank a card (up to 4 cards), gated as
    on the shared card."""
    import torch

    from photon_ml_tpu_torch.parallel.launch import launch

    world = min(4, torch.cuda.device_count())
    t0 = time.perf_counter()
    outs = launch(rank_e2e_phases, world, backend="nccl", devices=[f"cuda:{r}" for r in range(world)],
                  deadline_s=RANK_DEADLINE_S, args=(data, None, True))
    log(f"phase 3e-d: {world} ranks, one card each, over NCCL, "
        f"{time.perf_counter() - t0:.2f} s from spawn to the last rank's return")
    check_3e_d(outs, f"nccl, {world} cards", ds, phase3e, failures)


SERVE_REPLAY_ROWS = 25_000  # 3v: rows of 3g's validation file cli.serve replays (cut from 100,000 for 3n's time, then from 50,000 for 3n-ladder's)
SERVE_UNSEEN = 1_000  # and requests with ids no model row has
SERVE_PARITY_ROWS = 32_768  # rows scored at bucket 256 and held against offline scoring (cut from 65,536 for 3v-sh's time)
SERVE_SMALL_ROWS = 4_096  # rows scored singly, in pairs and in odd triples


def e2e_records(a: dict, lo: int, hi: int, user_shift: int = 0, movie_shift: int = 0):
    """Rows [lo, hi) of an e2e draw as the records its Avro file holds
    (write_e2e_files), for serving.bundle.request_from_record."""
    ip = a["indptr"]
    return [{"features": [{"name": f"f{i}", "term": "", "value": float(v)}
                          for i, v in zip(a["ids"][ip[r]:ip[r + 1]].tolist(), a["vals"][ip[r]:ip[r + 1]].tolist())],
             "metadataMap": {"userId": str(int(a["users"][r]) + user_shift),
                             "movieId": str(int(a["movies"][r]) + movie_shift)},
             "uid": None, "offset": None} for r in range(lo, hi)]


def write_serve_requests(replay_dir: str, val: dict) -> None:
    """3v's request stream: SERVE_REPLAY_ROWS rows of the validation draw
    `val` (part-0.avro), then SERVE_UNSEEN rows whose ids no model row has
    (part-1.avro)."""
    import os

    from photon_ml_tpu_torch.native.avro_writer import write_training_examples_columnar

    os.makedirs(replay_dir)
    ip = val["indptr"]
    n, m = SERVE_REPLAY_ROWS, SERVE_UNSEEN
    names = [f"f{i}" for i in range(E2E_D)]
    write_training_examples_columnar(os.path.join(replay_dir, "part-0.avro"), val["labels"][:n], ip[:n + 1],
                                     val["ids"][:ip[n]], val["vals"][:ip[n]], names,
                                     int_tags={"userId": val["users"][:n], "movieId": val["movies"][:n]})
    write_training_examples_columnar(os.path.join(replay_dir, "part-1.avro"), val["labels"][n:n + m],
                                     ip[n:n + m + 1] - ip[n], val["ids"][ip[n]:ip[n + m]],
                                     val["vals"][ip[n]:ip[n + m]], names,
                                     int_tags={"userId": val["users"][n:n + m] + 10_000_000,
                                               "movieId": val["movies"][n:n + m] + 10_000_000})


def serve_args(best: str, replay_dir: str, out: str, *extra) -> list:
    """3v's cli.serve command line (its defaults: max_batch 256, max_wait 2 ms)."""
    return ["--model-input-directory", best, "--requests", replay_dir, "--root-output-directory", out,
            "--feature-shard-configurations", E2E_SHARD, "--logging-level", "WARNING", *extra]


def serving_phase(root: str, work: str, truth, n_users: int, n_movies: int, dense: dict, dev) -> dict:
    """Phase 3v: the online serving tier on phase 3c's model directory (FE
    over "g", 201 wide; per-user and per-movie), then phase 3's dense model.
    Offline references first (their launches counted apart); then, with the
    launch counts at 0, the engine path: staging, the nine bucket graphs,
    graph against eager per bucket, batch invariance and parity, the
    cli.serve replay, the idle share of one replay window, and the drills.
    Returns the engine path's launches (all zero) and the offline ones."""
    import os
    import threading as _threading

    import torch

    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.contracts import (
        PORT_TOLERANCES,
        ROBUSTNESS_CLEAN_ZERO_KEYS,
        SERVING_CLEAN_ZERO_KEYS,
        SERVING_METRIC_KEYS,
        SERVING_SUMMARY_KEYS,
    )
    from photon_ml_tpu_torch.data.game_dataset import GameDataset
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
    from photon_ml_tpu_torch.io import model_bridge, model_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
    from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine, load_bundle
    from photon_ml_tpu_torch.serving.bundle import request_from_record
    from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec, GameTransformer
    from photon_ml_tpu_torch.types import TaskType
    from photon_ml_tpu_torch.utils import faults, telemetry

    launches, reset = serving_launches, reset_serving_launches
    tol = PORT_TOLERANCES["convert_scores"]
    best = os.path.join(root, "drivers", "train", "models", "best")
    shards = {"g": FeatureShardConfig(("features",), True)}
    failures = []
    t_phase = time.perf_counter()

    # ---- offline references (counted apart) ------------------------------------------
    reset()
    val = e2e_arrays(E2E_ROWS // 4, seed=24, n_users=n_users, n_movies=n_movies, truth=truth)  # 3g's rows
    imaps = {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}
    artifact = model_store.load_game_model(best, imaps)
    ds, _ = read_game_dataset(os.path.join(work, "validation"), shards, index_maps=imaps,
                              id_tag_fields=E2E_TAGS, device=dev)
    model, specs = model_bridge.game_model_from_artifact(artifact, dev)
    offline = GameTransformer(model, specs, artifact.task).transform(ds).scores[:SERVE_PARITY_ROWS].cpu().numpy()
    del ds, model
    X, Xe, entity = (dense["arrays"][k][:SERVE_PARITY_ROWS] for k in ("X", "Xe", "entity"))
    p3 = dense["phase3"]
    task = TaskType.LOGISTIC_REGRESSION
    d_model = GameModel({"fixed": FixedEffectModel(Coefficients(p3["fe"].to(dev)), task),
                         "per-entity": RandomEffectModel(p3["re"].to(dev), None, task)})
    d_specs = {"fixed": CoordinateScoringSpec(shard="global"),
               "per-entity": CoordinateScoringSpec(shard="per_entity", random_effect_type="entityId",
                                                   entity_index={e: e for e in range(p3["re"].shape[0] - 1)})}
    d_ds = GameDataset.build({"global": X, "per_entity": Xe}, np.zeros(len(X), np.float32),
                             id_tags={"entityId": entity}, device=dev)
    d_ref = GameTransformer(d_model, d_specs, task).transform(d_ds).scores.cpu().numpy()
    # The library row reduction's bits by bucket, which `row_sum` replaced on
    # the scoring path: each bucket's slices against one pass of all rows.
    w_fe, M = p3["fe"].to(dev), p3["re"].to(dev)
    Xt, Xet = d_ds.shards["global"], d_ds.shards["per_entity"]
    rows_t = torch.as_tensor(entity.astype(np.int64), device=dev)
    full_fe, full_re = torch.sum(Xt * w_fe, dim=-1), torch.sum(Xet * M[rows_t], dim=-1)
    torch_sum_diff = {}
    for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        n_fe = n_re = 0
        for lo in range(0, SERVE_SMALL_ROWS, b):
            sl = slice(lo, lo + b)
            n_fe += int((torch.sum(Xt[sl] * w_fe, dim=-1) != full_fe[sl]).sum())
            n_re += int((torch.sum(Xet[sl] * M[rows_t[sl]], dim=-1) != full_re[sl]).sum())
        torch_sum_diff[b] = dict(fe_512=n_fe, re_16=n_re)
    del d_ds, Xt, Xet, full_fe, full_re
    offline_launches = launches()
    d_bundle = ServingBundle.from_model(d_model, d_specs, task, device=dev)
    d_reqs = [ScoreRequest(features={"global": X[i], "per_entity": Xe[i]}, entity_ids={"entityId": int(entity[i])})
              for i in range(len(X))]
    e2e_reqs_recs = e2e_records(val, 0, SERVE_PARITY_ROWS)
    torch.cuda.synchronize()
    log(json.dumps(dict(phase="3v-setup", offline_s=time.perf_counter() - t_phase,
                        offline_launches=offline_launches, torch_sum_rows_differing_of_4096=torch_sum_diff)))

    # ---- the engine path: launch counts at 0 ---------------------------------------------
    reset()
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    bundle = load_bundle(best, device=dev)
    load_s = time.perf_counter() - t0
    # The breaker drill's probe interval: long beside a host stall (a
    # collection pass), so the open circuit answers FE-only until the
    # drill's own sleep lets the probe through.
    engine = ServingEngine(bundle, circuit_probe_interval_s=0.5)
    reqs = [request_from_record(bundle, r, shards) for r in e2e_reqs_recs]
    t0 = time.perf_counter()
    captures = engine.warmup()
    warm_s = time.perf_counter() - t0
    bucket_ms = {}
    for b, prog in sorted(engine._state.programs.items()):
        g_ms = time_ms(torch, lambda: prog.graph.replay())
        e_ms = time_ms(torch, prog._program)
        bucket_ms[b] = dict(graph_ms=g_ms, eager_ms=e_ms, eager_over_graph=e_ms / g_ms)
    log(json.dumps(dict(phase="3v-staging", load_s=load_s, upload_bytes=bundle.upload_bytes,
                        upload_mib=bundle.upload_bytes / 2**20, upload_s=bundle.upload_s,
                        coordinates={c.cid: list(c.params.shape) for c in bundle.coordinates.values()},
                        buckets=list(engine.buckets), captures=captures, warmup_s=warm_s,
                        static_buffer_bytes=engine.warmup_buffer_bytes(), bucket_ms=bucket_ms)))
    if captures != 9 or engine.buckets[-1] != 256:
        failures.append(f"warmup captured {captures} graphs over buckets {engine.buckets}")

    def scores(results):
        return np.asarray([r.score for r in results], np.float32)

    t0 = time.perf_counter()
    small = reqs[:SERVE_SMALL_ROWS]
    singles = np.concatenate([scores(engine.score_batch([r])) for r in small])
    pairs = np.concatenate([scores(engine.score_batch(small[i:i + 2])) for i in range(0, len(small), 2)])
    triples = np.concatenate([scores(engine.score_batch(small[i:i + 3])) for i in range(0, len(small), 3)])
    full = np.concatenate([scores(engine.score_batch(reqs[i:i + 256])) for i in range(0, len(reqs), 256)])
    e2e_s = time.perf_counter() - t0
    e2e_bits = bool((singles == full[:SERVE_SMALL_ROWS]).all() and (pairs == singles).all()
                    and (triples == singles).all())
    e2e_err = float(np.abs(full.astype(np.float64) - offline).max())
    e2e_ok = bool(np.allclose(full, offline, rtol=tol["rtol"], atol=tol["atol"]))
    t0 = time.perf_counter()
    with ServingEngine(d_bundle) as d_engine:
        d_captures = d_engine.warmup()
        d_by_bucket, d_rows = {}, {}
        for b in d_engine.buckets:  # every row from buckets of 64 up, the first 4,096 below
            n_rows = len(d_reqs) if b >= 64 else SERVE_SMALL_ROWS
            got = np.concatenate([scores(d_engine.score_batch(d_reqs[i:i + b])) for i in range(0, n_rows, b)])
            d_by_bucket[b], d_rows[b] = int((got != d_ref[:n_rows]).sum()), n_rows
        d_recompiles = d_engine.recompiles_after_warmup
    dense_s = time.perf_counter() - t0
    log(json.dumps(dict(phase="3v-parity", e2e_rows=len(reqs), small_rows=SERVE_SMALL_ROWS,
                        e2e_bit_equal_across_buckets=e2e_bits, e2e_max_abs_vs_offline=e2e_err, e2e_tol=tol,
                        e2e_within_tol=e2e_ok, e2e_s=e2e_s, dense_rows_checked=d_rows,
                        dense_rows_differing_by_bucket=d_by_bucket, dense_captures=d_captures,
                        dense_recompiles=d_recompiles, dense_s=dense_s,
                        recompiles_after_warmup=engine.recompiles_after_warmup)))
    if not e2e_bits or not e2e_ok:
        failures.append(f"e2e rows: bit-equal across buckets {e2e_bits}, {e2e_err:.3e} from offline scoring")
    if any(d_by_bucket.values()) or d_recompiles != 0:
        failures.append(f"phase 3's model is not bit-equal to GameTransformer at every bucket: {d_by_bucket}")
    del d_bundle, d_reqs, d_model

    # ---- the driver: cli.serve on 25,000 rows of 3g's validation file + unseen ids ----------
    replay_dir = os.path.join(work, "serve-requests")
    write_serve_requests(replay_dir, val)
    n, m = SERVE_REPLAY_ROWS, SERVE_UNSEEN
    out = os.path.join(work, "serve")
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    summary = serve_cli.main(serve_args(best, replay_dir, out))
    serve_wall = time.perf_counter() - t0
    sv = summary["serving"]
    journal_ok, journal_errors = telemetry.validate_journal(os.path.join(out, "journal.jsonl"))
    robust = {k: summary["robustness_counters"][k] for k in ROBUSTNESS_CLEAN_ZERO_KEYS}
    log(json.dumps(dict(
        phase="3v-serve", wall_s=serve_wall, num_requests=summary["num_requests"],
        failed_requests=summary["failed_requests"], malformed_records=summary["malformed_records"],
        serving={k: sv[k] for k in (*SERVING_METRIC_KEYS, *SERVING_CLEAN_ZERO_KEYS, "completed", "batches",
                                     "batch_size_p50", "batch_size_p95", "padding_waste", "cold_start_lookups",
                                     "compiles", "engine_qps", "upload_bytes", "upload_s", "stage_walls_s")},
        health=summary["health"]["state"], robustness_counters=robust, journal_lines=journal_ok,
        journal_errors=journal_errors, summary_keys_ok=sorted(summary) == sorted(SERVING_SUMMARY_KEYS))))
    if summary["num_requests"] != n + m or summary["failed_requests"] or summary["health"]["state"] != "CLOSED" \
            or any(robust.values()) or any(sv[k] for k in SERVING_CLEAN_ZERO_KEYS) \
            or sv["recompiles_after_warmup"] != 0 or journal_errors or sorted(summary) != sorted(SERVING_SUMMARY_KEYS):
        failures.append("the cli.serve replay is not clean (see the 3v-serve line)")

    # ---- idle share over one replay window (8,192 requests through the batcher) -------------
    window = reqs[:serve_cli.REPLAY_WINDOW]
    with engine.batcher() as b:
        t0 = time.perf_counter()
        b.score_all(window)
        wall = time.perf_counter() - t0
        batches0 = engine.metrics()["batches"]
        prof = profile_call(lambda: b.score_all(window), wall)
        batches = engine.metrics()["batches"] - batches0
    log(json.dumps(dict(phase="3v-idle", requests=len(window), batches=batches, **prof)))

    # ---- drills on the served bundle's engine -------------------------------------------------
    clean = scores(engine.score_batch(reqs[:1024]))
    fe_only = scores(engine.score_batch_fe_only(reqs[:1024]))
    drills = {}
    telemetry.METRICS.reset()
    import logging

    port_log = logging.getLogger("photon_ml_tpu_torch")
    log_level = port_log.level
    port_log.setLevel(logging.ERROR)  # each injected fault and retry logs a warning
    with faults.inject("score:p0.05", seed=3):
        with engine.batcher(max_batch=16) as b:  # 256 batches or more: about 13 faults
            got = scores(b.score_all(small))
    drills["score_p0.05"] = dict(requests=len(small), bit_equal=bool((got == singles).all()),
                                 degraded_batches=faults.COUNTERS.get("serving_degraded_batches"))
    os.environ["PHOTON_RETRY_MAX_ATTEMPTS"] = "1"
    try:
        with faults.inject("score:1000"):
            # photon-lint: disable=planner-constant — the drill pins the batcher's wait: it checks answers
            # under an armed fault, not the wait
            with engine.batcher(max_wait_ms=0.5) as b:
                answers, errors = {}, 0
                for i in range(32):
                    try:
                        answers[i] = b.submit(reqs[i]).result(timeout=60)
                    except faults.InjectedFault:
                        errors += 1
        opened = engine.breaker.state.value
        time.sleep(0.6)  # the probe interval
        with engine.batcher() as b:
            probe = b.submit(reqs[32]).result(timeout=60)
            after = scores(b.score_all(reqs[33:64]))
    finally:
        del os.environ["PHOTON_RETRY_MAX_ATTEMPTS"]
    drills["breaker"] = dict(errors_before_open=errors, state_under_faults=opened,
                             fe_only_answers=sum(r.fe_only for r in answers.values()),
                             fe_only_bit_equal=bool(all(r.fe_only and np.float32(r.score) == fe_only[i]
                                                        for i, r in answers.items())),
                             probe_full=bool(not probe.fe_only and np.float32(probe.score) == clean[32]),
                             state_after_probe=engine.breaker.state.value,
                             after_bit_equal=bool((after == clean[33:64]).all()))
    trips0 = faults.COUNTERS.get("watchdog_trips")
    engine._watchdog_ms = 0.001  # far below one dispatch
    hung = None
    with engine.batcher() as b:
        for i in range(64):
            res = b.submit(reqs[i]).result(timeout=60)
            if faults.COUNTERS.get("watchdog_trips") > trips0:
                hung = (i, res)
                break
        for _ in range(100):  # the monitor thread marks the engine just after the trip
            if "device_hang" in engine.health.degraded_reasons:
                break
            time.sleep(0.01)
        degraded_at_trip = list(engine.health.degraded_reasons)
        engine._watchdog_ms = 60_000.0
        cleared = b.submit(reqs[100]).result(timeout=60)
    engine._watchdog_ms = 0.0
    drills["watchdog"] = dict(trips=faults.COUNTERS.get("watchdog_trips") - trips0,
                              answered_fe_only=bool(hung is not None and hung[1].fe_only
                                                    and np.float32(hung[1].score) == fe_only[hung[0]]),
                              degraded_at_trip=degraded_at_trip, cleared=engine.health.degraded_reasons == [],
                              after_bit_equal=bool(np.float32(cleared.score) == clean[100]))
    compiles0 = engine.compiles
    coord = engine.bundle.coordinates["per-user"]
    host_rows = coord.params.cpu().numpy().copy()
    engine.mark_shard_lost("per-user", 0)
    lost = engine.score_batch(reqs[:1024])
    cold_user = [ScoreRequest(features=r.features, entity_ids={**r.entity_ids, "userId": "-1"}) for r in reqs[:1024]]
    cold_ref = scores(engine.score_batch(cold_user))
    with engine._device_mutex:
        coord.params.zero_()  # the shard's rows are gone from the card
    t0 = time.perf_counter()
    nbytes = engine.restage_shard("per-user", 0, rows=host_rows)
    restage_s = time.perf_counter() - t0
    back = scores(engine.score_batch(reqs[:1024]))
    drills["shard_loss"] = dict(lost_answers=sum(r.n_lost for r in lost),
                                lost_bit_equal_to_cold_user=bool((scores(lost) == cold_ref).all()),
                                restaged_bytes=nbytes, restage_s=restage_s,
                                restaged_bit_equal=bool((back == clean).all()),
                                recaptures=engine.compiles - compiles0, health=engine.health.state.value)
    stop = _threading.Event()
    traffic = dict(answered=0, failed=0, mismatched=0)
    with engine.batcher() as b:
        def flow():
            i = 0
            while not stop.is_set():
                k = i % 1024
                try:
                    r = b.submit(reqs[k], block=True).result(timeout=60)
                    traffic["answered"] += 1
                    traffic["mismatched"] += int(np.float32(r.score) != clean[k])
                except Exception:  # counted: the drill wants none
                    traffic["failed"] += 1
                i += 1

        t = _threading.Thread(target=flow, name="chip-smoke-serving-traffic")
        t.start()
        try:
            time.sleep(0.2)  # traffic on the old generation
            info = engine.bundle_manager.swap(lambda: load_bundle(best, device=dev))
            time.sleep(0.2)  # and on the new one
        finally:
            stop.set()
            t.join(timeout=120)
    drills["swap"] = dict(**traffic, version=info["version"], stage_s=info["stage_s"],
                          staging_captures=info["staging_compiles"], old_released=info["old_released"],
                          recompiles_after_warmup=engine.recompiles_after_warmup)
    engine.close()
    port_log.setLevel(log_level)
    path_launches = launches()
    log(json.dumps(dict(phase="3v-drills", **drills)))
    d = drills
    if not (d["score_p0.05"]["bit_equal"] and d["score_p0.05"]["degraded_batches"] > 0):
        failures.append(f"score:p0.05 drill {d['score_p0.05']}")
    if not (d["breaker"]["errors_before_open"] == 5 and d["breaker"]["state_under_faults"] == "OPEN"
            and d["breaker"]["fe_only_answers"] == 32 - 5 and d["breaker"]["fe_only_bit_equal"]
            and d["breaker"]["probe_full"] and d["breaker"]["state_after_probe"] == "CLOSED"
            and d["breaker"]["after_bit_equal"]):
        failures.append(f"breaker drill {d['breaker']}")
    if not (d["watchdog"]["trips"] > 0 and d["watchdog"]["answered_fe_only"]
            and "device_hang" in d["watchdog"]["degraded_at_trip"] and d["watchdog"]["cleared"]
            and d["watchdog"]["after_bit_equal"]):
        failures.append(f"watchdog drill {d['watchdog']}")
    if not (d["shard_loss"]["lost_answers"] > 0 and d["shard_loss"]["lost_bit_equal_to_cold_user"]
            and d["shard_loss"]["restaged_bit_equal"] and d["shard_loss"]["recaptures"] == 0):
        failures.append(f"shard-loss drill {d['shard_loss']}")
    if not (d["swap"]["answered"] > 0 and d["swap"]["failed"] == 0 and d["swap"]["mismatched"] == 0
            and d["swap"]["version"] == 1 and d["swap"]["staging_captures"] == 9
            and d["swap"]["recompiles_after_warmup"] == 0):
        failures.append(f"swap drill {d['swap']}")
    if any(path_launches.values()):
        failures.append(f"the engine path launched a kernel: {path_launches}")
    log(json.dumps(dict(phase="3v", wall_s=time.perf_counter() - t_phase, launches=path_launches,
                        offline_launches=offline_launches, ok=not failures)))
    if failures:
        raise SystemExit("phase 3v failed: " + "; ".join(failures))
    return dict(path=path_launches, offline=offline_launches)


# ---------------------------------------------------------------- phase 3v-sh

SHARD_CARDS = 4  # 3v-sh: the first min(4, count) cards, or 4 shards on card 0 of a one-card machine
SHARD_ROWS = 16_384  # 3v-sh: 3v's requests scored at each bucket of 64 and up
SHARD_SMALL_ROWS = 1_024  # and the first of them at each bucket below 64
SHARD_UNSEEN = 512  # and 3v's requests with ids no model row has


def shard_mesh(torch, n: int):
    """3v-sh's mesh of n shards: one a card over the first n cards where the
    machine has two or more, else n shards on card 0 (card identities
    0..n-1, the plan's and the orchestrator's code paths without a
    cross-card copy)."""
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(min(n, count))] if count >= 2 \
        else [torch.device("cuda", 0)] * n
    return make_mesh(devs)


def bits(a) -> np.ndarray:
    """A float32 array's bit patterns (-0.0 and 0.0 differ)."""
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def entity_shard_phase(root: str, work: str, dev) -> dict:
    """Phase 3v-sh: 3c's model with both random effects row-sharded over a
    mesh of SHARD_CARDS shards (one a card, or all on card 0), on 3v's
    requests. Offline first (its sparse launches counted apart): the
    transformer over 3g's validation file, sharded against replicated, and
    its gather's `collective` site retried once. Then, with the launch
    counts at 0: the sharded engine bit-equal to the replicated one at
    every bucket, the largest bucket's gather and replay against the
    replicated replay, the bytes on each card, a lost card restaged, a live
    reshard replicated -> 4 -> 2 -> replicated under traffic (bit-equal
    after each step, 0 failed, no recompile), and an injected
    `reshard_stage` failure rolled back. Returns the engine path's launches
    (all zero) and the offline ones."""
    import collections
    import itertools
    import logging
    import os
    import threading as _threading

    import torch

    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.game.model import GameModel, RandomEffectModel
    from photon_ml_tpu_torch.io import model_bridge, model_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
    from photon_ml_tpu_torch.parallel.mesh import put_row_sharded
    from photon_ml_tpu_torch.serving import ScoreRequest, ServingEngine, load_bundle
    from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
    from photon_ml_tpu_torch.utils import faults, telemetry

    launches, reset = serving_launches, reset_serving_launches
    best = os.path.join(root, "drivers", "train", "models", "best")
    replay_dir = os.path.join(work, "serve-requests")
    shard_configs = dict([parse_feature_shard_config(E2E_SHARD)])
    failures = []
    t_phase = time.perf_counter()
    mesh4, mesh2 = shard_mesh(torch, SHARD_CARDS), shard_mesh(torch, 2)
    cards = len(set(mesh4.devices))
    log(f"phase 3v-sh: cards {cards}, shards {mesh4.size}")

    def scores(results):
        return np.asarray([r.score for r in results], np.float32)

    # ---- offline: the transformer, sharded against replicated (counted apart) ------------
    reset()
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    imaps = {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}
    artifact = model_store.load_game_model(best, imaps)
    ds, _ = read_game_dataset(os.path.join(work, "validation"), {"g": FeatureShardConfig(("features",), True)},
                              index_maps=imaps, id_tag_fields=E2E_TAGS, device=dev)
    model, specs = model_bridge.game_model_from_artifact(artifact, dev)
    sharded = GameModel({cid: RandomEffectModel(put_row_sharded(m.coefficients_matrix, mesh4), None, m.task)
                         if isinstance(m, RandomEffectModel) else m for cid, m in model.models.items()})
    t_ref = GameTransformer(model, specs, artifact.task).transform(ds).scores.cpu().numpy()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    t_sh = GameTransformer(sharded, specs, artifact.task).transform(ds).scores.cpu().numpy()
    sharded_s = time.perf_counter() - t1
    with faults.inject("collective:1"):
        t_retry = GameTransformer(sharded, specs, artifact.task).transform(ds).scores.cpu().numpy()
    retries = faults.COUNTERS.get("collective_retries")
    offline = dict(rows=len(t_ref), bit_equal=bool((bits(t_sh) == bits(t_ref)).all()),
                   retried_bit_equal=bool((bits(t_retry) == bits(t_ref)).all()), collective_retries=retries,
                   sharded_transform_s=sharded_s, setup_s=time.perf_counter() - t0)
    del ds, model, sharded
    torch.cuda.empty_cache()
    offline_launches = launches()
    log(json.dumps(dict(phase="3v-sh-transformer", **offline, launches=offline_launches)))
    if not (offline["bit_equal"] and offline["retried_bit_equal"] and retries == 1):
        failures.append(f"the sharded transformer: {offline}")

    # ---- the engine path: launch counts at 0 ------------------------------------------------
    reset()
    telemetry.METRICS.reset()
    port_log = logging.getLogger("photon_ml_tpu_torch")
    log_level = port_log.level
    t0 = time.perf_counter()
    bundle_r = load_bundle(best, device=dev)
    eng_r = ServingEngine(bundle_r)
    reqs = list(itertools.islice(serve_cli._iter_avro_requests(
        os.path.join(replay_dir, "part-0.avro"), bundle_r, shard_configs, [0]), SHARD_ROWS))
    reqs += list(itertools.islice(serve_cli._iter_avro_requests(
        os.path.join(replay_dir, "part-1.avro"), bundle_r, shard_configs, [0]), SHARD_UNSEEN))
    eng_r.warmup()
    ref = np.concatenate([scores(eng_r.score_batch(reqs[i:i + 256])) for i in range(0, len(reqs), 256)])
    t1 = time.perf_counter()
    bundle_s = load_bundle(best, device=dev, mesh=mesh4)
    stage_s = time.perf_counter() - t1
    eng_s = ServingEngine(bundle_s)
    t1 = time.perf_counter()
    captures = eng_s.warmup()
    warm_s = time.perf_counter() - t1
    by_bucket, rows_by_bucket = {}, {}
    for b in eng_s.buckets:
        n_rows = len(reqs) if b >= 64 else SHARD_SMALL_ROWS
        got = np.concatenate([scores(eng_s.score_batch(reqs[i:i + b])) for i in range(0, n_rows, b)])
        by_bucket[b], rows_by_bucket[b] = int((bits(got) != bits(ref[:n_rows])).sum()), n_rows
    per_card = collections.Counter()
    for c in bundle_s.coordinates.values():
        for block in (c.params.blocks if c.mesh is not None else (c.params,)):
            per_card[str(block.device)] += block.numel() * block.element_size()
    prog_s, prog_r = eng_s._state.programs[256], eng_r._state.programs[256]
    timing = dict(gather_ms=time_ms(torch, prog_s.gather), replay_ms=time_ms(torch, lambda: prog_s.graph.replay()),
                  replicated_replay_ms=time_ms(torch, lambda: prog_r.graph.replay()))
    for name, eng in (("sharded", eng_s), ("replicated", eng_r)):
        eng.score_batch(reqs[:256])
        t1 = time.perf_counter()
        for i in range(20):
            eng.score_batch(reqs[256 * i:256 * (i + 1)])
        timing[f"{name}_batch_256_host_ms"] = (time.perf_counter() - t1) / 20 * 1e3
    sharding = eng_s.metrics()["sharding"]
    log(json.dumps(dict(phase="3v-sh-parity", cards=cards, shards=mesh4.size, rows=len(reqs),
                        rows_checked=rows_by_bucket, rows_differing_by_bucket=by_bucket, captures=captures,
                        stage_s=stage_s, warmup_s=warm_s, recompiles_after_warmup=eng_s.recompiles_after_warmup,
                        sharding=sharding, device_bytes_by_card=dict(per_card),
                        device_bytes_per_shard=bundle_s.device_bytes_per_shard(),
                        device_bytes_replicated=bundle_r.device_bytes(), bucket_256=timing)))
    if any(by_bucket.values()) or captures != 9 or eng_s.recompiles_after_warmup != 0 \
            or not sharding["entity_sharded"] or sharding["axis_size"] != SHARD_CARDS:
        failures.append(f"the sharded engine is not the replicated bits at every bucket: {by_bucket}")

    # ---- a lost card: exactly its entities FE-only, then restaged -----------------------------
    sub = reqs[:4096]
    coord = eng_s.bundle.coordinates["per-user"]
    host_rows = coord.params.blocks[1].cpu().numpy().copy()
    compiles0 = eng_s.compiles
    lo, hi = eng_s.mark_shard_lost("per-user", 1)
    lost = [r for i in range(0, len(sub), 256) for r in eng_s.score_batch(sub[i:i + 256])]
    cold = [ScoreRequest(features=r.features, entity_ids={**r.entity_ids, "userId": "-1"}, offset=r.offset)
            for r in sub]
    cold_ref = np.concatenate([scores(eng_r.score_batch(cold[i:i + 256])) for i in range(0, len(cold), 256)])
    rows, _ = coord.lookup_rows([r.entity_ids.get("userId") for r in sub])
    mask = (rows >= lo) & (rows < hi) & (rows != coord.unseen_row)
    with eng_s._device_mutex:
        coord.params.blocks[1].zero_()  # the card's rows are gone
    t1 = time.perf_counter()
    nbytes = eng_s.restage_shard("per-user", 1, rows=host_rows)
    restage_s = time.perf_counter() - t1
    back = np.concatenate([scores(eng_s.score_batch(sub[i:i + 256])) for i in range(0, len(sub), 256)])
    loss = dict(card=str(coord.mesh.devices[1]), rows=[lo, hi], lost_answers=sum(r.n_lost for r in lost),
                lost_requests=int(mask.sum()),
                lost_bit_equal=bool((bits(scores(lost)) == bits(np.where(mask, cold_ref, ref[:len(sub)]))).all()),
                restaged_bytes=nbytes, restage_s=restage_s,
                restaged_bit_equal=bool((bits(back) == bits(ref[:len(sub)])).all()),
                recaptures=eng_s.compiles - compiles0, health=eng_s.health.state.value)
    eng_s.close()
    bundle_s.release()
    del bundle_s, eng_s, coord
    torch.cuda.empty_cache()

    # ---- live reshard under traffic: replicated -> 4 -> 2 -> replicated -----------------------
    probe = reqs[:4096]
    stop = _threading.Event()
    traffic = dict(answered=0, failed=0, mismatched=0)
    steps = []
    with eng_r.batcher() as b:
        def flow():
            i = 0
            while not stop.is_set():
                k = i % 1024
                try:
                    r = b.submit(reqs[k], block=True).result(timeout=60)
                    traffic["answered"] += 1
                    traffic["mismatched"] += int(bits(np.float32(r.score)) != bits(ref[k]))
                except Exception:  # counted: the drill wants none
                    traffic["failed"] += 1
                i += 1

        t = _threading.Thread(target=flow, name="chip-smoke-shard-traffic")
        t.start()
        try:
            for name, target in ((str(SHARD_CARDS), mesh4), ("2", mesh2), ("replicated", None)):
                time.sleep(0.1)
                answered0 = traffic["answered"]
                info = eng_r.reshard_orchestrator.reshard(target)
                got = np.concatenate([scores(eng_r.score_batch(probe[i:i + 256]))
                                      for i in range(0, len(probe), 256)])
                steps.append(dict(to=name, old_shards=info["old_shards"], new_shards=info["new_shards"],
                                  moved_rows=info["moved_rows"], moved_bytes=info["moved_bytes"],
                                  stage_s=info["stage_s"], upload_s=info["upload_s"],
                                  prewarm_s=info["prewarm_s"], prewarm_captures=info["staging_compiles"],
                                  answered_during=traffic["answered"] - answered0, version=info["version"],
                                  bit_equal=bool((bits(got) == bits(ref[:len(probe)])).all()),
                                  recompiles_after_warmup=eng_r.recompiles_after_warmup))
            time.sleep(0.1)
        finally:
            stop.set()
            t.join(timeout=120)
    log(json.dumps(dict(phase="3v-sh-reshard", steps=steps, traffic=traffic)))
    if traffic["failed"] or traffic["mismatched"] or not traffic["answered"] or len(steps) != 3 or not all(
            s["bit_equal"] and s["prewarm_captures"] == 9 and s["recompiles_after_warmup"] == 0 for s in steps):
        failures.append(f"the live reshard: {steps}, {traffic}")

    # ---- an injected reshard_stage failure rolls back -------------------------------------------
    port_log.setLevel(logging.ERROR)  # each injected fault and retry logs a warning
    try:
        version0 = eng_r.bundle_version
        with faults.inject("reshard_stage:9999"):
            try:
                eng_r.reshard_orchestrator.reshard(mesh4)
                rolled_back = False
            except faults.InjectedFault:
                rolled_back = True
            during = np.concatenate([scores(eng_r.score_batch(probe[i:i + 256]))
                                     for i in range(0, 1024, 256)])
    finally:
        port_log.setLevel(log_level)
    rollback = dict(rolled_back=rolled_back, version_kept=eng_r.bundle_version == version0,
                    bit_equal=bool((bits(during) == bits(ref[:1024])).all()),
                    reshard_rollbacks=faults.COUNTERS.get("reshard_rollbacks"),
                    reshard_retries=faults.COUNTERS.get("reshard_retries"),
                    metrics_rollbacks=eng_r.metrics()["bundle_reshard_rollbacks"])
    eng_r.close()
    bundle_r.release()
    path_launches = launches()
    log(json.dumps(dict(phase="3v-sh-drills", shard_loss=loss, reshard_stage_fault=rollback)))
    if not (loss["lost_answers"] == loss["lost_requests"] > 0 and loss["lost_bit_equal"]
            and loss["restaged_bit_equal"] and loss["recaptures"] == 0 and loss["health"] == "READY"):
        failures.append(f"the lost card: {loss}")
    if not (rollback["rolled_back"] and rollback["version_kept"] and rollback["bit_equal"]
            and rollback["reshard_rollbacks"] == 1 and rollback["metrics_rollbacks"] == 1):
        failures.append(f"the reshard_stage rollback: {rollback}")
    if any(path_launches.values()):
        failures.append(f"the engine path launched a kernel: {path_launches}")
    log(json.dumps(dict(phase="3v-sh", cards=cards, shards=mesh4.size, wall_s=time.perf_counter() - t_phase,
                        launches=path_launches, offline_launches=offline_launches, card=card_line(),
                        ok=not failures)))
    if failures:
        raise SystemExit("phase 3v-sh failed: " + "; ".join(failures))
    return dict(path=path_launches, offline=offline_launches)


# ---------------------------------------------------------------- phases 3q and 3mv

Q_BLOCK = 2  # 3q: the block of 3e's part-0.avro it breaks
MHV_HOSTS = 2  # 3mv: cli.serve --multihost 2, both workers on the card
MHV_BLOCKS = 4  # its --multihost-devices-per-host (the flag's default): row blocks a matrix
MHV_KILLED = 1  # the worker each drill SIGKILLs once its first window is durable
# 3mv's requests: the first 4 blocks of 3v's part-0.avro (16,384 of its
# 25,000 rows, 2 windows) and all of its part-1.avro (the 1,000 unseen
# ids). Cut from 3v's stream for the script's time limit (the whole 101,000
# took 3mv 128.8 s on the card; cut from 12 blocks for 3n's time).
MHV_SEEN_BLOCKS = 4


def copy_blocks(src: str, dst: str, n_blocks: int) -> int:
    """The header and the first `n_blocks` blocks of Avro file `src`,
    copied byte for byte to `dst` (a valid container). Returns the rows."""
    from photon_ml_tpu_torch.io import avro as avro_io

    with open(src, "rb") as f:
        data = f.read()
    _, _, _, pos = avro_io.read_header(data, src)
    dec = avro_io.BinaryDecoder(data, pos)
    rows = 0
    for _ in range(n_blocks):
        rows += dec.read_long()
        size = dec.read_long()
        dec.pos += size + avro_io.SYNC_SIZE
    with open(dst, "wb") as f:
        f.write(data[:dec.pos])
    return rows


def serving_launches() -> dict:
    """The six kernels' launch counts in this process, as 3v reads them."""
    from photon_ml_tpu_torch.cli import serve_multihost as smh

    return smh.kernel_launches()


def reset_serving_launches() -> None:
    from photon_ml_tpu_torch.cli import serve_multihost as smh

    smh.reset_kernel_launches()


def quarantine_phase(root: str, work: str, dev) -> dict:
    """Phase 3q: a copy of 3e's part-0.avro with block Q_BLOCK broken (a
    deflate block of the reserved type, or a null-codec block whose records
    run off its end) read onto the card through the native route, against a
    read of the clean file: the clean rows less that block's, the same ELL
    planes and tags, `quarantined_blocks` 1. Returns the launches (none)."""
    import os

    import torch

    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
    from photon_ml_tpu_torch.utils import faults, telemetry

    src = os.path.join(root, "part-0.avro")
    qdir = os.path.join(work, "quarantine")
    os.makedirs(qdir)
    dst = os.path.join(qdir, "part-0.avro")
    t0 = time.perf_counter()
    with open(src, "rb") as f:
        data = bytearray(f.read())
    _, codec, _, pos = avro_io.read_header(bytes(data), src)
    dec = avro_io.BinaryDecoder(data, pos)
    first = 0
    for _ in range(Q_BLOCK):
        first += dec.read_long()
        size = dec.read_long()
        dec.pos += size + avro_io.SYNC_SIZE
    count, size = dec.read_long(), dec.read_long()
    if codec == "deflate":
        data[dec.pos] = 0x07
    else:
        data[dec.pos + size - 40:dec.pos + size] = b"\xff" * 40
    with open(dst, "wb") as f:
        f.write(bytes(data))
    del data
    write_s = time.perf_counter() - t0

    shards = {"g": FeatureShardConfig(("features",), True)}
    reset_serving_launches()
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    clean, _ = read_game_dataset(src, shards, id_tag_fields=E2E_TAGS, device=dev)
    clean_s = time.perf_counter() - t0
    clean_q = faults.COUNTERS.get("quarantined_blocks")
    t0 = time.perf_counter()
    got, _ = read_game_dataset(dst, shards, id_tag_fields=E2E_TAGS, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    got_s = time.perf_counter() - t0
    quarantined = faults.COUNTERS.get("quarantined_blocks") - clean_q
    launches = serving_launches()
    keep = np.ones(clean.num_samples, bool)
    keep[first:first + count] = False
    keep_t = torch.from_numpy(keep).to(dev)
    same = dict(
        labels=bool(torch.equal(got.labels, clean.labels[keep_t])),
        weights=bool(torch.equal(got.weights, clean.weights[keep_t])),
        indices=bool(torch.equal(got.shards["g"].indices, clean.shards["g"].indices[keep_t])),
        values=bool(torch.equal(got.shards["g"].values, clean.shards["g"].values[keep_t])),
        tags=all(bool((np.asarray(got.id_tags[t]) == np.asarray(clean.id_tags[t])[keep]).all())
                 for t in E2E_TAGS))
    row = dict(phase="3q", file_rows=clean.num_samples, codec=codec, broken_block=Q_BLOCK,
               block_rows=count, rows=got.num_samples, quarantined_blocks=quarantined,
               clean_quarantined_blocks=clean_q, ingest_path=got.ingest_timing["ingest_path"],
               write_s=write_s, clean_read_s=clean_s, read_s=got_s, same_as_clean_less_block=same,
               launches=launches)
    log(json.dumps(row))
    if (quarantined != 1 or clean_q != 0 or got.num_samples != clean.num_samples - count
            or not all(same.values()) or not str(row["ingest_path"]).startswith("native")
            or any(launches.values())):
        raise SystemExit(f"phase 3q failed: {row}")
    return launches


def windows_of(results, window: int) -> dict:
    """(stream position, ScoreResult) pairs -> a worker's part lines, by window."""
    out: dict = {}
    for i, r in results:
        out.setdefault(i // window, []).append(dict(i=i, score=r.score, n_lost=int(r.n_lost),
                                                    n_cold=int(r.n_cold), cold=bool(r.cold_start)))
    return out


def merged_answers(per_host: dict) -> dict:
    """Every window's answer of each stream position, by serve_multihost's rule."""
    from photon_ml_tpu_torch.cli import serve_multihost as smh

    best = {}
    for k in sorted({k for w in per_host.values() for k in w}):
        best.update(smh.best_answers(per_host, k))
    return best


def serve_multihost_phase(root: str, work: str, dev) -> dict:
    """Phase 3mv: `cli.serve --multihost 2` (4 row blocks a matrix) on 3c's
    model and 17,384 of 3v's requests (MHV_SEEN_BLOCKS), both workers
    sharing the card:
    uninterrupted, with worker 1 SIGKILLed once its first window is durable
    and no retry budget, and the same kill with a budget of one (worker 1
    rejoins from its progress marker through `host_join`). Gates: no failed
    request in any run; every merged answer with no lost row bit-equal to
    3v's single-process scores; the uninterrupted and the drill's merged
    output bit-equal to an in-process emulation on the card (two engines
    over bundles marked host-local for hosts 0 and 1, merged by the same
    rule; the drill's host 1 limited to the windows it wrote); the rejoin's
    scores the uninterrupted ones; one `host_loss` line a drill and
    `host_join` once, in the rejoin. The path's launches are the workers'
    (each counts from its start, in its progress marker and summary; the
    supervisor runs none), summed over every attempt of the three runs;
    the emulation's are this process's. Returns both ("workers",
    "emulation"): none, the serving path runs no kernel."""
    import os
    import shutil
    import signal

    import torch

    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.cli import serve_multihost as smh
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.io import score_store
    from photon_ml_tpu_torch.serving import ServingEngine, load_bundle
    from photon_ml_tpu_torch.utils import telemetry
    from photon_ml_tpu_torch.utils.knobs import get_knob, knob_is_set

    best = os.path.join(root, "drivers", "train", "models", "best")
    replay_dir = os.path.join(work, "serve-mh-requests")
    os.makedirs(replay_dir)
    seen = copy_blocks(os.path.join(work, "serve-requests", "part-0.avro"),
                       os.path.join(replay_dir, "part-0.avro"), MHV_SEEN_BLOCKS)
    shutil.copyfile(os.path.join(work, "serve-requests", "part-1.avro"), os.path.join(replay_dir, "part-1.avro"))
    single = score_store.load_score_columns(os.path.join(work, "serve", "scores"))
    by_3v = dict(zip((int(u) for u in single.uids), single.scores.tolist()))
    # 3v's score of each request of this stream, by stream position.
    ref = {i: by_3v[i] for i in range(seen)}
    ref.update({seen + j: by_3v[SERVE_REPLAY_ROWS + j] for j in range(SERVE_UNSEEN)})
    n_req = len(ref)
    card = card_line() if dev.type == "cuda" else "cpu"
    failures = []
    t_phase = time.perf_counter()
    reset_serving_launches()
    telemetry.METRICS.reset()

    def journal(path):
        try:
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        except OSError:
            return []

    def run(name: str, retries: int, kill: bool) -> dict:
        out = os.path.join(work, f"serve-mh-{name}")
        argv = serve_args(best, replay_dir, out, "--multihost", str(MHV_HOSTS),
                          "--multihost-devices-per-host", str(MHV_BLOCKS),
                          *(["--device", "cpu"] if dev.type == "cpu" else []))
        before = str(get_knob("PHOTON_HOST_LOSS_RETRIES")) if knob_is_set("PHOTON_HOST_LOSS_RETRIES") else None
        os.environ["PHOTON_HOST_LOSS_RETRIES"] = str(retries)
        done, errors = [], []

        def supervise():
            try:
                done.append(serve_cli.main(argv))
            except BaseException as exc:  # re-raised below
                errors.append(exc)

        sup = threading.Thread(target=supervise, name="mhv-supervisor")
        killed_at = None
        t0 = time.perf_counter()
        try:
            sup.start()
            host_dir = os.path.join(out, "hosts", f"attempt0-host{MHV_KILLED}")
            while kill and sup.is_alive():
                if os.path.exists(os.path.join(host_dir, "progress")):
                    with open(os.path.join(host_dir, "pid")) as f:
                        os.kill(int(f.read()), signal.SIGKILL)
                    killed_at = time.time()
                    break
                time.sleep(0.002)
            sup.join()
        finally:
            if before is None:
                os.environ.pop("PHOTON_HOST_LOSS_RETRIES", None)
            else:
                os.environ["PHOTON_HOST_LOSS_RETRIES"] = before
        wall = time.perf_counter() - t0
        if errors:
            raise SystemExit(f"phase 3mv: the {name} run's supervisor failed: {errors[0]!r}")
        if kill and killed_at is None:
            raise SystemExit(f"phase 3mv: the {name} run ended before worker {MHV_KILLED} could be killed")
        summary = done[0]
        mh = summary["multihost"]
        per_host = {h: smh._collect_parts(out, h, mh["attempts"][str(h)] - 1) for h in range(MHV_HOSTS)}
        answers = merged_answers(per_host)
        cols = score_store.load_score_columns(os.path.join(out, "scores"))
        scores = dict(zip((int(u) for u in cols.uids), cols.scores.tolist()))
        workers = []
        # Each attempt's launches: its summary's, or, for a killed worker,
        # those of its last progress marker (None if it wrote neither).
        launches = {}
        for entry in mh["attempt_log"]:
            host_dir = smh._host_dir(out, entry["attempt"], entry["host"])
            path = os.path.join(host_dir, "worker-summary.json")
            key = f"attempt{entry['attempt']}-host{entry['host']}"
            if not os.path.exists(path):
                marker = os.path.join(host_dir, "progress")
                if os.path.exists(marker):
                    with open(marker) as f:
                        launches[key] = json.load(f)["launches"]
                else:
                    launches[key] = None
                continue
            with open(path) as f:
                w = json.load(f)
            launches[key] = w["launches"]
            workers.append(dict(host=w["host"], attempt=w["attempt"], device=w["device"], **w["timings_s"],
                                p50_ms=w["serving"]["p50_ms"], p99_ms=w["serving"]["p99_ms"],
                                qps=w["serving"]["qps"], owned_rows=w["owned_rows"],
                                owned_shards=w["owned_shards"],
                                first_window_s=w["first_window_at"] - entry["started_at"]))
        killed = [e for e in mh["attempt_log"] if e["host"] == MHV_KILLED and e["attempt"] == 0]
        rejoined = [e for e in mh["attempt_log"] if e["host"] == MHV_KILLED and e["attempt"] == 1]
        events = journal(os.path.join(out, "journal.jsonl"))
        joins = sum(e["type"] == "host_join" for p in range(1, 3)
                    for e in journal(os.path.join(smh._host_dir(out, p, MHV_KILLED), "journal.jsonl")))
        kept = [i for i, a in answers.items() if a["n_lost"] == 0]
        return dict(
            name=name, out=out, summary=summary, per_host=per_host, answers=answers, scores=scores,
            launches=launches,
            row=dict(
                phase="3mv", run=name, retries=retries, wall_s=wall, num_requests=summary["num_requests"],
                failed_requests=summary["failed_requests"], fe_only_answers=mh["fe_only_answers"],
                degraded_cold_answers=mh["degraded_cold_answers"], no_loss_share=len(kept) / max(1, len(answers)),
                host_losses=mh["host_losses"], rejoins=mh["rejoins"], attempts=mh["attempts"],
                survivor_hosts=mh["survivor_hosts"], owned_rows=mh["owned_rows"],
                killed_after_windows=len(per_host[MHV_KILLED]) if kill and not rejoined else None,
                kill_to_exit_s=(killed[0]["ended_at"] - killed_at) if kill and killed else None,
                relaunch_to_first_window_s=next((w["first_window_s"] for w in workers
                                                 if w["host"] == MHV_KILLED and w["attempt"] == 1), None),
                relaunch_resume_window=rejoined[0]["resume_window"] if rejoined else None,
                host_loss_lines=sum(e["type"] == "host_loss" for e in events), host_join_lines=joins,
                merged_equals_best_answers=all(scores.get(i) == float(a["score"]) for i, a in answers.items())
                and len(scores) == len(answers),
                no_loss_answers_differing_from_3v=sum(scores[i] != ref[i] for i in kept),
                workers=workers, worker_launches=launches, card=card))

    runs = {name: run(name, retries, kill) for name, retries, kill in
            (("uninterrupted", 0, False), ("kill", 0, True), ("rejoin", 1, True))}

    # ---- the in-process emulation on the card ----------------------------------------------
    t0 = time.perf_counter()
    shard_configs = dict([parse_feature_shard_config(E2E_SHARD)])
    emulated = {}
    for host in range(MHV_HOSTS):
        bundle = load_bundle(best, device=dev, row_blocks=MHV_BLOCKS)
        smh._mark_host_local(bundle, host, MHV_HOSTS)
        if host == 0:
            reqs = list(serve_cli._iter_avro_requests(replay_dir, bundle, shard_configs, [0]))
        with ServingEngine(bundle) as engine:
            engine.warmup()
            results = []
            for lo in range(0, len(reqs), engine.max_batch):
                results.extend(enumerate(engine.score_batch(reqs[lo:lo + engine.max_batch]), lo))
        emulated[host] = windows_of(results, serve_cli.REPLAY_WINDOW)
        bundle.release()
    emulation_s = time.perf_counter() - t0
    whole = merged_answers(emulated)
    drill_windows = set(runs["kill"]["per_host"][MHV_KILLED])
    partial = merged_answers({0: emulated[0], MHV_KILLED: {k: v for k, v in emulated[MHV_KILLED].items()
                                                         if k in drill_windows}})

    def differing(run_, want):
        got = run_["answers"]
        return sum(i not in got or got[i]["score"] != a["score"] or got[i]["n_lost"] != a["n_lost"]
                   for i, a in want.items()) + len(set(got) - set(want))

    emulation_launches = serving_launches()
    unread = [f"{name} {key}" for name, r in runs.items() for key, ln in r["launches"].items() if ln is None]
    path_launches = {k: sum(ln[k] for r in runs.values() for ln in r["launches"].values() if ln is not None)
                     for k in emulation_launches}
    emulation = dict(phase="3mv-emulation", requests=len(reqs), emulation_s=emulation_s,
                     uninterrupted_answers_differing=differing(runs["uninterrupted"], whole),
                     kill_answers_differing=differing(runs["kill"], partial),
                     rejoin_scores_differing_from_uninterrupted=sum(
                         runs["rejoin"]["scores"][i] != s for i, s in runs["uninterrupted"]["scores"].items()),
                     no_loss_share_emulated=sum(a["n_lost"] == 0 for a in whole.values()) / len(whole),
                     launches=emulation_launches, card=card)
    for r in runs.values():
        log(json.dumps(r["row"]))
    log(json.dumps(emulation))

    for name, r in runs.items():
        row = r["row"]
        if (row["failed_requests"] or row["num_requests"] != n_req or not row["merged_equals_best_answers"]
                or row["no_loss_answers_differing_from_3v"]):
            failures.append(f"{name}: {row['failed_requests']} failed of {row['num_requests']}, merged = best "
                            f"{row['merged_equals_best_answers']}, {row['no_loss_answers_differing_from_3v']} "
                            "no-loss answers differ from 3v")
    u, k, j = (runs[n]["row"] for n in ("uninterrupted", "kill", "rejoin"))
    if (u["host_losses"], u["host_loss_lines"], u["survivor_hosts"]) != (0, 0, MHV_HOSTS):
        failures.append(f"uninterrupted: {u['host_losses']} losses, {u['survivor_hosts']} survivors")
    if (k["host_losses"], k["host_loss_lines"], k["host_join_lines"], k["survivor_hosts"], k["rejoins"]) \
            != (1, 1, 0, MHV_HOSTS - 1, 0) or not k["fe_only_answers"] > u["fe_only_answers"]:
        failures.append(f"kill drill: {k['host_losses']} losses, {k['host_loss_lines']} host_loss lines, "
                        f"{k['host_join_lines']} host_join, FE-only {k['fe_only_answers']}")
    if (j["host_losses"], j["host_loss_lines"], j["host_join_lines"], j["survivor_hosts"], j["rejoins"]) \
            != (1, 1, 1, MHV_HOSTS, 1):
        failures.append(f"rejoin drill: {j['host_losses']} losses, {j['host_loss_lines']} host_loss lines, "
                        f"{j['host_join_lines']} host_join, {j['survivor_hosts']} survivors")
    if emulation["uninterrupted_answers_differing"] or emulation["kill_answers_differing"] \
            or emulation["rejoin_scores_differing_from_uninterrupted"]:
        failures.append(f"against the emulation: {emulation}")
    if unread:
        failures.append(f"no launch count from worker attempt(s) {unread}")
    if any(path_launches.values()) or any(emulation_launches.values()):
        failures.append(f"the serving path launched a kernel: workers {path_launches}, "
                        f"emulation {emulation_launches}")
    log(json.dumps(dict(phase="3mv", wall_s=time.perf_counter() - t_phase, worker_launches=path_launches,
                        ok=not failures)))
    if failures:
        raise SystemExit("phase 3mv failed: " + "; ".join(failures))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"workers": path_launches, "emulation": emulation_launches}


# ---------------------------------------------------------------- phase 3n
# Multi-tenant serving and shadow deployment on 3c's model directory (the
# e2e model: FE over "g", per-user 27,586 and per-movie 5,405 rows, 201
# wide) with 3v's request stream as the traffic.

TEN_ROWS = 2_048  # 3n, 3n-ladder: requests of 3v's part-0.avro a tenant (half its first block: cut from 4,096 for 3n-ladder's time)
TEN_UNSEEN = 256  # and of its part-1.avro (ids no model row has)
TEN_VARIANTS = 3  # 3c's model with its coefficients scaled by a seeded draw, written by the model store
TEN_HOT_ROWS = 2_048  # the demoted tenant's hot rows a random effect (of 27,586 and 5,405)
TEN_SHADOW_ROWS = 1_024  # requests a shadow drill mirrors
TEN_SHADOW_WINDOW = 128  # joined rows a shadow window (PHOTON_SHADOW_MIN_WINDOWS, 3, agree for a verdict)
TEN_CLI_BLOCKS = 2  # cli.serve --tenant x3: the first 8,192 of 3v's requests
TEN_CLI_SHADOW_ROWS = 2_048  # cli.serve --shadow --labels: JSON lines


def tenant_variant_dirs(best: str, work: str, seed: int) -> list:
    """TEN_VARIANTS model directories: 3c's artifact with every coefficient
    scaled by (1 + 0.05 N(0, 1)) from a seeded draw, written by the port's
    model store beside a copy of 3c's feature indexes."""
    import os
    import shutil

    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store

    imaps = {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}
    art = model_store.load_game_model(best, imaps)
    dirs = []
    for k in range(TEN_VARIANTS):
        rng = np.random.default_rng(seed + k)
        coords = {cid: dataclasses.replace(c, means=(c.means * (1.0 + 0.05 * rng.standard_normal(c.means.shape)))
                                           .astype(np.float32))
                  for cid, c in art.coordinates.items()}
        out = os.path.join(work, "tenants", f"v{k}")
        model_store.save_game_model(out, model_store.GameModelArtifact(art.task, coords, art.opt_configs), imaps)
        shutil.copytree(os.path.join(best, "feature-indexes"), os.path.join(out, "feature-indexes"))
        dirs.append(out)
    return dirs


def tenancy_phase(root: str, work: str, dev) -> dict:
    """Phase 3n: four tenants of one co-batch signature (3c's model and
    TEN_VARIANTS variants) and a fifth outside it (3c's model demoted to the
    two-tier store, which answers solo) on one TenantRegistry. Gates, each
    on the card: co-batched answers bit-equal to each tenant's solo engine
    with co-batches dispatched; chaos armed for one tenant (lookup and score
    faults through its gate, a flood past its quota) leaving the clean
    tenants with no failed request, no degraded labelled counter and their
    bits; an admission over `hbm_budget_bytes` demoting the coldest tenant
    to the host tier (no hot rows) which answers bit-equal, and again after
    `restore`, then bit-equal while promotions run once it is demoted by
    hand with TEN_HOT_ROWS hot rows, and after a second `restore`; a member's swap mid-stream
    bit-equal to solo serving of each generation with no capture after
    warm-up. Shadow: a degraded challenger rejected, the champion's
    weights promoted through the generation flip, mirror and join faults
    counted as champion-only serving; the champion never fails a request
    and keeps its bits. Then `cli.serve --tenant` x3, `cli.serve --shadow
    --labels` and one `cli.refresh --shadow-gate` round at 3r-loop's shape.
    The serving path's launches are counted from 0 and must all be 0; the
    refresh round's training launches are counted apart. Returns both."""
    import contextlib
    import itertools
    import logging
    import os
    import threading as _threading

    import torch

    from photon_ml_tpu_torch.cli import refresh as refresh_cli
    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.contracts import (
        ROBUSTNESS_CLEAN_ZERO_KEYS,
        SERVING_SUMMARY_KEYS,
        SHADOW_BLOCK_KEYS,
        TENANT_BLOCK_KEYS,
        TENANT_CLEAN_ZERO_KEYS,
    )
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import model_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig
    from photon_ml_tpu_torch.serving import (
        Overloaded,
        ServingBundle,
        ServingEngine,
        ShadowController,
        TenantRegistry,
        demote_bundle_to_host_tier,
        load_bundle,
        request_from_record,
    )
    from photon_ml_tpu_torch.utils import faults, telemetry

    best = os.path.join(root, "drivers", "train", "models", "best")
    shards = {"g": FeatureShardConfig(("features",), True)}
    replay_dir = os.path.join(work, "serve-requests")
    card = card_line() if dev.type == "cuda" else "cpu"
    failures = []
    t_phase = time.perf_counter()
    port_log = logging.getLogger("photon_ml_tpu_torch")
    log_level = port_log.level
    port_log.setLevel(logging.ERROR)  # each injected fault and retry logs a warning

    # ---- set-up: the variants, the bundles, the requests ------------------------------
    t0 = time.perf_counter()
    variant_dirs = tenant_variant_dirs(best, work, seed=83)
    write_s = time.perf_counter() - t0
    recs = list(itertools.islice(avro_io.iter_container(os.path.join(replay_dir, "part-0.avro")), TEN_ROWS))
    recs += list(itertools.islice(avro_io.iter_container(os.path.join(replay_dir, "part-1.avro")), TEN_UNSEEN))
    recs = [r for _, r in recs]
    labels = np.asarray([float(r["label"]) for r in recs], np.float32)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_serving_launches()  # the serving path starts here
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    names = ["base"] + [f"v{k}" for k in range(TEN_VARIANTS)]
    bundles = {"base": load_bundle(best, device=dev)}
    for k, d in enumerate(variant_dirs):
        bundles[f"v{k}"] = load_bundle(d, device=dev)
    load_s = time.perf_counter() - t0
    reqs = [request_from_record(bundles["base"], r, shards) for r in recs]
    for i, r in enumerate(reqs):
        r.uid = str(i)
    tenant_bytes = bundles["base"].device_bytes()

    def solo(bundle, batch=256):
        with ServingEngine(bundle) as eng:
            return np.concatenate([np.asarray([x.score for x in eng.score_batch(reqs[i:i + batch])], np.float32)
                                   for i in range(0, len(reqs), batch)])

    t0 = time.perf_counter()
    ref = {n: solo(bundles[n]) for n in names}
    ref_s = time.perf_counter() - t0

    def view(b):
        """A bundle sharing `b`'s device planes: a registry may release it
        (a demotion, a promotion) while `b` serves on."""
        return dataclasses.replace(b, coordinates=dict(b.coordinates), provenance=dict(b.provenance))

    def replay(reg, tenants, idx=None):
        idx = range(len(reqs)) if idx is None else idx
        futs = [(n, i, reg.submit(n, reqs[i], block=True)) for i in idx for n in tenants]
        out = {n: np.zeros(len(reqs), np.float32) for n in tenants}
        failed = 0
        for n, i, f in futs:
            try:
                out[n][i] = f.result(timeout=120).score
            except Exception:  # counted: the gates want none
                failed += 1
        return out, failed

    # ---- co-batched answers against solo engines ----------------------------------------
    reg = TenantRegistry()
    t0 = time.perf_counter()
    for n in names:
        reg.admit(n, view(bundles[n]))  # the swap below releases v0's
    tiered = demote_bundle_to_host_tier(bundles["base"], hot_rows=TEN_HOT_ROWS)
    reg.admit("tiered", tiered)
    admit_s = time.perf_counter() - t0
    warm_captures = reg.metrics()["cobatch_compiles"]
    t0 = time.perf_counter()
    got, failed = replay(reg, names + ["tiered"])
    cobatch_wall = time.perf_counter() - t0
    m = reg.metrics()
    bits = {n: bool((got[n] == ref[n]).all()) for n in names}
    bits["tiered"] = bool((got["tiered"] == ref["base"]).all())
    group = next(k for k in reg._programs if len(k[1]) == len(names) and k[2] == 256)
    co_prog = reg._programs[group]
    solo_prog = reg.tenant("base").engine._state.programs
    co_ms = time_ms(torch, lambda: co_prog.graph.replay())
    solo_ms = {b: time_ms(torch, lambda b=b: solo_prog[b].graph.replay()) for b in (64, 256)}
    tiered_m = reg.tenant("tiered").batcher.metrics()
    n_co = sum(m["tenants"][n]["cobatched_requests"] for n in names)
    row = dict(phase="3n-cobatch", tenants=len(names) + 1, requests_a_tenant=len(reqs), failed=failed,
               bit_equal_to_solo=bits, cobatch_dispatches=m["cobatch_dispatches"], cobatched_requests=n_co,
               replays_a_request_cobatched=m["cobatch_dispatches"] / max(1, n_co),
               replays_a_request_solo=tiered_m["batches"] / max(1, tiered_m["completed"]),
               cobatch_graph_ms_4x256=co_ms, solo_graph_ms={str(b): v for b, v in solo_ms.items()},
               replay_wall_s=cobatch_wall, requests_a_s=(len(names) + 1) * len(reqs) / cobatch_wall,
               captures=warm_captures, captures_after_warmup=m["cobatch_compiles_after_warmup"],
               admit_s=admit_s, load_s=load_s, variants_write_s=write_s, solo_refs_s=ref_s,
               tenant_device_mib=tenant_bytes / 2**20, tiered_device_mib=tiered.device_bytes() / 2**20,
               tiered_hot_hits=tiered_m["hot_tier_hits"], tiered_cold_hits=tiered_m["cold_tier_hits"],
               tiered_promotions=tiered_m["promotions"], card=card)
    log(json.dumps(row))
    if failed or not all(bits.values()) or m["cobatch_dispatches"] == 0 or m["cobatch_compiles_after_warmup"]:
        failures.append(f"co-batch gate: {row}")

    # ---- a member's swap mid-stream ------------------------------------------------------
    stop = _threading.Event()
    seen = dict(answered=0, failed=0, old=0, new=0, neither=0)
    new_ref = ref["v2"]

    def traffic():
        i = 0
        while not stop.is_set():
            k = i % len(reqs)
            try:
                s = np.float32(reg.submit("v0", reqs[k], block=True).result(timeout=120).score)
                seen["answered"] += 1
                seen["old" if s == ref["v0"][k] else "new" if s == new_ref[k] else "neither"] += 1
            except Exception:  # counted: the gate wants none
                seen["failed"] += 1
            i += 1

    t = _threading.Thread(target=traffic, name="chip-smoke-tenancy-traffic")
    t.start()
    try:
        time.sleep(0.2)
        t0 = time.perf_counter()
        info = reg.tenant("v0").engine.bundle_manager.swap(view(bundles["v2"]))
        swap_s = time.perf_counter() - t0
        time.sleep(0.2)
    finally:
        stop.set()
        t.join(timeout=300)
    after, failed_after = replay(reg, ["v0", "base"], idx=range(1024))
    m = reg.metrics()
    row = dict(phase="3n-swap", **seen, swap_s=swap_s, version=info["version"],
               staging_captures=info["staging_compiles"], failed_after=failed_after,
               after_bit_equal_to_new=bool((after["v0"][:1024] == new_ref[:1024]).all()),
               base_bit_equal=bool((after["base"][:1024] == ref["base"][:1024]).all()),
               captures=m["cobatch_compiles"], captures_after_warmup=m["cobatch_compiles_after_warmup"],
               engine_recompiles_after_warmup={n: reg.tenant(n).engine.recompiles_after_warmup
                                               for n in reg.tenant_names})
    log(json.dumps(row))
    if seen["failed"] or seen["neither"] or not seen["answered"] or failed_after \
            or not row["after_bit_equal_to_new"] or not row["base_bit_equal"] \
            or m["cobatch_compiles_after_warmup"] or any(row["engine_recompiles_after_warmup"].values()):
        failures.append(f"swap gate: {row}")
    reg.close()
    tiered.release()

    # ---- chaos confined to one tenant ------------------------------------------------------
    telemetry.METRICS.reset()
    reg = TenantRegistry()
    reg.admit("noisy", bundles["base"], max_pending=8)
    reg.admit("clean0", bundles["v0"], inject_faults=False)
    reg.admit("clean1", bundles["v1"], inject_faults=False)
    noisy = {"submitted": 0, "shed_at_submit": 0, "answered": 0, "failed": 0}
    with faults.inject("lookup:p0.3,score:p0.3", seed=5):
        futs = []
        for i in range(2048):
            for n in ("clean0", "clean1"):
                futs.append((n, i, reg.submit(n, reqs[i], block=True)))
            try:
                noisy_f = reg.submit("noisy", reqs[i])
                noisy["submitted"] += 1
                futs.append(("noisy", i, noisy_f))
            except Overloaded:
                noisy["shed_at_submit"] += 1
        clean_bits, clean_failed = {"clean0": True, "clean1": True}, 0
        for n, i, f in futs:
            try:
                s = np.float32(f.result(timeout=120).score)
            except Exception:  # counted per tenant
                if n == "noisy":
                    noisy["failed"] += 1
                else:
                    clean_failed += 1
                continue
            if n == "noisy":
                noisy["answered"] += 1
            else:
                clean_bits[n] &= bool(s == ref["v0" if n == "clean0" else "v1"][i])
    m = reg.metrics()
    labelled = {c: telemetry.METRICS.labeled_counters(c) for c in
                ("serving_degraded_batches", "serving_shed_requests", "serving_fe_only_requests",
                 "serving_deadline_misses", "watchdog_trips")}
    clean_labelled = {c: {k: v for k, v in d.items() if "clean" in k} for c, d in labelled.items()}
    row = dict(phase="3n-chaos", noisy=noisy, noisy_block={k: m["tenants"]["noisy"][k] for k in
                                                           ("completed", *TENANT_CLEAN_ZERO_KEYS)},
               clean_failed=clean_failed, clean_bit_equal=clean_bits,
               clean_blocks={n: {k: m["tenants"][n][k] for k in TENANT_CLEAN_ZERO_KEYS}
                             for n in ("clean0", "clean1")},
               labelled=labelled)
    log(json.dumps(row))
    if clean_failed or not all(clean_bits.values()) or any(v for d in clean_labelled.values() for v in d.values()) \
            or any(v for n in ("clean0", "clean1") for v in row["clean_blocks"][n].values()) \
            or not (noisy["shed_at_submit"] + m["tenants"]["noisy"]["degraded_batches"]):
        failures.append(f"chaos gate: {row}")
    reg.close()

    # ---- an admission over the budget demotes the coldest tenant --------------------------
    # The valve keeps no hot rows (every random-effect row from the host
    # tier); promotions run after `demote(hot_rows=TEN_HOT_ROWS)` by hand.
    budget = 3 * tenant_bytes + tenant_bytes // 2
    reg = TenantRegistry(hbm_budget_bytes=budget)
    for n in ("base", "v0", "v1"):
        reg.admit(n, view(bundles[n]))
    for n in ("v0", "v1"):  # base is the coldest
        reg.submit(n, reqs[0], block=True).result(timeout=120)
    t0 = time.perf_counter()
    reg.admit("v2", view(bundles["v2"]))
    admit_demote_s = time.perf_counter() - t0
    demoted = sorted(n for n in reg.tenant_names if reg.tenant(n).demoted)
    base_t = reg.tenant("base")
    demoted_bytes = base_t.device_bytes()
    cold, failed = replay(reg, ["base", "v2"])
    valve = base_t.batcher.metrics()
    t0 = time.perf_counter()
    repinned = reg.restore("base")
    restore_s = time.perf_counter() - t0
    back, failed1 = replay(reg, ["base"])
    t0 = time.perf_counter()
    reg.demote("base", hot_rows=TEN_HOT_ROWS)
    demote_s = time.perf_counter() - t0
    stores = base_t.bundle.stores()
    got, failed2 = replay(reg, ["base"])
    hits = base_t.batcher.metrics()
    for s in stores:
        s.drain()
    again, failed3 = replay(reg, ["base"], idx=range(1024))
    hits2 = base_t.batcher.metrics()
    reg.restore("base")
    back2, failed4 = replay(reg, ["base"])
    m = reg.metrics()
    row = dict(phase="3n-pressure", budget_bytes=budget, tenant_bytes=tenant_bytes, demoted=demoted,
               demoted_device_bytes=demoted_bytes, hot_rows=TEN_HOT_ROWS,
               entities={c.cid: c.unseen_row for c in bundles["base"].coordinates.values() if c.is_random_effect},
               admit_with_demotion_s=admit_demote_s, restore_s=restore_s, repinned_bytes=repinned,
               demote_hot_s=demote_s, failed=failed + failed1 + failed2 + failed3 + failed4,
               valve_bit_equal=bool((cold["base"] == ref["base"]).all()),
               valve_hot_hits=valve["hot_tier_hits"], valve_cold_hits=valve["cold_tier_hits"],
               restored_bit_equal=bool((back["base"] == ref["base"]).all()),
               newcomer_bit_equal=bool((cold["v2"] == ref["v2"]).all()),
               hot_rows_bit_equal=bool((got["base"] == ref["base"]).all()),
               after_promotions_bit_equal=bool((again["base"][:1024] == ref["base"][:1024]).all()),
               restored_again_bit_equal=bool((back2["base"] == ref["base"]).all()),
               hot_hits=hits["hot_tier_hits"], cold_hits=hits["cold_tier_hits"], promotions=hits["promotions"],
               evictions=hits["evictions"], hot_hits_after_drain=hits2["hot_tier_hits"] - hits["hot_tier_hits"],
               cold_hits_after_drain=hits2["cold_tier_hits"] - hits["cold_tier_hits"],
               captures_after_warmup=m["cobatch_compiles_after_warmup"])
    log(json.dumps(row))
    if demoted != ["base"] or row["failed"] or not all(row[k] for k in row if k.endswith("_bit_equal")) \
            or not hits["promotions"] or m["tenants"]["base"]["demoted"] or m["cobatch_compiles_after_warmup"]:
        failures.append(f"pressure gate: {row}")
    reg.close()

    # ---- shadow: reject a degraded challenger, promote the champion's weights, faults -------
    imaps = {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}
    art = model_store.load_game_model(best, imaps)
    rng = np.random.default_rng(89)
    degraded = model_store.GameModelArtifact(art.task, {
        cid: dataclasses.replace(c, means=(rng.standard_normal(c.means.shape) * float(np.std(c.means)))
                                 .astype(np.float32)) if cid == "global" else c
        for cid, c in art.coordinates.items()}, art.opt_configs)
    shadow_rows = {}
    # The promote drill last: it flips the champion onto its challenger.
    for drill, challenger, spec in (("reject", lambda: ServingBundle.from_artifact(degraded, device=dev,
                                                                                   index_maps=imaps), None),
                                    ("faults", lambda: load_bundle(best, device=dev),
                                     "shadow_mirror:p0.25,label_join:p0.25"),
                                    ("promote", lambda: load_bundle(best, device=dev), None)):
        reg = TenantRegistry()
        reg.admit("champion", view(bundles["base"]))
        t0 = time.perf_counter()
        ctl = ShadowController(reg, "champion", drill, challenger, window_size=TEN_SHADOW_WINDOW,
                               auto_actuate=drill != "promote")
        futs = []
        with faults.inject(spec, seed=7) if spec else contextlib.nullcontext():
            for i in range(TEN_SHADOW_ROWS):
                fut = reg.submit("champion", reqs[i], block=True)
                futs.append(fut)
                if ctl.mirror(reqs[i], fut):
                    ctl.record_label(reqs[i].uid, float(labels[i]))
            champ = np.asarray([f.result(timeout=120).score for f in futs], np.float32)
        verdict = ctl.wait_for_verdict(timeout_s=120.0) if drill != "faults" else ctl.drain(timeout_s=120.0)
        verdict_s = time.perf_counter() - t0
        promote_s = None
        if drill == "promote" and verdict == "promote":
            t1 = time.perf_counter()
            ctl.promote()
            promote_s = time.perf_counter() - t1
        block = ctl.summary()
        ctl.close()
        after = np.asarray([reg.submit("champion", reqs[i], block=True).result(timeout=120).score
                            for i in range(256)], np.float32)
        m = reg.metrics()
        row = dict(phase="3n-shadow", drill=drill, verdict=verdict, windows=block["windows"],
                   verdict_s=verdict_s, promote_s=promote_s, status=block["status"],
                   champion_metric=block["champion_metric"], challenger_metric=block["challenger_metric"],
                   mirrored=block["mirrored_requests"], mirror_failures=block["mirror_failures"],
                   label_join_failures=block["label_join_failures"], generation=block["generation"],
                   champion_failed=m["tenants"]["champion"]["failed"],
                   champion_bit_equal=bool((champ == ref["base"][:TEN_SHADOW_ROWS]).all()
                                           and (after == ref["base"][:256]).all()),
                   score_drift_p50=block["score_drift_p50"], tenants_after=reg.tenant_names,
                   captures_after_warmup=m["cobatch_compiles_after_warmup"])
        log(json.dumps(row))
        shadow_rows[drill] = row
        ok = row["champion_failed"] == 0 and row["champion_bit_equal"] and tuple(block) == SHADOW_BLOCK_KEYS \
            and reg.tenant_names == ["champion"] and not m["cobatch_compiles_after_warmup"]
        if drill == "reject":
            ok = ok and verdict == "reject" and block["status"] == "rejected" and block["generation"] == 0 \
                and block["champion_metric"] - block["challenger_metric"] > 0.02
        elif drill == "promote":
            ok = ok and verdict == "promote" and block["status"] == "promoted" and block["generation"] == 1
        else:
            ok = ok and block["mirror_failures"] > 0 and block["label_join_failures"] > 0
        if not ok:
            failures.append(f"shadow {drill} gate: {row}")
        reg.close()
    for b in bundles.values():
        b.release()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None

    # ---- the drivers --------------------------------------------------------------------
    cli_dir = os.path.join(work, "tenancy-requests")
    os.makedirs(cli_dir)
    n_cli = copy_blocks(os.path.join(replay_dir, "part-0.avro"), os.path.join(cli_dir, "part-0.avro"),
                        TEN_CLI_BLOCKS)
    out_t = os.path.join(work, "serve-tenants")
    telemetry.METRICS.reset()  # the drills' counters: each summary's robustness counters start at 0
    t0 = time.perf_counter()
    tenants_summary = serve_cli.main(["--requests", cli_dir, "--root-output-directory", out_t,
                                      "--feature-shard-configurations", E2E_SHARD, "--logging-level", "WARNING",
                                      "--tenant", f"base={best}", "--tenant", f"v0={variant_dirs[0]}",
                                      "--tenant", f"v1={variant_dirs[1]}"])
    tenants_wall = time.perf_counter() - t0
    json_path = os.path.join(work, "shadow-requests.jsonl")
    labels_path = os.path.join(work, "shadow-labels.jsonl")
    with open(json_path, "w") as fr, open(labels_path, "w") as fl:
        for i in range(TEN_CLI_SHADOW_ROWS):
            idx, vals = reqs[i].features["g"]
            fr.write(json.dumps({"uid": str(i), "ids": dict(reqs[i].entity_ids),
                                 "features": {"g": {"indices": np.asarray(idx).tolist(),
                                                    "values": np.asarray(vals, np.float64).tolist()}}}) + "\n")
            fl.write(json.dumps({"uid": str(i), "label": float(labels[i])}) + "\n")
    out_s = os.path.join(work, "serve-shadow")
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    shadow_summary = serve_cli.main(["--model-input-directory", best, "--requests", json_path,
                                     "--root-output-directory", out_s, "--shadow", f"cand={variant_dirs[0]}",
                                     "--labels", labels_path, "--shadow-window", str(TEN_SHADOW_WINDOW),
                                     "--logging-level", "WARNING"])
    shadow_wall = time.perf_counter() - t0
    path_launches = serving_launches()  # the serving path ends here
    out_r = os.path.join(work, "refresh-gate")
    reset_serving_launches()  # the refresh round's training, counted apart
    t0 = time.perf_counter()
    refresh_cli.main(["--root-output-directory", out_r, "--synthetic", "--rounds", "1", "--entities",
                      str(R_ENTITIES), "--base-rows", str(R_ENTITIES * R_ROWS_PER_ENTITY), "--batch-rows", "128",
                      "--churn-entities", "6", "--new-entities-per-round", "2", "--shadow-gate",
                      "--probe-rows", "512", "--seed", "61", "--logging-level", "WARNING"])
    refresh_wall = time.perf_counter() - t0
    refresh_launches = serving_launches()
    with open(os.path.join(out_r, "refresh-summary.json")) as f:
        (rnd,) = json.load(f)["rounds"]
    port_log.setLevel(log_level)

    def clean(summary, shed_mirrors=0):
        robust = {k: summary["robustness_counters"][k] for k in ROBUSTNESS_CLEAN_ZERO_KEYS}
        robust["shadow_mirror_failures"] -= shed_mirrors
        return sorted(summary) == sorted(SERVING_SUMMARY_KEYS) and summary["failed_requests"] == 0 \
            and not any(robust.values())

    # At the default quota the champion's submit waits for a slot and the
    # mirror's does not: a lagging challenger sheds mirrors, counted as
    # mirror failures by both packages. Every mirror failure must be such
    # a shed; the champion sheds none.
    shed_mirrors = int(shadow_summary["robustness_counters"].get("serving_shed_requests", 0))

    row = dict(phase="3n-cli", tenants_requests=tenants_summary["num_requests"], tenants_rows=n_cli,
               tenants_failed=tenants_summary["failed_requests"], tenants_wall_s=tenants_wall,
               tenants_clean=clean(tenants_summary),
               tenant_blocks_ok=all(tuple(b) == TENANT_BLOCK_KEYS for b in tenants_summary["tenants"].values()),
               cobatch_dispatches=tenants_summary["serving"]["cobatch_dispatches"],
               cobatched_requests={n: b["cobatched_requests"] for n, b in tenants_summary["tenants"].items()},
               shadow_requests=shadow_summary["num_requests"], shadow_failed=shadow_summary["failed_requests"],
               shadow_wall_s=shadow_wall, shadow_clean=clean(shadow_summary, shed_mirrors),
               shadow_shed_mirrors=shed_mirrors, shadow=shadow_summary["shadow"],
               refresh_wall_s=refresh_wall, refresh_round={k: v for k, v in rnd.items() if not isinstance(v, dict)},
               refresh_shadow=rnd["shadow"], refresh_launches=refresh_launches)
    log(json.dumps(row))
    if not (row["tenants_clean"] and row["tenant_blocks_ok"] and row["tenants_requests"] == n_cli
            and row["cobatch_dispatches"] > 0):
        failures.append(f"cli.serve --tenant: {row}")
    if not (row["shadow_clean"] and tuple(shadow_summary["shadow"]) == SHADOW_BLOCK_KEYS
            and shadow_summary["shadow"]["mirrored_requests"] > 0
            and shadow_summary["shadow"]["mirror_failures"] == shed_mirrors
            and shadow_summary["tenants"]["champion"]["shed"] == 0):
        failures.append(f"cli.serve --shadow: {row}")
    if not (rnd["committed"] and rnd["shadow_verdict"] == "promote"):
        failures.append(f"cli.refresh --shadow-gate: {row}")
    if any(path_launches.values()):
        failures.append(f"the serving path launched a kernel: {path_launches}")
    log(json.dumps(dict(phase="3n", wall_s=time.perf_counter() - t_phase, launches=path_launches,
                        refresh_launches=refresh_launches, peak_mem_gib=peak_gib,
                        mem_allocated_gib=torch.cuda.memory_allocated() / 2**30 if dev.type == "cuda" else None,
                        ok=not failures)))
    if failures:
        raise SystemExit("phase 3n failed: " + "; ".join(failures))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"path": path_launches, "refresh": refresh_launches}


# ---------------------------------------------------------------- phase 3n-ladder
# The precision ladder on one card (serving/bundle.py quantize_bundle_rows,
# serving/engine.py's re_bf16 / re_i8 kinds, TenantRegistry.demote_tier /
# restore_tier): 3c's model walked down and back in 3n's fleet, then the
# reference's squeeze cell (`bench.py:1209-1418`) with the ladder on and off.

LAD_TENANTS = 13  # the squeeze: the reference cell's 13 tenants
LAD_ENTITIES, LAD_D_FE, LAD_D_RE = 64, 12, 32  # of 64 entities x 32-wide rows, a 12-wide fixed effect
LAD_REQUESTS = 16  # requests a squeeze tenant


def ladder_squeeze_model(seed: int):
    """One of the squeeze cell's tenants (the reference's `build_wide`): a
    LAD_D_FE fixed effect and LAD_ENTITIES rows of LAD_D_RE, N(0, 0.4^2)."""
    import torch

    from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
    from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
    from photon_ml_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    rng = np.random.default_rng(seed)
    w = rng.normal(size=LAD_D_FE).astype(np.float32)
    M = np.zeros((LAD_ENTITIES + 1, LAD_D_RE), np.float32)
    M[:LAD_ENTITIES] = rng.normal(size=(LAD_ENTITIES, LAD_D_RE)) * 0.4
    model = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), task),
                       "per-e": RandomEffectModel(torch.from_numpy(M), None, task)})
    specs = {"fixed": CoordinateScoringSpec(shard="g"),
             "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                            entity_index={str(i): i for i in range(LAD_ENTITIES)})}
    return model, specs, task


def ladder_squeeze_requests(seed: int) -> list:
    """The reference's `requests_wide`: LAD_REQUESTS requests, some ids
    past the trained entities (cold starts)."""
    from photon_ml_tpu_torch.serving import ScoreRequest

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(LAD_REQUESTS, LAD_D_FE)).astype(np.float32)
    Xe = rng.normal(size=(LAD_REQUESTS, LAD_D_RE)).astype(np.float32)
    ids = rng.integers(0, LAD_ENTITIES + 4, size=LAD_REQUESTS)
    return [ScoreRequest(features={"g": X[i], "re": Xe[i]}, entity_ids={"eid": str(int(ids[i]))},
                         offset=float(i) * 0.0625, uid=str(i)) for i in range(LAD_REQUESTS)]


def within_tier(got, ref, tier: str) -> dict:
    """The worst |got - ref| and the share of the TIER_TOLERANCES[tier]
    allowance (atol + rtol |ref|) it uses: within the tolerance at <= 1."""
    from photon_ml_tpu_torch.contracts import TIER_TOLERANCES

    tol = TIER_TOLERANCES[tier]
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    allowed = tol["atol"] + tol["rtol"] * np.abs(np.asarray(ref, np.float64))
    return {"max_abs_diff": float(d.max()), "tolerance_used": float((d / allowed).max()),
            "within": bool((d <= allowed).all())}


def ladder_phase(root: str, work: str, dev) -> dict:
    """Phase 3n-ladder. 3c's model (its per-user and per-movie matrices 201
    wide, 27,587 and 5,406 rows) in 3n's fleet beside two of 3n's variants
    (co-batched), on 3n's requests: `demote_tier` to bf16, `restore_tier`
    to f32, `demote_tier` to bf16 and to int8, `restore_tier` to f32 (two
    steps). Each transition prints its seconds, the device bytes it freed or
    re-pinned and its pre-warm captures (the tenant's bucket graphs and the
    co-batch group's); each quantized rung the worst |score - f32 score| on
    every request and the share of TIER_TOLERANCES[rung] it uses, and must
    answer bit-equal to an f32 engine over the dequantized rows (the widen
    and the scale multiply run inside the bucket graph) and solo; each
    restore must answer bit-equal to the f32 answers before the demotion,
    and the variants keep their bits throughout. The replay of an int8 bucket's graph against the
    f32 one's (CUDA-event medians, bucket 256). A terminal `quantize_stage`
    fault must leave the f32 generation serving, bit-equal, at its
    version. Then the reference's squeeze: LAD_TENANTS tenants admitted
    under a budget of one f32 tenant beside int8 ones, with the ladder off
    (the valve demotes to the host tier; every answer bit-equal) and on
    (the valve quantizes before it demotes: more tenants resident, every
    demoted tenant already quantized, each answer within its rung's
    tolerance), then the coldest walked back to bf16 (its answers within
    TIER_TOLERANCES["bf16"] of its solo f32 ones) and to f32 bit-equal. Every
    engine's `recompiles_after_warmup` and the registries' captures after
    warm-up must be 0, with 0 failed requests, and the path must launch
    none of the six kernels. Returns its launches."""
    import itertools
    import logging
    import os

    import torch

    from photon_ml_tpu_torch.contracts import ROBUSTNESS_CLEAN_ZERO_KEYS, TIER_TOLERANCES
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig
    from photon_ml_tpu_torch.serving import ServingBundle, ServingEngine, TenantRegistry, load_bundle, \
        request_from_record
    from photon_ml_tpu_torch.serving.bundle import quantize_bundle_rows
    from photon_ml_tpu_torch.utils import faults, telemetry
    from photon_ml_tpu_torch.utils.knobs import get_knob, knob_is_set

    best = os.path.join(root, "drivers", "train", "models", "best")
    replay_dir = os.path.join(work, "serve-requests")
    variant_dirs = [os.path.join(work, "tenants", f"v{k}") for k in range(2)]
    card = card_line() if dev.type == "cuda" else "cpu"
    failures = []
    # The ladder's counters: tier_demotions, tier_restores, tier_rollbacks.
    tier_counters = tuple(k for k in ROBUSTNESS_CLEAN_ZERO_KEYS if k.startswith("tier_"))
    t_phase = time.perf_counter()
    port_log = logging.getLogger("photon_ml_tpu_torch")
    log_level = port_log.level
    port_log.setLevel(logging.ERROR)  # the injected fault and its retries log warnings

    recs = list(itertools.islice(avro_io.iter_container(os.path.join(replay_dir, "part-0.avro")), TEN_ROWS))
    recs += list(itertools.islice(avro_io.iter_container(os.path.join(replay_dir, "part-1.avro")), TEN_UNSEEN))
    reset_serving_launches()  # the serving path starts here
    telemetry.METRICS.reset()  # the robustness counters too
    t0 = time.perf_counter()
    names = ("base", "v0", "v1")
    bundles = dict(zip(names, [load_bundle(d, device=dev) for d in (best, *variant_dirs)]))
    load_s = time.perf_counter() - t0
    shards = {"g": FeatureShardConfig(("features",), True)}
    reqs = [request_from_record(bundles["base"], r, shards) for _, r in recs]
    widths = {c.cid: list(c.params.shape) for c in bundles["base"].coordinates.values()}

    def replay(reg, tenants):
        futs = [(n, i, reg.submit(n, r, block=True)) for i, r in enumerate(reqs) for n in tenants]
        out = {n: np.zeros(len(reqs), np.float32) for n in tenants}
        failed = 0
        for n, i, f in futs:
            try:
                out[n][i] = f.result(timeout=120).score
            except Exception:  # counted: the gates want none
                failed += 1
        return out, failed

    def graph_ms(t, bucket=256):
        return time_ms(torch, t.engine._state.programs[bucket].graph.replay) if dev.type == "cuda" else None

    def dequantized_scores(bundle):
        """An f32 engine's answers over `bundle` with each quantized plane
        dequantized whole (widened, times its row scales)."""
        coords = {cid: c if c.tier == "f32" else dataclasses.replace(
            c, params=c.params.float() * c.scales[:, None] if c.scales is not None else c.params.float(),
            tier="f32", scales=None, host_f32=None) for cid, c in bundle.coordinates.items()}
        with ServingEngine(dataclasses.replace(bundle, coordinates=coords, provenance={})) as eng:
            return np.concatenate([np.asarray([x.score for x in eng.score_batch(reqs[i:i + 256])], np.float32)
                                   for i in range(0, len(reqs), 256)])

    # ---- 3c's model down the ladder and back -------------------------------------------
    reg = TenantRegistry()
    t0 = time.perf_counter()
    for n in names:
        reg.admit(n, bundles[n])
    admit_s = time.perf_counter() - t0
    base = reg.tenant("base")
    ref, failed = replay(reg, names)
    f32_ms = graph_ms(base)
    transitions, rung_ms = [], {"f32": f32_ms}

    def step(method, **kw):
        m = reg.metrics()
        before = dict(tier=base.tier, compiles=base.engine.compiles, cobatch=m["cobatch_compiles"],
                      bytes=base.device_bytes(), cobatched=m["tenants"]["base"]["cobatched_requests"])
        t0 = time.perf_counter()
        moved = getattr(reg, method)("base", reason="chip_smoke", **kw)
        seconds = time.perf_counter() - t0
        got, failed = replay(reg, names)
        m = reg.metrics()
        row = dict(transition=f"{before['tier']} -> {base.tier}", seconds=seconds,
                   freed_bytes=before["bytes"] - base.device_bytes(), moved_bytes=moved,
                   device_bytes=base.device_bytes(),
                   prewarm_captures=base.engine.compiles - before["compiles"],
                   cobatch_prewarm_captures=m["cobatch_compiles"] - before["cobatch"], failed=failed,
                   quantized_coords=m["tenants"]["base"]["tier"]["quantized_coords"],
                   quant_error_max=m["tenants"]["base"]["tier"]["quant_error_max"],
                   variants_bit_equal=all(bool((got[n] == ref[n]).all()) for n in names[1:]),
                   base_cobatched=m["tenants"]["base"]["cobatched_requests"] - before["cobatched"])
        if base.tier == "f32":
            row["bit_equal_to_f32"] = bool((got["base"] == ref["base"]).all())
        else:
            row.update(within_tier(got["base"], ref["base"], base.tier), tolerance=TIER_TOLERANCES[base.tier],
                       bit_equal_to_dequantized=bool((got["base"] == dequantized_scores(base.bundle)).all()))
            rung_ms[base.tier] = graph_ms(base)
        transitions.append(row)
        log(json.dumps(dict(phase="3n-ladder-step", **row, card=card)))
        ok = not failed and row["variants_bit_equal"] and row["prewarm_captures"] > 0
        ok = ok and (row["bit_equal_to_f32"] if base.tier == "f32" else row["bit_equal_to_dequantized"]
                     and row["freed_bytes"] > 0 and not row["base_cobatched"])  # quantized: solo
        if not ok:
            failures.append(f"ladder step {row['transition']}: {row}")

    cobatched_f32 = reg.metrics()["tenants"]["base"]["cobatched_requests"]
    step("demote_tier")  # f32 -> bf16
    step("restore_tier")  # bf16 -> f32
    step("demote_tier")  # f32 -> bf16
    step("demote_tier")  # bf16 -> int8
    step("restore_tier")  # int8 -> bf16 -> f32
    # A terminal quantize_stage fault: nothing commits, the f32 generation serves on.
    version = base.engine._state.version
    with faults.inject("quantize_stage:99"):
        try:
            reg.demote_tier("base", reason="chip_smoke")
            fault = "not raised"
        except faults.InjectedFault:
            fault = "raised"
    got, failed_f = replay(reg, names)
    m = reg.metrics()
    fault_row = dict(fault=fault, tier=base.tier, version_kept=base.engine._state.version == version,
                     bit_equal=bool((got["base"] == ref["base"]).all()), failed=failed_f,
                     tier_rollbacks=m["tenants"]["base"]["tier"]["rollbacks"])
    recompiles = {n: reg.tenant(n).engine.recompiles_after_warmup for n in names}
    row = dict(phase="3n-ladder", model=widths, requests=len(reqs), admit_s=admit_s, load_s=load_s,
               transitions=[t["transition"] for t in transitions],
               graph_ms_256={k: v for k, v in rung_ms.items()},
               int8_over_f32_graph=(rung_ms["int8"] / rung_ms["f32"] if dev.type == "cuda" else None),
               terminal_fault=fault_row, recompiles_after_warmup=recompiles,
               cobatch_compiles_after_warmup=m["cobatch_compiles_after_warmup"],
               failed_requests=failed + failed_f + sum(t["failed"] for t in transitions),
               tenant_failed={n: b["failed"] for n, b in m["tenants"].items()},
               tier_block=m["tenants"]["base"]["tier"], cobatched_at_f32=cobatched_f32,
               counters={k: faults.COUNTERS.get(k) for k in tier_counters},
               card=card)
    log(json.dumps(row))
    if fault_row != dict(fault="raised", tier="f32", version_kept=True, bit_equal=True, failed=0,
                         tier_rollbacks=1):
        failures.append(f"terminal quantize_stage fault: {fault_row}")
    if any(recompiles.values()) or m["cobatch_compiles_after_warmup"] or row["failed_requests"] \
            or any(row["tenant_failed"].values()) or not cobatched_f32:
        failures.append(f"ladder serving: {row}")
    reg.close()
    for b in bundles.values():
        b.release()

    # ---- the reference's squeeze, with the ladder off and on -----------------------------
    names = [f"lad-{j}" for j in range(LAD_TENANTS)]
    lad = {n: ladder_squeeze_model(800 + j) for j, n in enumerate(names)}
    lad_reqs = {n: ladder_squeeze_requests(900 + j) for j, n in enumerate(names)}

    def squeeze_bundle(n):
        model, specs, task = lad[n]
        return ServingBundle.from_model(model, specs, task, device=dev)

    lad_ref = {}
    for n in names:
        with ServingEngine(squeeze_bundle(n), max_batch=16) as eng:
            lad_ref[n] = np.asarray([r.score for r in eng.score_batch(lad_reqs[n])], np.float32)
    probe = squeeze_bundle(names[0])
    per_f32 = probe.device_bytes()
    per_i8 = quantize_bundle_rows(probe, "int8")[0].device_bytes()
    budget = per_f32 + (LAD_TENANTS - 1) * per_i8 + per_i8 // 2
    squeeze = {}
    prior = str(int(get_knob("PHOTON_TIER_LADDER"))) if knob_is_set("PHOTON_TIER_LADDER") else None
    try:
        for ladder in (False, True):
            os.environ["PHOTON_TIER_LADDER"] = "1" if ladder else "0"
            telemetry.METRICS.reset()
            # photon-lint: disable=planner-constant — the squeeze cell pins the reference's wait (bench.py's
            # precision-ladder squeeze): a measurement's setting, not a runtime default
            reg = TenantRegistry(max_batch=16, max_wait_ms=1.0, hbm_budget_bytes=budget)
            t0 = time.perf_counter()
            for n in names:
                reg.admit(n, squeeze_bundle(n), deadline_ms=2000.0, inject_faults=False)
            admit_s = time.perf_counter() - t0
            m = reg.metrics()
            tiers = {n: m["tenants"][n]["tier"]["tier"] for n in names}
            demoted = [n for n in names if m["tenants"][n]["demoted"]]
            within = {}
            for n in names:
                got = np.asarray([reg.score(n, r).score for r in lad_reqs[n]], np.float32)
                within[n] = bool((got == lad_ref[n]).all()) if tiers[n] == "f32" else \
                    within_tier(got, lad_ref[n], tiers[n])["within"]
            row = dict(ladder=ladder, budget_bytes=budget, per_f32_bytes=per_f32, per_int8_bytes=per_i8,
                       resident=LAD_TENANTS - len(demoted), demoted={n: tiers[n] for n in demoted},
                       tiers={t: sum(v == t for v in tiers.values()) for t in ("f32", "bf16", "int8")},
                       admit_s=admit_s, answers_within=all(within.values()),
                       transitions={k: faults.COUNTERS.get(k) for k in ("tenant_demotions", *tier_counters)})
            if ladder:
                # The reference's restore: retire part of the fleet, walk the
                # coldest back to f32 (through bf16, within its tolerance),
                # bit-equal to its solo f32 answers.
                for n in names[5:10]:
                    reg.remove(n, release_bundle=True)
                t0 = time.perf_counter()
                reg.restore_tier(names[0], to="bf16", reason="chip_smoke")
                got = np.asarray([reg.score(names[0], r).score for r in lad_reqs[names[0]]], np.float32)
                row["restored_bf16"] = within_tier(got, lad_ref[names[0]], "bf16")
                reg.restore_tier(names[0], reason="chip_smoke")
                row["restore_s"] = time.perf_counter() - t0
                got = np.asarray([reg.score(names[0], r).score for r in lad_reqs[names[0]]], np.float32)
                row["restored_bit_equal"] = bool((got == lad_ref[names[0]]).all()) \
                    and reg.tenant(names[0]).tier == "f32" and not reg.tenant(names[0]).demoted
            m = reg.metrics()
            row.update(failed=sum(b["failed"] for b in m["tenants"].values()),
                       captures_after_warmup=m["cobatch_compiles_after_warmup"],
                       recompiles_after_warmup=sum(reg.tenant(n).engine.recompiles_after_warmup
                                                   for n in reg.tenant_names))
            reg.close(release_bundles=True)
            squeeze[ladder] = row
            log(json.dumps(dict(phase="3n-ladder-squeeze", **row)))
    finally:
        if prior is None:
            os.environ.pop("PHOTON_TIER_LADDER", None)
        else:
            os.environ["PHOTON_TIER_LADDER"] = prior
    off, on = squeeze[False], squeeze[True]
    if off["tiers"]["f32"] != LAD_TENANTS or not off["demoted"] or not off["answers_within"]:
        failures.append(f"squeeze, ladder off: {off}")
    # Ladder on: more tenants resident, and no tenant went to the host tier
    # while it could still step a rung down.
    if not (on["resident"] > off["resident"] and on["transitions"]["tier_demotions"] > 0
            and on["answers_within"] and on["restored_bf16"]["within"] and on["restored_bit_equal"]
            and all(t != "f32" for t in on["demoted"].values())):
        failures.append(f"squeeze, ladder on: {on}")
    for row in (off, on):
        if row["failed"] or row["captures_after_warmup"] or row["recompiles_after_warmup"]:
            failures.append(f"squeeze serving: {row}")
    launches = serving_launches()  # the serving path ends here
    port_log.setLevel(log_level)
    log(json.dumps(dict(phase="3n-ladder", wall_s=time.perf_counter() - t_phase, launches=launches,
                        ok=not failures)))
    if any(launches.values()):
        failures.append(f"the ladder's serving path launched a kernel: {launches}")
    if failures:
        raise SystemExit("phase 3n-ladder failed: " + "; ".join(failures))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase lint
# photon-lint over the port's tree (photon_ml_tpu_torch/analysis/).


def lint_phase() -> dict:
    """Phase lint: the port's nine static checks over the tree this script
    ships in, in process; raises on any finding. Returns its line."""
    import os

    from photon_ml_tpu_torch.analysis import discover, run_on

    t0 = time.perf_counter()
    files, ctx = discover(os.path.dirname(os.path.abspath(__file__)))
    findings = run_on(files, ctx)
    row = dict(phase="lint", files=len(files), findings=len(findings),
               seconds=time.perf_counter() - t0, card=card_line())
    log(json.dumps(row))
    if findings:
        raise SystemExit("phase lint: photon-lint findings on the port's tree:\n"
                         + "\n".join(f.render() for f in findings))
    return row


# ---------------------------------------------------------------- phase 3p
# The runtime planner and the autopilot on one card (planner/, autopilot/,
# serving/reshard.py): 3c's fit and 3v's replay planned from their own
# profiles, and the control loop over 3n's fleet.

P3_ROWS = 1_024  # 3p: requests of 3v's stream a tenant of the autopilot fleet
P3_HOT_ROWS = 256  # the fleet's two-tier tenant's hot rows (3n's 2,048, cut: rows evict, so promotions repeat)
P3_SERVE_BLOCKS = 2  # cli.serve --profile: the first 8,192 of 3v's requests


def planner_autopilot_phase(root: str, work: str, dev, train_launches_3c: dict) -> dict:
    """Phase 3p. Planned fit: 3c's cli.train command line with `--profile`
    3c's own profile.json must save 3c's model bit for bit, launch #4 and #5
    as often as 3c's train did, and record an active plan block from the
    profile; a copy of the profile with its device_kind edited is refused
    before the read; PHOTON_PLAN=1's calibration probe (upload GB/s, one
    op's round trip) is printed. Planned serving: 3v's cli.serve command
    line with `--profile` 3v's serve profile on 3v's first P3_SERVE_BLOCKS
    blocks gives 3v's scores bit for bit (the planned ceiling and wait
    printed). The autopilot on 3n's fleet (3c's model and 3n's variant v0,
    co-batched, and 3c's model two-tier with P3_HOT_ROWS hot rows, solo):
    `Autopilot.tick()` drives demote, restore, rebalance (from the two-tier
    store's promotions), retune and the one-card reshard, one action a
    tick: each applied, every answer of every tenant bit-equal to the
    fleet's before any action, 0 failed; an armed `autopilot_act` rolls the
    action back and quarantines its rule. Then 3n's `cli.serve --tenant` x3
    with `--autopilot` and `--profile` (3n's profile): 3n's scores bit for
    bit, the `autopilot` block, and `cli.obs decisions` on its journal. The
    serving part's launches are counted from 0 and must all be 0. Returns
    the planned fit's launches and the serving part's."""
    import itertools
    import logging
    import os
    import shutil

    import torch

    from photon_ml_tpu_torch import autopilot, planner
    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.contracts import AUTOPILOT_BLOCK_KEYS
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import model_store, score_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig
    from photon_ml_tpu_torch.serving import TenantRegistry, demote_bundle_to_host_tier, load_bundle, request_from_record
    from photon_ml_tpu_torch.utils import faults, telemetry

    c3 = os.path.join(root, "drivers", "train")
    best = os.path.join(c3, "models", "best")
    card = card_line() if dev.type == "cuda" else "cpu"
    failures = []
    t_phase = time.perf_counter()

    # ---- the planned fit ---------------------------------------------------------------
    def train_argv(out, profile):
        return ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
                "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
                "--coordinate-configurations", *E2E_COORDINATES, "--coordinate-descent-iterations", "1",
                "--output-mode", "BEST", "--logging-level", "WARNING", "--profile", profile]

    edited = os.path.join(work, "profile-edited.json")
    with open(os.path.join(c3, "profile.json")) as f:
        doc = json.load(f)
    doc["device_topology"]["device_kind"] = "NVIDIA A100-SXM4-80GB"
    with open(edited, "w") as f:
        json.dump(doc, f)
    refused_out = os.path.join(work, "planned-train-refused")
    train_log = logging.getLogger("photon_ml_tpu_torch.cli.train")
    train_log.disabled = True  # the refusal's traceback is the expected outcome
    t0 = time.perf_counter()
    try:
        train_cli.main(train_argv(refused_out, edited))
        refused = None
    except planner.PlanTopologyError as exc:
        refused = str(exc)
    finally:
        train_log.disabled = False
    refuse_s = time.perf_counter() - t0
    read_before_refusal = [t for t in journal_types(os.path.join(refused_out, "journal.jsonl"))
                           if t not in ("setup", "failure")]
    os.environ["PHOTON_PLAN"] = "1"
    try:
        probe = planner.calibration_probe(dev)
        calibrated = planner.ensure_ambient_plan(device=dev)
        calibration = calibrated.block()
    finally:
        planner.uninstall_plan()
        del os.environ["PHOTON_PLAN"]
    out = os.path.join(work, "planned-train")
    t0 = time.perf_counter()
    summary, sparse_t, dense_t, mem_t = counted(torch, lambda: train_cli.main(
        train_argv(out, os.path.join(c3, "profile.json"))))
    train_wall = time.perf_counter() - t0
    imaps = {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}
    vs_3c = same_model(model_store.load_game_model(os.path.join(out, "models", "best"), imaps),
                       model_store.load_game_model(best, imaps))
    plan = summary["fit_timing"]["plan"]
    row = dict(phase="3p-train", wall_s=train_wall, timings_s=summary["timings_s"], plan=plan,
               model_vs_3c=vs_3c, launches=sparse_t, launches_3c=train_launches_3c, dense_launches=dense_t,
               mem_gib=mem_t, refused=refused, refuse_s=refuse_s, read_before_refusal=read_before_refusal,
               calibration_probe=probe, calibration_plan=calibration, card=card)
    log(json.dumps(row))
    if not all(v["bit_equal"] for v in vs_3c.values()) or sparse_t != train_launches_3c or any(dense_t.values()) \
            or not (plan["active"] and plan["source"] == "profile") or planner.current_plan() is not None:
        failures.append(f"planned fit: {row}")
    if refused is None or "device_kind" not in refused or read_before_refusal \
            or os.path.exists(os.path.join(refused_out, "models")):
        failures.append(f"the edited profile was not refused before the read: {row}")
    if not (probe["upload_gb_per_s"] > 0 and probe["dispatch_rtt_ms"] > 0 and calibration["source"] == "calibration"):
        failures.append(f"calibration: {probe}, {calibration}")

    # ---- planned serving -------------------------------------------------------------------
    reset_serving_launches()  # the serving part starts here
    replay_dir = os.path.join(work, "serve-requests")
    sub_dir = os.path.join(work, "planned-serve-requests")
    os.makedirs(sub_dir)
    n_sub = copy_blocks(os.path.join(replay_dir, "part-0.avro"), os.path.join(sub_dir, "part-0.avro"),
                        P3_SERVE_BLOCKS)
    out_s = os.path.join(work, "planned-serve")
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    ssum = serve_cli.main(serve_args(best, sub_dir, out_s, "--profile",
                                     os.path.join(work, "serve", "profile.json")))
    serve_wall = time.perf_counter() - t0
    with open(os.path.join(out_s, "profile.json")) as f:
        planned_dispatch = json.load(f)["dispatch"]
    got = score_store.load_score_columns(os.path.join(out_s, "scores"))
    ref = score_store.load_score_columns(os.path.join(work, "serve", "scores"))
    ref_by_uid = dict(zip(ref.uids, ref.scores))
    serve_bits = len(got) == n_sub and all(ref_by_uid[u] == s for u, s in zip(got.uids, got.scores))
    decisions = {d["decision"]: (d["value"], d["source"]) for d in ssum["plan"]["decisions"]}
    row = dict(phase="3p-serve", wall_s=serve_wall, requests=ssum["num_requests"], failed=ssum["failed_requests"],
               planned=decisions, max_batch=planned_dispatch["max_batch"], max_wait_ms=planned_dispatch["max_wait_ms"],
               p50_ms=ssum["serving"]["p50_ms"], p99_ms=ssum["serving"]["p99_ms"],
               bit_equal_to_3v=serve_bits, card=card)
    log(json.dumps(row))
    if not serve_bits or ssum["failed_requests"] or set(decisions) != {"serving_max_batch", "serving_max_wait_ms"} \
            or planned_dispatch["max_batch"] != decisions["serving_max_batch"][0]:
        failures.append(f"planned serving: {row}")

    # ---- the autopilot over 3n's fleet -----------------------------------------------------
    shards = {"g": FeatureShardConfig(("features",), True)}
    variant = os.path.join(work, "tenants", "v0")
    recs = [r for _, r in itertools.islice(avro_io.iter_container(os.path.join(replay_dir, "part-0.avro")),
                                           P3_ROWS)]
    telemetry.METRICS.reset()
    reg = TenantRegistry()
    t0 = time.perf_counter()
    reg.admit("base", load_bundle(best, device=dev))
    reg.admit("v0", load_bundle(variant, device=dev))
    base_bundle = load_bundle(best, device=dev)
    reg.admit("tiered", demote_bundle_to_host_tier(base_bundle, hot_rows=P3_HOT_ROWS))
    base_bundle.release(close_stores=False)
    admit_s = time.perf_counter() - t0
    reqs = [request_from_record(reg.tenant("base").bundle, r, shards) for r in recs]
    names = ["base", "v0", "tiered"]

    def replay():
        futs = [(n, reg.submit(n, r, block=True)) for r in reqs for n in names]
        out, failed = {n: [] for n in names}, 0
        for n, f in futs:
            try:
                res = f.result(timeout=120)
                out[n].append((res.score, res.mean))
            except Exception:  # counted: the gates want none
                failed += 1
        return out, failed

    t0 = time.perf_counter()
    for _ in range(3):  # rows evict and come back: the promotions a rebalance plan reads
        replay()
        for s in reg.tenant("tiered").bundle.stores():
            s.drain()
    ref_fleet, failed0 = replay()
    warm_s = time.perf_counter() - t0
    actions = [("demote", "base", {"hot_rows": P3_HOT_ROWS}), ("restore", "base", {}),
               ("rebalance", "tiered", {"cid": "per-user"}), ("retune", None, {"serving_max_wait_ms": 1.0}),
               ("reshard", "v0", {"devices": 1}), ("fault", "v0", {"hot_rows": 0})]
    rows, failed_total = [], failed0
    for kind, tenant, params in actions:
        act = "demote" if kind == "fault" else kind
        rule = autopilot.ControlRule(
            name=f"3p-{kind}", signal=lambda c, p: 1.0, fire_above=0.5, rearm_below=0.0,
            decide=lambda c, p, s, act=act, tenant=tenant, params=params: autopilot.Action(
                kind=act, tenant=tenant, params=params))
        pilot = autopilot.Autopilot(reg, rules=[rule], start=False, cooldown_s=0.0,
                                    probe_requests={n: reqs[0] for n in names})
        t0 = time.perf_counter()
        if kind == "fault":
            with faults.inject("autopilot_act:1"):
                pilot.tick()
        else:
            pilot.tick()
        tick_s = time.perf_counter() - t0
        pilot.close()
        block = pilot.summary()
        after, failed = replay()
        failed_total += failed
        m = {n: reg.tenant(n).engine.metrics() for n in names}
        r = dict(action=kind, tenant=tenant, tick_s=tick_s, outcome=block["last_outcome"],
                 rollbacks=block["rollbacks"], quarantined=block["quarantined"], failed=failed,
                 bit_equal=after == ref_fleet,
                 differing={n: sum(x != y for x, y in zip(after[n], ref_fleet[n])) for n in names}, demoted={n: reg.tenant(n).demoted for n in names},
                 version={n: m[n]["bundle_version"] for n in names})
        if kind == "rebalance":
            store = reg.tenant("tiered").bundle.coordinates["per-user"].store
            r.update(rebalances=m["tiered"]["bundle_rebalances"], preloaded_rows=len(store.preloaded_rows),
                     hot_rows=store.capacity)
        rows.append(r)
        want = "rolled_back" if kind == "fault" else "applied"
        ok = r["bit_equal"] and not failed and r["outcome"] == want
        if kind == "fault":
            ok = ok and block["quarantined"] == ["3p-fault"] and block["rollbacks"] == 1
        elif kind == "rebalance":
            ok = ok and r["rebalances"] == 1 and r["preloaded_rows"] > 0
        elif kind == "retune":
            ok = ok and reg.max_wait_s == 1.0e-3
        elif kind == "reshard":
            ok = ok and m["v0"]["bundle_reshards"] == 1
        if not ok:
            failures.append(f"autopilot {kind}: {r}")
    planner.uninstall_plan()  # the retune's online decision
    fleet = reg.metrics()
    reg.close(release_bundles=True)
    row = dict(phase="3p-autopilot", tenants=names, requests_a_tenant=len(reqs), admit_s=admit_s,
               warm_s=warm_s, actions=rows, failed=failed_total,
               captures_after_warmup=fleet["cobatch_compiles_after_warmup"], card=card)
    log(json.dumps(row))
    if failed_total or fleet["cobatch_compiles_after_warmup"]:
        failures.append(f"autopilot fleet: {row}")

    # ---- cli.serve --tenant x3 --autopilot --profile, then cli.obs decisions -------------
    out_t = os.path.join(work, "serve-autopilot")
    telemetry.METRICS.reset()
    t0 = time.perf_counter()
    asum = serve_cli.main(["--requests", os.path.join(work, "tenancy-requests"), "--root-output-directory", out_t,
                           "--feature-shard-configurations", E2E_SHARD, "--logging-level", "WARNING",
                           "--tenant", f"base={best}", "--tenant", f"v0={variant}",
                           "--tenant", f"v1={os.path.join(work, 'tenants', 'v1')}", "--autopilot",
                           "--profile", os.path.join(work, "serve-tenants", "profile.json")])
    auto_wall = time.perf_counter() - t0
    t_bits = {}
    for n in ("base", "v0", "v1"):
        a = score_store.load_score_columns(os.path.join(out_t, "scores", n))
        b = score_store.load_score_columns(os.path.join(work, "serve-tenants", "scores", n))
        t_bits[n] = list(a.uids) == list(b.uids) and bool(np.array_equal(a.scores, b.scores))
    code, text = obs_main(["decisions", os.path.join(out_t, "journal.jsonl")])
    path_launches = serving_launches()  # the serving part ends here
    lines = text.splitlines()
    row = dict(phase="3p-cli", wall_s=auto_wall, requests=asum["num_requests"], failed=asum["failed_requests"],
               autopilot=asum["autopilot"], plan_source=asum["plan"]["source"], bit_equal_to_3n=t_bits,
               decisions_exit=code, decisions_head=lines[:1], decision_rows=len(lines) - 1,
               launches=path_launches)
    log(json.dumps(row))
    if asum["failed_requests"] or tuple(asum["autopilot"]) != AUTOPILOT_BLOCK_KEYS \
            or asum["autopilot"]["status"] != "stopped" or asum["autopilot"]["rollbacks"] \
            or not asum["autopilot"]["ticks"] or not all(t_bits.values()) or code != 0 or len(lines) < 3:
        failures.append(f"cli.serve --autopilot: {row}")
    if any(path_launches.values()):
        failures.append(f"the serving part launched a kernel: {path_launches}")
    log(json.dumps(dict(phase="3p", wall_s=time.perf_counter() - t_phase, train_launches=sparse_t,
                        serving_launches=path_launches, ok=not failures)))
    shutil.rmtree(os.path.join(work, "planned-train"), ignore_errors=True)
    if failures:
        raise SystemExit("phase 3p failed: " + "; ".join(failures))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"train": sparse_t, "train_dense": dense_t, "path": path_launches}


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
    from photon_ml_tpu_torch.ops import ell_kernels, glm_kernels
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
    ell_kernels.reset_launch_counts()
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
    ell_launches = dict(ell_kernels.LAUNCHES)
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
        launches=launches, launches_3e=phase3e["launches"], ell_launches=ell_launches,
        dense_launches=dense_launches,
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
    if (launches["sparse_fused"] != phase3e["launches"]["sparse_fused"] or any(dense_launches.values())
            or not ell_launches["ell_rmatvec"]):
        failures.append(f"launches {launches} / ell {ell_launches} / dense {dense_launches} against "
                        f"phase 3e's {phase3e['launches']}")
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
    return {"sparse": launches, "dense": dense_launches, "ell": ell_launches}, fit


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
    from photon_ml_tpu_torch.utils import telemetry

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
    # The run's journal and profile, read back as a user reads them.
    journal_exit, journal_text = obs_main(["journal", os.path.join(out, "journal.jsonl"), "--validate"])
    journal = {}
    for etype in journal_types(os.path.join(out, "journal.jsonl")):
        journal[etype] = journal.get(etype, 0) + 1
    profile = telemetry.read_profile(os.path.join(out, "profile.json"), kind="fit")
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
        launches_score=sparse_s, dense_launches_score=dense_s, mem_gib_score=mem_s,
        journal_validate_exit=journal_exit, journal=journal, profile_topology=profile["device_topology"],
        profile_dispatch=profile["dispatch"], profile_bucket_shapes=profile["bucket_shapes"])
    log(json.dumps(row))
    failures = []
    if journal_exit or journal != {"setup": 1, "fit_start": 1, "sweep_config": 1, "coordinate_update": 3,
                                   "fit_finish": 1}:
        failures.append(f"journal: exit {journal_exit}, {journal}: {journal_text}")
    if profile["fit_timing"] != summary["fit_timing"] \
            or profile["device_topology"]["device_kind"] != torch.cuda.get_device_name(0):
        failures.append(f"profile: fit_timing {profile['fit_timing']} against {summary['fit_timing']}, "
                        f"topology {profile['device_topology']}")
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
            "dense": {k: dense_t[k] + dense_s[k] for k in dense_t}, "train": sparse_t}


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


# ------------------------------------------------- phases 3o, 3k, 5k, 3g, 5g
#
# The optimizers' other modes (OWLQN, box, FULL variances), checkpoint and
# resume, and the legacy single-GLM driver.

def close_arrays(a, b) -> dict:
    """Largest |a - b|, bit equality, and a within PORT_TOLERANCES
    ["checkpoint_resume"] (the JAX package's kill-and-resume bound) of b."""
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return dict(err=float(np.abs(a - b).max()), bit_equal=bool(np.array_equal(a, b)),
                within=bool(np.allclose(a, b, **PORT_TOLERANCES["checkpoint_resume"])))


def close_game_models(a, b) -> dict:
    """close_arrays of two GameModels' coefficients, by coordinate."""
    out = {}
    for cid, m in a.models.items():
        x = m.coefficients_matrix if hasattr(m, "coefficients_matrix") else m.coefficients.means
        o = b.models[cid]
        y = o.coefficients_matrix if hasattr(o, "coefficients_matrix") else o.coefficients.means
        out[cid] = close_arrays(x.cpu(), y.cpu())
    return out


def optimizer_modes_phase(ds, cfg_f) -> dict:
    """Phase 3o on phase 3's dense fixed effect (1,048,576 x 512, stored
    bf16): L1 through OWLQN, a wildcard box resolved from its JSON string
    (upperBound 0.5 as written, and 0.05, which binds), and FULL variances
    at D = 512 (margins on the plain route: a dense matrix has no margin
    kernel). Returns the launches by kernel."""
    import dataclasses

    import torch

    from photon_ml_tpu_torch.data.containers import LabeledData
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optimize import problem
    from photon_ml_tpu_torch.optimize.config import L1, OptimizerConfig
    from photon_ml_tpu_torch.optimize.constraints import bounds_arrays, create_constraint_feature_map
    from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

    task = TaskType.LOGISTIC_REGRESSION
    d = ds.shards["global"].shape[-1]
    imap = IndexMap.from_feature_names([f"f{j}" for j in range(d)])
    runs, failures, launches = {}, [], {}

    def add(dense):
        for k, v in dense.items():
            launches[k] = launches.get(k, 0) + v

    modes = {"l1": dataclasses.replace(cfg_f, regularization=L1, reg_weight=1e4)}
    for ub in (0.5, 0.05):
        box = bounds_arrays(create_constraint_feature_map(
            json.dumps([{"name": "*", "term": "*", "upperBound": ub}]), imap), imap.size)
        modes[f"box_ub{ub}"] = dataclasses.replace(
            cfg_f, optimizer=dataclasses.replace(cfg_f.optimizer, box_constraints=box))
    for name, cfg in modes.items():
        coord = FixedEffectCoordinate(ds, "global", cfg, task)
        t0 = time.perf_counter()
        (model, res), _, dense, mem = counted(torch, lambda: coord.train(ds.offsets))
        wall = time.perf_counter() - t0
        add(dense)
        w = model.coefficients.means
        row = dict(phase="3o", mode=name, n=int(ds.num_samples), d=d, wall_s=wall,
                   iterations=int(res.iterations), fn_evals=int(res.fn_evals), reason=int(res.reason),
                   loss=float(res.loss), zeros=int((w == 0).sum()), value_grad_launches=dense["value_grad"],
                   peak_gib=mem["peak"])
        if name.startswith("box"):
            upper = torch.as_tensor(cfg.optimizer.box_constraints[1], device=w.device)
            row["max_bound_violation"] = float(torch.clamp_min(w - upper, 0.0).max())
            row["at_bound"] = int((w == upper).sum())
            if row["max_bound_violation"] != 0.0:
                failures.append(f"{name}: the bound is violated by {row['max_bound_violation']}")
            if name == "box_ub0.05" and not row["at_bound"]:
                failures.append(f"{name}: no coefficient at the bound")
        elif not 0 < row["zeros"] < d:
            failures.append(f"l1: {row['zeros']} zeros of {d}")
        if not dense["value_grad"] or dense["value_grad"] != row["fn_evals"] \
                or not bool(torch.isfinite(w).all()):
            failures.append(f"{name}: {dense['value_grad']} value_grad launches for {row['fn_evals']} "
                            f"objective passes, or non-finite coefficients")
        log(json.dumps(row))
        runs[name] = w
    # FULL variances at D = 512 on the bf16-stored X, at the L1 solution.
    coord = FixedEffectCoordinate(ds, "global", cfg_f, task)
    data = LabeledData(coord.training_features, ds.labels, ds.offsets, ds.weights)
    full = dataclasses.replace(cfg_f, variance_computation=VarianceComputationType.FULL)
    t0 = time.perf_counter()
    var, _, dense, mem = counted(torch, lambda: problem.compute_variances(LOGISTIC, data, full, runs["l1"]))
    row = dict(phase="3o", mode="full_variance", d=d, seconds=time.perf_counter() - t0,
               peak_gib=mem["peak"], base_gib=mem["base"], launches=dense,
               finite_positive=bool(torch.isfinite(var).all() and (var > 0).all()))
    log(json.dumps(row))
    if not row["finite_positive"] or var.shape != (d,):
        failures.append("FULL variances are not finite positive (D,) values")
    if failures:
        raise SystemExit("phase 3o failed: " + "; ".join(failures))
    return launches


def checkpoint_phase(root: str, work: str) -> dict:
    """Phases 3k and 5k on phase 3e's files, and 3o's FULL variances of the
    e2e fixed effect. Returns the sparse launches by kernel."""
    import os

    import torch

    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.data.containers import LabeledData
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.game import checkpoint as ckpt_mod
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate
    from photon_ml_tpu_torch.io import model_store
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optimize import problem
    from photon_ml_tpu_torch.optimize.config import CoordinateOptimizationConfig
    from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

    task = TaskType.LOGISTIC_REGRESSION
    failures, launches = [], {}

    def add(sparse):
        for k, v in sparse.items():
            launches[k] = launches.get(k, 0) + v

    # Every checkpoint save and load is timed (the class's methods wrapped).
    saves, loads = [], []
    save0, load0 = ckpt_mod.CoordinateDescentCheckpoint.save, ckpt_mod.CoordinateDescentCheckpoint.load

    def timed_save(self, **kw):
        t = time.perf_counter()
        save0(self, **kw)
        saves.append(time.perf_counter() - t)

    def timed_load(self, *a, **kw):
        t = time.perf_counter()
        out = load0(self, *a, **kw)
        loads.append(time.perf_counter() - t)
        return out

    ckpt_mod.CoordinateDescentCheckpoint.save = timed_save
    ckpt_mod.CoordinateDescentCheckpoint.load = timed_load
    try:
        # ---- 3k through cli.train, on part 0 of 3e's files: one sweep
        # checkpointed, a resume to the second, against an uninterrupted
        # two-sweep run.
        part, part_rows = os.path.join(root, "part-0.avro"), E2E_ROWS // 2

        def train(out, iterations, extra=()):
            return counted(torch, lambda: train_cli.main([
                "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", part,
                "--root-output-directory", out, "--override-output-directory",
                "--feature-shard-configurations", E2E_SHARD, "--coordinate-configurations",
                *E2E_COORDINATES, "--coordinate-descent-iterations", str(iterations),
                "--output-mode", "BEST", "--logging-level", "WARNING", *extra]))

        ck_driver = os.path.join(work, "ck-driver")
        walls = {}
        for name, its, extra in (("straight", 2, ()), ("sweep1", 1, ("--checkpoint-directory", ck_driver)),
                                 ("resume", 2, ("--checkpoint-directory", ck_driver))):
            n_saves = len(saves)
            t0 = time.perf_counter()
            summary, sparse, _, _ = train(os.path.join(work, f"k-{name}"), its, extra)
            walls[name] = dict(wall_s=time.perf_counter() - t0, timings_s=summary["timings_s"],
                               save_s=saves[n_saves:], fused=sparse["sparse_fused"])
            add(sparse)
        best = {k: os.path.join(work, f"k-{k}", "models", "best") for k in ("straight", "resume")}
        imaps = {"g": IndexMap.load(os.path.join(best["straight"], "feature-indexes", "g.json"))}
        arts = {k: model_store.load_game_model(v, imaps) for k, v in best.items()}
        vs = {}
        for cid in arts["straight"].coordinates:
            a, b = arts["resume"].coordinates[cid], arts["straight"].coordinates[cid]
            if hasattr(a, "entity_ids") and a.entity_ids != b.entity_ids:
                vs[cid] = dict(err=float("inf"), bit_equal=False, within=False)
            else:
                vs[cid] = close_arrays(a.means, b.means)
        row = dict(phase="3k", path="cli.train", rows=part_rows, runs=walls, resume_vs_straight=vs,
                   load_s=loads[-1:], checkpoint_mib=dir_mib(ck_driver))
        log(json.dumps(row))
        if len(walls["sweep1"]["save_s"]) != 3 or len(walls["resume"]["save_s"]) != 3:
            failures.append(f"driver: {len(walls['sweep1']['save_s'])} + {len(walls['resume']['save_s'])} "
                            "checkpoint saves for 3 + 3 updates")
        if not all(v["within"] for v in vs.values()):
            failures.append(f"driver resume against the uninterrupted fit: {vs}")

        # ---- 3k through GameEstimator.fit: killed in sweep 2 at the fixed
        # effect, resumed by a new estimator on a new read of the files.
        fe_cfg, re_cfg = e2e_configs()
        cfgs = {"global": fe_cfg, **{c: re_cfg for c in E2E_RE}}
        ck_est = os.path.join(work, "ck-estimator")

        def estimator(ck=None):
            est = e2e_estimator(task)
            est.cd_iterations = 2
            est.checkpoint_dir = ck
            return est

        train0 = FixedEffectCoordinate.train
        calls = {"n": 0}

        def dying(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("simulated preemption")
            return train0(self, *a, **kw)

        ds = read_e2e(root, "cuda")
        FixedEffectCoordinate.train = dying
        n_saves = len(saves)
        t0 = time.perf_counter()
        try:
            estimator(ck_est).fit(ds, None, [cfgs])
            failures.append("the kill switch did not fire")
        except RuntimeError as exc:
            if "simulated preemption" not in str(exc):
                raise
        finally:
            FixedEffectCoordinate.train = train0
        killed = dict(wall_s=time.perf_counter() - t0, save_s=saves[n_saves:])
        with open(os.path.join(ck_est, "config-0", "state.json")) as f:
            killed["completed_steps"] = json.load(f)["completed_steps"]
        del ds
        gc.collect()
        torch.cuda.empty_cache()
        ds = read_e2e(root, "cuda")
        n_saves, n_loads = len(saves), len(loads)
        t0 = time.perf_counter()
        resumed, sparse, _, mem = counted(torch, lambda: estimator(ck_est).fit(ds, None, [cfgs])[0])
        add(sparse)
        resumed_s = time.perf_counter() - t0
        resumed_saves, resumed_loads = saves[n_saves:], loads[n_loads:]
        straight = estimator().fit(ds, None, [cfgs])[0]
        vs = close_game_models(resumed.model, straight.model)
        row = dict(phase="3k", path="GameEstimator.fit", rows=E2E_ROWS, killed=killed,
                   resume_wall_s=resumed_s, resume_save_s=resumed_saves, resume_load_s=resumed_loads,
                   checkpoint_mib=dir_mib(ck_est), resumed_vs_straight=vs, launches_resume=sparse,
                   peak_gib=mem["peak"])
        log(json.dumps(row))
        if killed["completed_steps"] != 3 or len(resumed_saves) != 3:
            failures.append(f"estimator: killed at step {killed['completed_steps']} (want 3), "
                            f"{len(resumed_saves)} saves on resume (want 3)")
        if not all(v["within"] for v in vs.values()) or not sparse["sparse_fused"]:
            failures.append(f"estimator resume against the uninterrupted fit: {vs}, launches {sparse}")

        # ---- 3o on the e2e fixed effect: FULL variances at D = 201, the
        # margins through the X w kernel.
        layout = ds.sparse_layout("g")
        data = LabeledData(layout, ds.labels, ds.offsets, ds.weights)
        full = CoordinateOptimizationConfig(regularization=fe_cfg.regularization, reg_weight=fe_cfg.reg_weight,
                                            variance_computation=VarianceComputationType.FULL)
        w = resumed.model["global"].coefficients.means
        t0 = time.perf_counter()
        var, sparse, _, mem = counted(torch, lambda: problem.compute_variances(LOGISTIC, data, full, w))
        add(sparse)
        row = dict(phase="3o", mode="full_variance_e2e", rows=E2E_ROWS, d=int(w.shape[0]),
                   seconds=time.perf_counter() - t0, peak_gib=mem["peak"], base_gib=mem["base"],
                   launches=sparse, finite_positive=bool(torch.isfinite(var).all() and (var > 0).all()))
        log(json.dumps(row))
        if not row["finite_positive"] or not sparse["sparse_matvec"]:
            failures.append(f"e2e FULL variances: finite positive {row['finite_positive']}, launches {sparse}")
        del layout, data, var
        card_models = resumed.model
        del ds, straight
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 5k: the card's checkpoint through the port on the CPU.
        t0 = time.perf_counter()
        state = ckpt_mod.CoordinateDescentCheckpoint(os.path.join(ck_est, "config-0")).load(task, device="cpu")
        load_cpu_s = time.perf_counter() - t0
        from photon_ml_tpu_torch.game.model import GameModel

        loaded = close_game_models(GameModel(state.models), card_models)
        ds_cpu = read_e2e(root, "cpu")
        t0 = time.perf_counter()
        cpu_fit = estimator(ck_est).fit(ds_cpu, None, [cfgs])[0]
        cpu_resume_s = time.perf_counter() - t0
        on_cpu = close_game_models(cpu_fit.model, card_models)
        row = dict(phase="5k", completed_steps=state.completed_steps, load_cpu_s=load_cpu_s,
                   loaded_vs_card=loaded, cpu_resume_s=cpu_resume_s, cpu_resume_vs_card=on_cpu,
                   cpu_model_device=str(cpu_fit.model["global"].coefficients.means.device))
        log(json.dumps(row))
        if not all(v["bit_equal"] for v in loaded.values()) or not all(v["bit_equal"] for v in on_cpu.values()) \
                or row["cpu_model_device"] != "cpu" or state.completed_steps != 6:
            failures.append(f"5k: the card's checkpoint on the CPU: {row}")
        del ds_cpu, cpu_fit

        # ---- 3k: the fixed effect alone with ELASTIC_NET through the driver,
        # on part 0.
        out = os.path.join(work, "k-elastic-net")
        t0 = time.perf_counter()
        summary, sparse, dense, _ = counted(torch, lambda: train_cli.main([
            "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", part,
            "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
            "--coordinate-configurations",
            "name=global,feature.shard=g,optimizer=LBFGS,tolerance=1e-6,max.iter=10,"
            f"regularization=ELASTIC_NET,reg.alpha=0.5,reg.weights={part_rows // 200}",
            "--output-mode", "BEST", "--logging-level", "WARNING"]))
        add(sparse)
        art = model_store.load_game_model(os.path.join(out, "models", "best"), imaps)
        means = art.coordinates["global"].means
        row = dict(phase="3k", path="elastic_net", rows=part_rows, wall_s=time.perf_counter() - t0,
                   reg_weight=part_rows // 200,
                   alpha=0.5, nonzeros=int((means != 0).sum()), d=int(means.shape[0]),
                   sparse_fused=sparse["sparse_fused"], timings_s=summary["timings_s"])
        log(json.dumps(row))
        if not sparse["sparse_fused"] or any(dense.values()) or not 0 < row["nonzeros"] < row["d"]:
            failures.append(f"elastic net: {row['nonzeros']} nonzeros, launches {sparse} / {dense}")
    finally:
        ckpt_mod.CoordinateDescentCheckpoint.save = save0
        ckpt_mod.CoordinateDescentCheckpoint.load = load0
    if failures:
        raise SystemExit("phase 3k/5k failed: " + "; ".join(failures))
    return launches


def legacy_driver_e2e_phase(root: str, work: str, truth, n_users: int, n_movies: int) -> dict:
    """Phase 3g: cli.glm_driver on phase 3e's 4,000,000-row files, validated
    on 1,000,000 rows (E2E_ROWS / 4) of the same model (another seed's rows, labelled by
    3e's weights and effects), written by the port's columnar writer; the
    default L2 sweep and an L1 fit. Then the sweep itself by TRON with
    SIMPLE variances on the same layout. Returns the sparse launches."""
    import os

    import torch

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.data.containers import LabeledData
    from photon_ml_tpu_torch.models.training import train_glm_sweep
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    val_dir = os.path.join(work, "validation")
    os.makedirs(val_dir)
    t0 = time.perf_counter()
    val_rows = E2E_ROWS // 4
    val_mb = write_e2e_files(val_dir, e2e_arrays(val_rows, seed=24, n_users=n_users, n_movies=n_movies,
                                                 truth=truth))
    val_write_s = time.perf_counter() - t0
    failures, launches = [], {}

    def add(sparse):
        for k, v in sparse.items():
            launches[k] = launches.get(k, 0) + v

    for name, extra in (("l2_sweep", []), ("l1", ["--regularization-type", "L1", "--regularization-weights", "1"])):
        out = os.path.join(work, f"glm-{name}")
        t0 = time.perf_counter()
        summary, sparse, dense, mem = counted(torch, lambda: glm_driver.main([
            "--training-data-directory", root, "--validate-data-directory", val_dir,
            "--output-directory", out, "--format", "TRAINING_EXAMPLE", "--max-iterations", "50",
            "--logging-level", "WARNING", *extra]))
        add(sparse)
        metrics = summary["validation_metrics"]
        row = dict(phase="3g", run=name, rows=E2E_ROWS, validation_rows=val_rows,
                   validation_write_s=val_write_s, validation_mb=val_mb, wall_s=time.perf_counter() - t0,
                   timings_s=summary["timings_s"], iterations=summary["iterations"],
                   auc={rw: m["Area under ROC"] for rw, m in metrics.items()},
                   best_weight=summary["best_regularization_weight"], stages=summary["stages"],
                   sparse_fused=sparse["sparse_fused"], sparse_matvec=sparse["sparse_matvec"],
                   dense_launches=dense, peak_gib=mem["peak"])
        log(json.dumps(row))
        if not sparse["sparse_fused"] or not sparse["sparse_matvec"] or any(dense.values()) \
                or summary["stages"][-1] != "VALIDATED" or not all(a > 0.5 for a in row["auc"].values()):
            failures.append(f"{name}: {row}")

    # The sweep by TRON with SIMPLE variances on the same layout: the
    # Hessian-vector products compose X w and X^T u, the variances X^T u squared.
    ds = read_e2e(root, "cuda")
    data = LabeledData(ds.sparse_layout("g"), ds.labels, ds.offsets, ds.weights)
    cfg = CoordinateOptimizationConfig(optimizer=OptimizerConfig(OptimizerType.TRON, 15, 1e-6),
                                       regularization=L2, variance_computation=VarianceComputationType.SIMPLE)
    t0 = time.perf_counter()
    sweep, sparse, dense, _ = counted(torch, lambda: train_glm_sweep(
        data, TaskType.LOGISTIC_REGRESSION, cfg, [10.0, 1.0]))
    add(sparse)
    variances = [m.coefficients.variances for m in sweep.models.values()]
    row = dict(phase="3g", run="tron_simple_variances", wall_s=time.perf_counter() - t0, launches=sparse,
               iterations={str(k): int(r.iterations) for k, r in sweep.results.items()},
               fn_evals={str(k): int(r.fn_evals) for k, r in sweep.results.items()},
               variances_finite_positive=all(bool(torch.isfinite(v).all() and (v > 0).all()) for v in variances))
    log(json.dumps(row))
    if not all(sparse[k] for k in ("sparse_fused", "sparse_matvec", "sparse_rmatvec")) \
            or not row["variances_finite_positive"] or any(dense.values()):
        failures.append(f"TRON sweep: {row}")
    del ds, data
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("phase 3g failed: " + "; ".join(failures))
    return launches


# ----------------------------------------------------------------------- phase 3j
#
# The training driver's telemetry at full width: the run journal, the trace
# and the run profile, and the checkpoint's staged model write, which
# overlaps each step's model write with that step's validation.

def obs_main(argv) -> tuple:
    """`python -m photon_ml_tpu_torch.cli.obs argv` in process: (exit code,
    standard output)."""
    import contextlib
    import io

    from photon_ml_tpu_torch.cli import obs

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = obs.main(argv)
    return code, out.getvalue()


def journal_types(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["type"] for line in f if line.strip()]


def model_counts(best: str) -> dict:
    """A saved e2e model's entities by random effect and its shard's columns."""
    import os

    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store

    imap = IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))
    art = model_store.load_game_model(best, {"g": imap})
    return dict(entities={cid: len(art.coordinates[cid].entity_ids) for cid in E2E_RE}, columns=imap.size)


def telemetry_phase(root: str, work: str) -> dict:
    """Phase 3j: 3c's cli.train on part 0 of 3e's files (2,000,000 rows,
    every user, movie and column of 3e's, checked against 3c's run), with
    3g's validation file and a checkpoint directory, twice: (A) traced with
    the staged write on (PHOTON_TRACE=1 PHOTON_PIPELINE=1), (B) untraced
    with it off (PHOTON_PIPELINE=0). The saved models and state.json's
    checksums must be bit-equal, both journals valid and alike, A's trace
    cover 90% of its wall with one `ckpt_write` span a step on the writer
    thread, B stage no write, and both launch the sparse kernels and no
    dense one. Returns the launches of both runs by kernel."""
    import os

    import torch

    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.game import checkpoint as ckpt_mod
    from photon_ml_tpu_torch.io import model_store
    from photon_ml_tpu_torch.utils import telemetry

    part = os.path.join(root, "part-0.avro")
    val_dir = os.path.join(work, "validation")
    saves, staged = [], []
    save0 = ckpt_mod.CoordinateDescentCheckpoint.save
    begin0 = ckpt_mod.CoordinateDescentCheckpoint.begin_model_write

    def timed_save(self, **kw):
        t = time.perf_counter()
        save0(self, **kw)
        saves.append(dict(step=kw["completed_steps"], save_s=time.perf_counter() - t,
                          staged=kw.get("staged") is not None))

    def counted_begin(self, **kw):
        staged.append(kw["completed_steps"])
        return begin0(self, **kw)

    runs, failures, launches = {}, [], {"sparse": {}, "dense": {}}
    ckpt_mod.CoordinateDescentCheckpoint.save = timed_save
    ckpt_mod.CoordinateDescentCheckpoint.begin_model_write = counted_begin
    env0 = {k: os.environ.get(k) for k in ("PHOTON_TRACE", "PHOTON_PIPELINE")}
    try:
        for name, env in (("A", {"PHOTON_TRACE": "1", "PHOTON_PIPELINE": "1"}),
                          ("B", {"PHOTON_TRACE": "0", "PHOTON_PIPELINE": "0"})):
            os.environ.update(env)
            out, ck = os.path.join(work, f"j-{name}"), os.path.join(work, f"j-{name}-ckpt")
            n_saves, n_staged = len(saves), len(staged)
            t0 = time.perf_counter()
            summary, sparse, dense, mem = counted(torch, lambda: train_cli.main([
                "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", part,
                "--validation-data-directories", val_dir, "--root-output-directory", out,
                "--feature-shard-configurations", E2E_SHARD, "--coordinate-configurations",
                *E2E_COORDINATES, "--coordinate-descent-iterations", "1", "--validation-evaluators",
                "AUC", "--checkpoint-directory", ck, "--output-mode", "BEST",
                "--logging-level", "WARNING"]))
            wall = time.perf_counter() - t0
            for k, v in sparse.items():
                launches["sparse"][k] = launches["sparse"].get(k, 0) + v
            for k, v in dense.items():
                launches["dense"][k] = launches["dense"].get(k, 0) + v
            code, text = obs_main(["journal", os.path.join(out, "journal.jsonl"), "--validate"])
            profile = telemetry.read_profile(os.path.join(out, "profile.json"), kind="fit")
            with open(os.path.join(ck, "config-0", "state.json")) as f:
                state = json.load(f)
            runs[name] = dict(
                phase="3j", run=name, env=env, rows=summary["num_samples"], wall_s=wall,
                timings_s=summary["timings_s"], fit_s=summary["timings_s"]["train explicit configurations"],
                saves=saves[n_saves:], staged_steps=staged[n_staged:], launches=sparse, dense_launches=dense,
                peak_gib=mem["peak"], journal_validate_exit=code, journal=journal_types(
                    os.path.join(out, "journal.jsonl")), **model_counts(os.path.join(out, "models", "best")),
                auc=summary["best_evaluation"]["AUC"], pipeline=profile["dispatch"]["pipeline"],
                checksums=state["checksums"], card=card_line())
    finally:
        ckpt_mod.CoordinateDescentCheckpoint.save = save0
        ckpt_mod.CoordinateDescentCheckpoint.begin_model_write = begin0
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    a, b = runs["A"], runs["B"]
    trace_path = os.path.join(work, "j-A", "trace.json")
    with open(trace_path) as f:
        doc = json.load(f)
    threads = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    writes = [threads.get(e["tid"]) for e in spans if e["name"] == "ckpt_write"]
    coverage_code, coverage_text = obs_main(["trace", trace_path, "--min-coverage", "90"])
    a.update(spans=len(spans), trace_mib=os.path.getsize(trace_path) / 2**20, ckpt_write_threads=writes,
             trace_summary=coverage_text.splitlines()[:2], trace_exit=coverage_code)
    b["trace_written"] = os.path.exists(os.path.join(work, "j-B", "trace.json"))
    counts_3e = model_counts(os.path.join(root, "drivers", "train", "models", "best"))
    imaps = {"g": IndexMap.load(os.path.join(work, "j-A", "models", "best", "feature-indexes", "g.json"))}
    models = {k: model_store.load_game_model(os.path.join(work, f"j-{k}", "models", "best"), imaps)
              for k in ("A", "B")}
    bits = same_model(models["A"], models["B"])
    for row in (a, b):
        log(json.dumps(row))
    log(json.dumps(dict(phase="3j", run="A vs B", fit_s=[a["fit_s"], b["fit_s"]], wall_s=[a["wall_s"], b["wall_s"]],
                        save_s=[[s["save_s"] for s in r["saves"]] for r in (a, b)], models_bit_equal=bits,
                        counts=dict(entities=a["entities"], columns=a["columns"]), counts_3e=counts_3e)))
    lifecycle = ["setup", "fit_start", "sweep_config"] + ["coordinate_update", "checkpoint"] * 3 + ["fit_finish"]
    if dict(entities=a["entities"], columns=a["columns"]) != counts_3e:
        failures.append(f"part 0 lacks an entity or column of 3e's files: {a['entities']}, {a['columns']} "
                        f"against {counts_3e}")
    if not all(v["bit_equal"] for v in bits.values()) or a["checksums"] != b["checksums"]:
        failures.append(f"the staged write moved bits: {bits}, checksums equal {a['checksums'] == b['checksums']}")
    if a["journal_validate_exit"] or b["journal_validate_exit"] or a["journal"] != lifecycle \
            or b["journal"] != lifecycle:
        failures.append(f"journals: exits {a['journal_validate_exit']}/{b['journal_validate_exit']}, "
                        f"{a['journal']} / {b['journal']}")
    if coverage_code or writes != ["photon-ckpt-write"] * 3 or a["staged_steps"] != [1, 2, 3] \
            or b["staged_steps"] or b["trace_written"] or not a["pipeline"] or b["pipeline"]:
        failures.append(f"trace exit {coverage_code}, ckpt_write threads {writes}, staged steps "
                        f"{a['staged_steps']} / {b['staged_steps']}, B traced {b['trace_written']}")
    for r in (a, b):
        if not r["launches"]["sparse_fused"] or not r["launches"]["sparse_matvec"] \
                or any(r["dense_launches"].values()):
            failures.append(f"{r['run']}: launches {r['launches']} / {r['dense_launches']}")
    if failures:
        raise SystemExit("phase 3j failed: " + "; ".join(failures))
    return launches


# ---------------------------------------------------------- phases 3x, 3x-scale, 3t
#
# The off-heap index stores (cli.build_index, --offheap-indexmap-dir) and the
# train driver's hyperparameter tuning, on phase 3e's files.

# format, partitions (PHIDX with 1 partition dropped for 3p's time: 8 partitions cover the format)
OFFHEAP_STORES = (("phidx", 8), ("paldb", 4))
SCALE_KEYS = 1 << 18  # 262,144 synthetic name\x01term keys (PHIDX); cut from 4,194,304 for the time limit (by halves, for 3j, 3r, 3n and 3p)
SCALE_PALDB_KEYS = 1 << 16  # PalDB's writer and reader are pure Python: cut to 65,536 (from 131,072 for 3p's time)
TUNING_TRIALS = 2  # a mode (cut from 4, with 3x-scale and 3mv, for 3n's time; from 3 for 3w-sg's)
EXPLICIT_WEIGHTS = {"global": 1.0, "per-user": 10.0, "per-movie": 10.0}  # E2E_COORDINATES' reg.weights


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def e2e_readings(ds, pairs: dict) -> dict:
    """Models of the e2e cell held to a base model on `ds` (a read of the
    cell's files onto the card, in the artifacts' feature ids), on the card
    in float64: for each name of `pairs` ({name: (base, model)} artifacts),
    each random effect's largest relative gap on each entity's objective at
    the base's offsets (`gaps`), and the model's and the base's training AUCs."""
    import torch

    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig, build_random_effect_dataset
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.ops.losses import LOGISTIC

    if sorted(ds.shards) != ["g"]:
        raise SystemExit(f"the e2e read has shards {sorted(ds.shards)}")
    g = ds.shards["g"]
    dev = g.values.device
    reds = {cid: build_random_effect_dataset(ds, RandomEffectDataConfig(tag, "g", active_upper_bound=cap,
                                                                        min_bucket=8))
            for cid, (tag, cap) in E2E_RE.items()}

    def matrix(coord, red):
        """An artifact's (E, D) means as the (E + 1, D) matrix of `red`'s rows."""
        keys = sorted(red.entity_index, key=red.entity_index.get)
        art = {k: i for i, k in enumerate(coord.entity_ids)}
        src = np.fromiter((art.get(str(k), -1) for k in keys), np.int64, count=len(keys))
        out = np.zeros((len(keys) + 1, g.dim), np.float32)
        out[np.flatnonzero(src >= 0)] = np.asarray(coord.means, np.float32)[src[src >= 0]]
        return torch.from_numpy(out).to(dev)

    def scores(w_rows):  # (N, K) gathered coefficients times the values
        return (g.values * w_rows).sum(dim=1)

    idx = g.indices.long()
    rows = {cid: red.sample_entity_rows.long()[:, None] for cid, red in reds.items()}

    def parts(model):
        fe = torch.as_tensor(np.asarray(model.coordinates["global"].means, np.float32), device=dev)
        re = {cid: matrix(model.coordinates[cid], red) for cid, red in reds.items()}
        return fe, re, {"global": scores(fe[idx]),
                        **{cid: scores(re[cid][rows[cid], idx]) for cid in reds}}

    def auc(s):
        return float(area_under_roc_curve(ds.offsets + sum(s.values()), ds.labels))

    out = {}
    for name, (base, model) in pairs.items():
        _, base_re, base_s = parts(base)
        _, model_re, model_s = parts(model)
        offsets = {"per-user": ds.offsets + base_s["global"]}
        offsets["per-movie"] = offsets["per-user"] + base_s["per-user"]
        out[name] = dict(gaps={cid: re_objective_gap(ds, red, offsets[cid], LOGISTIC, 10.0, model_re[cid],
                                                     base_re[cid]) for cid, red in reds.items()},
                         auc=auc(model_s), base_auc=auc(base_s))
    del reds
    gc.collect()
    torch.cuda.empty_cache()
    return out


def offheap_re_gaps(root: str, c3_map, c3_model, models: dict) -> dict:
    """Each random effect of each model (artifacts read through 3c's map)
    against 3c's, on each entity's objective at 3c's offsets (`e2e_readings`
    on a new read of the files, in 3c's feature ids): {store: {cid: largest
    relative gap}}."""
    ds = read_e2e(root, "cuda")
    readings = e2e_readings(ds, {name: (c3_model, m) for name, m in models.items()})
    return {name: r["gaps"] for name, r in readings.items()}


def offheap_phase(root: str, work: str) -> dict:
    """Phase 3x: cli.build_index on phase 3e's training files twice
    (PHIDX with 8 partitions, PalDB with 4), then phase 3c's cli.train
    and cli.score command lines through each store. Each model must equal
    3c's by feature name within PORT_TOLERANCES["offheap_index"]: bit-equal
    where the store numbers the features as 3c's map does; else the fixed
    effect and each random effect on its coefficients, or, where a lane
    moved past them, on each entity's objective; the scoring AUC too.
    Returns the sparse launches by kernel."""
    import json as _json
    import os

    import torch

    from photon_ml_tpu_torch.cli import build_index
    from photon_ml_tpu_torch.cli import score as score_cli
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store, score_store

    tol = PORT_TOLERANCES["offheap_index"]
    c3 = os.path.join(root, "drivers")
    c3_best = os.path.join(c3, "train", "models", "best")
    c3_map = IndexMap.load(os.path.join(c3_best, "feature-indexes", "g.json"))
    c3_model = model_store.load_game_model(c3_best, {"g": c3_map})
    with open(os.path.join(c3, "score", "scoring-summary.json")) as f:
        c3_auc = _json.load(f)["evaluation"]["AUC"]
    c3_scores = score_store.load_score_columns(os.path.join(c3, "score", "scores")).scores
    failures, launches, rows, models = [], {}, {}, {}
    for fmt, parts in OFFHEAP_STORES:
        name = f"{fmt}-{parts}"
        idx = os.path.join(work, f"index-{name}")
        t0 = time.perf_counter()
        build_index.main(["--input-data-directories", root, "--feature-shard-configurations", E2E_SHARD,
                          "--num-partitions", str(parts), "--output-dir", idx, "--output-format", fmt])
        build_s = time.perf_counter() - t0
        out = os.path.join(work, f"train-{name}")
        summary, sparse_t, dense_t, mem_t = counted(torch, lambda: train_cli.main([
            "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
            "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
            "--coordinate-configurations", *E2E_COORDINATES, "--coordinate-descent-iterations", "1",
            "--output-mode", "BEST", "--logging-level", "WARNING", "--offheap-indexmap-dir", idx]))
        best = os.path.join(out, "models", "best")
        scored = os.path.join(work, f"score-{name}")
        ssum, sparse_s, dense_s, mem_s = counted(torch, lambda: score_cli.main([
            "--input-data-directories", root, "--model-input-directory", best,
            "--root-output-directory", scored, "--feature-shard-configurations", E2E_SHARD,
            "--evaluators", "AUC", "--logging-level", "WARNING", "--offheap-indexmap-dir", idx]))
        for k, v in sparse_t.items():
            launches[k] = launches.get(k, 0) + v + sparse_s[k]
        shipped = IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))
        # Read back through 3c's map: both models in 3c's feature ids, by name.
        models[name] = model_store.load_game_model(best, {"g": c3_map})
        scores = score_store.load_score_columns(os.path.join(scored, "scores")).scores
        rows[name] = dict(
            phase="3x", store=fmt, partitions=parts, build_index_s=build_s, store_mib=dir_mib(idx),
            intercept_id=shipped.intercept_index, intercept_id_3c=c3_map.intercept_index,
            same_ids_as_3c=dict(shipped.items()) == dict(c3_map.items()), train_timings_s=summary["timings_s"],
            score_timings_s=ssum["timings_s"], model_vs_3c=same_model(models[name], c3_model),
            score_err_vs_3c=(float(np.abs(scores - c3_scores).max()) if len(scores) == len(c3_scores)
                             else float("inf")),
            auc=ssum["evaluation"]["AUC"], auc_3c=c3_auc, tol=tol, launches_train=sparse_t,
            launches_score=sparse_s, dense_launches=[dense_t, dense_s], mem_gib_train=mem_t, card=card_line())
        if not sparse_t["sparse_fused"] or not sparse_s["sparse_matvec"] or any(dense_t.values()) \
                or any(dense_s.values()):
            failures.append(f"{name}: launches train {sparse_t} / {dense_t}, score {sparse_s} / {dense_s}")
    t0 = time.perf_counter()
    gaps = offheap_re_gaps(root, c3_map, c3_model, models)
    gaps_s = time.perf_counter() - t0
    for name, row in rows.items():
        vs = row["model_vs_3c"]
        row.update(re_objective_gap_vs_3c=gaps[name], objective_check_s=gaps_s)
        if row["same_ids_as_3c"]:
            held = {cid: "bits" if v["bit_equal"] else "failed" for cid, v in vs.items()}
        else:
            held = {cid: "coefficients" if v["err"] <= tol["coef_atol"] else
                    "objective" if cid in gaps[name] and gaps[name][cid] <= tol["re_objective_rtol"] else "failed"
                    for cid, v in vs.items()}
        row["held_on"] = held
        log(json.dumps(row))
        if "failed" in held.values():
            failures.append(f"{name}: the model is not 3c's by feature name ({held}, {vs}, {gaps[name]})")
        if not abs(row["auc"] - c3_auc) <= tol["auc_atol"]:
            failures.append(f"{name}: scoring AUC {row['auc']} against 3c's {c3_auc}")
    if failures:
        raise SystemExit("phase 3x failed: " + "; ".join(failures))
    return launches


def offheap_scale_phase(work: str) -> None:
    """Phase 3x-scale, on the host: a PHIDX store of SCALE_KEYS synthetic
    name\\x01term keys in 8 partitions (build, a get_index sweep of every
    key, a get_feature_name sweep of every id, MiB), then the same for
    PalDB at SCALE_PALDB_KEYS keys in 4 partitions (its writer and reader
    are pure Python, as the JAX package's)."""
    import os

    from photon_ml_tpu_torch.io import paldb
    from photon_ml_tpu_torch.native import index_store

    def sweep(lookup_index, lookup_name, keys):
        t0 = time.perf_counter()
        ids = np.fromiter((lookup_index(k) for k in keys), np.int64, count=len(keys))
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        names = [lookup_name(i) for i in range(len(keys))]
        name_s = time.perf_counter() - t0
        ok = bool(np.array_equal(np.sort(ids), np.arange(len(keys)))) and \
            all(names[i] == k for i, k in zip(ids[:: 997].tolist(), keys[:: 997]))
        return index_s, name_s, ok

    failures = []
    for fmt, n, parts in (("phidx", SCALE_KEYS, 8), ("paldb", SCALE_PALDB_KEYS, 4)):
        t0 = time.perf_counter()
        keys = [f"member.feature.{i}\x01term{i % 97}" for i in range(n)]
        keys_s = time.perf_counter() - t0
        d = os.path.join(work, f"scale-{fmt}")
        t0 = time.perf_counter()
        if fmt == "phidx":
            index_store.build_partitioned_store(d, keys, parts, namespace="g")
        else:
            paldb.write_index_map(d, "g", keys, parts)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = (index_store.PartitionedIndexStore(d, "g") if fmt == "phidx"
                 else paldb.load_index_map(d, "g"))
        open_s = time.perf_counter() - t0
        index_s, name_s, ok = sweep(store.get_index, store.get_feature_name, keys)
        row = dict(phase="3x-scale", store=fmt, keys=n, partitions=parts, where="host (the card's machine)",
                   keys_s=keys_s, build_s=build_s, open_s=open_s, store_mib=dir_mib(d),
                   get_index_sweep_s=index_s, get_index_keys_per_s=n / index_s,
                   get_feature_name_sweep_s=name_s, get_feature_name_ids_per_s=n / name_s, ok=ok,
                   card=card_line())
        if fmt == "paldb":
            row["cut"] = f"{n:,} keys, not {SCALE_KEYS:,}: the pure-Python writer and loader"
        log(json.dumps(row))
        if not ok:
            failures.append(f"{fmt}: a lookup sweep disagrees with the keys")
        if fmt == "phidx":
            store.close()
        del keys, store
    if failures:
        raise SystemExit("phase 3x-scale failed: " + "; ".join(failures))


MH_RANKS = 4  # 3m: cli.train --multihost 4
MH_PARTS = 8  # 3m: 3e's rows as 8 part files in row order (2 a rank)
MH_KILL_AT_STEP = 3  # 3m's drill: a worker is killed once state.json shows this step committed
MH_KILLED = 2  # the worker the drill kills
# 3c's coordinates with the IDENTITY projector the multi-host scope requires.
# 3c's coordinates with IDENTITY projectors, and the random effects at
# tolerance 0, so each lane takes the bench's 5 iterations in one process
# and on the ranks alike. At 1e-5 a warm-started lane stops once a step
# gains under 1e-5 of its objective, which the ranks' last bits can tip
# either way, leaving one run's lane iterations short of the other's
# (ROADMAP, stopping noise).
MH_COORDINATES = [c.replace("tolerance=1e-5", "tolerance=0.0") + ",projector=IDENTITY"
                  if "random.effect" in c else c for c in E2E_COORDINATES]


def multihost_args(data: str, index: str, out: str, *extra) -> list:
    """3m's cli.train command line: 3c's coordinates (IDENTITY projectors,
    the random effects at tolerance 0: MH_COORDINATES), two sweeps,
    through the PHIDX store, checkpointed under `out`/ckpt."""
    import os

    return ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", data,
            "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
            "--coordinate-configurations", *MH_COORDINATES, "--coordinate-descent-iterations", "2",
            "--offheap-indexmap-dir", index, "--checkpoint-directory", os.path.join(out, "ckpt"),
            "--output-mode", "BEST", "--logging-level", "WARNING", *extra]


def shard_layout(ckpt: str) -> dict:
    """Each random effect's shard files in a checkpoint: whether every file
    was written by the rank of its block index, and whether the blocks tile
    the (E + 1) rows in order."""
    import os
    import re

    with open(os.path.join(ckpt, "state.json")) as f:
        state = json.load(f)
    writers = state["multihost"]["shard_hosts"]
    out = {}
    for cid in E2E_RE:
        rels = state["model_files"][cid]
        own = all(writers[r] == int(re.search(r"shard(\d+)of", r).group(1)) for r in rels)
        row, tiled = 0, True
        for rel in rels:
            with np.load(os.path.join(ckpt, rel)) as z:
                tiled &= int(z["row_start"]) == row
                row += int(z["matrix"].shape[0])
                n_entities = int(z["n_entities"])
        out[cid] = dict(files=[os.path.basename(r) for r in rels], own_rank_wrote_each=own,
                        blocks_tile_rows=tiled and row == n_entities + 1)
    return out


def rank_rows(summary: dict, run: str, card: str) -> list:
    """One printed row a worker of a `--multihost` summary: its device,
    files, rows, ingest stages, set-up, each sweep's wall, each checkpoint
    save's exchange, write and commit seconds (the largest over the steps),
    peak memory, launches and collectives."""
    rows = []
    for r in summary["ranks"]:
        sweeps = {}
        for key, sec in r["timings_s"].items():
            it = key.rsplit("/iter", 1)[1]
            sweeps[it] = sweeps.get(it, 0.0) + sec
        saves = r["checkpoint_saves"]
        rows.append(dict(
            phase="3m", run=run, rank=r["rank"], attempt=r["attempt"], device=r["device"],
            backend=r["backend"], files=r["files"], rows=r["rows"], bringup_s=r["bringup_s"],
            ingest_s=r["ingest_s"], setup_s=r["setup_s"], fit_s=r["fit_s"], sweep_wall_s=sweeps,
            checkpoint_steps=[s["step"] for s in saves],
            checkpoint_max_s={k: max(s.get(k, 0.0) for s in saves)
                              for k in ("exchange_s", "write_s", "commit_s")},
            checkpoint_total_s=sum(sum(v for k, v in s.items() if k != "step") for s in saves),
            peak_mem_gib=r["peak_mem_gib"], launches=r["launches"], collectives=r["collectives"],
            card=card))
    return rows


def multihost_phase(work: str, device: str = "cuda:0") -> dict:
    """Phase 3m: `cli.train --multihost 4` at the e2e cell's full width, the
    four workers on `device` (cuda:0: sharing the card over gloo; cuda: a
    card each over NCCL where there are four), uninterrupted, then the same
    job with worker 2 SIGKILLed once step 3 is committed (the supervisor
    relaunches three workers on the 4-shard checkpoint). Held against a
    one-process cli.train of the same arguments on the card. Returns rank
    0's launches of the uninterrupted run's fit."""
    import os
    import signal

    from photon_ml_tpu_torch.cli import build_index
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset

    import torch

    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    card = card_line()
    data, index = os.path.join(work, "mh-parts"), os.path.join(work, "mh-index")
    os.makedirs(data, exist_ok=True)
    t0 = time.perf_counter()
    mb = write_e2e_files(data, e2e_arrays(E2E_ROWS), MH_PARTS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_index.main(["--input-data-directories", data, "--feature-shard-configurations", E2E_SHARD,
                      "--num-partitions", "1", "--output-dir", index])
    index_s = time.perf_counter() - t0

    one_dir = os.path.join(work, "mh-one")
    t0 = time.perf_counter()
    one_device = "cpu" if device == "cpu" else "cuda"
    one_summary, one_sparse, one_dense, one_mem = counted(
        torch, lambda: train_cli.main(multihost_args(data, index, one_dir, "--device", one_device)))
    one_s = time.perf_counter() - t0
    full_dir = os.path.join(work, "mh-full")
    t0 = time.perf_counter()
    full = train_cli.main(multihost_args(data, index, full_dir, "--multihost", str(MH_RANKS),
                                         "--device", device))
    full_s = time.perf_counter() - t0

    # The drill: the supervisor on a thread, worker 2 killed from here.
    drill_dir = os.path.join(work, "mh-drill")
    done, errors = [], []

    def supervise():
        try:
            done.append(train_cli.main(multihost_args(data, index, drill_dir, "--multihost",
                                                      str(MH_RANKS), "--device", device)))
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    sup = threading.Thread(target=supervise, name="mh-supervisor")
    t0 = time.perf_counter()
    sup.start()
    state = os.path.join(drill_dir, "ckpt", "state.json")
    pid_file = os.path.join(drill_dir, "hosts", f"attempt0-host{MH_KILLED}", "pid")
    killed_at, killed_step = None, None
    while sup.is_alive():
        try:
            with open(state) as f:
                killed_step = json.load(f)["completed_steps"]
        except (OSError, ValueError):
            killed_step = None
        if killed_step is not None and killed_step >= MH_KILL_AT_STEP:
            with open(pid_file) as f:
                os.kill(int(f.read()), signal.SIGKILL)
            killed_at = time.time()
            break
        time.sleep(0.01)
    sup.join()
    drill_s = time.perf_counter() - t0
    if errors:
        raise SystemExit(f"phase 3m: the drill's supervisor failed: {errors[0]!r}")
    if killed_at is None:
        raise SystemExit("phase 3m: the drill's fit ended before a worker could be killed")
    drill = done[0]

    # The three models in the store's feature ids, on a read of the part
    # files through the store.
    best = lambda d: os.path.join(d, "models", "best")
    imaps = {"g": IndexMap.load(os.path.join(best(one_dir), "feature-indexes", "g.json"))}
    models = {name: model_store.load_game_model(best(d), imaps)
              for name, d in (("one", one_dir), ("full", full_dir), ("drill", drill_dir))}
    t0 = time.perf_counter()
    ds = read_game_dataset(data, {"g": FeatureShardConfig(("features",), True)}, index_maps=imaps,
                           id_tag_fields=E2E_TAGS, device=one_device)[0]
    readings = e2e_readings(ds, {"full_vs_one": (models["one"], models["full"]),
                                 "drill_vs_full": (models["full"], models["drill"])})
    del ds
    torch.cuda.empty_cache()
    readings_s = time.perf_counter() - t0
    fe = {k: np.asarray(m.coordinates["global"].means) for k, m in models.items()}
    fe_gap = {"full_vs_one": float(np.abs(fe["full"] - fe["one"]).max()),
              "drill_vs_full": float(np.abs(fe["drill"] - fe["full"]).max())}
    layouts = {run: shard_layout(os.path.join(d, "ckpt")) for run, d in (("full", full_dir),
                                                                       ("drill", drill_dir))}

    rows = rank_rows(full, "uninterrupted", card) + rank_rows(drill, "drill, attempt 1", card)
    for row in rows:
        log(json.dumps(row))
    log_mh = drill["multihost"]["attempt_log"]
    with open(os.path.join(drill_dir, "hosts", "attempt1-host0", "journal.jsonl")) as f:
        resumed = [json.loads(line) for line in f if '"checkpoint"' in line]
    first = resumed[0] if resumed else None
    summary = dict(
        phase="3m", ranks=MH_RANKS, device=device, parts=MH_PARTS, rows=E2E_ROWS, write_s=write_s,
        write_mb=mb, build_index_s=index_s, one_process_wall_s=one_s,
        one_process_timings_s=one_summary["timings_s"], one_process_launches=one_sparse,
        one_process_mem_gib=one_mem, uninterrupted_wall_s=full_s, drill_wall_s=drill_s,
        uninterrupted_multihost=full["multihost"], drill_multihost=drill["multihost"],
        killed_worker=MH_KILLED, killed_after_step=killed_step,
        kill_to_survivors_exit_s=log_mh[0]["ended_at"] - killed_at,
        relaunch_to_first_resumed_update_s=None if first is None else first["ts"] - log_mh[1]["started_at"],
        first_resumed_step=None if first is None else first["step"],
        fe_coef_gap=fe_gap, readings=readings, readings_s=readings_s, shard_layouts=layouts,
        tol=tol, card=card)
    log(json.dumps(summary))

    failures = []
    if any(one_dense.values()) or not one_sparse["sparse_fused"]:
        failures.append(f"the one-process run's launches {one_sparse} / {one_dense}")
    for row in rows:
        ln = row["launches"]
        if (not ln["sparse_fused"] or not ln["sparse_matvec"] or not ln["rank_sum"]
                or ln["value_grad"] or ln["hvp"]):
            failures.append(f"{row['run']} rank {row['rank']}: launches {ln}")
    mh = full["multihost"]
    if (mh["attempts"], mh["host_losses"], mh["final_hosts"]) != (1, 0, MH_RANKS):
        failures.append(f"the uninterrupted run: {mh}")
    mh = drill["multihost"]
    if (mh["attempts"], mh["host_losses"], mh["repeated_sweeps"], mh["final_hosts"]) != (2, 1, 1, MH_RANKS - 1):
        failures.append(f"the drill: {mh}")
    for name, r in readings.items():
        if (fe_gap[name] > tol["fe_coef_atol"] or any(g > tol["re_objective_rtol"] for g in r["gaps"].values())
                or abs(r["auc"] - r["base_auc"]) > tol["auc_atol"] or not r["auc"] > 0.5):
            failures.append(f"{name}: fe {fe_gap[name]:.3e}, {r} against {tol}")
    for run, layout in layouts.items():
        for cid, lay in layout.items():
            if not (lay["own_rank_wrote_each"] and lay["blocks_tile_rows"]):
                failures.append(f"{run} {cid}: shard files {lay}")
    if failures:
        raise SystemExit("phase 3m failed: " + "; ".join(failures))
    ln = full["ranks"][0]["launches"]
    return {"sparse": {k: ln[k] for k in SPARSE_REPLACES}, "rank_sum": ln["rank_sum"]}


def tuning_phase(root: str, val_dir: str, work: str) -> dict:
    """Phase 3t: cli.train on phase 3e's files with phase 3g's validation
    file, output mode ALL, --hyper-parameter-tuning RANDOM then BAYESIAN,
    TUNING_TRIALS trials each: each trial's weights, validation AUC, fit
    seconds and launches, and the seconds of the searcher's proposals (the
    GP's fits among them). RANDOM's weights must be the port's searcher's
    proposals for the seed computed on the CPU, BAYESIAN's first two its
    Sobol points too, and the best model the argmax over explicit and tuned
    results. Returns the sparse launches by kernel."""
    import os

    import torch

    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.hyperparameter import search
    from photon_ml_tpu_torch.ops import sparse_kernels as sk

    ids = ["global", "per-user", "per-movie"]
    dims = [search.HyperparameterConfig(c, *train_cli.TUNING_REG_WEIGHT_RANGE, transform="LOG") for c in ids]
    searcher = search.RandomSearch(dims, lambda p: 0.0, seed=1)  # --random-seed 0, plus 1
    expected = [searcher.propose() for _ in range(TUNING_TRIALS)]
    fit0, gp0 = GameEstimator.fit, search.fit_gp
    fits, gp_fits = [], []

    def fit(self, *a, **k):  # each estimator fit: its seconds and launches
        before = dict(sk.LAUNCHES)
        out = fit0(self, *a, **k)
        fits.append({n: sk.LAUNCHES[n] - before[n] for n in before})
        return out

    def fit_gp(*a, **k):
        t0 = time.perf_counter()
        out = gp0(*a, **k)
        gp_fits.append(time.perf_counter() - t0)
        return out

    failures, launches, weights = [], {}, {}
    GameEstimator.fit, search.fit_gp = fit, fit_gp
    try:
        for mode in ("RANDOM", "BAYESIAN"):
            fits.clear()
            gp_fits.clear()
            out = os.path.join(work, f"tuned-{mode.lower()}")
            summary, sparse, dense, mem = counted(torch, lambda: train_cli.main([
                "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
                "--validation-data-directories", val_dir, "--validation-evaluators", "AUC",
                "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
                "--coordinate-configurations", *E2E_COORDINATES, "--coordinate-descent-iterations", "1",
                "--output-mode", "ALL", "--hyper-parameter-tuning", mode, "--hyper-parameter-tuning-iter",
                str(TUNING_TRIALS), "--random-seed", "0", "--logging-level", "WARNING"]))
            for k, v in sparse.items():
                launches[k] = launches.get(k, 0) + v
            trials = summary["tuning_trials"]
            weights[mode] = [np.array([t["reg_weights"][c] for c in ids]) for t in trials]
            aucs = [e["AUC"] for e in summary["evaluations"]]
            tuning_s = summary["timings_s"]["hyperparameter tuning"]
            with open(os.path.join(out, "models", "best", "model-metadata.json")) as f:
                best_weights = {c: v["reg_weight"] for c, v in json.load(f)["optimizationConfigurations"].items()}
            row = dict(phase="3t", mode=mode, trials=[dict(t, launches=l) for t, l in zip(trials, fits[1:])],
                       explicit_auc=aucs[0], explicit_launches=fits[0], best_index=summary["best_index"],
                       best_auc=summary["best_evaluation"]["AUC"], best_weights=best_weights,
                       tuning_s=tuning_s, trial_fit_s=sum(t["fit_s"] for t in trials),
                       proposal_s=tuning_s - sum(t["fit_s"] for t in trials), fit_gp_s=list(gp_fits),
                       timings_s=summary["timings_s"], launches=sparse, dense_launches=dense, mem_gib=mem,
                       models=sorted(os.listdir(os.path.join(out, "models"))), card=card_line())
            log(json.dumps(row))
            want = ["best", "explicit-0"] + [f"tuned-{i}" for i in range(TUNING_TRIALS)]
            if summary["num_tuned"] != TUNING_TRIALS or row["models"] != want or len(fits) != TUNING_TRIALS + 1:
                failures.append(f"{mode}: {summary['num_tuned']} trials, models {row['models']}")
            if summary["best_index"] != int(np.argmax(aucs)) or row["best_auc"] != max(aucs):
                failures.append(f"{mode}: best index {summary['best_index']} is not the argmax of {aucs}")
            chosen = ({c: w for c, w in zip(ids, weights[mode][summary["best_index"] - 1])}
                      if summary["best_index"] else EXPLICIT_WEIGHTS)
            if best_weights != chosen:
                failures.append(f"{mode}: the best model's weights {best_weights} are not result "
                                f"{summary['best_index']}'s {chosen}")
            if not all(f["sparse_fused"] and f["sparse_matvec"] for f in fits) or any(dense.values()):
                failures.append(f"{mode}: a fit launched no sparse kernel, or a dense one ran: {fits}, {dense}")
            if mode == "BAYESIAN" and len(gp_fits) != TUNING_TRIALS - 2:
                failures.append(f"BAYESIAN: {len(gp_fits)} GP fits for {TUNING_TRIALS - 2} GP proposals")
    finally:
        GameEstimator.fit, search.fit_gp = fit0, gp0
    if not all(np.array_equal(a, b) for a, b in zip(weights["RANDOM"], expected)):
        failures.append(f"RANDOM's weights {weights['RANDOM']} are not the searcher's {expected}")
    if not all(np.array_equal(a, b) for a, b in zip(weights["BAYESIAN"][:2], expected[:2])):
        failures.append(f"BAYESIAN's Sobol trials {weights['BAYESIAN'][:2]} are not {expected[:2]}")
    if failures:
        raise SystemExit("phase 3t failed: " + "; ".join(failures))
    return launches


# ---- phase 3w: batched hyperparameter sweeps ------------------------------------------
SWEEP_N, SWEEP_N_VAL, SWEEP_ENTITIES, SWEEP_D_FIXED, SWEEP_D_RE = 768, 256, 64, 12, 4  # bench.py:2893
SWEEP_TRIALS, SWEEP_BATCH = 16, 8  # bench.py's sweep: BAYESIAN, seed 11, batch 8, max_stack 8
SWEEP_REFERENCE_BAR = 10.0  # bench.py's speedup target, a figure for one XLA dispatch a chunk
TUNE_TRIALS, TUNE_BATCH = 8, 4  # 3w-e2e: cli.tune --tuning-iter 8 --tuning-batch-size 4


def sweep_bench_data(n_rows: int, seed: int, dev):
    """bench.py's sweep generator (bench.py:2893-2910) in numpy: a 12-wide
    dense fixed effect, a 4-wide random effect over 64 entities."""
    from photon_ml_tpu_torch.data.game_dataset import GameDataset

    r = np.random.default_rng(seed)
    ent = r.integers(0, SWEEP_ENTITIES, size=n_rows)
    Xf = r.normal(size=(n_rows, SWEEP_D_FIXED)).astype(np.float32)
    Xe = r.normal(size=(n_rows, SWEEP_D_RE)).astype(np.float32)
    wt = r.normal(size=SWEEP_D_FIXED).astype(np.float32)
    ut = r.normal(size=(SWEEP_ENTITIES, SWEEP_D_RE)).astype(np.float32)
    mg = Xf @ wt + np.einsum("nd,nd->n", Xe, ut[ent])
    ys = (r.uniform(size=n_rows) < 1 / (1 + np.exp(-mg))).astype(np.float32)
    return GameDataset.build({"g": Xf, "e": Xe}, ys, id_tags={"entityId": ent}, device=dev)


def sweep_bench_setup(dev):
    """bench.py's sweep estimator (seed 7) and base configuration: FE L-BFGS
    12 iterations, RE 8, tol 1e-7, L2 1.0; per-entity min_bucket 16."""
    from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig, RandomEffectDataConfig
    from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
    from photon_ml_tpu_torch.types import TaskType

    base = {cid: CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=it, tolerance=1e-7),
                                              regularization=L2, reg_weight=1.0)
            for cid, it in (("fixed", 12), ("per-entity", 8))}
    est = GameEstimator(TaskType.LOGISTIC_REGRESSION,
                        {"fixed": FixedEffectDataConfig("g"),
                         "per-entity": RandomEffectDataConfig("entityId", "e", min_bucket=16)}, seed=7)
    return est, sweep_bench_data(SWEEP_N, 31, dev), sweep_bench_data(SWEEP_N_VAL, 37, dev), base


class trial_launches:
    """Within the scope, the kernels' launches of each fit the sweep module
    runs, in order: every trial (in every mode), then the winner's refit."""

    def __enter__(self):
        from photon_ml_tpu_torch.hyperparameter import sweep
        from photon_ml_tpu_torch.ops import glm_kernels
        from photon_ml_tpu_torch.ops import sparse_kernels as sk

        self.fits, self._mod = [], sweep
        self._orig = sweep.run_coordinate_descent
        tables = (glm_kernels.LAUNCHES, sk.LAUNCHES)
        names = ("value_grad", "sparse_fused", "sparse_matvec")

        def run(*a, **k):
            before = {n: t[n] for t in tables for n in names if n in t}
            out = self._orig(*a, **k)
            self.fits.append({n: t[n] - before[n] for t in tables for n in names if n in t})
            return out

        sweep.run_coordinate_descent = run
        return self

    def __exit__(self, *exc):
        self._mod.run_coordinate_descent = self._orig
        return False


def sweep_models_equal(a, b) -> bool:
    """Two lists of trial arrays ({cid: {name: tensor or None}}) bit for bit."""
    import torch

    return len(a) == len(b) and all(
        x.keys() == z.keys() and all(
            x[c].keys() == z[c].keys() and all(
                (u is None and v is None) or (u is not None and v is not None and torch.equal(u, v))
                for u, v in ((x[c][n], z[c][n]) for n in x[c]))
            for c in x)
        for x, z in zip(a, b))


def sweep_bench_phase(dev) -> dict:
    """Phase 3w-bench and the drills: bench.py's sweep section at its own
    shape through the stacked executor, against one estimator.fit a trial
    and a serial executor on the same points. Returns the launches of the
    measured sweep (counted from 0)."""
    import dataclasses as _dc

    import torch

    from photon_ml_tpu_torch.contracts import ROBUSTNESS_CLEAN_ZERO_KEYS, SWEEP_SECTION_KEYS, SWEEP_TRIAL_KEYS
    from photon_ml_tpu_torch.hyperparameter import HyperparameterConfig, HyperparameterTuningMode, get_tuner
    from photon_ml_tpu_torch.utils import faults

    est, ds, val, base = sweep_bench_setup(dev)
    failures = []
    executor = est.sweep_executor(ds, val, base, mode="stacked", max_stack=8)
    dims = [HyperparameterConfig("fixed", 1e-3, 1e3, transform="LOG"),
            HyperparameterConfig("per-entity", 1e-3, 1e3, transform="LOG")]
    # The reference's warm-up: two throwaway rounds (cold, then warm), reset.
    warm_pts = 10 ** np.random.default_rng(41).uniform(-3, 3, size=(8, 2))
    t0 = time.perf_counter()
    executor.evaluate_batch(warm_pts)
    executor.evaluate_batch(warm_pts)
    executor.reset()
    warmup_s = time.perf_counter() - t0

    rounds = []  # each round's points, values and trial models, as evaluated
    evaluate = executor.evaluate_batch

    def kept(points):
        values = evaluate(points)
        rounds.append((np.array(points), list(values), executor.last_trial_models))
        return values

    executor.evaluate_batch = kept
    rob_base = {k: faults.COUNTERS.get(k) for k in ROBUSTNESS_CLEAN_ZERO_KEYS}
    tuner = get_tuner(HyperparameterTuningMode.BAYESIAN)
    with trial_launches() as rec:
        t0 = time.perf_counter()
        (_, res), sparse, dense, mem = counted(torch, lambda: tuner.sweep(
            SWEEP_TRIALS, dims, HyperparameterTuningMode.BAYESIAN, executor, seed=11,
            batch_size=SWEEP_BATCH))
        sweep_wall = time.perf_counter() - t0
    stacked_launches = rec.fits[:SWEEP_TRIALS]  # the refit comes last
    eval_wall = sum(t.seconds for t in res.trials)

    def fit_trial(point):
        cfgs = {cid: _dc.replace(base[cid], reg_weight=float(w)) for cid, w in zip(base, point)}
        return est.fit(ds, val, [cfgs])[0]

    fit_trial(warm_pts[0])  # warms the estimator's validation path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in res.trials:
        fit_trial(t.point)
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    standalone = fit_trial(res.best_point)
    winner_bitwise = bool(
        torch.equal(res.winner_model["fixed"].coefficients.means,
                    standalone.model["fixed"].coefficients.means)
        and torch.equal(res.winner_model["per-entity"].coefficients_matrix,
                        standalone.model["per-entity"].coefficients_matrix))
    rob = {k: faults.COUNTERS.get(k) - rob_base[k] for k in ROBUSTNESS_CLEAN_ZERO_KEYS}
    rob["diverged_steps"] = sum(t.diverged_steps for t in res.trials)

    # The same rounds through a serial executor (warm from the same incumbents).
    serial = est.sweep_executor(ds, val, base, mode="serial")
    with trial_launches() as rec_serial:
        serial_rounds = [(serial.evaluate_batch(p), serial.last_trial_models) for p, _, _ in rounds]
    serial_launches = rec_serial.fits
    same_values = all(sv == v for (sv, _), (_, v, _) in zip(serial_rounds, rounds))
    same_models = all(sweep_models_equal(sm, m) for (_, sm), (_, _, m) in zip(serial_rounds, rounds))

    section = dict(
        shape=dict(n_samples=SWEEP_N, n_validation=SWEEP_N_VAL, n_entities=SWEEP_ENTITIES,
                   d_fixed=SWEEP_D_FIXED, d_re=SWEEP_D_RE),
        trials=len(res.trials), rounds=executor.rounds, batch_size=SWEEP_BATCH,
        modes=sorted({t.mode for t in res.trials}), stack_decisions=res.stack_decisions,
        trial_timings=[t.timing_entry() for t in res.trials], sweep_wall_s=sweep_wall,
        trial_eval_wall_s=eval_wall,
        proposal_wall_s=max(0.0, sweep_wall - eval_wall - res.winner_refit_s),
        winner_refit_s=res.winner_refit_s, serial_baseline_wall_s=serial_wall,
        speedup_vs_serial=serial_wall / max(eval_wall, 1e-9), reference_bar=SWEEP_REFERENCE_BAR,
        speedup_basis="trial-evaluation walls on the same 16 points: stacked executor rounds "
                      "against one estimator.fit a point",
        best_point=[float(v) for v in res.best_point], winner_value=float(res.winner_value),
        winner_bitwise_vs_standalone=winner_bitwise, robustness=rob, warmup_s=warmup_s,
        stacked_vs_serial_values_equal=same_values, stacked_vs_serial_models_bit_equal=same_models,
        round_eval_wall_s={"stacked": [sum(t.seconds for t in res.trials if t.round == r)
                                       for r in range(executor.rounds)],
                           "serial_executor": [sum(t.seconds for t in serial.trials if t.round == r)
                                               for r in range(serial.rounds)]},
        value_grad_per_trial={"stacked": [c["value_grad"] for c in stacked_launches],
                              "serial": [c["value_grad"] for c in serial_launches]},
        launches=dense, sparse_launches=sparse, mem_gib=mem, card=card_line())
    log(json.dumps(dict(phase="3w-bench", **section)))
    missing = [k for k in SWEEP_SECTION_KEYS if section.get(k) is None]
    missing += [f"trial:{k}" for k in SWEEP_TRIAL_KEYS for t in section["trial_timings"] if k not in t]
    if missing:
        failures.append(f"the sweep record lacks {missing}")
    if not winner_bitwise:
        failures.append("the winner's refit is not bit-equal to a standalone fit")
    if any(v != 0 for v in rob.values()):
        failures.append(f"robustness counters of a clean sweep are not 0: {rob}")
    if not (same_values and same_models):
        failures.append(f"serial trials differ from stacked ones (values {same_values}, "
                        f"models {same_models})")
    if section["value_grad_per_trial"]["stacked"] != section["value_grad_per_trial"]["serial"] \
            or len(rec.fits) != SWEEP_TRIALS + 1 or not all(c["value_grad"] for c in stacked_launches):
        failures.append(f"value_grad launches a trial differ by mode: {section['value_grad_per_trial']}")
    if any(sparse.values()):
        failures.append(f"a sparse kernel ran on the dense cell: {sparse}")

    # ---- 3w-drills --------------------------------------------------------------------
    pts = np.array([[0.3, 2.0]])
    clean = est.sweep_executor(ds, val, base, mode="serial", warm_start=False)
    struck = est.sweep_executor(ds, val, base, mode="serial", warm_start=False)
    v_clean = clean.evaluate_batch(pts)
    with faults.inject("solve@1") as inj:
        v_struck = struck.evaluate_batch(pts)
    solve_row = dict(drill="solve", fired=inj.injected.get("solve", 0),
                     diverged_steps=struck.trials[0].diverged_steps, values_equal=v_clean == v_struck,
                     models_bit_equal=sweep_models_equal(clean.last_trial_models, struck.last_trial_models))
    if (solve_row["fired"], solve_row["diverged_steps"]) != (1, 1) or not solve_row["values_equal"] \
            or not solve_row["models_bit_equal"]:
        failures.append(f"the solve drill: {solve_row}")
    bad = np.array([[np.nan, 1.0]])
    nan_runs = {}
    cards = torch.cuda.device_count()  # shard groups: one card a group
    for mode, kw in (("serial", {}), ("stacked", {}), ("shard_group", {"shard_groups": cards})):
        ex = est.sweep_executor(ds, val, base, mode=mode, warm_start=False, **kw)
        nan_runs[mode] = (ex.evaluate_batch(bad), ex.trials[0].diverged_steps, ex.last_trial_models)
    fe_zero = {m: bool((r[2][0]["fixed"]["w"] == 0).all()) for m, r in nan_runs.items()}
    nan_row = dict(drill="nan_reg_weight", values={m: r[0] for m, r in nan_runs.items()},
                   diverged_steps={m: r[1] for m, r in nan_runs.items()}, fe_zeros=fe_zero,
                   models_bit_equal={m: sweep_models_equal(r[2], nan_runs["serial"][2])
                                     for m, r in nan_runs.items()})
    if not all(fe_zero.values()) or len({r[1] for r in nan_runs.values()}) != 1 \
            or len({tuple(r[0]) for r in nan_runs.values()}) != 1 or not all(nan_row["models_bit_equal"].values()):
        failures.append(f"the NaN-weight drill: {nan_row}")
    ref = est.sweep_executor(ds, val, base, mode="serial")
    grp = est.sweep_executor(ds, val, base, mode="shard_group", shard_groups=cards)
    same = True
    t0 = time.perf_counter()
    for p, _, _ in rounds[:2]:
        same = same and ref.evaluate_batch(p[:4]) == grp.evaluate_batch(p[:4]) \
            and sweep_models_equal(ref.last_trial_models, grp.last_trial_models)
    group_row = dict(shard_groups=cards, cards=[str(c["devices"][0]) for c in grp._groups()],
                     bit_equal_to_serial=same, wall_s=time.perf_counter() - t0)
    if not same:
        failures.append(f"shard groups ({cards}) differ from serial trials")
    log(json.dumps(dict(phase="3w-drills", solve=solve_row, nan_reg_weight=nan_row, shard_groups=group_row,
                        multi_card_groups=f"run: {cards} groups, a card each" if cards >= 2 else
                        "not run: 1 card", card=card_line())))
    if failures:
        raise SystemExit("phase 3w-bench failed: " + "; ".join(failures))
    return dense


def sweep_e2e_phase(root: str, val_dir: str, work: str, dev):
    """Phase 3w-e2e: cli.tune at full width on phase 3e's training files and
    3g's validation file with 3c's coordinates (BAYESIAN, 8 trials in rounds
    of 4), then cli.train at the winner's weights (bit-equal to
    models/tuned-best once both are loaded), then two cold points stacked
    and serial in process on 3f's estimator and a new read of the data.
    Phase 3w-sg follows on the same data and estimator. Returns the cli.tune
    run's (sparse, dense) launches, counted from 0, and 3w-sg's."""
    import os
    import re

    import torch

    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.cli import tune as tune_cli
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.hyperparameter import search
    from photon_ml_tpu_torch.io import model_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
    from photon_ml_tpu_torch.types import TaskType

    failures = []
    out = os.path.join(work, "tune")
    propose0 = search.GaussianProcessSearch.propose_batch
    proposals = []

    def propose_batch(self, k):
        t0 = time.perf_counter()
        pts = propose0(self, k)
        proposals.append(time.perf_counter() - t0)
        return pts

    search.GaussianProcessSearch.propose_batch = propose_batch
    try:
        with trial_launches() as rec:
            summary, sparse, dense, mem = counted(torch, lambda: tune_cli.main([
                "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
                "--validation-data-directories", val_dir, "--validation-evaluators", "AUC",
                "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
                "--coordinate-configurations", *E2E_COORDINATES, "--coordinate-descent-iterations", "1",
                "--tuning-mode", "BAYESIAN", "--tuning-iter", str(TUNE_TRIALS), "--tuning-batch-size",
                str(TUNE_BATCH), "--random-seed", "0", "--logging-level", "WARNING"]))
    finally:
        search.GaussianProcessSearch.propose_batch = propose0
    per_trial = rec.fits[:TUNE_TRIALS]  # the refit comes last
    with open(os.path.join(out, "tuning-summary.json")) as f:
        on_disk = json.load(f)
    log(json.dumps(dict(
        phase="3w-e2e", read_s=summary["timings_s"]["read data"], timings_s=summary["timings_s"],
        trials=[dict(t, launches=l) for t, l in zip(summary["trials"], per_trial)],
        modes=summary["modes"], rounds=summary["rounds"], stack_decisions=summary["stack_decisions"],
        proposal_s=proposals, sweep_wall_s=summary["sweep_wall_s"], winner_refit_s=summary["winner_refit_s"],
        save_s=summary["timings_s"]["save model"], best_point=summary["best_point"],
        best_value=summary["best_value"], winner_value=summary["winner_value"],
        summary_keys=sorted(on_disk), launches=sparse, dense_launches=dense, mem_gib=mem, card=card_line())))
    if len(rec.fits) != TUNE_TRIALS + 1 or not all(c["sparse_fused"] and c["sparse_matvec"] for c in per_trial) \
            or any(dense.values()):
        failures.append(f"cli.tune's trials: launches {per_trial}, dense {dense}")
    if summary["modes"] != ["stacked"] or summary["rounds"] != TUNE_TRIALS // TUNE_BATCH:
        failures.append(f"cli.tune ran {summary['modes']} in {summary['rounds']} rounds")

    # cli.train at the winner's weights: the same model, bit for bit.
    weights = dict(zip(summary["tuned_coordinates"], summary["best_point"]))
    coords = [re.sub(r"reg\.weights=[^,]*", f"reg.weights={weights[s.split(',')[0][5:]]!r}", s)
              for s in E2E_COORDINATES]
    at_winner = os.path.join(work, "train-at-winner")
    t0 = time.perf_counter()
    train_cli.main(["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
                    "--validation-data-directories", val_dir, "--validation-evaluators", "AUC",
                    "--root-output-directory", at_winner, "--feature-shard-configurations", E2E_SHARD,
                    "--coordinate-configurations", *coords, "--coordinate-descent-iterations", "1",
                    "--random-seed", "0", "--output-mode", "BEST", "--logging-level", "WARNING"])
    train_s = time.perf_counter() - t0

    def load(d):
        return model_store.load_game_model(d, {"g": IndexMap.load(os.path.join(d, "feature-indexes", "g.json"))})

    vs_train = same_model(load(os.path.join(out, "models", "tuned-best")),
                          load(os.path.join(at_winner, "models", "best")))

    # Two cold points, stacked and serial, in process at full width.
    shards = {"g": FeatureShardConfig(("features",), True)}
    t0 = time.perf_counter()
    ds, imaps = read_game_dataset(root, shards, id_tag_fields=E2E_TAGS, device=dev)
    val, _ = read_game_dataset(val_dir, shards, index_maps=imaps, id_tag_fields=E2E_TAGS, device=dev)
    read_s = time.perf_counter() - t0
    est = e2e_estimator(TaskType.LOGISTIC_REGRESSION)
    fe, re_cfg = e2e_configs()
    base = {"global": fe, "per-user": re_cfg, "per-movie": re_cfg}
    pts = np.array([[1.0, 10.0, 10.0], [0.3, 30.0, 3.0]])
    runs = {}
    for mode in ("stacked", "serial"):
        ex = est.sweep_executor(ds, val, base, mode=mode, warm_start=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = ex.evaluate_batch(pts)
        torch.cuda.synchronize()
        runs[mode] = (values, ex.last_trial_models, time.perf_counter() - t0)
    full_width = dict(values={m: r[0] for m, r in runs.items()}, wall_s={m: r[2] for m, r in runs.items()},
                      values_equal=runs["stacked"][0] == runs["serial"][0],
                      models_bit_equal=sweep_models_equal(runs["stacked"][1], runs["serial"][1]),
                      read_s=read_s)
    log(json.dumps(dict(phase="3w-e2e-check", train_at_winner_s=train_s, tuned_vs_train=vs_train,
                        full_width_two_points=full_width, card=card_line())))
    if not all(v["bit_equal"] for v in vs_train.values()):
        failures.append(f"models/tuned-best is not cli.train's model at the winner's weights: {vs_train}")
    if not (full_width["values_equal"] and full_width["models_bit_equal"]):
        failures.append(f"full-width stacked trials differ from serial ones: {full_width}")
    if failures:
        raise SystemExit("phase 3w-e2e failed: " + "; ".join(failures))
    del runs
    sg = walled("phase 3w-sg", sweep_group_phase, ds, val, est, base, dev)
    del ds, val, est
    gc.collect()
    torch.cuda.empty_cache()
    return sparse, dense, sg


def re_lane_check(coord, offsets, cfg) -> dict:
    """A random effect's largest bucket solved whole, then with the live
    lanes of each of 4 slices, of one-lane slices (its first 8 lanes) and
    of 3-lane slices at odd offsets (1, 5, 9, 13) in place
    (parallel/mesh.py `lanes_in_place`, as a shard group's card solves
    them): the live lanes whose coefficients differ from the whole bucket's
    (0 is the gate). Every solve runs on the route the coordinate takes: a
    sparse shard's block stays an ELL block. Beside it, not gated, the same
    slices solved alone (each cut out of the block), which shows what the
    in-place solve is for: a library's batched product picks its kernel
    from the batch."""
    import torch

    from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data
    from photon_ml_tpu_torch.optimize import problem
    from photon_ml_tpu_torch.parallel.mesh import lanes_in_place

    red = coord.re_dataset
    bi = max(range(len(red.buckets)), key=lambda i: red.buckets[i].num_entities * red.buckets[i].capacity)
    bucket = red.buckets[bi]

    def block_of(blocks):
        return gather_block_data(coord.dataset, red.feature_shard, blocks, offsets, red.feature_mask)

    blk = block_of(bucket)
    E = int(blk.features.shape[0])
    w0 = torch.zeros((E, coord.dim), dtype=blk.labels.dtype, device=blk.labels.device)

    def solve(b, lo, hi):
        return problem.solve(coord.loss, b, cfg, w0[lo:hi].clone(), None, use_kernel=False).coefficients

    def alone(lo, hi):
        feats = blk.features
        feats = feats.lanes(lo, hi) if isinstance(feats, SparseFeatures) else feats[lo:hi].clone()
        part = LabeledData(feats, *(t[lo:hi].clone() for t in (blk.labels, blk.offsets, blk.weights)))
        return solve(part, lo, hi)

    def in_place(lo, hi):
        return solve(block_of(lanes_in_place(bucket, lo, hi, red.num_entities)), 0, E)[lo:hi]

    whole = solve(blk, 0, E)
    per = -(-E // 4)
    cuts = {"four_slices": [(lo, min(E, lo + per)) for lo in range(0, E, per)],
            "one_lane_slices": [(i, i + 1) for i in range(min(E, 8))],
            "three_lane_slices": [(lo, lo + 3) for lo in (1, 5, 9, 13) if lo + 3 <= E]}
    differ = lambda how, ranges: int((torch.cat([how(lo, hi) for lo, hi in ranges])
                                      != torch.cat([whole[lo:hi] for lo, hi in ranges])).any(1).sum())
    return dict(bucket=bi, entities=E, capacity=bucket.capacity, dim=coord.dim,
                in_place={k: differ(in_place, r) for k, r in cuts.items()},
                alone={k: differ(alone, r) for k, r in cuts.items()})


SG_SHARDS = 4  # 3w-sg: a group of the first 4 cards, or of 4 shards on card 0 of a one-card machine
SG_POINTS = (np.array([[1.0, 10.0, 10.0], [0.3, 30.0, 3.0]]),  # 3w-sg: two rounds of two points,
             np.array([[3.0, 5.0, 20.0], [0.5, 10.0, 1.0]]))   # the second warm from the first's incumbent


def sweep_group_phase(ds, val, est, base, dev) -> dict:
    """Phase 3w-sg: a shard group of several cards at full width. The group
    is `_sweep_group_builder` over SG_SHARDS shards (`shard_mesh`: one a
    card on a machine of several, else all on card 0 with card identities
    0..3), put in place of the executor's groups, so its trials run through
    the shard-group worker with each random effect's store row-sharded over
    it; SIMPLE variances on both random effects. Gates: every trial's value
    == the serial executor's and every model (coefficients, variances) bit
    for bit, cold and warm; the kernels' launches a trial equal to serial's;
    `collective` armed once gives collective_retries 1 and the same bits.
    Returns the group's trials' launches (sparse, dense), counted from 0."""
    import dataclasses as _dc

    import torch

    from photon_ml_tpu_torch.types import VarianceComputationType
    from photon_ml_tpu_torch.utils import faults

    failures = []
    t_phase = time.perf_counter()
    simple = VarianceComputationType.SIMPLE
    base = {cid: cfg if cid == "global" else _dc.replace(cfg, variance_computation=simple)
            for cid, cfg in base.items()}
    mesh = shard_mesh(torch, SG_SHARDS)
    devs = list(mesh.devices)

    def group_executor(**kw):
        ex = est.sweep_executor(ds, val, base, mode="shard_group", **kw)
        ex._group_contexts = [dict(index=0, devices=devs, coordinates=ex.group_builder(devs))]
        return ex

    serial = est.sweep_executor(ds, val, base, mode="serial")
    group = group_executor()
    rounds, walls = [], {"serial": [], "group": []}
    with trial_launches() as rec_serial:
        for pts in SG_POINTS:
            rounds.append([serial.evaluate_batch(pts), serial.last_trial_models])
    walls["serial"] = [t.seconds for t in serial.trials]
    with trial_launches() as rec_group:
        (_, sg_sparse, sg_dense, mem) = counted(torch, lambda: [
            rounds[i].extend([group.evaluate_batch(pts), group.last_trial_models])
            for i, pts in enumerate(SG_POINTS)])
    walls["group"] = [t.seconds for t in group.trials]
    same_values = all(r[0] == r[2] for r in rounds)
    same_models = all(sweep_models_equal(r[1], r[3]) for r in rounds)
    coords = group._group_contexts[0]["coordinates"]
    sharding = {cid: c.sharding_info() for cid, c in coords.items() if hasattr(c, "sharding_info")}
    # The bucket solve itself: the largest bucket of each random effect whole
    # and in slices down to one lane, on the offsets of the dataset.
    lanes = {cid: re_lane_check(serial.coordinates[cid], serial.coordinates[cid].dataset.offsets,
                                base[cid]) for cid in sharding}
    store_bytes = {cid: 2 * info["rows_per_shard"] * coords[cid].dim * 4 for cid, info in sharding.items()}
    variances = all(t[cid]["v"] is not None for r in rounds for t in r[3] for cid in sharding)

    # The `collective` drill: one cold trial, the first gather of the group struck once.
    pt = SG_POINTS[0][:1]
    clean = est.sweep_executor(ds, val, base, mode="serial", warm_start=False)
    v_clean = clean.evaluate_batch(pt)
    struck = group_executor(warm_start=False)
    retries0 = faults.COUNTERS.get("collective_retries")
    with faults.inject("collective:1") as inj:
        v_struck = struck.evaluate_batch(pt)
    drill = dict(fired=inj.injected.get("collective", 0),
                 collective_retries=faults.COUNTERS.get("collective_retries") - retries0,
                 values_equal=v_clean == v_struck,
                 models_bit_equal=sweep_models_equal(clean.last_trial_models, struck.last_trial_models))
    row = dict(phase="3w-sg", cards=len(set(devs)), shards=mesh.size, devices=[str(d) for d in devs],
               points=[p.tolist() for p in SG_POINTS],
               values={"serial": [r[0] for r in rounds], "group": [r[2] for r in rounds]},
               values_equal=same_values, models_bit_equal=same_models, variances=variances,
               launches_per_trial={"serial": rec_serial.fits, "group": rec_group.fits},
               sharding=sharding, store_bytes_a_card=store_bytes, lanes_differing=lanes,
               trial_s=walls, collective_drill=drill, launches=sg_sparse, dense_launches=sg_dense,
               mem_gib=mem, wall_s=time.perf_counter() - t_phase, card=card_line())
    log(json.dumps(row))
    if not (same_values and same_models and variances):
        failures.append(f"group trials differ from serial ones (values {same_values}, models "
                        f"{same_models}, variances {variances})")
    if rec_group.fits != rec_serial.fits or not all(f["sparse_fused"] for f in rec_group.fits):
        failures.append(f"launches a trial differ: serial {rec_serial.fits}, group {rec_group.fits}")
    if any(v for row in lanes.values() for v in row["in_place"].values()):
        failures.append(f"a bucket solve's lanes differ between the whole bucket and its slices in "
                        f"place: {lanes}")
    if not all(info["entity_sharded"] and info["axis_size"] == SG_SHARDS for info in sharding.values()):
        failures.append(f"the group's random effects are not row-sharded over {SG_SHARDS}: {sharding}")
    if (drill["fired"], drill["collective_retries"]) != (1, 1) or not drill["values_equal"] \
            or not drill["models_bit_equal"]:
        failures.append(f"the collective drill: {drill}")
    if any(t.diverged_steps for t in group.trials):
        failures.append("a group trial diverged")
    if failures:
        raise SystemExit("phase 3w-sg failed: " + "; ".join(failures))
    if SG_TRACE_DIR is not None:
        trace_group_trial(serial, group_executor(warm_start=False), SG_POINTS[0][:1], SG_TRACE_DIR)
    return {"sparse": sg_sparse, "dense": sg_dense}


SG_TRACE_DIR = None  # a directory: 3w-sg then traces one cold trial there (tools/chip_smoke_sweep.py)


def trace_group_trial(serial, group, pt, out_dir: str) -> dict:
    """Where one cold trial's time goes, serial and in the group (after
    3w-sg's gates, outside its counts): the host seconds of the trial's
    spans, each summed over its calls (the coordinates' train and score,
    the ring gather and scatter, the broadcast gather of `score`, the
    offsets sent to the cards, and each card's slice solves, summed by
    card since the cards' threads overlap), then the group's trial once
    more (its coordinate descent, on this thread) under torch.profiler,
    whose operators by self CPU time and by device time go to
    `out_dir`/group_ops.txt (the top 8 by device time in the log line).
    Logs and returns the spans."""
    import collections
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.game import coordinate as gcoord

    os.makedirs(out_dir, exist_ok=True)
    lock = threading.Lock()
    spans, calls = collections.defaultdict(float), collections.Counter()
    targets = [(gcoord.FixedEffectCoordinate, "train", "fe.train"),
               (gcoord.FixedEffectCoordinate, "score", "fe.score"),
               (gcoord.RandomEffectCoordinate, "train", "re.train"),
               (gcoord.RandomEffectCoordinate, "score", "re.score"),
               (gcoord, "ring_gather_rows", "ring_gather"), (gcoord, "ring_scatter_rows", "ring_scatter"),
               (gcoord, "bcast_gather_rows", "bcast_gather"), (gcoord, "card_offsets", "card_offsets")]

    def timed(fn, label):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    spans[label] += time.perf_counter() - t
                    calls[label] += 1
        return wrapper

    def solve_timed(fn):
        def wrapper(self, bucket, k, w0, offsets, cfg, dev):
            t = time.perf_counter()
            try:
                return fn(self, bucket, k, w0, offsets, cfg, dev)
            finally:
                with lock:
                    spans[f"solve@{dev}"] += time.perf_counter() - t
                    calls[f"solve@{dev}"] += 1
        return wrapper

    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    saved.append((gcoord.RandomEffectCoordinate, "_solve_slice", gcoord.RandomEffectCoordinate._solve_slice))
    out = {}
    try:
        for obj, name, label in targets:
            setattr(obj, name, timed(getattr(obj, name), label))
        gcoord.RandomEffectCoordinate._solve_slice = solve_timed(saved[-1][2])
        for label, ex in (("serial", serial), ("group", group)):
            spans.clear()
            calls.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ex.evaluate_batch(pt)
            torch.cuda.synchronize()
            out[label] = dict(trial_s=time.perf_counter() - t, spans_s=dict(spans), calls=dict(calls))
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    # The trial's coordinate descent again, on this thread (the profiler's
    # operator rows are this thread's; the device rows are every card's).
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent

    ctx = group._groups()[0]
    home = ctx["devices"][0]
    with torch.cuda.device(home), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_coordinate_descent(ctx["coordinates"], group.num_iterations,
                               reg_weights=group._rw_map(pt[0]), seed=group.seed)
        for d in dict.fromkeys(ctx["devices"]):
            torch.cuda.synchronize(d)
    ka = prof.key_averages()
    with open(os.path.join(out_dir, "group_ops.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40) + "\n")
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40) + "\n")
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    top = sorted(ka, key=dev_us, reverse=True)[:8]
    out["profiled"] = dict(self_cpu_s=sum(e.self_cpu_time_total for e in ka) / 1e6,
                           self_device_s=sum(dev_us(e) for e in ka) / 1e6, ops=len(ka),
                           top_device_ms={e.key: [dev_us(e) / 1e3, e.count] for e in top})
    log(json.dumps(dict(phase="3w-sg-trace", **out, card=card_line())))
    return out


SG_CLI_GROUPS, SG_CLI_TRIALS, SG_CLI_BATCH = 2, 4, 2  # 3w-sg-cli: RANDOM, 4 trials in rounds of 2


def sweep_groups_cli_phase(root: str, val_dir: str, work: str) -> dict:
    """Phase 3w-sg-cli (4 or more cards; tools/chip_smoke_sweep.py): cli.tune
    at 3w-e2e's width with `--sweep-mode shard_group --shard-groups 2` (two
    groups of two cards: each random effect row-sharded over its group's
    cards) against `--sweep-mode serial`: the same trial values and
    models/tuned-best bit-equal once both are loaded."""
    import os

    import torch

    from photon_ml_tpu_torch.cli import tune as tune_cli
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.io import model_store

    runs = {}
    for mode, extra in (("serial", []), ("shard_group", ["--shard-groups", str(SG_CLI_GROUPS)])):
        out = os.path.join(work, f"tune-{mode}")
        t0 = time.perf_counter()
        summary = tune_cli.main([
            "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
            "--validation-data-directories", val_dir, "--validation-evaluators", "AUC",
            "--root-output-directory", out, "--feature-shard-configurations", E2E_SHARD,
            "--coordinate-configurations", *E2E_COORDINATES, "--coordinate-descent-iterations", "1",
            "--tuning-mode", "RANDOM", "--tuning-iter", str(SG_CLI_TRIALS), "--tuning-batch-size",
            str(SG_CLI_BATCH), "--random-seed", "0", "--sweep-mode", mode, "--logging-level", "WARNING",
            *extra])
        torch.cuda.synchronize()
        best = os.path.join(out, "models", "tuned-best")
        runs[mode] = (summary, model_store.load_game_model(
            best, {"g": IndexMap.load(os.path.join(best, "feature-indexes", "g.json"))}),
            time.perf_counter() - t0)
    (s_sum, s_model, s_wall), (g_sum, g_model, g_wall) = runs["serial"], runs["shard_group"]
    vs = same_model(g_model, s_model)
    row = dict(phase="3w-sg-cli", cards=torch.cuda.device_count(), shard_groups=SG_CLI_GROUPS,
               modes={"serial": s_sum["modes"], "shard_group": g_sum["modes"]},
               values={"serial": [t["value"] for t in s_sum["trials"]],
                       "shard_group": [t["value"] for t in g_sum["trials"]]},
               trial_s={"serial": [t["seconds"] for t in s_sum["trials"]],
                        "shard_group": [t["seconds"] for t in g_sum["trials"]]},
               sweep_wall_s={"serial": s_sum["sweep_wall_s"], "shard_group": g_sum["sweep_wall_s"]},
               wall_s={"serial": s_wall, "shard_group": g_wall}, tuned_best_vs_serial=vs, card=card_line())
    log(json.dumps(row))
    if g_sum["modes"] != ["shard_group"] or row["values"]["serial"] != row["values"]["shard_group"] \
            or not all(v["bit_equal"] for v in vs.values()):
        raise SystemExit(f"phase 3w-sg-cli failed: {row}")
    return row


def sweep_phase(root: str, val_dir: str, work: str) -> dict:
    """Phase 3w: the bench-shape sweep with its drills, then the e2e sweep
    and 3w-sg. Returns each counted path's launches by kernel, summed:
    {"dense", "sparse"}, and 3w-sg's apart: {"sg": {"dense", "sparse"}}."""
    import torch

    dev = torch.device("cuda")
    bench_dense = sweep_bench_phase(dev)
    e2e_sparse, e2e_dense, sg = sweep_e2e_phase(root, val_dir, work, dev)
    return {"dense": {k: bench_dense[k] + e2e_dense[k] for k in bench_dense}, "sparse": e2e_sparse,
            "sg": sg}


A9A_TRAIN, A9A_TEST = 32561, 16281  # a9a's published split (123 features)
A9A_CONSTRAINTS = [{"name": "1", "term": "", "lowerBound": -0.01, "upperBound": 0.01},
                   {"name": "2", "term": "", "lowerBound": 0.0}]


def glm_objective(csr, means: np.ndarray, l1: float, l2: float) -> float:
    """The legacy model's objective in float64 on the host: logistic loss
    of the rows, l1 |w|_1 and (l2 / 2) |w|^2."""
    rows = np.repeat(np.arange(csr.num_rows), np.diff(csr.indptr))
    z = np.bincount(rows, csr.values.astype(np.float64) * means[csr.indices], minlength=csr.num_rows)
    y = csr.labels.astype(np.float64)
    return float(np.sum(np.logaddexp(0.0, z) - y * z) + l1 * np.abs(means).sum()
                 + 0.5 * l2 * (means ** 2).sum())


def legacy_driver_small_phase(seed: int) -> dict:
    """Phase 5g: cli.glm_driver at a9a's published size
    (examples/generate_dataset.py, 32,561 + 16,281 rows, 123 features) with
    --format LIBSVM, once with --coefficient-constraints and once with
    ELASTIC_NET (alpha 0.5), each on the card and on the CPU, to tolerance
    1e-10 (at the driver's 1e-7 the relative function-value test fires on
    f32 noise, at iterations that differ with the summation order). The best
    weight must be the same, each weight's AUC within "auc_atol", and each
    model within "fe_coef_atol"; where the solver's stopping noise moves a
    model past it, its objective (float64, host) within "re_objective_rtol"
    of the CPU model's (the row says which held). The bound must hold
    exactly. Returns the card runs' sparse launches."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from photon_ml_tpu_torch.cli import glm_driver
    from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.libsvm import read_libsvm
    from photon_ml_tpu_torch.io import model_store

    tol = PORT_TOLERANCES["card_vs_cpu_glmix"]
    failures, launches = [], {}
    with tempfile.TemporaryDirectory(prefix="photon-a9a-") as root:
        subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "examples" / "generate_dataset.py"),
                        root, "--train", str(A9A_TRAIN), "--test", str(A9A_TEST)],
                       check=True, capture_output=True, timeout=300)
        csr = read_libsvm(os.path.join(root, "train.libsvm"))
        runs = {"constraints": ["--coefficient-constraints", json.dumps(A9A_CONSTRAINTS)],
                "elastic_net": ["--regularization-type", "ELASTIC_NET", "--elastic-net-alpha", "0.5"]}
        for name, extra in runs.items():
            out, summaries = {}, {}
            for device in ("cuda", "cpu"):
                out[device] = os.path.join(root, f"{name}-{device}")
                args = ["--training-data-directory", os.path.join(root, "train.libsvm"),
                        "--validate-data-directory", os.path.join(root, "test.libsvm"),
                        "--output-directory", out[device], "--format", "LIBSVM", "--device", device,
                        "--tolerance", "1e-10", "--max-iterations", "500",
                        "--logging-level", "WARNING", *extra]
                t0 = time.perf_counter()
                if device == "cuda":
                    summaries[device], sparse, dense, _ = counted(torch, lambda: glm_driver.main(args))
                    for k, v in sparse.items():
                        launches[k] = launches.get(k, 0) + v
                    if not sparse["sparse_fused"] or not sparse["sparse_matvec"] or any(dense.values()):
                        failures.append(f"{name}: launches {sparse} / {dense}")
                else:
                    summaries[device] = glm_driver.main(args)
                summaries[device]["wall_s"] = time.perf_counter() - t0
            imap = IndexMap.load(os.path.join(out["cpu"], "feature-index.json"))
            weights = summaries["cpu"]["regularization_weights"]
            alpha = 0.5 if name == "elastic_net" else 0.0
            per_weight = {}
            for rw in weights:
                m = {d: model_store.load_game_model(os.path.join(out[d], "models", str(rw)),
                                                    {"global": imap}).coordinates["global"].means
                     for d in ("cuda", "cpu")}
                coef_err = float(np.abs(m["cuda"] - m["cpu"]).max())
                f = {d: glm_objective(csr, np.asarray(m[d], np.float64), alpha * rw, (1 - alpha) * rw)
                     for d in m}
                gap = abs(f["cuda"] - f["cpu"]) / abs(f["cpu"])
                auc = {d: summaries[d]["validation_metrics"][str(rw)]["Area under ROC"] for d in m}
                held = "coefficients" if coef_err <= tol["fe_coef_atol"] else (
                    "objective" if gap <= tol["re_objective_rtol"] else "neither")
                per_weight[str(rw)] = dict(coef_err=coef_err, objective_rel_gap=gap, held=held,
                                           auc_card=auc["cuda"], auc_cpu=auc["cpu"],
                                           zeros_card=int((m["cuda"] == 0).sum()),
                                           iterations_card=summaries["cuda"]["iterations"][str(rw)],
                                           iterations_cpu=summaries["cpu"]["iterations"][str(rw)])
                if held == "neither" or abs(auc["cuda"] - auc["cpu"]) > tol["auc_atol"]:
                    failures.append(f"{name} weight {rw}: {per_weight[str(rw)]}")
                if name == "constraints":
                    w1 = m["cuda"][imap.get_index("1")]
                    w2 = m["cuda"][imap.get_index("2")]
                    if not (np.float32(-0.01) <= w1 <= np.float32(0.01) and w2 >= 0.0):
                        failures.append(f"{name} weight {rw}: the box does not hold ({w1}, {w2})")
            best = {d: summaries[d]["best_regularization_weight"] for d in ("cuda", "cpu")}
            row = dict(phase="5g", run=name, seed=seed, rows=A9A_TRAIN, test_rows=A9A_TEST, best_weight=best,
                       per_weight=per_weight, wall_s={d: summaries[d]["wall_s"] for d in best},
                       timings_s_card=summaries["cuda"]["timings_s"], tol=tol)
            log(json.dumps(row))
            if best["cuda"] != best["cpu"]:
                failures.append(f"{name}: best weight {best}")
    if failures:
        raise SystemExit("phase 5g failed: " + "; ".join(failures))
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
        if (r["collectives"] != {"exact_sum": passes + 2, "owned_to_global": 0, "exchange": 0}
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
                and r["collectives"] == {"exact_sum": passes + 1, "owned_to_global": 0,
                                         "exchange": 0}
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
    from photon_ml_tpu_torch.ops import cuda_build, ell_kernels, glm_kernels, sparse_kernels
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

    threads = [threading.Thread(target=build, args=(src,), name=f"build-{src.name}")
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, pmesh.SOURCE, ell_kernels.SOURCE)]
    threads.append(threading.Thread(target=build_native, name="build-native"))
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

    # ---- phase 3o: OWLQN, the box and FULL variances on the dense fixed effect ----
    launches3o = walled("phase 3o", optimizer_modes_phase, ds, cfg_f)
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

    # ---- phases 2s-5s: the sparse fixed effect ------------------------------------
    sparse_rows, sparse_launches = walled("phases 2s-5s", sparse_phases, args.seed, dev, bw, f32_rate)

    # ---- phases 2e-5e, 3f and 3c: the e2e cell from Avro files ----------------------
    e2e_rows, e2e_ell_rows, e2e_launches = walled(
        "phases 2e-5e, 3e-d, 5e-d, 3f, 3r, 3c, 3k, 5k, 3g, 3j, 3x, 3m, 3t, 3w, 3v, 3v-sh, 3q, 3mv, 3n, "
        "3n-ladder, 3p", e2e_phases, args.seed, dev, bw, f32_rate, dict(arrays=arrays, phase3=phase3))

    # ---- phase 3e-w: 3e's cell over a 16,384-wide shard ------------------------------
    wide = walled("phase 3e-w", wide_e2e_phase, args.seed, dev, bw, f32_rate)

    # ---- phase 5f: small estimator fits, card vs CPU --------------------------------
    small_launches = walled("phase 5f", estimator_small_phase, args.seed + 51)

    # ---- phase 5c: run_glmix.sh's driver runs, card vs CPU ---------------------------
    driver_launches = walled("phase 5c", driver_small_phase, args.seed + 61)

    # ---- phase 5g: the legacy driver at a9a's size, card vs CPU ----------------------
    legacy_launches = walled("phase 5g", legacy_driver_small_phase, args.seed + 71)

    # ---- phases 2d-5d: data-parallel GLMix on ranks --------------------------------
    dist_rows, dist_launches = walled("phases 2d-5d", distributed_phases, args.seed, dev, arrays,
                                      kernel_rows, phase3)

    # ---- phase lint: photon-lint over the port's tree --------------------------------
    lint_phase()

    # ---- the record lines -------------------------------------------------------
    source = "photon_ml_tpu_torch/csrc/glm_fused.cu"
    replaces = {"value_grad": "photon_ml_tpu/ops/pallas_glm.py:506",
                "hvp": "photon_ml_tpu/ops/pallas_glm.py:542"}
    kernels = [
        dict(name=k, route="cuda", source=source, replaces=replaces[k],
             launches=(launches[k] + e2e_launches["3f"]["dense"][k] + small_launches["dense"][k]
                       + e2e_launches["3c"]["dense"][k] + driver_launches["dense"][k] + launches3o[k]
                       + e2e_launches["3w"]["dense"][k] + e2e_launches["3w"]["sg"]["dense"][k]
                       + e2e_launches["3j"]["dense"][k]
                       + e2e_launches["3r"]["dense"][k] + e2e_launches["3n"]["refresh"][k]
                       + e2e_launches["3p"]["train_dense"][k]),
             launches_by_phase={"3+4": launches[k], "3f": e2e_launches["3f"]["dense"][k],
                                "5f": small_launches["dense"][k], "3c": e2e_launches["3c"]["dense"][k],
                                "5c": driver_launches["dense"][k], "3o": launches3o[k],
                                "3j": e2e_launches["3j"]["dense"][k],
                                "3w": e2e_launches["3w"]["dense"][k],
                                "3w-sg": e2e_launches["3w"]["sg"]["dense"][k],
                                "3v": e2e_launches["3v"]["path"][k],
                                "3v-sh": e2e_launches["3v-sh"]["path"][k],
                                "3q": e2e_launches["3q"][k], "3mv": e2e_launches["3mv"]["workers"][k],
                                "3mv-emulation": e2e_launches["3mv"]["emulation"][k],
                                "3r": e2e_launches["3r"]["dense"][k], "3n": e2e_launches["3n"]["path"][k],
                                "3n-refresh": e2e_launches["3n"]["refresh"][k],
                                "3n-ladder": e2e_launches["3n-ladder"][k],
                                "3p": e2e_launches["3p"]["train_dense"][k] + e2e_launches["3p"]["path"][k]},
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
             launches=(sparse_launches[k] + e2e_launches["3e"][k] + e2e_launches["3e-d"][k]
                       + e2e_launches["3f"]["sparse"][k]
                       + small_launches["sparse"][k] + e2e_launches["3c"]["sparse"][k]
                       + driver_launches["sparse"][k] + e2e_launches["3k"][k] + e2e_launches["3g"][k]
                       + legacy_launches[k] + e2e_launches["3x"][k] + e2e_launches["3t"][k]
                       + e2e_launches["3w"]["sparse"][k] + e2e_launches["3w"]["sg"]["sparse"][k]
                       + e2e_launches["3m"]["sparse"][k]
                       + e2e_launches["3j"]["sparse"][k] + e2e_launches["3r"]["sparse"][k]
                       + e2e_launches["3n"]["refresh"][k] + e2e_launches["3p"]["train"][k]),
             launches_by_phase={"3s+4s": sparse_launches[k], "3e": e2e_launches["3e"][k],
                                "3e-d": e2e_launches["3e-d"][k],
                                "3f": e2e_launches["3f"]["sparse"][k], "5f": small_launches["sparse"][k],
                                "3c": e2e_launches["3c"]["sparse"][k], "5c": driver_launches["sparse"][k],
                                "3k+5k+3o": e2e_launches["3k"][k], "3g": e2e_launches["3g"][k],
                                "5g": legacy_launches[k], "3j": e2e_launches["3j"]["sparse"][k],
                                "3x": e2e_launches["3x"][k],
                                "3t": e2e_launches["3t"][k], "3w": e2e_launches["3w"]["sparse"][k],
                                "3w-sg": e2e_launches["3w"]["sg"]["sparse"][k],
                                "3v": e2e_launches["3v"]["path"][k],
                                "3v-sh": e2e_launches["3v-sh"]["path"][k], "3m": e2e_launches["3m"]["sparse"][k],
                                "3q": e2e_launches["3q"][k], "3mv": e2e_launches["3mv"]["workers"][k],
                                "3mv-emulation": e2e_launches["3mv"]["emulation"][k],
                                "3r": e2e_launches["3r"]["sparse"][k], "3n": e2e_launches["3n"]["path"][k],
                                "3n-refresh": e2e_launches["3n"]["refresh"][k],
                                "3n-ladder": e2e_launches["3n-ladder"][k],
                                "3p": e2e_launches["3p"]["train"][k] + e2e_launches["3p"]["path"][k]},
             max_abs_err=sparse_rows[k]["max_abs_err"],
             ms=sparse_rows[k]["kernel_ms"], plain_ms=sparse_rows[k]["plain_ms"],
             bound_ms=sparse_rows[k]["bound_ms"], bound_by=sparse_rows[k]["bound_by"],
             library_ms=sparse_rows[k]["library_ms"],
             e2e_shape={f: e2e_rows[k][f] for f in ("n", "d", "nnz", "route", "max_abs_err", "kernel_ms",
                                                     "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for k in SPARSE_REPLACES
    ]
    # Kernel #3: #1/#2 on each rank's rows, one all_gather and the rank-order
    # kernel (launched once per cross-rank sum: rank_sum_launches, 3d + 4d,
    # and 3e-d and 3m, where it sums the sparse fixed effect's per-rank sums), rank 0's.
    rank_sums = {"3d+4d": dist_launches["rank_sum"], "3e-d": e2e_launches["3e-d"]["rank_sum"],
                 "3m": e2e_launches["3m"]["rank_sum"]}
    kernels += [
        dict(name=k, route="cuda", source="photon_ml_tpu_torch/csrc/exact_sum.cu",
             replaces=DIST_REPLACES[k], launches=dist_launches[k],
             launches_by_phase={"3d+4d": dist_launches[k], "3e-d": e2e_launches["3e-d"][k],
                                "3w": e2e_launches["3w"]["dense"][k], "3j": e2e_launches["3j"]["dense"][k],
                                "3v": e2e_launches["3v"]["path"][k],
                                "3v-sh": e2e_launches["3v-sh"]["path"][k], "3q": e2e_launches["3q"][k],
                                "3mv": e2e_launches["3mv"]["workers"][k],
                                "3mv-emulation": e2e_launches["3mv"]["emulation"][k],
                                "3r": e2e_launches["3r"]["dense"][k], "3n": e2e_launches["3n"]["path"][k],
                                "3n-refresh": e2e_launches["3n"]["refresh"][k],
                                "3n-ladder": e2e_launches["3n-ladder"][k],
                                "3p": e2e_launches["3p"]["path"][k]},
             rank_sum_launches=sum(rank_sums.values()), rank_sum_launches_by_phase=rank_sums,
             **dist_rows[k])
        for k in DIST_REPLACES
    ]
    # The ELL transposes of a random effect's block (port only): launched in
    # 3e, 3f and 3e-w (each counted from 0); times on 3e's per-user chunk,
    # 3e-w's beside.
    ell_by_phase = {"3e": e2e_launches["3e-ell"]["ell_rmatvec"],
                    "3f": e2e_launches["3f"]["ell"]["ell_rmatvec"], "3e-w": wide["ell"]["ell_rmatvec"]}
    fields = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    row3e = e2e_ell_rows["ell_rmatvec"]
    kernels.append(dict(
        name="ell_rmatvec", route="cuda", source="photon_ml_tpu_torch/csrc/ell_block.cu",
        replaces=ELL_REPLACES, launches=sum(ell_by_phase.values()), launches_by_phase=ell_by_phase,
        max_abs_err=row3e["max_abs_err"], ms=row3e["kernel_ms"], plain_ms=row3e["plain_ms"],
        bound_ms=row3e["bound_ms"], bound_by=row3e["bound_by"], library_ms=row3e["library_ms"],
        dense_einsum_ms=row3e["dense_einsum_ms"], torch_route_ms=row3e["torch_route_ms"],
        wide_shape={f: wide["rows"]["ell_rmatvec"][f] for f in fields + ("torch_route_ms",)}))
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
