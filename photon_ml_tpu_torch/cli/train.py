"""GAME training driver: the end-to-end train CLI.

Port of `photon_ml_tpu/cli/train.py` (photon-client cli/game/training/
GameTrainingDriver.scala:55-855):

    parse args -> read training/validation Avro data onto the device
    (index maps from the data, or from an off-heap PalDB/PHIDX store)
    -> validate rows -> (warm-start model) -> GameEstimator.fit over the
    expanded reg-weight sweep -> optional hyperparameter tuning (RANDOM |
    BAYESIAN) -> model selection -> save models, their feature index maps
    and training-summary.json under the output root.

Output layout (ModelProcessingUtils.saveGameModelToHDFS):
    <root>/models/best/...               (unless output mode NONE)
    <root>/models/explicit-<i>/...       (EXPLICIT | ALL)
    <root>/models/tuned-<i>/...          (TUNED | ALL)
    <root>/models/<dir>/feature-indexes/<shard>.json
    <root>/training-summary.json         (with `timings_s` by section)
    <root>/profile.json                  (the last fit's run profile)
    <root>/journal.jsonl                 (the run journal)
    <root>/trace.json                    (under PHOTON_TRACE=1)
    <root>/photon-ml-tpu.log

The journal holds the job's lifecycle, one typed line an event: `setup`,
then the estimator's `fit_start`, `sweep_config`, `coordinate_update`,
`checkpoint` and `fit_finish`, or `failure` when the job raises. With
PHOTON_TRACE=1 the job's spans (the timed sections, the fit, each
coordinate update, each file's decode, each staged checkpoint write) are
written as Chrome trace-event JSON. `python -m photon_ml_tpu_torch.cli.obs`
reads all three files.

The option names are the JAX driver's, so its command lines parse
unchanged. `--device` (default cuda) picks the device; asking for cuda
with no card raises. Tuning trials are fits on the device; the Bayesian
search's GP runs on the CPU (hyperparameter/gp.py). `--multihost N` runs
the fit on N ranks, one worker process each, under a supervisor that
relaunches the survivors of a rank loss (cli/train_multihost.py; its
workers come back here with `--mh-worker` and keep journals of their own).
`--profile <profile.json>` (a run profile an earlier run wrote) plans the
run (photon_ml_tpu_torch/planner/): installed after the journal and before
the read, refused on another topology, uninstalled on every exit path; a
plan a caller installed stays. PHOTON_PLAN and PHOTON_PLAN_PROFILE work as
in the reference. The summary's `fit_timing` and `profile.json` carry the
`plan` block.

Usage: python -m photon_ml_tpu_torch.cli.train --help
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import logging
import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.cli.config import (
    CoordinateConfiguration,
    coordinate_config_to_string,
    expand_game_opt_configs,
    feature_shard_config_to_string,
    parse_coordinate_config,
    parse_feature_shard_config,
)
from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.data.validators import validate_game_dataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator, GameResult, select_best_result
from photon_ml_tpu_torch.evaluation.suite import EvaluatorType, better_than
from photon_ml_tpu_torch.hyperparameter.search import HyperparameterConfig
from photon_ml_tpu_torch.hyperparameter.tuner import HyperparameterTuningMode, get_tuner
from photon_ml_tpu_torch.io import avro_data, model_bridge, model_store
from photon_ml_tpu_torch.io.paldb import resolve_offheap_index_maps
from photon_ml_tpu_torch.optimize.constraints import bounds_arrays, create_constraint_feature_map
from photon_ml_tpu_torch.types import (
    DataValidationType,
    NormalizationType,
    ProjectorType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)
from photon_ml_tpu_torch.utils.date_range import paths_for_date_range, resolve_range
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.observability import (
    EventEmitter,
    PhotonFailureEvent,
    PhotonLogger,
    PhotonSetupEvent,
    Timed,
    TimingRegistry,
    journal_listener,
)

logger = logging.getLogger("photon_ml_tpu_torch.cli.train")

# Default tuning range for regularization weights (the reference's tuning
# JSON defaults, GameHyperparameterDefaults.scala:20: log-scale weights).
TUNING_REG_WEIGHT_RANGE = (1e-4, 1e4)


class ModelOutputMode(enum.Enum):
    """Reference: io/ModelOutputMode.scala."""

    NONE = "NONE"
    BEST = "BEST"
    EXPLICIT = "EXPLICIT"
    TUNED = "TUNED"
    ALL = "ALL"

    @classmethod
    def parse(cls, name: str) -> "ModelOutputMode":
        return cls[name.strip().upper()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.train",
        description="Train GAME/GLMix models (Photon ML on PyTorch)",
    )
    p.add_argument("--training-task", required=True, type=TaskType.parse,
                   help="LINEAR_REGRESSION | LOGISTIC_REGRESSION | POISSON_REGRESSION | "
                        "SMOOTHED_HINGE_LOSS_LINEAR_SVM")
    p.add_argument("--input-data-directories", required=True, nargs="+",
                   help="training data dirs/files (Avro TrainingExample records)")
    p.add_argument("--input-column-names", default=None,
                   help="Rename record fields: 'response=the_label,weight=w,"
                        "offset=o,uid=id,metadataMap=meta'")
    p.add_argument("--input-data-date-range", default=None,
                   help="Inclusive 'yyyyMMdd-yyyyMMdd' range of daily input "
                        "subdirectories <dir>/yyyy/MM/dd")
    p.add_argument("--input-data-days-range", default=None,
                   help="Relative '<start days ago>-<end days ago>' range")
    p.add_argument("--validation-data-date-range", default=None,
                   help="Date range for validation dirs")
    p.add_argument("--validation-data-days-range", default=None,
                   help="Days range for validation dirs")
    p.add_argument("--validation-data-directories", nargs="*", default=[],
                   help="validation data dirs/files")
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--override-output-directory", action="store_true",
                   help="overwrite an existing output directory")
    p.add_argument("--feature-shard-configurations", required=True, nargs="+", metavar="DSL",
                   help='e.g. "name=globalShard,feature.bags=features|context,intercept=true"')
    p.add_argument("--coordinate-configurations", required=True, nargs="+", metavar="DSL",
                   help='e.g. "name=global,feature.shard=globalShard,optimizer=LBFGS,'
                        'tolerance=1.0E-6,max.iter=50,regularization=L2,reg.weights=0.1|1|10"')
    p.add_argument("--coordinate-update-sequence", default=None,
                   help="comma-separated coordinate ids (default: config order)")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--normalization", type=NormalizationType.parse, default=NormalizationType.NONE)
    p.add_argument("--validation-evaluators", nargs="*", default=[],
                   help="e.g. AUC RMSE PRECISION@5:queryId AUC:documentId")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="directory of prebuilt persistent feature-index partitions "
                        "(cli.build_index output, PHIDX or PalDB, found per shard); "
                        "default: index maps built from the training data")
    p.add_argument("--model-input-directory", default=None,
                   help="warm-start / partial-retrain model directory")
    p.add_argument("--partial-retrain-locked-coordinates", default=None,
                   help="comma-separated coordinate ids to lock (reuse from "
                        "--model-input-directory)")
    p.add_argument("--variance-computation-type", type=VarianceComputationType.parse,
                   default=VarianceComputationType.NONE)
    p.add_argument("--data-validation", type=lambda s: DataValidationType[s.strip().upper()],
                   default=DataValidationType.VALIDATE_FULL)
    p.add_argument("--checkpoint-directory", default=None,
                   help="checkpoint the coordinate descent after every update under "
                        "<dir>/config-<i>/; a rerun resumes there")
    p.add_argument("--data-summary-directory", default=None,
                   help="Write per-feature-shard summary statistics as "
                        "FeatureSummarizationResultAvro under this directory")
    p.add_argument("--output-mode", type=ModelOutputMode.parse, default=ModelOutputMode.BEST)
    p.add_argument("--model-sparsity-threshold", type=float, default=0.0)
    p.add_argument("--hyper-parameter-tuning", type=HyperparameterTuningMode.parse,
                   default=HyperparameterTuningMode.NONE,
                   help="NONE | RANDOM | BAYESIAN: tune each regularized coordinate's "
                        "weight on the validation data after the explicit sweep")
    p.add_argument("--hyper-parameter-tuning-iter", type=int, default=20,
                   help="tuning trials (one fit each)")
    p.add_argument("--hyper-parameter-tuning-batch-size", type=int, default=1,
                   help="proposals a round: Sobol batches (RANDOM), constant-liar "
                        "EI (BAYESIAN); the trials of a round are fitted one by one")
    p.add_argument("--random-seed", type=int, default=0)
    p.add_argument("--profile", default=None,
                   help="a persisted run profile (profile.json from a prior run) the adaptive "
                        "planner consumes (the Python ingest route's chunk rows); topology-checked "
                        "loudly. Overrides PHOTON_PLAN_PROFILE")
    p.add_argument("--logging-level", default="INFO")
    p.add_argument("--application-name", default="photon-ml-tpu-training")
    p.add_argument("--multihost", type=int, default=0, metavar="N",
                   help="train on N ranks, one worker process each, under a supervisor that "
                        "relaunches the survivors of a rank loss (needs --checkpoint-directory "
                        "and --offheap-indexmap-dir; cli/train_multihost.py)")
    p.add_argument("--multihost-devices-per-host", type=int, default=None, metavar="M",
                   help="devices of one rank: 1 (a rank of the port drives one device)")
    # The multi-host workers' internal flags (set by the supervisor).
    p.add_argument("--mh-worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mh-attempt", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--mh-coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--mh-num-hosts", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--mh-host-id", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--mh-rendezvous", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:<i> or cpu; cuda with no card raises. With "
                        "--multihost: cpu, one card cuda:<i> shared by every rank, or cuda (a "
                        "card each where there are enough, else all on cuda:0)")
    return p


def _read_data(args, coordinate_configs: Dict[str, CoordinateConfiguration], device):
    """readTrainingData/readValidationData (GameTrainingDriver.scala:503-547):
    index maps come from the off-heap store when one is given
    (prepareFeatureMaps, GameDriver.scala:231-236), else from the training
    data; validation rows read through them."""
    shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    id_tags = [c.data_config.random_effect_type for c in coordinate_configs.values()
               if isinstance(c.data_config, RandomEffectDataConfig)]
    for ev in args.validation_evaluators:
        et = EvaluatorType.parse(ev)
        if et.is_grouped and et.id_tag not in id_tags:
            id_tags.append(et.id_tag)
    columns = (avro_data.InputColumnNames.parse(args.input_column_names)
               if args.input_column_names else avro_data.InputColumnNames())
    prebuilt = (resolve_offheap_index_maps(args.offheap_indexmap_dir, shard_configs)
                if args.offheap_indexmap_dir else None)
    train_range = resolve_range(args.input_data_date_range, args.input_data_days_range)
    train, index_maps = avro_data.read_game_dataset(
        paths_for_date_range(args.input_data_directories, train_range), shard_configs,
        index_maps=prebuilt, id_tag_fields=id_tags, columns=columns, device=device)
    validation = None
    if args.validation_data_directories:
        val_range = resolve_range(args.validation_data_date_range, args.validation_data_days_range)
        validation, _ = avro_data.read_game_dataset(
            paths_for_date_range(args.validation_data_directories, val_range), shard_configs,
            index_maps=index_maps, id_tag_fields=id_tags, columns=columns, device=device)
    return train, validation, index_maps


def _apply_constraints(args, coordinate_configs: Dict[str, CoordinateConfiguration],
                       index_maps) -> None:
    """constraints.file in the coordinate DSL: the JSON constraint string
    resolved against the shard's index map (optimize/constraints.py) into
    the (lower, upper) vectors of the coordinate's projected L-BFGS. The
    bounds are per original feature, so normalization (the optimizer works
    in normalized space) and a random effect whose projector is not
    IDENTITY are refused, as the JAX driver refuses them."""
    for cfg in coordinate_configs.values():
        if not cfg.constraint_file:
            continue
        if args.normalization != NormalizationType.NONE:
            raise ValueError(
                f"coordinate {cfg.name!r}: box constraints cannot combine "
                "with --normalization (bounds apply in original feature "
                "space; the optimizer works in normalized space)")
        dc_cfg = cfg.data_config
        if isinstance(dc_cfg, RandomEffectDataConfig) and dc_cfg.projector_type != ProjectorType.IDENTITY:
            raise ValueError(
                f"coordinate {cfg.name!r}: box constraints require the "
                "IDENTITY projector (bounds are per global feature index)")
        imap = index_maps[dc_cfg.feature_shard]
        with open(cfg.constraint_file) as f:
            cmap = create_constraint_feature_map(f.read(), imap)
        box = bounds_arrays(cmap, imap.size)
        if box is not None:
            cfg.opt_config = dataclasses.replace(
                cfg.opt_config,
                optimizer=dataclasses.replace(cfg.opt_config.optimizer, box_constraints=box))
            logger.info("coordinate %s: box constraints on %d feature(s)", cfg.name, len(cmap))


def _tuning_dimensions(coordinate_configs: Dict[str, CoordinateConfiguration],
                       tunable_ids) -> List[HyperparameterConfig]:
    """One LOG-scale dimension per regularized trainable coordinate
    (GameEstimatorEvaluationFunction.configurationToVector:152); locked
    coordinates have no config entry in the sweep and are not tuned."""
    return [HyperparameterConfig(name=cid, min_value=TUNING_REG_WEIGHT_RANGE[0],
                                 max_value=TUNING_REG_WEIGHT_RANGE[1], transform="LOG")
            for cid, cfg in coordinate_configs.items()
            if cid in tunable_ids and cfg.opt_config.regularization.reg_type != RegularizationType.NONE]


def _tune(args, estimator, coordinate_configs, train, validation,
          explicit: List[GameResult]) -> Tuple[List[GameResult], List[dict]]:
    """runHyperparameterTuning (GameTrainingDriver.scala:643): a search over
    the regularized coordinates' weights, each trial one fit on the device
    warm-started from the best explicit model, scored on the validation
    data. The searcher draws from `--random-seed` + 1. Returns the trials'
    results in order and a record of each (its weights, metric and fit
    seconds); none without validation data or a tunable weight."""
    if validation is None:
        return [], []
    dims = _tuning_dimensions(coordinate_configs, set(explicit[0].config))
    if not dims:
        return [], []
    _, base = select_best_result(explicit)
    maximize = better_than(base.evaluation.primary, 1.0, 0.0)
    tuned: List[GameResult] = []
    trials: List[dict] = []

    def evaluate(point: np.ndarray) -> float:
        cfgs = dict(base.config)
        for value, dim in zip(point, dims):
            cfgs[dim.name] = dataclasses.replace(cfgs[dim.name], reg_weight=float(value))
        t0 = time.perf_counter()
        tuned.append(estimator.fit(train, validation, [cfgs], initial_model=base.model)[0])
        value = tuned[-1].evaluation.primary_value
        trials.append({"reg_weights": {d.name: float(v) for d, v in zip(dims, point)},
                       "value": value, "fit_s": time.perf_counter() - t0})
        return value

    get_tuner(args.hyper_parameter_tuning).search(
        args.hyper_parameter_tuning_iter, dims, args.hyper_parameter_tuning, evaluate,
        maximize=maximize, seed=args.random_seed + 1,
        batch_size=args.hyper_parameter_tuning_batch_size)
    logger.info("hyperparameter tuning: %d trials", len(tuned))
    return tuned, trials


def run(args, event_emitter: Optional[EventEmitter] = None) -> Dict[str, object]:
    """The training job; its lifecycle events go to `event_emitter` (a new
    one by default) and, through it, into `<root>/journal.jsonl`."""
    logging.basicConfig(
        level=getattr(logging, args.logging_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    coordinate_configs: Dict[str, CoordinateConfiguration] = {}
    for s in args.coordinate_configurations:
        cfg = parse_coordinate_config(s)
        coordinate_configs[cfg.name] = cfg
    device = resolve_device(args.device)

    out_root = args.root_output_directory
    models_root = os.path.join(out_root, "models")
    if os.path.exists(models_root):
        if not args.override_output_directory:
            raise FileExistsError(
                f"{models_root} exists; pass --override-output-directory to replace")
        # Never mix stale model subdirs into the new run (cleanOutputDirs,
        # GameTrainingDriver.scala:487).
        shutil.rmtree(models_root)
    os.makedirs(out_root, exist_ok=True)
    job_logger = PhotonLogger(os.path.join(out_root, "photon-ml-tpu.log"), level=args.logging_level)
    if event_emitter is None:
        event_emitter = EventEmitter()
    journal = telemetry.RunJournal(os.path.join(out_root, "journal.jsonl"))
    event_emitter.register(journal_listener(journal))
    # Only the ambient slots this run fills are emptied at its end: a
    # caller's journal or tracer outlives the run.
    journal_owned = telemetry.current_journal() is None
    if journal_owned:
        telemetry.install_journal(journal)
    tracer_owned = telemetry.current_tracer() is None
    tracer = telemetry.start_tracing_if_enabled()
    event_emitter.send(PhotonSetupEvent(args=str(vars(args))))
    try:
        # After the journal (plan_decision lines land in it), before the read.
        with planner.owned_plan(args.profile, device=device):
            return _run_job(args, coordinate_configs, device, out_root, models_root, event_emitter)
    except Exception as exc:
        logger.exception("training job failed")
        event_emitter.send(PhotonFailureEvent(error=repr(exc)))
        raise
    finally:
        if tracer is not None and tracer_owned:
            tracer.export(os.path.join(out_root, "trace.json"))
            telemetry.uninstall_tracer()
            logger.info("trace written to %s", os.path.join(out_root, "trace.json"))
        if journal_owned:
            telemetry.uninstall_journal()
        journal.close()
        job_logger.close()


def _run_job(args, coordinate_configs, device, out_root: str, models_root: str,
             event_emitter: EventEmitter) -> Dict[str, object]:
    timings = TimingRegistry()
    update_sequence = ([c.strip() for c in args.coordinate_update_sequence.split(",")]
                       if args.coordinate_update_sequence else list(coordinate_configs))
    locked = ({c.strip() for c in args.partial_retrain_locked_coordinates.split(",")}
              if args.partial_retrain_locked_coordinates else set())
    if locked and not args.model_input_directory:
        raise ValueError("--partial-retrain-locked-coordinates requires --model-input-directory")

    # The effective configuration, printed back in the DSL.
    logger.info("effective feature shard configurations:")
    for s in args.feature_shard_configurations:
        logger.info("  %s", feature_shard_config_to_string(*parse_feature_shard_config(s)))
    logger.info("effective coordinate configurations:")
    for cfg in coordinate_configs.values():
        logger.info("  %s", coordinate_config_to_string(cfg))

    with Timed("read data", registry=timings, device=device):
        train, validation, index_maps = _read_data(args, coordinate_configs, device)
    logger.info("training data: %d samples, shards %s", train.num_samples,
                {k: v.size for k, v in index_maps.items()})
    with Timed("validate data", registry=timings, device=device):
        validate_game_dataset(train, args.training_task, args.data_validation)
        if validation is not None:
            validate_game_dataset(validation, args.training_task, args.data_validation)

    # calculateAndSaveFeatureShardStats (GameTrainingDriver.scala:575-593).
    if args.data_summary_directory:
        with Timed("feature summarization", registry=timings, device=device):
            for shard, imap in index_maps.items():
                stats = summarize(train.shards[shard], intercept_index=imap.intercept_index)
                n_written = model_store.write_basic_statistics(
                    os.path.join(args.data_summary_directory, shard), stats, imap)
                logger.info("feature summary: shard %s -> %d records", shard, n_written)

    if args.variance_computation_type != VarianceComputationType.NONE:
        for cfg in coordinate_configs.values():
            cfg.opt_config = dataclasses.replace(
                cfg.opt_config, variance_computation=args.variance_computation_type)

    _apply_constraints(args, coordinate_configs, index_maps)

    estimator = GameEstimator(
        args.training_task,
        {cid: c.data_config for cid, c in coordinate_configs.items()},
        update_sequence=update_sequence,
        coordinate_descent_iterations=args.coordinate_descent_iterations,
        normalization=args.normalization,
        validation_evaluators=[EvaluatorType.parse(e) for e in args.validation_evaluators],
        locked_coordinates=locked or None,
        intercept_indices={shard: imap.intercept_index for shard, imap in index_maps.items()
                           if imap.intercept_index is not None},
        seed=args.random_seed,
        checkpoint_dir=args.checkpoint_directory,
        event_emitter=event_emitter,
    )

    # Warm start / partial retrain (GameTrainingDriver.scala:370-409).
    initial_model = None
    if args.model_input_directory:
        artifact = model_store.load_game_model(args.model_input_directory, index_maps)
        estimator.prepare(train)
        initial_model = model_bridge.warm_start_model_for_estimator(
            artifact, estimator.scoring_specs(), device)
        logger.info("warm start from %s", args.model_input_directory)

    sweep = expand_game_opt_configs(
        {cid: coordinate_configs[cid] for cid in update_sequence if cid not in locked})
    logger.info("training %d explicit configuration(s)", len(sweep))
    with Timed("train explicit configurations", registry=timings, device=device):
        explicit: List[GameResult] = estimator.fit(train, validation, sweep,
                                                   initial_model=initial_model)
    tuned, trials = [], []
    if args.hyper_parameter_tuning != HyperparameterTuningMode.NONE:
        with Timed("hyperparameter tuning", registry=timings, device=device):
            tuned, trials = _tune(args, estimator, coordinate_configs, train, validation, explicit)

    # Model selection over explicit and tuned results, then save
    # (GameTrainingDriver.scala:683-779).
    results = explicit + tuned
    best_i, best = select_best_result(results)
    specs = estimator.scoring_specs()
    summary: Dict[str, object] = {
        "num_samples": int(train.num_samples),
        "num_explicit": len(explicit),
        "num_tuned": len(tuned),
        "best_index": best_i,
        "best_evaluation": None if best.evaluation is None else best.evaluation.results,
    }
    if trials:
        summary["tuning_trials"] = trials
        summary["evaluations"] = [None if r.evaluation is None else r.evaluation.results for r in results]

    def save(result: GameResult, subdir: str) -> None:
        artifact = model_bridge.artifact_from_game_model(
            result.model, specs, args.training_task,
            opt_configs={cid: {"optimizer": c.optimizer.optimizer_type.value,
                               "max_iterations": c.optimizer.max_iterations,
                               "tolerance": c.optimizer.tolerance,
                               "regularization": c.regularization.reg_type.value,
                               "reg_weight": c.reg_weight}
                         for cid, c in result.config.items()})
        mdir = os.path.join(models_root, subdir)
        model_store.save_game_model(mdir, artifact, index_maps,
                                    sparsity_threshold=args.model_sparsity_threshold)
        # The feature index maps ship with the model, so the scoring driver
        # resolves names as training did.
        idx_dir = os.path.join(mdir, "feature-indexes")
        os.makedirs(idx_dir, exist_ok=True)
        for shard, imap in index_maps.items():
            imap.save(os.path.join(idx_dir, f"{shard}.json"))

    if args.output_mode != ModelOutputMode.NONE:
        with Timed("save models", registry=timings, device=device):
            save(best, "best")
            if args.output_mode in (ModelOutputMode.EXPLICIT, ModelOutputMode.ALL):
                for i, r in enumerate(explicit):
                    save(r, f"explicit-{i}")
            if args.output_mode in (ModelOutputMode.TUNED, ModelOutputMode.ALL):
                for i, r in enumerate(tuned):
                    save(r, f"tuned-{i}")

    for i, r in enumerate(results):
        logger.info("config %d%s: %s", i, " (best)" if i == best_i else "",
                    None if r.evaluation is None else r.evaluation.results)
    for r in results:
        for section, seconds in r.timing.items():
            timings.record(f"coordinate {section}", seconds)
    summary["timings_s"] = dict(timings.seconds)
    summary["fit_timing"] = dict(estimator.fit_timing)
    with open(os.path.join(out_root, "training-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    # The last fit's run profile (after tuning, the last trial's).
    profile_path = telemetry.write_profile(os.path.join(out_root, "profile.json"),
                                           estimator.run_profile())
    logger.info("run profile written to %s", profile_path)
    logger.info("timing summary:\n%s", timings.summary())
    return summary


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Parse `argv` (default: the process's) and run; returns the summary
    written to training-summary.json. `--multihost N` runs the supervisor,
    and `--mh-worker` one of its workers, which exits with its code."""
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)
    if args.mh_worker:
        from photon_ml_tpu_torch.cli import train_multihost

        raise SystemExit(train_multihost.run_worker(args))
    if args.multihost:
        from photon_ml_tpu_torch.cli import train_multihost

        return train_multihost.run_supervisor(args, raw_argv)
    return run(args)


if __name__ == "__main__":
    main()
