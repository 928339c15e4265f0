"""Hyperparameter sweep driver: batched tuning of GAME regularization weights.

Port of `photon_ml_tpu/cli/tune.py`. Where `cli/train.py`'s tuning runs one
full `estimator.fit` a trial (the reference's serial search,
GameTrainingDriver.scala:643-680), this driver runs the sweep through the
batched trial executor (`hyperparameter/sweep.py`): the GP/Sobol searcher
proposes k-candidate rounds, each round is evaluated as stacked trials (or
one trial a shard group, or serially), with `trial_start`/`trial_finish`
journal events and rounds warm-started from the incumbent. The winner is
refit cold and saved, bit-equal to a standalone fit of the winning
configuration.

    parse args -> read training/validation Avro data onto the device
    -> validate rows -> GameEstimator.sweep_executor
    -> HyperparameterTuner.sweep (RANDOM | BAYESIAN, batched rounds)
    -> models/tuned-best (+ feature-indexes/), tuning-summary.json,
       journal.jsonl, trace.json under PHOTON_TRACE

The option names are the JAX driver's. `--device` (default cuda) picks the
device; asking for cuda with no card raises. `--profile` plans the sweep's
fits (photon_ml_tpu_torch/planner/), as in cli.train: installed after the
journal and before the read, refused on another topology, uninstalled on
every exit path. Shard groups of more than one card are ROADMAP item 9 and raise.
`tuning-summary.json` carries the reference's keys plus `timings_s`.

Usage: python -m photon_ml_tpu_torch.cli.tune --help
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.cli.config import parse_coordinate_config
from photon_ml_tpu_torch.cli.train import TUNING_REG_WEIGHT_RANGE, _read_data, _tuning_dimensions
from photon_ml_tpu_torch.data.validators import validate_game_dataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
from photon_ml_tpu_torch.evaluation.suite import EvaluatorType
from photon_ml_tpu_torch.hyperparameter.tuner import HyperparameterTuningMode, get_tuner
from photon_ml_tpu_torch.io import model_bridge, model_store
from photon_ml_tpu_torch.types import DataValidationType, NormalizationType, TaskType
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.observability import Timed, TimingRegistry

logger = logging.getLogger("photon_ml_tpu_torch.cli.tune")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.tune",
        description="Batched hyperparameter sweeps over GAME/GLMix regularization weights "
                    "(Photon ML on PyTorch)",
    )
    p.add_argument("--training-task", required=True, type=TaskType.parse)
    p.add_argument("--input-data-directories", required=True, nargs="+")
    p.add_argument("--validation-data-directories", required=True, nargs="+",
                   help="validation data (the trial metric): a sweep without validation has "
                        "no objective")
    p.add_argument("--input-column-names", default=None)
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--override-output-directory", action="store_true")
    p.add_argument("--feature-shard-configurations", required=True, nargs="+", metavar="DSL")
    p.add_argument("--coordinate-configurations", required=True, nargs="+", metavar="DSL",
                   help="the mini-DSL of cli.train; each coordinate's reg weight is the base "
                        "the sweep tunes around")
    p.add_argument("--coordinate-update-sequence", default=None)
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--normalization", type=NormalizationType.parse,
                   default=NormalizationType.NONE)
    p.add_argument("--validation-evaluators", nargs="*", default=[])
    p.add_argument("--offheap-indexmap-dir", default=None)
    p.add_argument("--data-validation", type=lambda s: DataValidationType[s.strip().upper()],
                   default=DataValidationType.VALIDATE_FULL)
    p.add_argument("--tuning-mode", type=HyperparameterTuningMode.parse,
                   default=HyperparameterTuningMode.BAYESIAN,
                   help="RANDOM | BAYESIAN (constant-liar qEI rounds)")
    p.add_argument("--tuning-iter", type=int, default=16, help="total trials across all rounds")
    p.add_argument("--tuning-batch-size", type=int, default=4,
                   help="candidates proposed and evaluated a round")
    p.add_argument("--sweep-mode", default=None, choices=["stacked", "shard_group", "serial"],
                   help="trial evaluation mode (default: auto, stacked when no coordinate "
                        "store is entity-sharded, else shard groups on several cards)")
    p.add_argument("--no-warm-start", action="store_true",
                   help="do not warm-start rounds from the incumbent (the parity mode)")
    p.add_argument("--max-stack", type=int, default=None,
                   help="override PHOTON_SWEEP_MAX_STACK for this run")
    p.add_argument("--shard-groups", type=int, default=None,
                   help="override PHOTON_SWEEP_SHARD_GROUPS for this run")
    p.add_argument("--profile", default=None,
                   help="a persisted run profile the adaptive planner consumes for the sweep's "
                        "fits; topology-checked loudly. Overrides PHOTON_PLAN_PROFILE")
    p.add_argument("--random-seed", type=int, default=0)
    p.add_argument("--logging-level", default="INFO")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda with no card raises")
    # cli.train's reader also reads date ranges; the sweep driver has none.
    p.set_defaults(input_data_date_range=None, input_data_days_range=None,
                   validation_data_date_range=None, validation_data_days_range=None)
    return p


def run(args) -> Dict[str, object]:
    logging.basicConfig(
        level=getattr(logging, args.logging_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    device = resolve_device(args.device)
    out_root = args.root_output_directory
    models_root = os.path.join(out_root, "models")
    if os.path.exists(models_root):
        if not args.override_output_directory:
            raise FileExistsError(f"{models_root} exists; pass --override-output-directory")
        shutil.rmtree(models_root)
    os.makedirs(out_root, exist_ok=True)

    # The run journal (trial_start/trial_finish land here) and, under
    # PHOTON_TRACE, the span trace; a caller's own journal or tracer stays.
    journal = telemetry.RunJournal(os.path.join(out_root, "journal.jsonl"))
    journal_owned = telemetry.current_journal() is None
    if journal_owned:
        telemetry.install_journal(journal)
    tracer_owned = telemetry.current_tracer() is None
    tracer = telemetry.start_tracing_if_enabled()
    try:
        with planner.owned_plan(args.profile, device=device):
            return _run_job(args, device, out_root, models_root)
    finally:
        if tracer is not None and tracer_owned:
            tracer.export(os.path.join(out_root, "trace.json"))
            telemetry.uninstall_tracer()
        if journal_owned:
            telemetry.uninstall_journal()
        journal.close()


def _run_job(args, device, out_root: str, models_root: str) -> Dict[str, object]:
    timings = TimingRegistry()
    coordinate_configs = {}
    for s in args.coordinate_configurations:
        cfg = parse_coordinate_config(s)
        coordinate_configs[cfg.name] = cfg
    update_sequence = ([c.strip() for c in args.coordinate_update_sequence.split(",")]
                       if args.coordinate_update_sequence else list(coordinate_configs))

    with Timed("read data", registry=timings, device=device):
        train, validation, index_maps = _read_data(args, coordinate_configs, device)
    if validation is None:
        raise ValueError("--validation-data-directories produced no data")
    with Timed("validate data", registry=timings, device=device):
        validate_game_dataset(train, args.training_task, args.data_validation)
        validate_game_dataset(validation, args.training_task, args.data_validation)
    logger.info("sweep data: %d training / %d validation samples", train.num_samples,
                validation.num_samples)

    dims = _tuning_dimensions(coordinate_configs, set(update_sequence))
    if not dims:
        raise ValueError("no tunable coordinates: every coordinate's regularization is NONE "
                         "(the sweep tunes reg weights)")
    tuned_names = [d.name for d in dims]

    estimator = GameEstimator(
        args.training_task,
        {cid: c.data_config for cid, c in coordinate_configs.items()},
        update_sequence=update_sequence,
        coordinate_descent_iterations=args.coordinate_descent_iterations,
        normalization=args.normalization,
        validation_evaluators=[EvaluatorType.parse(e) for e in args.validation_evaluators],
        intercept_indices={shard: imap.intercept_index for shard, imap in index_maps.items()
                           if imap.intercept_index is not None},
        seed=args.random_seed,
    )
    base_config = {cid: coordinate_configs[cid].opt_config for cid in update_sequence}
    with Timed("prepare", registry=timings, device=device):
        executor = estimator.sweep_executor(
            train, validation, base_config, tuned_ids=tuned_names, mode=args.sweep_mode,
            warm_start=not args.no_warm_start, max_stack=args.max_stack,
            shard_groups=args.shard_groups)

    t0 = time.perf_counter()
    with Timed("sweep", registry=timings, device=device):
        out = get_tuner(args.tuning_mode).sweep(
            args.tuning_iter, dims, args.tuning_mode, executor, seed=args.random_seed + 1,
            batch_size=args.tuning_batch_size)
    if out is None:
        raise ValueError("tuning mode NONE or zero iterations: nothing to do")
    search_result, sweep_result = out
    sweep_wall = time.perf_counter() - t0
    logger.info("sweep: %d trials in %.1fs, best %s=%.6f at %s", len(sweep_result.trials),
                sweep_wall, str(executor.validation_suite.primary), sweep_result.best_value,
                dict(zip(tuned_names, sweep_result.best_point.tolist())))

    # The winner (the cold refit), in cli.train's layout.
    specs = estimator.scoring_specs()
    artifact = model_bridge.artifact_from_game_model(
        sweep_result.winner_model, specs, args.training_task,
        opt_configs={
            cid: {"optimizer": c.optimizer.optimizer_type.value,
                  "max_iterations": c.optimizer.max_iterations,
                  "tolerance": c.optimizer.tolerance,
                  "regularization": c.regularization.reg_type.value,
                  "reg_weight": (float(sweep_result.best_point[tuned_names.index(cid)])
                                 if cid in tuned_names else c.reg_weight)}
            for cid, c in base_config.items()
        })
    mdir = os.path.join(models_root, "tuned-best")
    with Timed("save model", registry=timings, device=device):
        model_store.save_game_model(mdir, artifact, index_maps)
        idx_dir = os.path.join(mdir, "feature-indexes")
        os.makedirs(idx_dir, exist_ok=True)
        for shard, imap in index_maps.items():
            imap.save(os.path.join(idx_dir, f"{shard}.json"))

    summary: Dict[str, object] = {
        "num_training_samples": int(train.num_samples),
        "num_validation_samples": int(validation.num_samples),
        "tuning_mode": args.tuning_mode.value,
        "trials": [t.timing_entry() for t in sweep_result.trials],
        "rounds": executor.rounds,
        "batch_size": int(args.tuning_batch_size),
        "modes": sorted({t.mode for t in sweep_result.trials}),
        "stack_decisions": sweep_result.stack_decisions,
        "sweep_wall_s": round(sweep_wall, 3),
        "winner_refit_s": round(sweep_result.winner_refit_s, 3),
        "tuned_coordinates": tuned_names,
        "tuning_range": list(TUNING_REG_WEIGHT_RANGE),
        "best_trial": sweep_result.best_trial,
        "best_point": sweep_result.best_point.tolist(),
        "best_value": sweep_result.best_value,
        "winner_value": sweep_result.winner_value,
        "best_observation": float(search_result.best_value),
        "timings_s": dict(timings.seconds),
    }
    with open(os.path.join(out_root, "tuning-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    logger.info("winner model saved to %s", mdir)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Parse `argv` (default: the process's) and run; returns the summary
    written to tuning-summary.json."""
    return run(build_parser().parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
