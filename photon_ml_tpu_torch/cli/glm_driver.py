"""Legacy single-GLM training driver: the staged pipeline.

Port of `photon_ml_tpu/cli/glm_driver.py` (photon-client Driver.scala:60-524,
stages INIT -> PREPROCESSED -> TRAINED -> VALIDATED): one fixed-effect GLM
over LibSVM or TrainingExample-Avro input, a regularization sweep trained
with warm starts (models/training.py), per-weight validation metrics
(evaluation/legacy.py) and model selection, an inline JSON constraint
string for box constraints, L1 and elastic net through OWLQN. The data
lives on `--device` (default cuda; cuda with no card raises) as a sparse
layout, so on the card training runs the fused value/gradient kernel,
scoring the X w kernel and SIMPLE variances the X^T u kernel.

Output layout, the JAX driver's:
    <out>/learned-models-text/model-<rw>.txt   name\\tterm\\tvalue\\trw lines,
                                               by value descending
    <out>/models/<rw>/                         the model store's layout
    <out>/feature-index.json
    <out>/driver-summary.json
    <out>/journal.jsonl                        `fit_start`, `fit_finish`

Usage: python -m photon_ml_tpu_torch.cli.glm_driver --help
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
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data import sparse_layout
from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures, pack_csr_to_ell
from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap, feature_key
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import legacy
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
from photon_ml_tpu_torch.io.model_store import (
    FixedEffectArtifact,
    GameModelArtifact,
    save_game_model,
    write_basic_statistics,
)
from photon_ml_tpu_torch.models.training import train_glm_sweep
from photon_ml_tpu_torch.ops.normalization import from_feature_stats
from photon_ml_tpu_torch.optimize.config import (
    CoordinateOptimizationConfig,
    OptimizerConfig,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimize.constraints import bounds_arrays, create_constraint_feature_map
from photon_ml_tpu_torch.types import NormalizationType, OptimizerType, RegularizationType, TaskType
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.observability import (
    EventEmitter,
    Timed,
    TimingRegistry,
    TrainingFinishEvent,
    TrainingStartEvent,
    journal_listener,
)

logger = logging.getLogger("photon_ml_tpu_torch.cli.glm_driver")


class DriverStage(enum.IntEnum):
    """DriverStage.scala:45-49."""

    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3


class InputFormat(enum.Enum):
    """TRAINING_EXAMPLE (Avro) | LIBSVM."""

    TRAINING_EXAMPLE = "TRAINING_EXAMPLE"
    LIBSVM = "LIBSVM"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-glm-driver",
        description="Legacy single-GLM staged training driver (Driver.scala)",
    )
    p.add_argument("--training-data-directory", required=True)
    p.add_argument("--validate-data-directory", default=None)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--delete-output-dirs-if-exist", action="store_true")
    p.add_argument("--format", type=lambda s: InputFormat[s.strip().upper()],
                   default=InputFormat.TRAINING_EXAMPLE,
                   help="TRAINING_EXAMPLE (Avro) or LIBSVM")
    p.add_argument("--task", type=TaskType.parse, default=TaskType.LOGISTIC_REGRESSION)
    p.add_argument("--regularization-weights", default="0.1,1,10,100",
                   help="comma-separated sweep (trained descending, warm start)")
    p.add_argument("--regularization-type", type=RegularizationType.parse,
                   default=RegularizationType.L2)
    p.add_argument("--elastic-net-alpha", type=float, default=None)
    p.add_argument("--optimizer", type=OptimizerType.parse, default=OptimizerType.LBFGS)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--normalization-type", type=NormalizationType.parse,
                   default=NormalizationType.NONE)
    p.add_argument("--intercept", default="true",
                   help="append the intercept pseudo-feature (true/false)")
    p.add_argument("--coefficient-constraints", default=None,
                   help="inline JSON constraint string (GLMSuite.scala:46 "
                        "format, wildcards supported)")
    p.add_argument("--selected-features-file", default=None,
                   help="Avro of FeatureNameTermAvro records (or JSON lines "
                        "of {name, term}); training restricts to these "
                        "features + intercept (Driver.prepareTrainingData, "
                        "GLMSuite selectedFeaturesFile)")
    p.add_argument("--summarization-output-dir", default=None,
                   help="write per-feature statistics as "
                        "FeatureSummarizationResultAvro")
    p.add_argument("--logging-level", default="INFO")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda with no card raises")
    return p


@dataclasses.dataclass
class _State:
    stage: DriverStage = DriverStage.INIT
    stage_history: List[DriverStage] = dataclasses.field(default_factory=list)

    def assert_stage(self, expected: DriverStage) -> None:
        """Driver.assertDriverStage: refuse to run stages out of order."""
        if self.stage != expected:
            raise RuntimeError(f"Expected driver stage {expected.name} but found {self.stage.name}")

    def update(self, new: DriverStage) -> None:
        self.stage_history.append(self.stage)
        self.stage = new


def _read(args, path: str, device, index_map: Optional[IndexMap] = None):
    """LibSVM or TrainingExample Avro -> (LabeledData over the ELL shard on
    `device`, the index map)."""
    flag = args.intercept.strip().lower()
    if flag not in ("true", "false"):
        raise ValueError(f"--intercept must be true or false, got {args.intercept!r}")
    with_intercept = flag == "true"
    if args.format == InputFormat.LIBSVM:
        if args.selected_features_file:
            # LibSVM features are positional: a (name, term) list means nothing there.
            raise ValueError("--selected-features-file requires --format TRAINING_EXAMPLE")
        num_features = None
        if index_map is not None:
            num_features = index_map.size - (1 if with_intercept else 0)
        csr = read_libsvm(path, add_intercept=with_intercept, num_features=num_features)
        feats = pack_csr_to_ell(csr.indptr, csr.indices, csr.values, csr.dim)
        n = csr.num_rows
        data = LabeledData(
            SparseFeatures(feats.indices.to(device), feats.values.to(device), feats.dim),
            torch.from_numpy(np.ascontiguousarray(csr.labels, np.float32)).to(device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.ones(n, dtype=torch.float32, device=device),
        )
        if index_map is None:
            # Feature i is named str(i + 1), as in the reference's LibSVM format.
            names = [str(i + 1) for i in range(csr.dim - (1 if with_intercept else 0))]
            index_map = IndexMap({**{n_: i for i, n_ in enumerate(names)},
                                  **({"(INTERCEPT)": csr.dim - 1} if with_intercept else {})})
        return data, index_map
    shards = {"global": FeatureShardConfig(("features",), with_intercept)}
    if index_map is None and args.selected_features_file:
        index_map = _selected_features_map(args.selected_features_file, with_intercept)
    maps = None if index_map is None else {"global": index_map}
    ds, built = read_game_dataset(path, shards, index_maps=maps, device=device)
    return LabeledData(ds.shards["global"], ds.labels, ds.offsets, ds.weights), built["global"]


def _selected_features_map(path: str, with_intercept: bool) -> IndexMap:
    """The index map of the listed (name, term) features (and the
    intercept), from a FeatureNameTermAvro container (or a directory of
    them) or JSON lines of {name, term}: every other feature is dropped at
    read time."""
    if not os.path.exists(path):
        raise IOError(f"Could not find [{path}]. Check that the file exists")
    files = avro_io.list_container_files(path) if os.path.isdir(path) else [path]
    is_avro = False
    if files and os.path.isfile(files[0]):
        with open(files[0], "rb") as f:
            is_avro = f.read(4) == b"Obj\x01"
    if is_avro:
        records = [r for p in files for r in avro_io.read_container(p)[1]]
    else:
        with open(path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    keys = [feature_key(r["name"], r.get("term", "")) for r in records]
    if not keys:
        raise ValueError(f"selected-features file {path} lists no features")
    return IndexMap.from_feature_names(keys, add_intercept=with_intercept)


def _layout(data: LabeledData) -> LabeledData:
    """The ELL shard as a sparse layout: training, scoring and variances
    then run the sparse kernels on the card (their plain versions here)."""
    return dataclasses.replace(data, features=sparse_layout.from_ell(data.features))


def run(args) -> Dict[str, object]:
    logging.basicConfig(
        level=getattr(logging, args.logging_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    device = resolve_device(args.device)
    out_dir = args.output_directory
    if os.path.exists(out_dir):
        if not args.delete_output_dirs_if_exist:
            raise FileExistsError(f"{out_dir} exists; pass --delete-output-dirs-if-exist")
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    emitter = EventEmitter()
    journal = telemetry.RunJournal(os.path.join(out_dir, "journal.jsonl"))
    emitter.register(journal_listener(journal))
    try:
        return _run_stages(args, _State(), out_dir, device, emitter)
    finally:
        journal.close()  # on every exit path


def _run_stages(args, state: _State, out_dir: str, device, emitter: EventEmitter) -> Dict[str, object]:
    timings = TimingRegistry()
    emitter.send(TrainingStartEvent(num_samples=-1))

    # INIT -> PREPROCESSED (Driver.preprocess: read, summarize, normalize).
    state.assert_stage(DriverStage.INIT)
    with Timed("read training data", registry=timings, device=device):
        train_ell, index_map = _read(args, args.training_data_directory, device)
    n_train, dim = train_ell.features.shape
    logger.info("training data: %d samples, %d features", n_train, dim)
    with Timed("preprocess", registry=timings, device=device):
        stats = summarize(train_ell.features, intercept_index=index_map.intercept_index)
        if args.summarization_output_dir:
            n_rec = write_basic_statistics(args.summarization_output_dir, stats, index_map)
            logger.info("feature summary: %d records", n_rec)
        norm = None
        if args.normalization_type != NormalizationType.NONE:
            norm = from_feature_stats(args.normalization_type, mean=stats.mean,
                                      variance=stats.variance, max_abs=stats.max_abs,
                                      intercept_index=index_map.intercept_index)
        train_data = _layout(train_ell)
    state.update(DriverStage.PREPROCESSED)

    # PREPROCESSED -> TRAINED (Driver.train -> the ModelTraining sweep).
    state.assert_stage(DriverStage.PREPROCESSED)
    reg = RegularizationContext(
        args.regularization_type,
        elastic_net_alpha=(args.elastic_net_alpha
                           if args.regularization_type == RegularizationType.ELASTIC_NET else None),
    )
    box = None
    if args.coefficient_constraints:
        if args.normalization_type != NormalizationType.NONE:
            raise ValueError(
                "constraints cannot combine with normalization (bounds are "
                "original-space; the optimizer clips normalized coefficients)")
        cmap = create_constraint_feature_map(args.coefficient_constraints, index_map)
        box = bounds_arrays(cmap, index_map.size)
    cfg = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(args.optimizer, args.max_iterations, args.tolerance,
                                  box_constraints=box),
        regularization=reg,
    )
    weights = [float(w) for w in args.regularization_weights.split(",") if w.strip()]
    if not weights:
        raise ValueError("--regularization-weights parsed to an empty list")
    with Timed("train", registry=timings, device=device):
        sweep = train_glm_sweep(train_data, args.task, cfg, weights, norm=norm)
    state.update(DriverStage.TRAINED)

    # TRAINED -> VALIDATED (Driver.validate: metrics per weight + selection).
    summary: Dict[str, object] = {
        "num_features": int(dim),
        "num_training_samples": int(n_train),
        "regularization_weights": weights,
    }
    if args.validate_data_directory:
        state.assert_stage(DriverStage.TRAINED)
        with Timed("read validation data", registry=timings, device=device):
            val_data = _layout(_read(args, args.validate_data_directory, device, index_map)[0])
        with Timed("validate", registry=timings, device=device):
            metrics_per_weight = {str(rw): legacy.evaluate_glm(model, val_data)
                                  for rw, model in sweep.models.items()}
        # Selection from these metrics (ModelSelection.scala:26-92): AUC
        # maximized for classifiers, RMSE minimized otherwise.
        if args.task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
            key, better = legacy.AREA_UNDER_ROC, max
        else:
            key, better = legacy.ROOT_MEAN_SQUARE_ERROR, min
        best_weight = better(sweep.models, key=lambda rw: metrics_per_weight[str(rw)][key])
        best_value = metrics_per_weight[str(best_weight)][key]
        summary["validation_metrics"] = metrics_per_weight
        summary["best_regularization_weight"] = best_weight
        summary["best_metric_value"] = best_value
        state.update(DriverStage.VALIDATED)
        logger.info("best reg weight %s (%s %.5f)", best_weight, key, best_value)

    # Output: learned-models-text (IOUtils.writeModelsInText:242-280) and
    # the model store, one directory per weight.
    with Timed("write models", registry=timings, device=device):
        text_dir = os.path.join(out_dir, "learned-models-text")
        os.makedirs(text_dir)
        for rw, model in sweep.models.items():
            means = model.coefficients.means.cpu().numpy()
            lines = []
            for idx in np.argsort(-means):
                key = index_map.get_feature_name(int(idx))
                if key is None:
                    continue
                name, _, term = key.partition(DELIMITER)
                lines.append(f"{name}\t{term}\t{means[idx]}\t{rw}")
            with open(os.path.join(text_dir, f"model-{rw}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            save_game_model(
                os.path.join(out_dir, "models", str(rw)),
                GameModelArtifact(task=args.task,
                                  coordinates={"global": FixedEffectArtifact("global", means)}),
                {"global": index_map},
            )
        index_map.save(os.path.join(out_dir, "feature-index.json"))
    summary["stages"] = [s.name for s in state.stage_history + [state.stage]]
    summary["iterations"] = {str(rw): int(r.iterations) for rw, r in sweep.results.items()}
    summary["timings_s"] = dict(timings.seconds)
    with open(os.path.join(out_dir, "driver-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    emitter.send(TrainingFinishEvent(num_configs=len(sweep.models)))
    logger.info("final models written to %s", text_dir)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Parse `argv` (default: the process's) and run; returns the summary
    written to driver-summary.json."""
    return run(build_parser().parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
