"""GAME scoring driver: load model -> score dataset -> write scores.

Port of `photon_ml_tpu/cli/score.py` (photon-client cli/game/scoring/
GameScoringDriver.scala:39-284): load the feature index maps, from an
off-heap store (`--offheap-indexmap-dir`: PalDB or PHIDX partitions, found
per shard, prepareFeatureMaps GameDriver.scala:231-236) or, by default, the
JSON maps saved beside the model (`feature-indexes/<shard>.json`), load the
model directory (either package's), read the data onto the device through those maps, score it with
`GameTransformer`, write ScoringResultAvro part files under
`<root>/scores`, optionally evaluate, and write `scoring-summary.json` with
`timings_s` by section. `--device` (default cuda) picks the device; cuda
with no card raises.

Usage: python -m photon_ml_tpu_torch.cli.score --help
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite, EvaluatorType
from photon_ml_tpu_torch.io import avro_data, model_bridge, model_store, score_store
from photon_ml_tpu_torch.io.avro_data import UID
from photon_ml_tpu_torch.io.paldb import resolve_offheap_index_maps
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.utils.date_range import paths_for_date_range, resolve_range
from photon_ml_tpu_torch.utils.observability import Timed, TimingRegistry

logger = logging.getLogger("photon_ml_tpu_torch.cli.score")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.score",
        description="Score data with a trained GAME model (Photon ML on PyTorch)",
    )
    p.add_argument("--input-data-directories", required=True, nargs="+")
    p.add_argument("--model-input-directory", required=True,
                   help="a model directory written by either package's training driver "
                        "(e.g. <root>/models/best)")
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--feature-shard-configurations", required=True, nargs="+", metavar="DSL")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="prebuilt feature-index partitions (PalDB or PHIDX); "
                        "default: the JSON maps saved beside the model")
    p.add_argument("--input-column-names", default=None,
                   help="Rename record fields (see the training driver)")
    p.add_argument("--input-data-date-range", default=None,
                   help="Inclusive 'yyyyMMdd-yyyyMMdd' range of daily input subdirectories")
    p.add_argument("--input-data-days-range", default=None,
                   help="Relative '<start>-<end>' days-ago range")
    p.add_argument("--evaluators", nargs="*", default=[],
                   help="optional validation metrics computed on the scored data")
    p.add_argument("--model-id", default=None,
                   help="model id tag written into every score record")
    p.add_argument("--logging-level", default="INFO")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda with no card raises")
    return p


def run(args) -> Dict[str, object]:
    logging.basicConfig(
        level=getattr(logging, args.logging_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    device = resolve_device(args.device)
    timings = TimingRegistry()
    shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)

    with Timed("load model", registry=timings, device=device):
        if args.offheap_indexmap_dir:
            index_maps = resolve_offheap_index_maps(args.offheap_indexmap_dir, shard_configs)
        else:
            index_dir = os.path.join(args.model_input_directory, "feature-indexes")
            index_maps = {shard: IndexMap.load(os.path.join(index_dir, f"{shard}.json"))
                          for shard in shard_configs}
        artifact = model_store.load_game_model(args.model_input_directory, index_maps)
        model, specs = model_bridge.game_model_from_artifact(artifact, device)

    id_tags = [spec.random_effect_type for spec in specs.values() if spec.is_random_effect]
    for ev in args.evaluators:
        et = EvaluatorType.parse(ev)
        if et.is_grouped and et.id_tag not in id_tags:
            id_tags.append(et.id_tag)
    with Timed("read data", registry=timings, device=device):
        in_range = resolve_range(args.input_data_date_range, args.input_data_days_range)
        dataset, _ = avro_data.read_game_dataset(
            paths_for_date_range(args.input_data_directories, in_range), shard_configs,
            index_maps=index_maps, id_tag_fields=id_tags,
            columns=(avro_data.InputColumnNames.parse(args.input_column_names)
                     if args.input_column_names else avro_data.InputColumnNames()),
            device=device)
    logger.info("scoring %d samples", dataset.num_samples)

    with Timed("transform", registry=timings, device=device):
        result = GameTransformer(model, specs, artifact.task).transform(dataset)

    out_root = args.root_output_directory
    os.makedirs(out_root, exist_ok=True)
    scores_dir = os.path.join(out_root, "scores")
    uids = dataset.id_tags[UID] if UID in dataset.id_tags else np.arange(dataset.num_samples)
    with Timed("write scores", registry=timings, device=device):
        score_store.save_scores(scores_dir, result.scores, args.model_id or "game-model",
                                uids=uids, labels=dataset.labels, weights=dataset.weights)
    logger.info("scores written to %s", scores_dir)

    summary: Dict[str, object] = {"num_scored": dataset.num_samples}
    if args.evaluators:
        with Timed("evaluate", registry=timings, device=device):
            suite = EvaluationSuite([EvaluatorType.parse(e) for e in args.evaluators],
                                    dataset.labels, dataset.weights,
                                    id_tag_values=dataset.id_tags)
            summary["evaluation"] = suite.evaluate(result.scores).results
        logger.info("evaluation: %s", summary["evaluation"])
    summary["timings_s"] = dict(timings.seconds)
    with open(os.path.join(out_root, "scoring-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Parse `argv` (default: the process's) and run; returns the summary
    written to scoring-summary.json."""
    return run(build_parser().parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
