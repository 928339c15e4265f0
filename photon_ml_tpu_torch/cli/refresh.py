"""Continuous-refresh loop driver: data -> incremental fit -> delta swap.

Port of `photon_ml_tpu/cli/refresh.py`. Where the reference's production
cadence retrains from scratch and redeploys the whole artifact, this
driver runs the incremental alternative end to end against a live engine:

    round 0: full fit -> stage the serving bundle
    each round: delta batch -> merge -> fingerprint diff -> warm-started
        incremental fit (changed coordinates and entities only) -> delta
        bundle -> in-place generation flip (serving/delta.apply_delta)

It writes `refresh-summary.json` (each round's mode, delta manifest,
incremental fit seconds, `max_rel_diff`, generation, `committed` and
`data_to_served_s`, the delta batch in hand to the new generation live),
`journal.jsonl` (every `delta_fit_start`, `delta_fit_finish`,
`delta_apply` and `delta_rollback`) and `checkpoints/delta_records.jsonl`.

Data: `--synthetic` draws a base dataset and streamed delta batches (entity
churn and new entities) from `--seed`, the same numpy draws in the same
order as the reference's driver, so both packages' runs fit the same rows.
Batch size is PHOTON_REFRESH_BATCH_ROWS unless `--batch-rows` says; churn
past PHOTON_REFRESH_MAX_DELTA_FRACTION of the merged rows escapes to one
warm-started full refit (game/incremental.plan_delta_fit). Both knobs are
read from utils/knobs.py (the reference routes them through its planner).

What the port adds and refuses: `--device` (default cuda; cuda with no
card raises), and each round's `stages_s` in the summary (merge,
fingerprint copy and hash, plan, coordinate and layout build, offsets,
solve by coordinate, delta build, and the apply's upload, pre-warm and
flip). The summary has no `plan` block (the planner is ROADMAP item 10e).
`--shadow-gate` needs serving/shadow.py (item 10d) and raises before any
fit.

Usage: python -m photon_ml_tpu_torch.cli.refresh --help
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
    concat_datasets,
)
from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.game import incremental
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.serving.bundle import ServingBundle
from photon_ml_tpu_torch.serving.delta import apply_delta, build_delta_bundle
from photon_ml_tpu_torch.serving.engine import ServingEngine
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger("photon_ml_tpu_torch.cli.refresh")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.refresh",
        description="Continuous refresh: incremental fits + delta-bundle swaps against a live "
                    "serving engine")
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--synthetic", action="store_true",
                   help="draw a synthetic base dataset + streamed delta batches (the "
                        "self-contained demo mode)")
    p.add_argument("--rounds", type=int, default=3,
                   help="number of delta batches to stream (default 3)")
    p.add_argument("--base-rows", type=int, default=512,
                   help="synthetic base dataset rows (default 512)")
    p.add_argument("--batch-rows", type=int, default=None,
                   help="rows per streamed delta batch (default: the PHOTON_REFRESH_BATCH_ROWS "
                        "knob)")
    p.add_argument("--entities", type=int, default=24,
                   help="synthetic entity count in the base data")
    p.add_argument("--new-entities-per-round", type=int, default=2,
                   help="brand-new entities appearing in each delta batch")
    p.add_argument("--churn-entities", type=int, default=3,
                   help="existing entities each delta batch touches")
    p.add_argument("--training-task", type=TaskType.parse, default=TaskType.LOGISTIC_REGRESSION)
    p.add_argument("--shadow-gate", action="store_true",
                   help="land each round's delta as a shadow tenant first (not ported: ROADMAP "
                        "item 10d; raises)")
    p.add_argument("--probe-rows", type=int, default=48,
                   help="labelled probe requests per round (only with --shadow-gate)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda with no card raises")
    p.add_argument("--logging-level", default="INFO")
    return p


def _synthetic_batch(rng, n: int, entities: np.ndarray, d_fe: int, d_re: int,
                     device: DeviceLike) -> GameDataset:
    """One data batch over the given entity pool (rows cycle the pool, so
    every listed entity appears): the reference's draws, in its order."""
    ent = np.resize(entities, n)
    Xg = rng.normal(size=(n, d_fe)).astype(np.float32)
    Xre = rng.normal(size=(n, d_re)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return GameDataset.build({"g": Xg, "re": Xre}, y, id_tags={"eid": ent}, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_refresh_loop(out_root: str, *, rounds: int, base_rows: int, batch_rows: Optional[int],
                     entities: int, new_entities_per_round: int, churn_entities: int,
                     task: TaskType, seed: int, d_fe: int = 6, d_re: int = 4,
                     device: DeviceLike = "cuda") -> Dict[str, object]:
    """The synthetic loop; returns (and writes) the refresh summary."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if batch_rows is None:
        batch_rows = int(get_knob("PHOTON_REFRESH_BATCH_ROWS"))
    data_configs = {
        "fixed": FixedEffectDataConfig("g"),
        "per-entity": RandomEffectDataConfig("eid", "re", min_bucket=4),
    }
    oc = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=25),
                                      regularization=L2, reg_weight=1.0)
    opt_configs = {"fixed": oc, "per-entity": oc}
    ckpt_dir = os.path.join(out_root, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)

    t_full = time.perf_counter()
    dataset = _synthetic_batch(rng, base_rows, np.arange(entities, dtype=np.int64), d_fe, d_re, dev)
    state = incremental.full_fit(dataset, data_configs, opt_configs, task, seed=seed)
    _sync(dev)
    full_fit_s = time.perf_counter() - t_full
    specs = incremental.scoring_specs(data_configs, state.entity_indices)
    engine = ServingEngine(ServingBundle.from_model(state.model, specs, task, device=dev),
                           max_batch=16)
    next_entity = entities
    round_records: List[Dict[str, object]] = []
    try:
        for r in range(rounds):
            churn = rng.choice(entities, size=min(churn_entities, entities), replace=False)
            fresh = np.arange(next_entity, next_entity + new_entities_per_round)
            next_entity += new_entities_per_round
            pool = np.concatenate([churn, fresh]).astype(np.int64)
            t_data = time.perf_counter()
            batch = _synthetic_batch(rng, batch_rows, pool, d_fe, d_re, dev)
            dataset = concat_datasets(dataset, batch)
            _sync(dev)
            merge_s = time.perf_counter() - t_data
            result = incremental.incremental_fit(dataset, data_configs, opt_configs, task,
                                                 prev=state, seed=seed, checkpoint_dir=ckpt_dir)
            t_build = time.perf_counter()
            delta = build_delta_bundle(state, result.state, source=f"round-{r}",
                                       mode=result.plan.mode, delta_rows=result.plan.delta_rows,
                                       total_rows=result.plan.total_rows)
            delta_build_s = time.perf_counter() - t_build
            info = apply_delta(engine, delta)
            data_to_served_s = time.perf_counter() - t_data
            committed = bool(info["committed"])
            if committed:
                state = result.state
            record = {
                "round": r,
                "mode": result.plan.mode,
                "delta": delta.manifest(),
                "incremental_fit_s": round(result.seconds, 4),
                "max_rel_diff": result.max_rel_diff,
                "generation": int(info["version"]),
                "committed": committed,
                "data_to_served_s": round(data_to_served_s, 4),
                "stages_s": {"merge": merge_s, **result.stage_s, "delta_build": delta_build_s,
                             "apply": {k: info.get(f"{k}_s", 0.0)
                                       for k in ("upload", "prewarm", "flip")}},
            }
            round_records.append(record)
            logger.info("round %d: mode=%s delta_rows=%d/%d generation=%d committed=%s "
                        "data->served %.3fs", r, result.plan.mode, result.plan.delta_rows,
                        result.plan.total_rows, record["generation"], committed, data_to_served_s)
        provenance = dict(engine.bundle.provenance)
        metrics = engine.metrics()
    finally:
        engine.close()
        engine.bundle.release()
    summary = {
        "rounds": round_records,
        "full_fit_s": round(full_fit_s, 4),
        "batch_rows": int(batch_rows),
        "provenance": provenance,
        "bundle_deltas": metrics["bundle_deltas"],
        "device": str(dev),
    }
    with open(os.path.join(out_root, "refresh-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO))
    if args.shadow_gate:
        raise NotImplementedError("--shadow-gate needs serving/shadow.ShadowController and "
                                  "serving/tenancy.TenantRegistry: ROADMAP item 10d (not ported)")
    if not args.synthetic:
        raise SystemExit("only --synthetic data is supported; production refresh loops drive "
                         "game.incremental + serving.delta directly against their ingest (see the "
                         "README 'Continuous refresh' runbook)")
    out_root = args.root_output_directory
    os.makedirs(out_root, exist_ok=True)
    journal = telemetry.RunJournal(os.path.join(out_root, "journal.jsonl"))
    telemetry.install_journal(journal)
    try:
        summary = run_refresh_loop(
            out_root, rounds=args.rounds, base_rows=args.base_rows, batch_rows=args.batch_rows,
            entities=args.entities, new_entities_per_round=args.new_entities_per_round,
            churn_entities=args.churn_entities, task=args.training_task, seed=args.seed,
            device=args.device)
    finally:
        telemetry.uninstall_journal()
        journal.close()
    served = [r["data_to_served_s"] for r in summary["rounds"]]
    logger.info("refresh loop done: %d round(s), data->served %s s, summary at %s", len(served),
                [round(s, 3) for s in served], os.path.join(out_root, "refresh-summary.json"))


if __name__ == "__main__":
    main()
