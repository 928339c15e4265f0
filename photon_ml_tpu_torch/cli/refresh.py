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
warm-started full refit (game/incremental.plan_delta_fit). Both are
planned quantities (`refresh_batch_rows`, `refresh_max_delta_fraction`):
the knob, else the installed plan's, else the default.

What the port adds and refuses: `--device` (default cuda; cuda with no
card raises), and each round's `stages_s` in the summary (merge,
fingerprint copy and hash, plan, coordinate and layout build, offsets,
solve by coordinate, delta build, and the apply's upload, pre-warm and
flip). The summary's `plan` block is the installed plan's (inactive
without one), as the reference's.

`--shadow-gate` lands each round's fit as a shadow tenant first: the live
engine is tenant "live" of a `TenantRegistry`, `--probe-rows` labelled
probe requests (fresh rows from the training distribution, entities of the
base pool) are mirrored into the challenger, and the round's delta commits
(`apply_delta_for_tenant`) only on a `promote` verdict over two windows; a
reject, or no verdict in time, journals `delta_rollback` and leaves the
live generation as it was. Its labels follow a noisy linear rule on the
fixed features instead of coin flips, as the reference's do, so the gate
compares quality; each round's record gains `shadow` and
`shadow_verdict`.

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

from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
    concat_datasets,
)
from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.game import incremental
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.serving.bundle import ScoreRequest, ServingBundle
from photon_ml_tpu_torch.serving.delta import apply_delta, apply_delta_for_tenant, build_delta_bundle
from photon_ml_tpu_torch.serving.engine import ServingEngine
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

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
                   help="land each round's delta as a shadow tenant first and commit it only on a "
                        "clean online verdict (a regression journals delta_rollback and leaves the "
                        "live generation untouched)")
    p.add_argument("--probe-rows", type=int, default=48,
                   help="labelled probe requests mirrored through the shadow per round (two "
                        "evaluation windows; only used with --shadow-gate)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda with no card raises")
    p.add_argument("--logging-level", default="INFO")
    return p


def _synthetic_batch(rng, n: int, entities: np.ndarray, d_fe: int, d_re: int,
                     device: DeviceLike, w_true: Optional[np.ndarray] = None) -> GameDataset:
    """One data batch over the given entity pool (rows cycle the pool, so
    every listed entity appears): the reference's draws, in its order. With
    `w_true` the labels follow a noisy linear rule on the fixed features
    (the shadow gate compares quality, which needs a signal)."""
    ent = np.resize(entities, n)
    Xg = rng.normal(size=(n, d_fe)).astype(np.float32)
    Xre = rng.normal(size=(n, d_re)).astype(np.float32)
    if w_true is None:
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    else:
        y = (Xg @ w_true + 0.25 * rng.normal(size=n) > 0.0).astype(np.float32)
    return GameDataset.build({"g": Xg, "re": Xre}, y, id_tags={"eid": ent}, device=device)


def _probe_requests(rng, n: int, entities: int, d_fe: int, d_re: int, w_true: np.ndarray,
                    round_idx: int):
    """A gated round's labelled probe traffic: fresh rows of the training
    distribution, entities cycling the base pool (both models answer
    warm); the reference's draws."""
    ent = np.resize(np.arange(entities, dtype=np.int64), n)
    Xg = rng.normal(size=(n, d_fe)).astype(np.float32)
    Xre = rng.normal(size=(n, d_re)).astype(np.float32)
    y = (Xg @ w_true + 0.25 * rng.normal(size=n) > 0.0).astype(np.float32)
    reqs = [ScoreRequest(features={"g": Xg[i], "re": Xre[i]}, entity_ids={"eid": int(ent[i])},
                         uid=f"probe-r{round_idx}-{i}") for i in range(n)]
    return reqs, y


def _shadow_gate_round(registry, r: int, result, delta, data_configs, task: TaskType, *,
                       entities: int, d_fe: int, d_re: int, w_true: np.ndarray, probe_rows: int,
                       seed: int, device):
    """Land one round's fit as a shadow before committing its delta (the
    module docstring). Returns (the apply's record or None, the shadow
    block, the verdict)."""
    from photon_ml_tpu_torch.serving.shadow import ShadowController

    chall_bundle = ServingBundle.from_model(
        result.state.model, incremental.scoring_specs(data_configs, result.state.entity_indices),
        task, device=device)
    window = max(4, probe_rows // 2)
    controller = ShadowController(registry, "live", f"delta-r{r}", chall_bundle, auto_actuate=False,
                                  window_size=window, min_windows=2, cooldown_s=0.0,
                                  mirror_fraction=1.0)
    probe_rng = np.random.default_rng(seed + 7919 * (r + 1))
    reqs, labels = _probe_requests(probe_rng, 2 * window, entities, d_fe, d_re, w_true, r)
    try:
        futures = []
        for req, label in zip(reqs, labels):
            fut = registry.submit("live", req, block=True)
            futures.append(fut)
            if controller.mirror(req, fut):
                controller.record_label(req.uid, float(label))
        for fut in futures:
            fut.result(timeout=60.0)
        verdict = controller.wait_for_verdict(timeout_s=120.0)
        shadow_block = controller.summary()
    finally:
        # A rejected shadow is gone already; a promote-ready one leaves
        # without a verdict counter (the delta below is the actuation).
        controller.close()
    if verdict == "promote":
        return apply_delta_for_tenant(registry, "live", delta), shadow_block, verdict
    reason = ("shadow gate: challenger regressed on probe traffic" if verdict == "reject"
              else "shadow gate: no clean verdict before timeout")
    live_version = int(registry.tenant("live").engine._state.version)
    telemetry.emit_event("delta_rollback", version=live_version, reason=reason)
    faults.COUNTERS.increment("delta_rollbacks")
    logger.warning("round %d delta rejected by shadow gate: %s", r, reason)
    return None, shadow_block, verdict or "no-verdict"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_refresh_loop(out_root: str, *, rounds: int, base_rows: int, batch_rows: Optional[int],
                     entities: int, new_entities_per_round: int, churn_entities: int,
                     task: TaskType, seed: int, d_fe: int = 6, d_re: int = 4,
                     device: DeviceLike = "cuda", shadow_gate: bool = False,
                     probe_rows: int = 48) -> Dict[str, object]:
    """The synthetic loop; returns (and writes) the refresh summary."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if batch_rows is None:
        batch_rows = int(planner.planned_value("refresh_batch_rows"))
    data_configs = {
        "fixed": FixedEffectDataConfig("g"),
        "per-entity": RandomEffectDataConfig("eid", "re", min_bucket=4),
    }
    oc = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=25),
                                      regularization=L2, reg_weight=1.0)
    opt_configs = {"fixed": oc, "per-entity": oc}
    ckpt_dir = os.path.join(out_root, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)

    # A gated run needs labels with a signal (_synthetic_batch); the ungated
    # stream keeps its coin flips.
    w_true = np.linspace(1.5, -1.5, d_fe).astype(np.float32) if shadow_gate else None
    t_full = time.perf_counter()
    dataset = _synthetic_batch(rng, base_rows, np.arange(entities, dtype=np.int64), d_fe, d_re, dev,
                               w_true=w_true)
    state = incremental.full_fit(dataset, data_configs, opt_configs, task, seed=seed)
    _sync(dev)
    full_fit_s = time.perf_counter() - t_full
    specs = incremental.scoring_specs(data_configs, state.entity_indices)
    bundle0 = ServingBundle.from_model(state.model, specs, task, device=dev)
    registry = None
    if shadow_gate:
        from photon_ml_tpu_torch.serving.tenancy import TenantRegistry

        registry = TenantRegistry(max_batch=16)
        registry.admit("live", bundle0)
        engine = registry.tenant("live").engine
    else:
        engine = ServingEngine(bundle0, max_batch=16)
    next_entity = entities
    round_records: List[Dict[str, object]] = []
    try:
        for r in range(rounds):
            churn = rng.choice(entities, size=min(churn_entities, entities), replace=False)
            fresh = np.arange(next_entity, next_entity + new_entities_per_round)
            next_entity += new_entities_per_round
            pool = np.concatenate([churn, fresh]).astype(np.int64)
            t_data = time.perf_counter()
            batch = _synthetic_batch(rng, batch_rows, pool, d_fe, d_re, dev, w_true=w_true)
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
            shadow_block = verdict = None
            if shadow_gate:
                info, shadow_block, verdict = _shadow_gate_round(
                    registry, r, result, delta, data_configs, task, entities=entities, d_fe=d_fe,
                    d_re=d_re, w_true=w_true, probe_rows=probe_rows, seed=seed, device=dev)
            else:
                info = apply_delta(engine, delta)
            data_to_served_s = time.perf_counter() - t_data
            committed = info is not None and bool(info["committed"])
            if committed:
                # A rejected round keeps the data, not the weights: the next
                # delta is fit from the last state the gate let through.
                state = result.state
            record = {
                "round": r,
                "mode": result.plan.mode,
                "delta": delta.manifest(),
                "incremental_fit_s": round(result.seconds, 4),
                "max_rel_diff": result.max_rel_diff,
                "generation": int(info["version"]) if info is not None else int(engine._state.version),
                "committed": committed,
                "data_to_served_s": round(data_to_served_s, 4),
                "stages_s": {"merge": merge_s, **result.stage_s, "delta_build": delta_build_s,
                             "apply": {k: (info or {}).get(f"{k}_s", 0.0)
                                       for k in ("upload", "prewarm", "flip")}},
            }
            if shadow_block is not None:
                record["shadow"] = shadow_block
                record["shadow_verdict"] = verdict
            round_records.append(record)
            logger.info("round %d: mode=%s delta_rows=%d/%d generation=%d committed=%s "
                        "data->served %.3fs", r, result.plan.mode, result.plan.delta_rows,
                        result.plan.total_rows, record["generation"], committed, data_to_served_s)
        provenance = dict(engine.bundle.provenance)
        metrics = engine.metrics()
    finally:
        if registry is not None:
            registry.close(release_bundles=True)
        else:
            engine.close()
            engine.bundle.release()
    summary = {
        "rounds": round_records,
        "full_fit_s": round(full_fit_s, 4),
        "batch_rows": int(batch_rows),
        "provenance": provenance,
        "bundle_deltas": metrics["bundle_deltas"],
        "plan": planner.plan_block(),
        "device": str(dev),
    }
    with open(os.path.join(out_root, "refresh-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO))
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
            device=args.device, shadow_gate=args.shadow_gate, probe_rows=args.probe_rows)
    finally:
        telemetry.uninstall_journal()
        journal.close()
    served = [r["data_to_served_s"] for r in summary["rounds"]]
    logger.info("refresh loop done: %d round(s), data->served %s s, summary at %s", len(served),
                [round(s, 3) for s in served], os.path.join(out_root, "refresh-summary.json"))


if __name__ == "__main__":
    main()
