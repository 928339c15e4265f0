"""Online serving driver: pin a model once, replay a request stream.

Port of `photon_ml_tpu/cli/serve.py`. The single-tenant path (`run`,
`_run_with_bundle`) loads a model directory written by either package's
`cli.train` onto the device (`--device`, default cuda; cuda with no card
raises), builds the engine's bucket programs (CUDA graphs on the card),
streams the requests through the deadline micro-batcher in windows of
REPLAY_WINDOW, and writes one ScoringResultAvro part per window under
`<root>/scores`, `serving-summary.json` (every SERVING_SUMMARY_KEYS key:
`plan` is the run's plan block; `tenants`, `shadow` and `autopilot` are
empty), `journal.jsonl`, `profile.json`, and `trace.json` when
PHOTON_TRACE is on.

`--profile <profile.json>` (a serve profile an earlier run wrote) plans the
bucket ceiling and the flush wait (photon_ml_tpu_torch/planner/): installed
after the journal, before anything is staged, refused on another topology,
uninstalled on every exit path. `--max-batch` and `--max-wait-ms` still
win, and the plan block records them as source "knob". PHOTON_PLAN and
PHOTON_PLAN_PROFILE work as in the reference.

`--tenant NAME=MODEL_DIR` (repeatable) pins every tenant's model on the
card behind a `TenantRegistry` and assigns the stream round robin, each
record encoded against its tenant's bundle; scores land under
`scores/<tenant>/` and the summary's `tenants` block has one
TENANT_BLOCK_KEYS block a tenant. `--shadow NAME=MODEL_DIR` serves the
model directory as the champion and the challenger as a shadow tenant
that receives a copy of every request with a uid (co-batched with the
champion; only the champion's scores are written); `--labels` joins
{"uid", "label", "weight"} lines into the online evaluation windows
(`--shadow-window` rows each) that drive the promote or reject verdict,
and the summary's `shadow` block (SHADOW_BLOCK_KEYS) records it.
`--autopilot` (with `--tenant`) runs the `photon-autopilot` control loop
(autopilot/) over the registry beside the replay, every decision
journaled, and the summary's `autopilot` block (AUTOPILOT_BLOCK_KEYS)
records it; a loop that died fails the run.

Requests are JSON lines (`.json`/`.jsonl`: {"uid", "offset", "ids":
{re_type: id}, "features": {shard: {feature_key: value} | {"indices",
"values"} | [dense]}}) or Avro records of the training data's shape (a file
or a part-file directory; needs `--feature-shard-configurations`). A
request that cannot be encoded or scored costs its own record, counted.
The Avro replay reads with quarantine, as the reference's does: a corrupt
block costs its requests (counted in `quarantined_blocks`, which the
summary's `robustness_counters` carries; under `--multihost`, a worker's
count, since the supervisor reads no request), never the rest of the
stream.

`--reshard-to N` is the reference's live drill: once the second replay
window is submitted, a `photon-reshard-cli` thread reshards the engine's
random effects onto the first N cards of the process (`parallel.mesh.
surviving_mesh`; 1: replicated) under the traffic; a failure rolls back
with the old generation serving, is recorded under the summary's
`reshard` block as `"error"`, and the replay goes on. Requests are encoded
against the live generation. PHOTON_SERVING_ENTITY_SHARD stages the model
row-sharded over every card of the process (`load_bundle`); the summary's
`serving.sharding` block says how it is placed.

`--multihost N` runs N share-nothing serving workers over the same model
and request stream, each owning a partition of every random effect's rows,
and merges their answers (cli/serve_multihost.py); `main` dispatches it,
and `run` is the single-process path. Under `--multihost`, `--shadow` and
`--labels`, `--profile` and `--autopilot` are not read, as in the
reference's driver. The reference's refusals of flag combinations come
first, in its order and words, all before anything is staged.

Usage: python -m photon_ml_tpu_torch.cli.serve --help
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.serving.bundle import ScoreRequest, ServingBundle, load_bundle, request_from_record
from photon_ml_tpu_torch.serving.engine import ServingEngine

logger = logging.getLogger("photon_ml_tpu_torch.cli.serve")

# Requests go through the batcher a window at a time: memory stays
# O(window), and each window's scores are one part file.
REPLAY_WINDOW = 8192

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.serve",
        description="Replay scoring requests through the online serving engine "
                    "(Photon ML on PyTorch)")
    p.add_argument("--model-input-directory", default=None,
                   help="a model directory written by either package's training driver")
    p.add_argument("--requests", required=True,
                   help="a .json/.jsonl file (one request a line) or an Avro file/part directory")
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--feature-shard-configurations", nargs="+", default=None, metavar="DSL",
                   help="required for Avro requests: the shard DSL the scoring driver takes")
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="prebuilt feature-index partitions (PalDB or PHIDX); default: the JSON "
                        "maps saved beside the model")
    p.add_argument("--max-batch", type=int, default=None,
                   help="largest micro-batch and bucket program (default 256)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="flush a partial batch once its oldest request has waited this long "
                        "(default 2.0)")
    p.add_argument("--max-pending", type=int, default=None,
                   help="admission bound on the pending queue (default 4x max-batch)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline budget (default: none)")
    p.add_argument("--model-id", default=None, help="model id tag written into every score record")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; cuda with no card raises")
    p.add_argument("--logging-level", default="INFO")
    p.add_argument("--multihost", type=int, default=0, metavar="N",
                   help="multi-host production serving: N share-nothing OS-process hosts, each "
                        "staging only its own partition of every random-effect coordinate's rows "
                        "(host-local stores); a host killed mid-replay costs fidelity (its rows "
                        "answer FE-only through the survivors), never a failed request, and "
                        "rejoins by restaging its partition")
    p.add_argument("--multihost-devices-per-host", type=int, default=4, metavar="M",
                   help="the per-host shard count of each coordinate's store (a worker of the "
                        "port drives one device and cuts each random-effect matrix into M row "
                        "blocks on it); only meaningful with --multihost")
    # Plumbing between the multi-host supervisor and its workers.
    p.add_argument("--mh-serve-worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mh-host-id", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--mh-num-hosts", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--mh-attempt", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--mh-resume-window", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--tenant", action="append", default=None, metavar="NAME=MODEL_DIR",
                   help="multi-tenant serving (repeatable, in place of --model-input-directory): "
                        "every tenant's model pinned on the card behind one registry, with "
                        "per-tenant quotas, deadlines and failure domains and weighted-fair "
                        "co-batching; the stream is assigned round robin")
    p.add_argument("--shadow", default=None, metavar="NAME=MODEL_DIR",
                   help="shadow deployment (single-tenant mode only): a challenger admitted as a "
                        "shadow tenant, mirrored the champion's traffic and co-batched with it; its "
                        "answers are never returned, and online evaluation windows (see --labels) "
                        "drive a journalled promote/reject verdict")
    p.add_argument("--labels", default=None, metavar="PATH",
                   help="label stream of the shadow's online evaluation: .json/.jsonl lines of "
                        "{\"uid\", \"label\", \"weight\"?} joined by uid; without it the shadow "
                        "mirrors but no verdict can fire")
    p.add_argument("--shadow-window", type=int, default=64,
                   help="joined rows per shadow evaluation window (default 64); a verdict needs "
                        "PHOTON_SHADOW_MIN_WINDOWS consecutive windows agreeing")
    p.add_argument("--profile", default=None,
                   help="a persisted run profile (profile.json from a prior run) the adaptive "
                        "planner consumes for the bucket ceiling and the flush wait; "
                        "topology-checked loudly. Overrides PHOTON_PLAN_PROFILE")
    p.add_argument("--autopilot", action="store_true",
                   help="closed-loop autoscaling (multi-tenant mode only): run the photon-autopilot "
                        "control loop over the registry during the replay (PHOTON_AUTOPILOT_* knobs); "
                        "every decision is journaled; the summary gains an 'autopilot' block")
    p.add_argument("--reshard-to", type=int, default=None,
                   help="live mesh elasticity drill: once replay traffic is flowing, reshard the "
                        "engine's coefficient layout to this many entity shards (1 = replicated) on a "
                        "background worker; zero failed requests, rollback on any staging/commit "
                        "failure; the summary gains a 'reshard' block")
    return p


def _plan_overrides(args) -> Dict[str, object]:
    """The planned quantities an explicit flag set: the plan block records
    them as source "knob"."""
    out: Dict[str, object] = {}
    if args.max_batch is not None:
        out["serving_max_batch"] = int(args.max_batch)
    if args.max_wait_ms is not None:
        out["serving_max_wait_ms"] = float(args.max_wait_ms)
    return out


def _encode_json_request(bundle: ServingBundle, doc: dict) -> ScoreRequest:
    features = {}
    for shard, payload in (doc.get("features") or {}).items():
        if isinstance(payload, dict) and "indices" in payload:
            features[shard] = (np.asarray(payload["indices"], np.int32),
                               np.asarray(payload.get("values", []), np.float32))
        elif isinstance(payload, dict):
            features[shard] = payload  # named features, through the index maps
        else:
            features[shard] = np.asarray(payload, np.float32)
    return bundle.encode_request(features, entity_ids=doc.get("ids") or {},
                                 offset=float(doc.get("offset") or 0.0),
                                 uid=None if doc.get("uid") is None else str(doc["uid"]))


def _iter_json_docs(path: str, malformed: List[int]) -> Iterator[dict]:
    """Parsed request documents; a malformed line costs one record."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except Exception as exc:  # one malformed line costs one record
                malformed[0] += 1
                logger.warning("skipping malformed request at %s:%d: %s", path, lineno, exc)


def _iter_json_requests(path: str, bundle: ServingBundle, malformed: List[int]) -> Iterator[ScoreRequest]:
    for doc in _iter_json_docs(path, malformed):
        try:
            req = _encode_json_request(bundle, doc)
        except Exception as exc:  # one malformed line costs one record
            malformed[0] += 1
            logger.warning("skipping malformed request in %s: %s", path, exc)
            continue
        yield req


def _iter_avro_records(path: str) -> Iterator[dict]:
    """Raw replay records (a corrupt block quarantined), for paths that
    encode each record against a bundle of their choice."""
    from photon_ml_tpu_torch.io import avro as avro_io

    for _, rec in avro_io.iter_directory(path, quarantine=True):
        yield rec


def _iter_avro_requests(path: str, bundle: ServingBundle, shard_configs,
                        malformed: List[int]) -> Iterator[ScoreRequest]:
    from photon_ml_tpu_torch.io import avro as avro_io

    # One corrupt block costs its requests (counted), not the stream.
    for _, rec in avro_io.iter_directory(path, quarantine=True):
        try:
            req = request_from_record(bundle, rec, shard_configs)
        except Exception as exc:  # one malformed record costs one record
            malformed[0] += 1
            logger.warning("skipping malformed replay record in %s: %s", path, exc)
            continue
        yield req


def _write_score_part(scores_dir: str, k: int, results, model_id: str) -> str:
    """One window's scores as a ScoringResultAvro part, written under a
    dot-prefixed name (which readers skip) and renamed into place. `results`
    holds (stream position, ScoreResult); a uid defaults to the position."""
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.native import avro_writer

    part = avro_io.part_file_path(scores_dir, k)
    tmp = os.path.join(scores_dir, f".part-{k:05d}.avro.tmp")
    uids = np.asarray([r.uid if r.uid is not None else str(pos) for pos, r in results])
    table, codes = np.unique(uids, return_inverse=True)
    avro_writer.write_scores_columnar(tmp, np.asarray([r.score for _, r in results], np.float64),
                                      model_id, uid_strings=(codes.reshape(-1), [str(u) for u in table]))
    os.replace(tmp, part)
    return part


def _validate(args) -> List[tuple]:
    """The reference's refusals, in its order and words; returns the parsed
    --tenant specs."""
    is_json = args.requests.endswith((".json", ".jsonl"))
    if not is_json and not args.feature_shard_configurations:
        raise ValueError("Avro request replay needs --feature-shard-configurations (the bag -> "
                         "shard mapping offline ingest uses)")
    if getattr(args, "multihost", 0) or getattr(args, "mh_serve_worker", False):
        raise ValueError("--multihost serving dispatches in serve.main(); run() is the "
                         "single-process path")
    tenants = args.tenant
    if bool(tenants) == bool(args.model_input_directory):
        raise ValueError("pass exactly one of --model-input-directory (single-tenant) or --tenant "
                         "NAME=MODEL_DIR (repeatable, multi-tenant)")
    if tenants and args.reshard_to is not None:
        raise ValueError("--reshard-to is a single-tenant drill; it cannot be combined with --tenant")
    if args.shadow:
        if tenants:
            raise ValueError("--shadow mirrors one champion's traffic; it cannot be combined with "
                             "--tenant")
        if args.reshard_to is not None:
            raise ValueError("--shadow and --reshard-to both drive generation flips; run them "
                             "separately")
    if args.autopilot:
        if not tenants:
            raise ValueError("--autopilot supervises a multi-tenant fleet; combine it with --tenant")
        if args.reshard_to is not None:
            raise ValueError("--autopilot owns the reshard actuator; it cannot be combined with the "
                             "--reshard-to drill")
    specs: List[tuple] = []
    for spec in tenants or []:
        name, sep, model_dir = spec.partition("=")
        if not sep or not name or not model_dir:
            raise ValueError(f"--tenant {spec!r}: expected NAME=MODEL_DIR")
        if name in dict(specs):
            raise ValueError(f"duplicate tenant name {name!r}")
        specs.append((name, model_dir))
    return specs


def run(args) -> Dict[str, object]:
    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO),
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # Refusals and argument checks come before anything is staged.
    tenant_specs = _validate(args)
    is_json = args.requests.endswith((".json", ".jsonl"))
    device = resolve_device(args.device)
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.native import avro_writer
    from photon_ml_tpu_torch.utils import telemetry

    avro_writer.require_deflate()
    shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations or [])
    index_maps = None
    if args.offheap_indexmap_dir:
        from photon_ml_tpu_torch.io.paldb import resolve_offheap_index_maps

        index_maps = resolve_offheap_index_maps(args.offheap_indexmap_dir, shard_configs)

    out_root = args.root_output_directory
    os.makedirs(out_root, exist_ok=True)
    journal = telemetry.RunJournal(os.path.join(out_root, "journal.jsonl"))
    # Install only the slots this run owns: a caller's journal or tracer
    # stays installed.
    journal_owned = telemetry.current_journal() is None
    if journal_owned:
        telemetry.install_journal(journal)
    tracer_owned = telemetry.current_tracer() is None
    tracer = telemetry.start_tracing_if_enabled()
    try:
        # After the journal (plan_decision lines land in it), before staging.
        with planner.owned_plan(args.profile, device=device):
            if tenant_specs:
                return _run_multi_tenant(args, tenant_specs, index_maps, shard_configs, is_json,
                                         device)
            if args.shadow:
                return _run_with_shadow(args, index_maps, shard_configs, is_json, device)
            bundle = load_bundle(args.model_input_directory, device=device, index_maps=index_maps)
            logger.info("bundle pinned: %d coordinate(s), %.1f MB staged in %.3fs",
                        len(bundle.coordinates), bundle.upload_bytes / 1e6, bundle.upload_s)
            try:
                return _run_with_bundle(args, bundle, shard_configs, is_json)
            finally:
                bundle.release()
    finally:
        if tracer is not None and tracer_owned:
            tracer.export(os.path.join(out_root, "trace.json"))
            telemetry.uninstall_tracer()
        if journal_owned:
            telemetry.uninstall_journal()
        journal.close()


def _encode_live(engine: ServingEngine, raw, is_json: bool, shard_configs) -> ScoreRequest:
    """`raw` encoded against the engine's live generation: a reshard flips
    the engine onto a new bundle and releases the one the replay started
    on, so an encoding that a flip overtook is made again."""
    while True:
        version = engine.bundle_version
        bundle = engine.bundle
        try:
            req = _encode(bundle, raw, is_json, shard_configs)
        except Exception:
            if engine.bundle_version != version:
                continue
            raise
        if engine.bundle_version == version:
            return req


def _run_with_bundle(args, bundle: ServingBundle, shard_configs, is_json: bool) -> Dict[str, object]:
    from photon_ml_tpu_torch.contracts import ROBUSTNESS_CLEAN_ZERO_KEYS
    from photon_ml_tpu_torch.utils import faults, telemetry

    malformed = [0]  # records dropped before submission
    out_root = args.root_output_directory
    engine = ServingEngine(bundle, max_batch=args.max_batch)

    def requests() -> Iterator[ScoreRequest]:
        raws = _iter_json_docs(args.requests, malformed) if is_json else _iter_avro_records(args.requests)
        for raw in raws:
            try:
                yield _encode_live(engine, raw, is_json, shard_configs)
            except Exception as exc:  # one malformed record costs one record
                malformed[0] += 1
                logger.warning("skipping malformed request in %s: %s", args.requests, exc)

    stream = requests()
    t_warm = time.perf_counter()
    with telemetry.span("serve_warmup"):
        compiles = engine.warmup()
    warmup_s = time.perf_counter() - t_warm
    logger.info("engine warm: %d bucket program(s) built in %.3fs", compiles, warmup_s)

    scores_dir = os.path.join(out_root, "scores")
    os.makedirs(scores_dir, exist_ok=True)
    model_id = args.model_id or "game-model"
    n_requests = 0
    n_failed = 0
    # The --reshard-to drill: started on a thread once the second window is
    # submitted, so the flip happens under traffic; joined on every exit
    # path inside the engine's context.
    reshard_to = args.reshard_to
    reshard_info: dict = {}
    reshard_thread = None

    def live_reshard() -> None:
        from photon_ml_tpu_torch.parallel.mesh import surviving_mesh

        try:
            reshard_info.update(engine.reshard_orchestrator.reshard(
                surviving_mesh(reshard_to, device=bundle.device)))
            logger.info("live reshard committed: %s", reshard_info)
        except Exception as exc:  # recorded; the replay goes on
            reshard_info["error"] = repr(exc)
            logger.warning("live reshard rolled back: %r", exc)

    t_replay = time.perf_counter()
    try:
        with telemetry.span("serve_replay"), engine, engine.batcher(
                max_wait_ms=args.max_wait_ms, max_pending=args.max_pending,
                default_deadline_ms=args.deadline_ms) as batcher:
            try:
                for k in itertools.count():
                    window = list(itertools.islice(stream, REPLAY_WINDOW))
                    if not window:
                        break
                    if k == 1 and reshard_to is not None and reshard_thread is None:
                        reshard_thread = threading.Thread(target=live_reshard, name="photon-reshard-cli")
                        reshard_thread.start()
                    # A closed-loop client: block=True waits for room in the queue.
                    futures = [batcher.submit(r, block=True) for r in window]
                    results = []
                    for i, fut in enumerate(futures):
                        try:
                            results.append((n_requests + i, fut.result()))
                        except Exception as exc:  # one failed request costs one record
                            n_failed += 1
                            logger.warning("request %r failed: %s",
                                           window[i].uid if window[i].uid is not None
                                           else str(n_requests + i), exc)
                    if results:
                        _write_score_part(scores_dir, k, results, model_id)
                    n_requests += len(window)
                if reshard_to is not None and reshard_thread is None:
                    live_reshard()  # one window: the drill runs without traffic beside it
            finally:
                if reshard_thread is not None:
                    reshard_thread.join()
            replay_s = time.perf_counter() - t_replay
            metrics = batcher.metrics()
            wait_ms = batcher.max_wait_s * 1e3
    finally:
        if engine.bundle is not bundle:
            engine.bundle.release()  # the live generation a reshard made
    logger.info("replayed %d request(s), %d failed, %d malformed record(s) skipped; scores in %s",
                n_requests, n_failed, malformed[0], scores_dir)
    summary = {
        "num_requests": n_requests,
        "failed_requests": n_failed,
        "malformed_records": malformed[0],
        "serving": metrics,
        "health": engine.health.snapshot(),
        "robustness_counters": {**{k: 0 for k in ROBUSTNESS_CLEAN_ZERO_KEYS}, **faults.counters()},
        "plan": planner.plan_block(overrides=_plan_overrides(args)),
        "tenants": {},
        "provenance": dict(engine.bundle.provenance),
        "shadow": {},
        "autopilot": {},
    }
    if reshard_to is not None:
        summary["reshard"] = reshard_info
    with open(os.path.join(out_root, "serving-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    profile = telemetry.build_profile(
        "serve", wall_s=warmup_s + replay_s, stages={"warmup_s": warmup_s, "replay_s": replay_s},
        dispatch={"max_batch": engine.max_batch, "max_wait_ms": wait_ms,
                  "sharding": metrics["sharding"]},
        bucket_shapes={"engine_buckets": list(engine.buckets)}, serving=metrics,
        topology=telemetry.device_topology(bundle.device))
    profile["plan"] = summary["plan"]
    telemetry.write_profile(os.path.join(out_root, "profile.json"), profile)
    return summary


def _summary(args, n_requests: int, n_failed: int, malformed: int, metrics, health, provenance,
             shadow: dict, autopilot: dict) -> Dict[str, object]:
    from photon_ml_tpu_torch.contracts import ROBUSTNESS_CLEAN_ZERO_KEYS
    from photon_ml_tpu_torch.utils import faults

    return {
        "num_requests": n_requests,
        "failed_requests": n_failed,
        "malformed_records": malformed,
        "serving": metrics,
        "health": health,
        "robustness_counters": {**{k: 0 for k in ROBUSTNESS_CLEAN_ZERO_KEYS}, **faults.counters()},
        "plan": planner.plan_block(overrides=_plan_overrides(args)),
        "tenants": metrics["tenants"],
        "provenance": provenance,
        "shadow": shadow,
        "autopilot": autopilot,
    }


def _write_registry_outputs(out_root: str, summary: dict, registry, names: List[str],
                            warmup_s: float, replay_s: float, device) -> None:
    from photon_ml_tpu_torch.utils import telemetry

    with open(os.path.join(out_root, "serving-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    profile = telemetry.build_profile(
        "serve", wall_s=warmup_s + replay_s, stages={"warmup_s": warmup_s, "replay_s": replay_s},
        dispatch={"max_batch": registry.max_batch, "max_wait_ms": registry.max_wait_s * 1e3,
                  "tenants": names},
        bucket_shapes={"registry_buckets": list(registry.buckets)}, serving=summary["serving"],
        topology=telemetry.device_topology(device))
    profile["plan"] = summary["plan"]
    telemetry.write_profile(os.path.join(out_root, "profile.json"), profile)


def _encode(bundle: ServingBundle, raw, is_json: bool, shard_configs) -> ScoreRequest:
    return _encode_json_request(bundle, raw) if is_json else request_from_record(bundle, raw,
                                                                                 shard_configs)


def _run_multi_tenant(args, tenant_specs, index_maps, shard_configs, is_json: bool,
                      device) -> Dict[str, object]:
    """`--tenant NAME=MODEL_DIR`, repeatable: every tenant's bundle on the
    card behind one TenantRegistry, the stream assigned round robin (each
    record encoded against its tenant's bundle), scores under
    scores/<tenant>/, one TENANT_BLOCK_KEYS block a tenant in the summary.
    `--autopilot` runs the control loop over the registry from after the
    admissions to the end of the replay."""
    from photon_ml_tpu_torch.serving.tenancy import TenantRegistry
    from photon_ml_tpu_torch.utils import telemetry

    out_root = args.root_output_directory
    t_warm = time.perf_counter()
    registry = TenantRegistry(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    names: List[str] = []
    malformed = [0]
    pilot = None
    autopilot_block: dict = {}
    try:
        for name, model_dir in tenant_specs:
            registry.admit(name, lambda d=model_dir: load_bundle(d, device=device, index_maps=index_maps),
                           max_pending=args.max_pending, deadline_ms=args.deadline_ms)
            names.append(name)
            logger.info("tenant %r pinned: %.1f MB", name,
                        registry.tenant(name).bundle.upload_bytes / 1e6)
        warmup_s = time.perf_counter() - t_warm
        if args.autopilot:
            from photon_ml_tpu_torch.autopilot import Autopilot

            pilot = Autopilot(registry)
            logger.info("autopilot armed: %d rule(s), tick %dms", len(pilot.rules), pilot.tick_ms)
        raw_stream = _iter_json_docs(args.requests, malformed) if is_json \
            else _iter_avro_records(args.requests)
        scores_root = os.path.join(out_root, "scores")
        model_id = args.model_id or "game-model"
        n_requests = n_failed = assigned = 0
        t_replay = time.perf_counter()
        with telemetry.span("serve_replay", tenants=names):
            for k in itertools.count():
                window = []  # (tenant, request)
                for raw in itertools.islice(raw_stream, REPLAY_WINDOW):
                    name = names[assigned % len(names)]
                    assigned += 1
                    try:
                        window.append((name, _encode(registry.tenant(name).bundle, raw, is_json,
                                                     shard_configs)))
                    except Exception as exc:  # one malformed record costs one record
                        malformed[0] += 1
                        logger.warning("skipping malformed request for tenant %r: %s", name, exc)
                if not window:
                    break
                futures = [(name, registry.submit(name, r, block=True)) for name, r in window]
                by_tenant: Dict[str, list] = {}
                for i, (name, fut) in enumerate(futures):
                    try:
                        by_tenant.setdefault(name, []).append((n_requests + i, fut.result()))
                    except Exception as exc:  # one failed request costs one record
                        n_failed += 1
                        logger.warning("tenant %r request %d failed: %s", name, n_requests + i, exc)
                for name, results in by_tenant.items():
                    os.makedirs(os.path.join(scores_root, name), exist_ok=True)
                    _write_score_part(os.path.join(scores_root, name), k, results, model_id)
                n_requests += len(window)
        replay_s = time.perf_counter() - t_replay
        if pilot is not None:
            pilot.close()  # a loop that died raises here
            autopilot_block = pilot.summary()
            pilot = None
        metrics = registry.metrics()
        health = {n: registry.tenant(n).engine.health.snapshot() for n in names}
        provenance = {n: dict(registry.tenant(n).bundle.provenance) for n in names}
    finally:
        try:
            if pilot is not None:
                pilot.close()
        finally:
            registry.close(release_bundles=True)
    logger.info("replayed %d request(s) across %d tenant(s), %d failed, %d malformed skipped",
                n_requests, len(names), n_failed, malformed[0])
    summary = _summary(args, n_requests, n_failed, malformed[0], metrics, health, provenance, {},
                       autopilot_block)
    _write_registry_outputs(out_root, summary, registry, names, warmup_s, replay_s, device)
    return summary


def _load_labels(path: str) -> dict:
    """uid -> (label, weight) from .json/.jsonl lines; a malformed line
    costs one label."""
    labels: dict = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
                labels[str(doc["uid"])] = (float(doc["label"]), float(doc.get("weight", 1.0)))
            except Exception as exc:  # one malformed line costs one label
                logger.warning("skipping malformed label at %s:%d: %s", path, lineno, exc)
    return labels


def _run_with_shadow(args, index_maps, shard_configs, is_json: bool, device) -> Dict[str, object]:
    """`--shadow NAME=MODEL_DIR`: the model directory serves as tenant
    "champion" and the challenger rides as a shadow tenant fed a copy of
    every request with a uid (its answers are never returned: only the
    champion's scores are written); `--labels` joins labels into the
    windows that drive the verdict. Champion and challenger share the
    feature space: one encoding serves both."""
    from photon_ml_tpu_torch.serving.shadow import ShadowController
    from photon_ml_tpu_torch.serving.tenancy import TenantRegistry
    from photon_ml_tpu_torch.utils import telemetry

    shadow_name, sep, shadow_dir = args.shadow.partition("=")
    if not sep or not shadow_name or not shadow_dir:
        raise ValueError(f"--shadow {args.shadow!r}: expected NAME=MODEL_DIR")
    champion = "champion"
    if shadow_name == champion:
        raise ValueError(f"--shadow name {shadow_name!r} collides with the champion tenant name")
    labels = _load_labels(args.labels) if args.labels else {}
    out_root = args.root_output_directory
    t_warm = time.perf_counter()
    registry = TenantRegistry(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    controller = None
    malformed = [0]
    try:
        registry.admit(champion, lambda: load_bundle(args.model_input_directory, device=device,
                                                     index_maps=index_maps),
                       max_pending=args.max_pending, deadline_ms=args.deadline_ms)
        controller = ShadowController(registry, champion, shadow_name,
                                      lambda: load_bundle(shadow_dir, device=device,
                                                          index_maps=index_maps),
                                      window_size=args.shadow_window, max_pending=args.max_pending,
                                      deadline_ms=args.deadline_ms)
        warmup_s = time.perf_counter() - t_warm
        logger.info("champion pinned; challenger %r riding shadow (window=%d, %d label(s))",
                    shadow_name, args.shadow_window, len(labels))
        raw_stream = _iter_json_docs(args.requests, malformed) if is_json \
            else _iter_avro_records(args.requests)
        scores_dir = os.path.join(out_root, "scores")
        os.makedirs(scores_dir, exist_ok=True)
        model_id = args.model_id or "game-model"
        n_requests = n_failed = 0
        t_replay = time.perf_counter()
        with telemetry.span("serve_replay", shadow=shadow_name):
            for k in itertools.count():
                # Encoded against the champion's current bundle: after a
                # promotion, the promoted challenger's.
                bundle = registry.tenant(champion).bundle
                window = []
                for raw in itertools.islice(raw_stream, REPLAY_WINDOW):
                    try:
                        window.append(_encode(bundle, raw, is_json, shard_configs))
                    except Exception as exc:  # one malformed record costs one record
                        malformed[0] += 1
                        logger.warning("skipping malformed request: %s", exc)
                if not window:
                    break
                futures = []
                for req in window:
                    fut = registry.submit(champion, req, block=True)
                    futures.append(fut)
                    # After the champion's submit, so the pair lands in one
                    # round; False is champion-only, never an error.
                    if controller.mirror(req, fut) and req.uid in labels:
                        lab, w = labels[req.uid]
                        controller.record_label(req.uid, lab, weight=w)
                results = []
                for i, fut in enumerate(futures):
                    try:
                        results.append((n_requests + i, fut.result()))
                    except Exception as exc:  # one failed request costs one record
                        n_failed += 1
                        logger.warning("request %d failed: %s", n_requests + i, exc)
                if results:
                    _write_score_part(scores_dir, k, results, model_id)
                n_requests += len(window)
        replay_s = time.perf_counter() - t_replay
        if labels:
            controller.drain(timeout_s=120.0)
        shadow_block = controller.summary()
        controller.close()
        metrics = registry.metrics()
        health = registry.tenant(champion).engine.health.snapshot()
        provenance = dict(registry.tenant(champion).bundle.provenance)
    finally:
        if controller is not None:
            controller.close()
        registry.close(release_bundles=True)
    logger.info("replayed %d request(s), %d failed, %d malformed skipped; shadow %r finished %s",
                n_requests, n_failed, malformed[0], shadow_name, shadow_block["status"])
    summary = _summary(args, n_requests, n_failed, malformed[0], metrics, health, provenance,
                       shadow_block, {})
    _write_registry_outputs(out_root, summary, registry, [champion, shadow_name], warmup_s, replay_s,
                            device)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Parse `argv` (default: the process's) and run; returns the summary
    written to serving-summary.json. `--multihost N` runs the multi-host
    supervisor; `--mh-serve-worker` (the supervisor's workers) runs one
    serving host and exits with its code."""
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)
    if args.mh_serve_worker:
        from photon_ml_tpu_torch.cli import serve_multihost

        raise SystemExit(serve_multihost.run_worker(args))
    if args.multihost:
        from photon_ml_tpu_torch.cli import serve_multihost

        return serve_multihost.run_supervisor(args, raw_argv)
    return run(args)


if __name__ == "__main__":
    main()
