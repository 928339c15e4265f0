"""Multi-host serving (`cli.serve --multihost N`): host-local stores, and the
loss of a whole host as a failure the fleet survives.

Port of `photon_ml_tpu/cli/serve_multihost.py`. N worker processes each
stage the whole fixed effect but own only a partition of every
random-effect coordinate's rows: a worker cuts each matrix into
`--multihost-devices-per-host` row blocks (`ServingBundle` `row_blocks=`;
the reference stages one block per device of the host), owns block s iff
`s % N` is its host id, and marks every other block LOST in the bundle's
`ShardHealth` at start-up. A lookup of a row it does not own answers from
the pinned zero row, the shard-loss degradation of the serving tier.

Every worker replays the whole request stream and writes one JSONL result
part per window of `REPLAY_WINDOW` requests, each with a `progress`
marker, both by `os.replace`. The supervisor merges at the end: for each
request it keeps the answer with the fewest shard-loss fallbacks
(`ScoreResult.n_lost`, then fewer cold lookups, then the lower host id), so

  * while the owner lives, its answer is bit-equal to one process's
    `cli.serve` (marking other blocks lost never touches an owned row);
  * once the owner is dead, every survivor has answered those rows from the
    pinned zero row, the same bits on each: the request degrades, it never
    fails.

Ownership is per coordinate: with two random effects a request whose two
rows belong to different hosts has no host owning both, and its best
answer has `n_lost` 1 even with every host alive (the reference's
behaviour, kept).

A worker that dies (a SIGKILL drill) is journaled as `host_loss` (source
"serve-supervisor") and counted in `host_losses`; while
PHOTON_HOST_LOSS_RETRIES allows, the supervisor relaunches that worker
alone from its last durable window (`--mh-resume-window`), and the rejoin
restages its partition through `hostmesh.restage_host_rows` (the `host_join`
fault site and journal event). Out of budget, the host stays dead. Workers
share nothing (no process group, no heartbeat): the supervisor's poll is
the detector. The supervisor never touches a device; each worker runs on
`--device` (the card unless the command line says cpu), several workers
sharing one card where there is one.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

logger = logging.getLogger("photon_ml_tpu_torch.cli.serve_multihost")

# Worker result parts are JSONL (one answered request a line), not Avro
# score parts: the merge needs the fidelity fields (n_lost, n_cold) that
# the score schema does not carry.
_RESULT_FIELDS = ("i", "uid", "score", "mean", "cold", "n_cold", "n_lost", "fe")

# The supervisor's limit on the whole fleet's replay.
SUPERVISE_TIMEOUT_S = 900.0


def _host_dir(out_root: str, attempt: int, host_id: int) -> str:
    return os.path.join(out_root, "hosts", f"attempt{attempt}-host{host_id}")


def _validate_scope(args) -> None:
    """Refuse, before any staging, every flag combination the multi-host
    serve path does not implement (the reference's refusals, word for
    word). `--profile` and `--autopilot` are not read here, as in the
    reference."""
    refusals = []
    if getattr(args, "tenant", None):
        refusals.append("--tenant (multi-tenant) has no multi-host form")
    if getattr(args, "reshard_to", None) is not None:
        refusals.append("--reshard-to is a single-process drill (each multi-host worker's "
                        "layout IS the shard ownership map)")
    if not args.model_input_directory:
        refusals.append("--model-input-directory is required")
    if refusals:
        raise ValueError("--multihost serve scope: " + "; ".join(refusals))
    if not args.requests.endswith((".json", ".jsonl")) and not args.feature_shard_configurations:
        raise ValueError("Avro request replay needs --feature-shard-configurations (the bag -> "
                         "shard mapping offline ingest uses)")
    if int(args.multihost_devices_per_host) < 1:
        raise ValueError(f"--multihost-devices-per-host {args.multihost_devices_per_host}: "
                         "a store has at least one row block")


# ------------------------------------------------------------------ worker


def _mark_host_local(bundle, host_id: int, num_hosts: int):
    """Degrade `bundle` to this host's partition: every random-effect shard
    NOT owned by this host (owner = shard index mod num_hosts) is marked
    LOST, so its rows answer from the pinned zero row. Returns ({cid:
    [owned shard indices]}, total owned rows)."""
    owned: Dict[str, List[int]] = {}
    owned_rows = 0
    for cid, c in bundle.coordinates.items():
        sh = c.shard_health
        if not c.is_random_effect or sh is None:
            continue
        owned[cid] = []
        for s in range(sh.n_shards):
            if s % num_hosts == host_id:
                owned[cid].append(s)
                lo, hi = sh.row_range(s)
                owned_rows += hi - lo
            else:
                bundle.mark_shard_lost(cid, s)
    return owned, owned_rows


def kernel_launches() -> Dict[str, int]:
    """The port's kernels' launch counts in this process (each wrapper adds
    one where it launches its kernel): a worker's are recorded in its
    progress marker and summary, since the supervisor runs none."""
    from photon_ml_tpu_torch.ops import glm_kernels, sparse_kernels
    from photon_ml_tpu_torch.parallel import mesh as pmesh

    return {**sparse_kernels.LAUNCHES, **glm_kernels.LAUNCHES, **pmesh.LAUNCHES}


def reset_kernel_launches() -> None:
    from photon_ml_tpu_torch.ops import glm_kernels, sparse_kernels
    from photon_ml_tpu_torch.parallel import mesh as pmesh

    sparse_kernels.reset_launch_counts()
    glm_kernels.reset_launch_counts()
    pmesh.reset_launch_counts()


def _atomic_write(path: str, text: str) -> None:
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def run_worker(args) -> int:
    """One serving host: the whole artifact loaded, a host-local store (the
    blocks it does not own LOST), the whole stream replayed from
    `--mh-resume-window`, crash-safe per-window JSONL parts and a progress
    marker the supervisor reads to relaunch a killed worker where it left
    off. The marker and the summary carry the kernels' launches since the
    worker started, so a killed worker's count is read up to its last
    durable window. Returns the process's exit code."""
    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.parallel import hostmesh
    from photon_ml_tpu_torch.serving.bundle import load_bundle
    from photon_ml_tpu_torch.serving.engine import ServingEngine
    from photon_ml_tpu_torch.utils import telemetry

    host_id, num_hosts = args.mh_host_id, args.mh_num_hosts
    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO),
                        format=f"%(asctime)s h{host_id} %(name)s %(levelname)s %(message)s")
    _validate_scope(args)
    out_root = args.root_output_directory
    host_dir = _host_dir(out_root, args.mh_attempt, host_id)
    results_dir = os.path.join(host_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    # The pid file lands before any staging: it is a kill drill's target,
    # and a load-phase loss must be reachable too.
    with open(os.path.join(host_dir, "pid"), "w") as f:
        f.write(str(os.getpid()))

    journal = telemetry.RunJournal(os.path.join(host_dir, "journal.jsonl"))
    journal_owned = telemetry.current_journal() is None
    if journal_owned:
        telemetry.install_journal(journal)

    bundle = None
    reset_kernel_launches()
    try:
        from photon_ml_tpu_torch.cli.config import parse_feature_shard_config

        shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations or [])
        index_maps = None
        if args.offheap_indexmap_dir:
            from photon_ml_tpu_torch.io.paldb import resolve_offheap_index_maps

            index_maps = resolve_offheap_index_maps(args.offheap_indexmap_dir, shard_configs)
        started_at = time.time()
        t0 = time.perf_counter()
        bundle = load_bundle(args.model_input_directory, device=resolve_device(args.device),
                             index_maps=index_maps, row_blocks=int(args.multihost_devices_per_host))
        owned, owned_rows = _mark_host_local(bundle, host_id, num_hosts)
        load_s = time.perf_counter() - t0
        logger.info("host-local store: %s (%d owned rows of every RE coordinate)",
                    {cid: len(s) for cid, s in owned.items()}, owned_rows)
        if args.mh_attempt > 0:
            # A rejoin after a loss: the partition was just restaged from
            # the artifact (the load above); the host_join site can still
            # veto it, and then this worker exits non-zero and the fleet
            # keeps answering its rows FE-only.
            hostmesh.restage_host_rows(host_id, num_hosts, owned_rows)

        is_json = args.requests.endswith((".json", ".jsonl"))
        malformed = [0]
        stream = (serve_cli._iter_json_requests(args.requests, bundle, malformed) if is_json
                  else serve_cli._iter_avro_requests(args.requests, bundle, shard_configs, malformed))
        engine = ServingEngine(bundle, max_batch=args.max_batch)
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        n_requests = 0
        n_failed = 0
        first_window_at = None
        t0 = time.perf_counter()
        with engine, engine.batcher(max_wait_ms=args.max_wait_ms, max_pending=args.max_pending,
                                    default_deadline_ms=args.deadline_ms) as batcher:
            for k in itertools.count():
                window = list(itertools.islice(stream, serve_cli.REPLAY_WINDOW))
                if not window:
                    break
                if k < args.mh_resume_window:
                    # Answered durably before this relaunch; the stream is
                    # still consumed, so positions stay global.
                    n_requests += len(window)
                    continue
                futures = [batcher.submit(r, block=True) for r in window]
                lines = []
                for i, fut in enumerate(futures):
                    try:
                        r = fut.result()
                    except Exception as exc:  # one failed request costs one record
                        n_failed += 1
                        logger.warning("request %d failed: %s", n_requests + i, exc)
                        continue
                    lines.append(dict(zip(_RESULT_FIELDS, (
                        n_requests + i, r.uid, r.score, r.mean, bool(r.cold_start), int(r.n_cold),
                        int(r.n_lost), bool(r.fe_only)))))
                # A part, then the marker, each by rename: a SIGKILL tears
                # only a dot-prefixed temp, never a file a merge or a
                # relaunch trusts.
                _atomic_write(os.path.join(results_dir, f"part-{k:05d}.jsonl"),
                              "".join(json.dumps(ln) + "\n" for ln in lines))
                _atomic_write(os.path.join(host_dir, "progress"),
                              json.dumps({"next_window": k + 1, "launches": kernel_launches()}))
                if first_window_at is None:
                    first_window_at = time.time()
                n_requests += len(window)
            replay_s = time.perf_counter() - t0
            metrics = batcher.metrics()
        summary = {
            "host": host_id,
            "attempt": args.mh_attempt,
            "num_requests": n_requests,
            "failed_requests": n_failed,
            "malformed_records": malformed[0],
            "owned_shards": owned,
            "owned_rows": owned_rows,
            "serving": metrics,
            "counters": telemetry.METRICS.counters(),
            "launches": kernel_launches(),
            "device": str(bundle.device),
            "started_at": started_at,
            "first_window_at": first_window_at,
            "timings_s": {"load_s": load_s, "warmup_s": warmup_s, "replay_s": replay_s},
        }
        _atomic_write(os.path.join(host_dir, "worker-summary.json"),
                      json.dumps(summary, indent=2, default=str))
        return 0
    except Exception:
        logger.exception("serve worker h%d failed", host_id)
        return 1
    finally:
        if bundle is not None:
            bundle.release()
        if journal_owned:
            telemetry.uninstall_journal()
        journal.close()


# -------------------------------------------------------------- supervisor


def _read_progress(out_root: str, host_id: int, upto_attempt: int) -> int:
    """The latest durable window marker over a host's attempts (0 if it
    never finished a window): where a relaunch resumes."""
    best = 0
    for a in range(upto_attempt + 1):
        try:
            with open(os.path.join(_host_dir(out_root, a, host_id), "progress")) as f:
                best = max(best, int(json.load(f)["next_window"]))
        except (OSError, ValueError, KeyError):
            continue
    return best


def _collect_parts(out_root: str, host_id: int, upto_attempt: int) -> Dict[int, List[dict]]:
    """One host's answered windows, later attempts overriding earlier ones
    (a resumed worker answers again the window its predecessor died in)."""
    windows: Dict[int, List[dict]] = {}
    for a in range(upto_attempt + 1):
        rdir = os.path.join(_host_dir(out_root, a, host_id), "results")
        if not os.path.isdir(rdir):
            continue
        for fn in sorted(os.listdir(rdir)):
            if not (fn.startswith("part-") and fn.endswith(".jsonl")):
                continue
            with open(os.path.join(rdir, fn)) as f:
                windows[int(fn[len("part-"):-len(".jsonl")])] = [json.loads(ln) for ln in f if ln.strip()]
    return windows


def best_answers(per_host: Dict[int, Dict[int, List[dict]]], k: int) -> Dict[int, dict]:
    """Window `k`'s answer for each request: the fewest shard-loss
    fallbacks, then the fewest cold lookups, then the lowest host id."""
    best: Dict[int, Tuple[tuple, dict]] = {}
    for host in sorted(per_host):
        for ln in per_host[host].get(k, []):
            rank = (ln["n_lost"], ln["n_cold"], host)
            cur = best.get(ln["i"])
            if cur is None or rank < cur[0]:
                best[ln["i"]] = (rank, ln)
    return {i: best[i][1] for i in sorted(best)}


def _merge_scores(out_root: str, per_host: Dict[int, Dict[int, List[dict]]],
                  model_id: str) -> Tuple[int, int, int]:
    """Route at merge time (`best_answers`; survivors' FE-only answers for a
    lost host's rows are bit-equal, so the tie-break is cosmetic) and write
    the Avro score parts a single-process replay writes. Returns (merged
    requests, FE-only answers, degraded answers that are also cold)."""
    from photon_ml_tpu_torch.cli.serve import _write_score_part
    from photon_ml_tpu_torch.serving.engine import ScoreResult

    scores_dir = os.path.join(out_root, "scores")
    os.makedirs(scores_dir, exist_ok=True)
    merged = fe_only_answers = degraded_cold = 0
    for k in sorted({k for w in per_host.values() for k in w}):
        results = []
        for i, ln in best_answers(per_host, k).items():
            if ln["n_lost"] > 0:
                fe_only_answers += 1
                degraded_cold += bool(ln["cold"])
            results.append((i, ScoreResult(score=ln["score"], mean=ln["mean"], uid=ln["uid"],
                                           cold_start=ln["cold"], n_cold=ln["n_cold"],
                                           fe_only=ln["fe"], n_lost=ln["n_lost"])))
        if results:
            _write_score_part(scores_dir, k, results, model_id)
            merged += len(results)
    return merged, fe_only_answers, degraded_cold


def run_supervisor(args, raw_argv: List[str]) -> dict:
    """Spawn N share-nothing serving workers over the same artifact and
    request stream, absorb whole-host losses (journal, bounded relaunch of
    the lost worker alone), merge the durable result parts into the final
    score parts, and write serving-summary.json with its `multihost`
    block. Returns the summary."""
    from photon_ml_tpu_torch.native import avro_writer
    from photon_ml_tpu_torch.utils import telemetry
    from photon_ml_tpu_torch.utils.knobs import get_knob

    logging.basicConfig(level=getattr(logging, args.logging_level.upper(), logging.INFO),
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    _validate_scope(args)
    avro_writer.require_deflate()  # the merge writes deflate score parts
    num_hosts = int(args.multihost)
    devices_per_host = int(args.multihost_devices_per_host)
    retries = int(get_knob("PHOTON_HOST_LOSS_RETRIES"))
    out_root = args.root_output_directory
    os.makedirs(out_root, exist_ok=True)

    journal = telemetry.RunJournal(os.path.join(out_root, "journal.jsonl"))
    journal_owned = telemetry.current_journal() is None
    if journal_owned:
        telemetry.install_journal(journal)
    try:
        return _supervise(args, raw_argv, num_hosts, devices_per_host, retries, out_root)
    finally:
        if journal_owned:
            telemetry.uninstall_journal()
        journal.close()


def _supervise(args, raw_argv: List[str], num_hosts: int, devices_per_host: int, retries: int,
               out_root: str) -> dict:
    from photon_ml_tpu_torch.contracts import ROBUSTNESS_CLEAN_ZERO_KEYS
    from photon_ml_tpu_torch.parallel import hostmesh
    from photon_ml_tpu_torch.utils import faults, telemetry

    # Each host's relaunches are its own; the retry budget is the fleet's.
    attempt = {k: 0 for k in range(num_hosts)}
    procs: Dict[int, subprocess.Popen] = {}
    logs: List = []
    done: Dict[int, bool] = {}
    dead: Dict[int, bool] = {}
    attempt_log: List[Dict[str, object]] = []
    current: Dict[int, Dict[str, object]] = {}
    losses = 0
    rejoins = 0
    env = hostmesh.worker_env()

    def spawn(host_id: int, att: int, resume: int) -> None:
        host_dir = _host_dir(out_root, att, host_id)
        os.makedirs(host_dir, exist_ok=True)
        argv = [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", *raw_argv, "--mh-serve-worker",
                "--mh-host-id", str(host_id), "--mh-num-hosts", str(num_hosts),
                "--mh-attempt", str(att), "--mh-resume-window", str(resume)]
        fo = open(os.path.join(host_dir, "worker.out"), "w")
        fe = open(os.path.join(host_dir, "worker.err"), "w")
        logs.extend([fo, fe])
        current[host_id] = dict(host=host_id, attempt=att, resume_window=resume, started_at=time.time())
        procs[host_id] = subprocess.Popen(argv, env=env, stdout=fo, stderr=fe)
        logger.info("serve worker h%d up (attempt %d, resume window %d, pid %d)",
                    host_id, att, resume, procs[host_id].pid)

    try:
        for k in range(num_hosts):
            spawn(k, 0, 0)
        deadline = time.monotonic() + SUPERVISE_TIMEOUT_S
        while not all(done.get(k) or dead.get(k) for k in range(num_hosts)):
            if time.monotonic() > deadline:
                raise RuntimeError("multi-host serve timed out; killing workers")
            time.sleep(0.05)
            for k in range(num_hosts):
                if done.get(k) or dead.get(k):
                    continue
                rc = procs[k].poll()
                if rc is None:
                    continue
                verdict = hostmesh.classify_exit(rc)
                attempt_log.append(dict(current[k], ended_at=time.time(), returncode=rc,
                                        verdict=verdict))
                if verdict == "ok":
                    done[k] = True
                    continue
                # A whole-host loss mid-replay (any non-zero exit: a signal,
                # or a worker that failed, a vetoed rejoin included):
                # journal it, and while the budget allows relaunch this
                # worker from its last durable window. Out of budget the
                # fleet degrades: survivors keep answering its rows FE-only.
                losses += 1
                telemetry.METRICS.increment("host_losses")
                telemetry.emit_event("host_loss", host=k, missed_beats=0, num_hosts=num_hosts,
                                     source="serve-supervisor")
                logger.warning("serve worker h%d lost (rc %s, %s), loss %d/%d budget",
                               k, rc, verdict, losses, retries)
                if losses <= retries:
                    attempt[k] += 1
                    rejoins += 1
                    spawn(k, attempt[k], _read_progress(out_root, k, attempt[k]))
                else:
                    dead[k] = True
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        for f in logs:
            f.close()

    survivors = sorted(k for k in range(num_hosts) if done.get(k))
    if not survivors:
        raise RuntimeError("every serve worker died; no durable results to merge "
                           f"(hosts under {os.path.join(out_root, 'hosts')})")
    per_host = {k: _collect_parts(out_root, k, attempt[k]) for k in range(num_hosts)}
    merged, fe_only_answers, degraded_cold = _merge_scores(out_root, per_host,
                                                           args.model_id or "game-model")
    # Stream totals come from a worker that finished the whole replay: at
    # least one survivor did.
    wsum = {}
    for k in survivors:
        with open(os.path.join(_host_dir(out_root, attempt[k], k), "worker-summary.json")) as f:
            wsum[k] = json.load(f)
    ref = wsum[survivors[0]]
    num_requests = max(w["num_requests"] for w in wsum.values())
    failed = num_requests - merged
    summary = {
        "num_requests": num_requests,
        "failed_requests": failed,
        "malformed_records": ref["malformed_records"],
        "serving": ref["serving"],
        # The supervisor reads no request: a quarantined request block is
        # counted by the workers, each of which reads the whole stream.
        "robustness_counters": {**{k: 0 for k in ROBUSTNESS_CLEAN_ZERO_KEYS}, **faults.counters(),
                                "quarantined_blocks": ref["counters"].get("quarantined_blocks", 0)},
        "multihost": {
            "num_hosts": num_hosts,
            "devices_per_host": devices_per_host,
            "attempts": {str(k): attempt[k] + 1 for k in range(num_hosts)},
            "host_losses": losses,
            "rejoins": rejoins,
            "survivor_hosts": len(survivors),
            "fe_only_answers": fe_only_answers,
            "degraded_cold_answers": degraded_cold,
            "owned_rows": {str(k): wsum[k]["owned_rows"] for k in survivors},
            # The port's record of every worker attempt: host, attempt,
            # resume window, wall-clock start and end, exit code, verdict.
            "attempt_log": attempt_log,
        },
    }
    with open(os.path.join(out_root, "serving-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    logger.info("multi-host replay merged: %d request(s), %d failed, %d FE-only degraded, "
                "%d host loss(es), %d survivor(s)", num_requests, failed, fe_only_answers, losses,
                len(survivors))
    return summary
