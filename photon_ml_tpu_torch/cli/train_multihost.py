"""Multi-host training: the supervisor and worker behind `cli.train --multihost N`.

Port of `photon_ml_tpu/cli/train_multihost.py`. The supervisor
(`run_supervisor`) owns no device state and never initialises CUDA: it
spawns one worker process per rank through `parallel/hostmesh.supervise`,
classifies their exits, and on a rank loss (a worker killed by a signal, or
a survivor that exited `EXIT_HOST_LOSS` after its heartbeat fired)
relaunches the survivors against the durable checkpoint directory; a loss
costs one repeated sweep, not the job.

Each worker (`run_worker`) is one rank of the process group
(`hostmesh.bringup`): it decodes only its byte-balanced slice of the input
files onto the CPU and exchanges the row planes, so every rank holds the
dataset one read of the sorted files gives (`exchange_ingest`); takes its
rows, which follow the first random effect's entities
(`parallel/mesh.shard_game_dataset` with ingest's `tag_codes`); builds the
coordinates; and runs `run_coordinate_descent` with a
`MultihostCheckpoint`, journaling a `checkpoint` line a committed step
into its own journal (the reference's worker journals none). Rank 0 then saves the model (read back from the
checkpoint), its index maps and `multihost-fit-summary.json` between the
barriers `fit-complete` and `artifact-saved`.

A worker's device and backend are explicit and recorded in its summary:
`--device cpu` runs every rank on the CPU over gloo; `--device cuda:<i>`
puts every rank on that one card, over gloo; `--device cuda` (the default)
gives rank r the card `cuda:r` over NCCL where the machine has a card for
every rank, and else every rank shares `cuda:0` over gloo. A rank has one
device, so `--multihost-devices-per-host` other than 1 is refused.

Scope: the multi-host mode supports the production fit path only.
Validation, tuning, warm start, variances, normalization, projectors other
than IDENTITY, constraints, locked coordinates and reg-weight sweeps are
refused before any process starts (`_validate_scope`, the reference's
refusals word for word).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import time
from typing import Dict, List, Tuple

from photon_ml_tpu_torch.cli.config import parse_coordinate_config, parse_feature_shard_config
from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig
from photon_ml_tpu_torch.types import NormalizationType, ProjectorType

logger = logging.getLogger(__name__)

# The one model directory the multi-host fit writes (no tuning: best is the
# single explicit fit).
_BEST_SUBDIR = "best"
_FIT_SUMMARY = "multihost-fit-summary.json"
_RANK_SUMMARY = "fit-summary.json"


# ---------------------------------------------------------------- supervisor


def _refuse_devices_per_host(args) -> None:
    if args.multihost_devices_per_host not in (None, 1):
        raise ValueError(f"--multihost-devices-per-host {args.multihost_devices_per_host}: a rank "
                         "of the PyTorch port drives one device, so a host is one rank (1 or unset)")


def run_supervisor(args, argv: List[str]) -> Dict[str, object]:
    """`cli.train --multihost N`: spawn N workers, absorb rank losses, and
    write training-summary.json: rank 0's fit summary plus the relaunch
    record (`multihost`)."""
    from photon_ml_tpu_torch.parallel import hostmesh
    from photon_ml_tpu_torch.utils import telemetry

    _refuse_devices_per_host(args)
    _validate_scope(args)
    out_root = args.root_output_directory
    models_root = os.path.join(out_root, "models")
    if os.path.exists(models_root):
        if not args.override_output_directory:
            raise FileExistsError(f"{models_root} exists; pass --override-output-directory to replace")
        shutil.rmtree(models_root)
    os.makedirs(out_root, exist_ok=True)
    # Rendezvous state (barriers, heartbeats, exchanged row planes) is per
    # run; only the checkpoint directory lasts.
    rendezvous = os.path.join(out_root, "rendezvous")
    if os.path.exists(rendezvous):
        shutil.rmtree(rendezvous)

    # The supervisor's journal holds the loss and relaunch record; each
    # worker keeps its own under hosts/.
    journal = telemetry.RunJournal(os.path.join(out_root, "journal.jsonl"))
    journal_owned = telemetry.current_journal() is None
    if journal_owned:
        telemetry.install_journal(journal)

    def build_argv(attempt: int, coordinator: str, hosts: int, host_id: int) -> List[str]:
        return [sys.executable, "-m", "photon_ml_tpu_torch.cli.train", *argv, "--mh-worker",
                "--mh-attempt", str(attempt), "--mh-coordinator", coordinator,
                "--mh-num-hosts", str(hosts), "--mh-host-id", str(host_id),
                "--mh-rendezvous", os.path.join(rendezvous, f"attempt{attempt}")]

    try:
        res = hostmesh.supervise(build_argv, num_hosts=args.multihost, rendezvous=rendezvous)
    finally:
        if journal_owned:
            telemetry.uninstall_journal()
        journal.close()

    fit_path = os.path.join(out_root, _FIT_SUMMARY)
    try:
        with open(fit_path) as f:
            summary: Dict[str, object] = json.load(f)
    except OSError:
        raise RuntimeError(f"multi-host fit reported success but {fit_path} is missing — "
                           "host 0 died after the fit-complete barrier?") from None
    summary["multihost"] = {
        "num_hosts": int(args.multihost),
        "devices_per_host": 1,
        "attempts": res.attempts,
        "host_losses": res.host_losses,
        # Each relaunch resumes at the last committed step: losses are
        # repeated sweeps.
        "repeated_sweeps": res.host_losses,
        "final_hosts": res.final_hosts,
        "attempt_log": res.attempt_log,
    }
    with open(os.path.join(out_root, "training-summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    logger.info("multi-host training complete: %d host(s), %d attempt(s), %d host loss(es)",
                res.final_hosts, res.attempts, res.host_losses)
    return summary


def _validate_scope(args) -> None:
    """Refuse everything outside the multi-host fit's scope, before any
    process starts: each is a feature that would need its own cross-rank
    design, and run rank by rank it would fit divergent models."""
    refusals = []
    if not args.checkpoint_directory:
        refusals.append("--checkpoint-directory is required (host-loss recovery "
                        "resumes from the last committed sweep)")
    if not getattr(args, "offheap_indexmap_dir", None):
        refusals.append("--offheap-indexmap-dir is required (feature ids must agree "
                        "across hosts; build one with cli/build_index.py)")
    if args.validation_data_directories:
        refusals.append("validation data is single-host only")
    if args.validation_evaluators:
        refusals.append("validation evaluators are single-host only")
    if args.hyper_parameter_tuning.name != "NONE":
        refusals.append("hyperparameter tuning is single-host only")
    if args.variance_computation_type.name != "NONE":
        refusals.append("coefficient variances are single-host only")
    if args.normalization != NormalizationType.NONE:
        refusals.append("normalization is single-host only")
    if getattr(args, "model_input_directory", None):
        refusals.append("warm start is single-host only")
    if getattr(args, "partial_retrain_locked_coordinates", None):
        refusals.append("partial retrain is single-host only")
    for s in args.coordinate_configurations:
        cfg = parse_coordinate_config(s)
        if cfg.constraint_file:
            refusals.append(f"coordinate {cfg.name!r}: constraints are single-host only")
        if len(set(cfg.reg_weights)) > 1:
            refusals.append(f"coordinate {cfg.name!r}: reg-weight sweeps are "
                            "single-host only (sweeps need validation)")
        dc = cfg.data_config
        if isinstance(dc, RandomEffectDataConfig) and dc.projector_type != ProjectorType.IDENTITY:
            refusals.append(f"coordinate {cfg.name!r}: only projector=IDENTITY is "
                            "supported multi-host (projected shards are built after "
                            "the global replication step)")
    if refusals:
        raise ValueError("--multihost: unsupported options:\n  - " + "\n  - ".join(refusals))


# -------------------------------------------------------------------- worker


def worker_device(device: str, num_hosts: int, host_id: int) -> Tuple[str, str]:
    """(device, backend) of rank `host_id` of `num_hosts` for `--device`
    (see the module docstring)."""
    import torch

    from photon_ml_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu", "gloo"
    if dev.index is not None:
        return f"cuda:{dev.index}", "gloo"
    if torch.cuda.device_count() >= num_hosts:
        return f"cuda:{host_id}", "nccl"
    return "cuda:0", "gloo"


def _journal_checkpoints(etype: str, **fields) -> None:
    """The worker's coordinate-descent hook: each committed step as a
    `checkpoint` line of the worker's journal."""
    from photon_ml_tpu_torch.utils import telemetry

    if etype == "checkpoint":
        telemetry.emit_event("checkpoint", **fields)


def run_worker(args) -> int:
    """One rank of the process group. Returns the process's exit code: 0
    on success, `EXIT_HOST_LOSS` when a peer's loss was detected (the
    supervisor relaunches the survivors), 1 on a real error."""
    from photon_ml_tpu_torch.parallel import hostmesh
    from photon_ml_tpu_torch.utils import telemetry
    from photon_ml_tpu_torch.utils.faults import HostLoss

    logging.basicConfig(
        level=getattr(logging, args.logging_level.upper(), logging.INFO),
        format=f"%(asctime)s h{args.mh_host_id} %(name)s %(levelname)s %(message)s")
    _refuse_devices_per_host(args)
    _validate_scope(args)

    out_root = args.root_output_directory
    host_dir = os.path.join(out_root, "hosts", f"attempt{args.mh_attempt}-host{args.mh_host_id}")
    os.makedirs(host_dir, exist_ok=True)
    # The pid first: a drill needs a target before the group forms.
    with open(os.path.join(host_dir, "pid"), "w") as f:
        f.write(str(os.getpid()))

    journal = telemetry.RunJournal(os.path.join(host_dir, "journal.jsonl"))
    telemetry.install_journal(journal)

    def escalate(loss: HostLoss) -> None:
        # The heartbeat declared a peer (or an injected self) lost and
        # journaled it: a collective with a dead member would wait until its
        # timeout (gloo) or forever (NCCL), so exit with the typed code.
        try:
            telemetry.uninstall_journal()
            journal.close()
        finally:
            os._exit(hostmesh.EXIT_HOST_LOSS)

    heartbeat = None
    try:
        device, backend = worker_device(args.device, args.mh_num_hosts, args.mh_host_id)
        t0 = time.perf_counter()
        hm = hostmesh.bringup(args.mh_coordinator, args.mh_num_hosts, args.mh_host_id,
                              args.mh_rendezvous, device=device, backend=backend)
        heartbeat = hostmesh.HostHeartbeat(hm, escalate).start()
        _fit(args, hm, host_dir, dict(device=device, backend=backend,
                                      bringup_s=time.perf_counter() - t0))
        hm.mesh.close()
        return 0
    except HostLoss as loss:
        # A loss seen outside the heartbeat (a barrier a rank never
        # reached): journaled and escalated the same way.
        telemetry.METRICS.increment("host_losses")
        telemetry.emit_event("host_loss", host=-1, missed_beats=0, num_hosts=args.mh_num_hosts,
                             source="barrier")
        logger.error("host loss: %s", loss)
        return hostmesh.EXIT_HOST_LOSS
    except Exception:
        logger.exception("multi-host worker failed")
        return 1
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        if telemetry.current_journal() is journal:
            telemetry.uninstall_journal()
        journal.close()


def _resolve_files(args) -> List[str]:
    """The input files of all ranks, sorted: every rank computes the same
    list, and `hostmesh.partition_files` gives each its slice."""
    from photon_ml_tpu_torch.io.avro import list_container_files
    from photon_ml_tpu_torch.utils.date_range import paths_for_date_range, resolve_range

    train_range = resolve_range(args.input_data_date_range, args.input_data_days_range)
    files: List[str] = []
    for p in paths_for_date_range(args.input_data_directories, train_range):
        files.extend(list_container_files(p))
    return sorted(files)


def _fit(args, hm, host_dir: str, record: Dict[str, object]) -> None:
    """The worker's fit: disjoint ingest and exchange, this rank's rows and
    coordinates, checkpointed coordinate descent, rank 0's artifact."""
    import torch

    from photon_ml_tpu_torch.data.game_dataset import build_random_effect_dataset
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.game.model import GameModel
    from photon_ml_tpu_torch.game.projector import project_shard
    from photon_ml_tpu_torch.io import avro_data, model_bridge, model_store
    from photon_ml_tpu_torch.io.paldb import resolve_offheap_index_maps
    from photon_ml_tpu_torch.ops import glm_kernels, sparse_kernels
    from photon_ml_tpu_torch.parallel import hostmesh
    from photon_ml_tpu_torch.parallel import mesh as pmesh
    from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
    from photon_ml_tpu_torch.utils import telemetry

    mesh = hm.mesh
    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    coordinate_configs = {}
    for s in args.coordinate_configurations:
        cfg = parse_coordinate_config(s)
        coordinate_configs[cfg.name] = cfg
    update_sequence = ([c.strip() for c in args.coordinate_update_sequence.split(",")]
                       if args.coordinate_update_sequence else list(coordinate_configs))
    shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    re_configs = [coordinate_configs[c].data_config for c in update_sequence
                  if isinstance(coordinate_configs[c].data_config, RandomEffectDataConfig)]
    index_maps = resolve_offheap_index_maps(args.offheap_indexmap_dir, shard_configs)
    columns = (avro_data.InputColumnNames.parse(args.input_column_names)
               if args.input_column_names else avro_data.InputColumnNames())

    files = _resolve_files(args)
    t0 = time.perf_counter()
    data, mine, ingest_s = hostmesh.exchange_ingest(
        hm, files, shard_configs, index_maps=index_maps,
        id_tag_fields=[dc.random_effect_type for dc in re_configs], columns=columns)
    ingest_s["total_s"] = time.perf_counter() - t0
    logger.info("host %d ingested %d/%d files; global dataset: %d samples", hm.host_id, len(mine),
                len(files), data.num_samples)

    # This rank's rows follow the first random effect's entities; any other
    # random effect trains on a row view.
    t0 = time.perf_counter()
    ds = pmesh.shard_game_dataset(mesh, data.shards, data.labels, offsets=data.offsets,
                                  weights=data.weights, tag_codes=data.tag_codes,
                                  owner=re_configs[0] if re_configs else None)
    num_samples = data.num_samples
    del data
    coords: Dict[str, object] = {}
    specs: Dict[str, CoordinateScoringSpec] = {}
    opt_configs: Dict[str, dict] = {}
    reg_weights: Dict[str, float] = {}
    for cid in update_sequence:
        cfg = coordinate_configs[cid]
        oc = cfg.expand()[0]  # one reg weight (sweeps are refused)
        dc = cfg.data_config
        if isinstance(dc, RandomEffectDataConfig):
            red = build_random_effect_dataset(ds, dc)
            ps = project_shard(ds, red, dc.projector_type, projected_dim=dc.projected_dim,
                               seed=args.random_seed)
            coords[cid] = RandomEffectCoordinate(ds, red, oc, args.training_task, None)
            specs[cid] = CoordinateScoringSpec(shard=dc.feature_shard, norm=None,
                                               random_effect_type=dc.random_effect_type,
                                               entity_index=red.entity_index, projector=ps.projector)
        else:
            coords[cid] = FixedEffectCoordinate(ds, dc.feature_shard, oc, args.training_task, None)
            specs[cid] = CoordinateScoringSpec(shard=dc.feature_shard, norm=None)
        reg_weights[cid] = oc.reg_weight
        opt_configs[cid] = {"optimizer": oc.optimizer.optimizer_type.value,
                            "max_iterations": oc.optimizer.max_iterations,
                            "tolerance": oc.optimizer.tolerance,
                            "regularization": oc.regularization.reg_type.value,
                            "reg_weight": oc.reg_weight}
    sync()
    setup_s = time.perf_counter() - t0

    checkpoints = []

    def checkpoint(directory: str):
        checkpoints.append(hostmesh.MultihostCheckpoint(directory, hm, coords,
                                                        attempt=args.mh_attempt))
        return checkpoints[-1]

    # The fit's launches and collectives, counted from 0 here.
    sparse_kernels.reset_launch_counts()
    glm_kernels.reset_launch_counts()
    pmesh.reset_launch_counts()
    mesh.reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, args.coordinate_descent_iterations,
                                    reg_weights=reg_weights, seed=args.random_seed,
                                    checkpoint_dir=args.checkpoint_directory,
                                    checkpoint_factory=checkpoint, on_event=_journal_checkpoints)
    sync()
    fit_s = time.perf_counter() - t0
    ckpt = checkpoints[0]
    rank_row = dict(
        rank=hm.host_id, num_hosts=hm.num_hosts, attempt=args.mh_attempt, **record,
        files=[os.path.basename(p) for p in mine], rows=ds.num_samples, ingest_s=ingest_s,
        setup_s=setup_s, fit_s=fit_s, timings_s=dict(result.timing),
        checkpoint_saves=ckpt.save_timings,
        launches=dict(sparse_kernels.LAUNCHES, **glm_kernels.LAUNCHES, **pmesh.LAUNCHES),
        collectives=dict(mesh.counts), collective_s=dict(mesh.seconds),
        peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None),
        diverged_steps=result.diverged_steps)
    with open(os.path.join(host_dir, _RANK_SUMMARY), "w") as f:
        json.dump(rank_row, f, indent=2, default=str)
    hm.barrier("fit-complete")

    if hm.host_id == 0:
        # The model of all ranks, from the checkpoint's shard files.
        st = hostmesh.MultihostCheckpoint(args.checkpoint_directory, hm, coords,
                                          attempt=args.mh_attempt).load(args.training_task)
        artifact = model_bridge.artifact_from_game_model(
            GameModel(dict(st.models)), specs, args.training_task, opt_configs=opt_configs)
        mdir = os.path.join(args.root_output_directory, "models", _BEST_SUBDIR)
        model_store.save_game_model(mdir, artifact, index_maps,
                                    sparsity_threshold=args.model_sparsity_threshold)
        idx_dir = os.path.join(mdir, "feature-indexes")
        os.makedirs(idx_dir, exist_ok=True)
        for shard, imap in index_maps.items():
            imap.save(os.path.join(idx_dir, f"{shard}.json"))
        ranks = []
        for r in range(hm.num_hosts):
            path = os.path.join(os.path.dirname(host_dir),
                                f"attempt{args.mh_attempt}-host{r}", _RANK_SUMMARY)
            with open(path) as f:
                ranks.append(json.load(f))
        summary = {
            "num_samples": int(num_samples),
            "num_files": len(files),
            "files_this_host": len(mine),
            "completed_steps": int(args.coordinate_descent_iterations * len(coords)),
            "coordinates": list(coords),
            "timings_s": {name: round(total, 3) for name, total in result.timing.items()},
            "counters": telemetry.METRICS.counters(),
            "ranks": ranks,
        }
        tmp = os.path.join(args.root_output_directory, _FIT_SUMMARY + ".tmp")
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=2, default=str)
        os.replace(tmp, os.path.join(args.root_output_directory, _FIT_SUMMARY))
    # The others keep the group open until rank 0's artifact is durable.
    hm.barrier("artifact-saved")
