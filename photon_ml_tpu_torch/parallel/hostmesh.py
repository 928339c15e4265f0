"""Multi-host training: process group, per-rank ingest, liveness, checkpoint and supervisor.

Port of `photon_ml_tpu/parallel/hostmesh.py`. A host of the JAX package is
a rank here: one process with one device (`cuda:r` where every rank has a
card of its own, else a shared card or the CPU), joined into the ranks'
process group (`parallel/mesh.py`) over `tcp://`.

- `bringup()` joins the group and returns a `HostMesh`: the rank's
  `RankMesh` plus the rendezvous directory every filesystem exchange of
  the ranks (barriers, heartbeats, ingested row planes) lives under.
- `exchange_ingest()` is the per-rank disjoint ingest: each rank decodes
  only its byte-balanced slice of the input files (`partition_files`), onto
  the CPU, publishes one npz of row planes per file under
  `rendezvous/xch/`, and after a barrier every rank assembles all files in
  sorted-file order (`data/game_dataset.concat_datasets`). Row order is a
  property of the file list, so every world size builds the dataset one
  read of the sorted files builds, bit for bit.
- `HostHeartbeat` is the liveness domain: every rank bumps a counter file;
  a peer whose counter stalls `MISS_THRESHOLD` consecutive periods
  (`PHOTON_HOST_HEARTBEAT_MS`) is declared lost with a typed
  `faults.HostLoss`. A process group cannot shrink while it runs, so the
  worker journals `host_loss` and exits `EXIT_HOST_LOSS` (with NCCL a
  collective waiting on a dead peer never returns; the exit is the way
  out), and the supervisor relaunches the survivors.
- `MultihostCheckpoint` is the checkpoint on ranks (`game/checkpoint.
  RankCheckpoint`: each rank writes its row block of every random effect
  under the global `<cid>.shard<k>of<n>.npz` names, rank 0 the replicated
  fixed effect; the commit is a collective agreement of the checksums,
  rank 0's state.json and a receipt vote, so no stale marker of a torn
  attempt can satisfy a later one) recording the supervisor attempt it
  ran in, and naming the rank that wrote a missing shard on load.
- `supervise()` is the relaunch loop behind `cli.train --multihost`: one
  worker process per rank, exits classified (`classify_exit`), and on a
  rank loss a relaunch of the survivors with a fresh port and a fresh
  `rendezvous/attempt<k>/`; only the checkpoint directory lasts across
  attempts. A loss costs one repeated sweep.

- `restage_host_rows()` is the rejoin of a lost multi-host serving worker
  (cli/serve_multihost.py): the `host_join` fault site gates it, and it
  journals `host_join`.

Not here: `replicate_dataset_global` and `shard_random_effect_global` (the
port lays out its rows with `parallel/mesh.shard_game_dataset`).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import GameDataset, concat_datasets
from photon_ml_tpu_torch.game.checkpoint import RankCheckpoint
from photon_ml_tpu_torch.parallel.mesh import RankMesh, init_rank_mesh
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.faults import HostLoss
from photon_ml_tpu_torch.utils.knobs import get_knob

# A worker's exit code after it detected a rank loss: the supervisor reads
# it as "relaunch the survivors", apart from success (0) and a real failure.
EXIT_HOST_LOSS = 76

# Consecutive heartbeat periods a peer's counter may stall before it is
# declared lost; detection latency is tuned through the period.
MISS_THRESHOLD = 20

# Knobs that must not leak from the supervisor into a worker (an armed fault
# plan firing in every worker, a tracer fighting over one trace file).
_SCRUBBED_KNOBS = ("PHOTON_FAULTS", "PHOTON_FAULTS_SEED", "PHOTON_TRACE")

# Each collective's time limit in a worker: past it a rank stuck on a lost
# peer fails (the heartbeat's exit usually comes first).
GROUP_TIMEOUT_S = 300.0


# ------------------------------------------------------------ process group


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def await_port_released(port: int, timeout_s: float = 10.0) -> None:
    """Wait until `port` binds again (a killed rank 0 can hold its socket
    through teardown, and the next attempt's bind must not fail)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with socket.socket() as s:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", port))
                return
        except OSError:
            time.sleep(0.1)


def worker_env() -> Dict[str, str]:
    """The environment of one worker process: the inherited one without the
    scrubbed knobs, with the repo importable. Nothing pins a device: a
    worker runs on its card unless its command line says `--device cpu`."""
    env = dict(os.environ)
    for leaked in _SCRUBBED_KNOBS:
        env.pop(leaked, None)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


@dataclasses.dataclass
class HostMesh:
    """One worker's handle on the process group: its rank's mesh, its
    identity, and the rendezvous directory."""

    mesh: RankMesh
    host_id: int
    num_hosts: int
    rendezvous: str

    def barrier(self, name: str, timeout_s: float = 600.0) -> float:
        return fs_barrier(self, name, timeout_s=timeout_s)


def bringup(coordinator: str, num_hosts: int, host_id: int, rendezvous: str, *, device: str,
            backend: str) -> HostMesh:
    """Join the process group at `coordinator` ("host:port", rank 0's
    store) as rank `host_id` of `num_hosts`, on `device` over `backend`."""
    mesh = init_rank_mesh(backend=backend, rank=host_id, world_size=num_hosts, device=device,
                          init_method=f"tcp://{coordinator}", timeout_s=GROUP_TIMEOUT_S)
    os.makedirs(rendezvous, exist_ok=True)
    return HostMesh(mesh, host_id, num_hosts, rendezvous)


# ------------------------------------------------------------------ barriers


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def fs_barrier(hm: HostMesh, name: str, *, timeout_s: float = 600.0) -> float:
    """Filesystem barrier over the ranks: every rank publishes a marker
    under `rendezvous/barriers/<name>/` and waits for all of them. Journals
    a `multihost_barrier` event with the wait; a timeout raises `HostLoss`
    naming the ranks that never arrived. Returns the seconds waited."""
    d = os.path.join(hm.rendezvous, "barriers", name)
    os.makedirs(d, exist_ok=True)
    _atomic_write_text(os.path.join(d, f"host{hm.host_id}.ok"), "1")
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    want = set(range(hm.num_hosts))
    while True:
        have = {int(f[len("host"):-len(".ok")]) for f in os.listdir(d)
                if f.startswith("host") and f.endswith(".ok")}
        if want <= have:
            break
        if time.monotonic() > deadline:
            raise HostLoss(f"barrier {name!r}: hosts {sorted(want - have)} never arrived within "
                           f"{timeout_s:.0f}s ({len(have & want)}/{hm.num_hosts} present)")
        time.sleep(0.05)
    seconds = time.monotonic() - t0
    telemetry.emit_event("multihost_barrier", name=name, host=hm.host_id, num_hosts=hm.num_hosts,
                         seconds=round(seconds, 6))
    return seconds


# ------------------------------------------------------------------- ingest


def partition_files(files: Sequence[str], num_hosts: int) -> List[List[str]]:
    """Each rank's disjoint files: the reader's byte-balanced split
    (`io/avro_data._balanced_slice`), a pure function of the listing."""
    from photon_ml_tpu_torch.io.avro_data import _balanced_slice

    return [list(_balanced_slice(list(files), k, num_hosts)) for k in range(num_hosts)]


def _dataset_to_npz_arrays(ds: GameDataset) -> Dict[str, np.ndarray]:
    """One file's dataset as flat host arrays: the row planes of every
    shard, labels, offsets, weights, and every id tag factorized."""
    out: Dict[str, np.ndarray] = {"labels": ds.labels.cpu().numpy(),
                                  "offsets": ds.offsets.cpu().numpy(),
                                  "weights": ds.weights.cpu().numpy()}
    for name in sorted(ds.shards):
        feats = ds.shards[name]
        if isinstance(feats, SparseFeatures):
            out[f"shard__{name}__indices"] = feats.indices.cpu().numpy()
            out[f"shard__{name}__values"] = feats.values.cpu().numpy()
            out[f"shard__{name}__dim"] = np.asarray(feats.dim)
        else:
            out[f"dense__{name}"] = feats.cpu().numpy()
    for tag, (codes, table) in ds.tag_codes.items():
        table = np.asarray(table)
        out[f"tag__{tag}__codes"] = np.asarray(codes, np.int64)
        out[f"tag__{tag}__table"] = table.astype(str) if table.dtype == object else table
    return out


def _dataset_from_npz(path: str) -> GameDataset:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    shards: Dict[str, object] = {}
    tag_codes: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for key, arr in arrays.items():
        if key.startswith("shard__") and key.endswith("__indices"):
            name = key[len("shard__"):-len("__indices")]
            shards[name] = SparseFeatures(torch.from_numpy(arr),
                                          torch.from_numpy(arrays[f"shard__{name}__values"]),
                                          int(arrays[f"shard__{name}__dim"]))
        elif key.startswith("dense__"):
            shards[key[len("dense__"):]] = arr
        elif key.startswith("tag__") and key.endswith("__codes"):
            tag = key[len("tag__"):-len("__codes")]
            tag_codes[tag] = (arr, arrays[f"tag__{tag}__table"])
    return GameDataset.build(shards, arrays["labels"], offsets=arrays["offsets"],
                             weights=arrays["weights"],
                             id_tags={t: table[c] for t, (c, table) in tag_codes.items()},
                             tag_codes=tag_codes, device="cpu")


def _appended_intercepts(parts: Sequence[GameDataset], index_maps) -> List[str]:
    """The sparse shards whose last ELL column is, in every row of every
    part, the intercept that ingest appends (its index, value 1.0)."""
    out = []
    for name, imap in (index_maps or {}).items():
        icpt = getattr(imap, "intercept_index", None)
        if icpt is None or not all(isinstance(p.shards.get(name), SparseFeatures) for p in parts):
            continue
        if all(bool((p.shards[name].indices[:, -1] == icpt).all())
               and bool((p.shards[name].values[:, -1] == 1.0).all()) for p in parts):
            out.append(name)
    return out


def exchange_ingest(hm: HostMesh, files: Sequence[str], shard_configs, *, timeout_s: float = 600.0,
                    **reader_kwargs):
    """Per-rank disjoint ingest with a full row exchange. Each rank decodes
    only its slice of `files` onto the CPU (one `read_game_dataset` a file,
    with the shared index maps every multi-host read needs, in
    `reader_kwargs`), publishes one npz of its row planes per file under
    `rendezvous/xch/`, waits at a barrier, then assembles all files in
    sorted-file order with `concat_datasets` (an intercept column ingest
    appended stays last as the planes widen). Returns (the dataset of all
    rows on the CPU, this rank's files, its seconds by stage)."""
    from photon_ml_tpu_torch.io.avro_data import read_game_dataset

    files = sorted(files)
    if len(files) < hm.num_hosts:
        raise ValueError(f"multi-host ingest needs at least one file per host "
                         f"({len(files)} files for {hm.num_hosts} hosts)")
    times = {"decode_s": 0.0, "publish_s": 0.0}
    mine = partition_files(files, hm.num_hosts)[hm.host_id]
    xch = os.path.join(hm.rendezvous, "xch")
    os.makedirs(xch, exist_ok=True)
    # A file's planes are named by its place in the sorted list: daily
    # directories repeat their part files' names.
    planes = lambda path: os.path.join(xch, f"{files.index(path):06d}.npz")
    for path in mine:
        t0 = time.perf_counter()
        ds_f, _ = read_game_dataset([path], shard_configs, device="cpu", **reader_kwargs)
        times["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = planes(path)
        tmp = out + f".tmp{hm.host_id}"
        with open(tmp, "wb") as f:
            np.savez(f, **_dataset_to_npz_arrays(ds_f))
        os.replace(tmp, out)
        times["publish_s"] += time.perf_counter() - t0
    times["barrier_s"] = hm.barrier("ingest-exchange", timeout_s=timeout_s)
    t0 = time.perf_counter()
    parts = [_dataset_from_npz(planes(p)) for p in files]
    times["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = concat_datasets(*parts, keep_last=_appended_intercepts(parts, reader_kwargs.get("index_maps")))
    times["concat_s"] = time.perf_counter() - t0
    return merged, mine, times


# ---------------------------------------------------------------- heartbeat


class HostHeartbeat:
    """Rank liveness over the rendezvous directory: a thread bumps this
    rank's counter file each period and watches every peer's; a peer whose
    counter stalls `miss_threshold` consecutive periods is declared lost
    (`host_heartbeat_misses` counts each stalled period, `host_losses` the
    loss, and a `host_loss` event is journaled) and `on_loss` gets the
    typed `HostLoss` (the worker's escalation: exit `EXIT_HOST_LOSS`). The
    `host_loss` fault site fires in the loop, so a drill can inject a loss
    of this rank without killing anything."""

    def __init__(self, hm: HostMesh, on_loss: Callable[[HostLoss], None], *,
                 period_ms: Optional[int] = None, miss_threshold: int = MISS_THRESHOLD):
        self.hm = hm
        self.on_loss = on_loss
        self.period_s = (int(get_knob("PHOTON_HOST_HEARTBEAT_MS")) if period_ms is None
                         else period_ms) / 1000.0
        self.miss_threshold = miss_threshold
        self._dir = os.path.join(hm.rendezvous, "hb")
        os.makedirs(self._dir, exist_ok=True)
        self._stop = threading.Event()
        self._beat = 0
        self._last_seen: Dict[int, int] = {}
        self._misses: Dict[int, int] = {}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"photon-hostmesh-heartbeat-h{hm.host_id}")

    def start(self) -> "HostHeartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)

    def _beat_path(self, host: int) -> str:
        return os.path.join(self._dir, f"host{host}.beat")

    def _run(self) -> None:
        hm = self.hm
        while not self._stop.is_set():
            _atomic_write_text(self._beat_path(hm.host_id), str(self._beat))
            self._beat += 1
            try:
                faults.fault_point("host_loss")
            except faults.InjectedFault:
                self._declare_loss(hm.host_id, 0, source="injected")
                return
            for peer in range(hm.num_hosts):
                if peer == hm.host_id:
                    continue
                try:
                    with open(self._beat_path(peer)) as f:
                        seen = int(f.read().strip() or "0")
                except (OSError, ValueError):
                    seen = -1  # not beating yet, or a torn read: counts as stalled
                if seen > self._last_seen.get(peer, -2):
                    self._last_seen[peer] = seen
                    self._misses[peer] = 0
                    continue
                misses = self._misses.get(peer, 0) + 1
                self._misses[peer] = misses
                telemetry.METRICS.increment("host_heartbeat_misses")
                if misses >= self.miss_threshold:
                    self._declare_loss(peer, misses, source="heartbeat")
                    return
            self._stop.wait(self.period_s)

    def _declare_loss(self, host: int, missed: int, *, source: str) -> None:
        telemetry.METRICS.increment("host_losses")
        telemetry.emit_event("host_loss", host=host, missed_beats=missed,
                             num_hosts=self.hm.num_hosts, source=source)
        self.on_loss(HostLoss(f"host {host} lost ({source}: {missed} stalled heartbeat periods) "
                              f"out of {self.hm.num_hosts} hosts"))


# ----------------------------------------------------------- serving rejoin


def restage_host_rows(host_id: int, num_hosts: int, restaged_rows: int) -> int:
    """A lost serving host rejoining the fleet restages its row partition
    from the artifact. The `host_join` fault site gates the restage: an
    injected failure raises, and the fleet stays as it was (the host's rows
    keep answering FE-only through the survivors). Journals `host_join` on
    success and returns the rows restaged."""
    faults.fault_point("host_join")
    telemetry.emit_event("host_join", host=host_id, num_hosts=num_hosts, restaged_rows=restaged_rows)
    return restaged_rows


# --------------------------------------------------------------- checkpoint


class MultihostCheckpoint(RankCheckpoint):
    """The checkpoint of the multi-host fit: `RankCheckpoint` over the
    worker's coordinates, with the supervisor attempt it was written in
    recorded in state.json's `multihost` block (beside the reference's
    `num_hosts` and `shard_hosts`)."""

    def __init__(self, directory: str, hm: HostMesh, coordinates: Mapping[str, object], *,
                 attempt: int = 0):
        super().__init__(directory, coordinates)
        if self.mesh is not hm.mesh:
            raise ValueError("the coordinates are not on this host's mesh")
        self.hm = hm
        self.attempt = int(attempt)
        self.record["attempt"] = self.attempt


# --------------------------------------------------------------- supervisor


@dataclasses.dataclass
class SuperviseResult:
    """What the relaunch loop did: worker attempts run (1 = no loss), rank
    losses absorbed (each a relaunch, so one repeated sweep), the rank
    count of the final attempt, the workers' log files, and each attempt's
    record (`attempt`, `hosts`, `started_at` and `ended_at` on the wall
    clock, `verdict`, the `host` and `returncode` that decided it)."""

    attempts: int
    host_losses: int
    final_hosts: int
    worker_logs: List[str]
    attempt_log: List[Dict[str, object]] = dataclasses.field(default_factory=list)


def classify_exit(returncode: int) -> str:
    """'ok'; 'host_loss' (a worker killed by a signal, or a survivor that
    exited EXIT_HOST_LOSS after detecting the loss); or 'failed' (a real
    error: never relaunched)."""
    if returncode == 0:
        return "ok"
    if returncode < 0 or returncode == EXIT_HOST_LOSS:
        return "host_loss"
    return "failed"


def supervise(build_argv: Callable[[int, str, int, int], List[str]], *, num_hosts: int,
              rendezvous: str, attempt_timeout_s: float = 900.0) -> SuperviseResult:
    """Spawn one worker process per rank (`build_argv(attempt, coordinator,
    hosts, host_id)` gives its command line), classify the exits, and on a
    rank loss relaunch the survivors with a fresh port and a fresh
    `rendezvous/attempt<k>/`. Losses past PHOTON_HOST_LOSS_RETRIES, a
    failed worker or an attempt past its time raise, with the worker's
    stderr tail. Owns no device."""
    max_host_losses = int(get_knob("PHOTON_HOST_LOSS_RETRIES"))
    hosts = int(num_hosts)
    losses = 0
    attempt = 0
    logs: List[str] = []
    attempt_log: List[Dict[str, object]] = []
    while True:
        port = free_port()
        coordinator = f"127.0.0.1:{port}"
        log_dir = os.path.join(rendezvous, f"attempt{attempt}", "logs")
        os.makedirs(log_dir, exist_ok=True)
        env = worker_env()
        procs = []
        started_at = time.time()
        for k in range(hosts):
            out_path = os.path.join(log_dir, f"host{k}.out")
            err_path = os.path.join(log_dir, f"host{k}.err")
            logs.extend([out_path, err_path])
            of, ef = open(out_path, "w"), open(err_path, "w")
            procs.append((k, subprocess.Popen(build_argv(attempt, coordinator, hosts, k), env=env,
                                              stdout=of, stderr=ef), of, ef))

        def reap_all() -> None:
            for _, q, _, _ in procs:
                if q.poll() is None:
                    q.terminate()
            deadline_t = time.monotonic() + 5.0
            for _, q, _, _ in procs:
                if q.poll() is None:
                    try:
                        q.wait(timeout=max(0.1, deadline_t - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        pass
            for _, q, _, _ in procs:
                if q.poll() is None:
                    q.kill()
            for _, q, of, ef in procs:
                q.wait()
                of.close()
                ef.close()

        def err_tail(k: int, lines: int = 30) -> str:
            try:
                with open(os.path.join(log_dir, f"host{k}.err")) as f:
                    return "\n".join(f.read().splitlines()[-lines:])
            except OSError:
                return "<no stderr captured>"

        verdict: Optional[Tuple[str, int, int]] = None  # (kind, host, returncode)
        deadline = time.monotonic() + attempt_timeout_s
        try:
            while verdict is None:
                codes = {k: p.poll() for k, p, _, _ in procs}
                exited = {k: classify_exit(rc) for k, rc in codes.items() if rc is not None}
                # A loss outranks the failures it causes: a peer's collective
                # with a killed rank errors out after the kill is visible here.
                lost = sorted((codes[k] >= 0, k) for k, kind in exited.items() if kind == "host_loss")
                failed = [k for k, kind in exited.items() if kind == "failed"]
                if lost:
                    verdict = ("host_loss", lost[0][1], codes[lost[0][1]])
                elif failed:
                    verdict = ("failed", failed[0], codes[failed[0]])
                elif len(exited) == len(procs):
                    verdict = ("ok", -1, 0)
                elif time.monotonic() > deadline:
                    verdict = ("timeout", -1, 0)
                else:
                    time.sleep(0.05)
        finally:
            reap_all()
            await_port_released(port)
        kind, bad_host, rc = verdict
        attempt_log.append(dict(attempt=attempt, hosts=hosts, started_at=started_at,
                                ended_at=time.time(), verdict=kind, host=bad_host, returncode=rc))
        if kind == "ok":
            return SuperviseResult(attempt + 1, losses, hosts, logs, attempt_log)
        if kind == "failed":
            raise RuntimeError(f"multi-host worker {bad_host} failed (exit {rc}) on attempt "
                               f"{attempt} — not a host loss, not relaunching.\n"
                               f"stderr tail:\n{err_tail(bad_host)}")
        if kind == "timeout":
            raise RuntimeError(f"multi-host attempt {attempt} exceeded {attempt_timeout_s:.0f}s "
                               f"with workers still running — reaped. stderr tail of host 0:\n"
                               f"{err_tail(0)}")
        # A rank loss: relaunch the survivors. A SIGKILLed worker journals
        # nothing, so the supervisor journals the loss.
        losses += 1
        telemetry.METRICS.increment("host_losses")
        telemetry.emit_event("host_loss", host=bad_host, missed_beats=0, num_hosts=hosts,
                             source="supervisor")
        if losses > max_host_losses:
            raise RuntimeError(f"host loss #{losses} exceeds the retry budget "
                               f"(PHOTON_HOST_LOSS_RETRIES={max_host_losses}) — giving up.\n"
                               f"stderr tail of host {max(0, bad_host)}:\n"
                               f"{err_tail(max(0, bad_host))}")
        if hosts <= 1:
            raise RuntimeError(f"host loss with a single remaining host — nothing to relaunch "
                               f"on.\nstderr tail:\n{err_tail(0)}")
        hosts -= 1
        attempt += 1
