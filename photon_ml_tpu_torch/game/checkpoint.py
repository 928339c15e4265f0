"""Checkpoint-restart of the coordinate-descent outer loop.

The port's own copy of `photon_ml_tpu/game/checkpoint.py`, with the same
files, keys and commit protocol, so a checkpoint either package writes
resumes in the other.

Durable state after each coordinate update:
  * every coordinate's current model, in the training representation
    (projected and normalized spaces); scores and residuals are recomputed
    from the models on resume, so they are never written;
  * the step cursor, the run's configuration fingerprint (`config_key`; a
    resume under another configuration is refused), the seed (down-sampling
    draws derive from (seed, step), so a resumed run draws the same
    samples), the best-pass snapshot and the validation history.

Write protocol:
  * each step writes the files of the coordinate trained that step (and
    of any coordinate that has no file yet) through the `_write_model_files`
    hook: in one process a single npz blob with the reference's keys,
    `steps/<step>/<cid>.npz`;
  * `state.json` maps every coordinate to its current files and is replaced
    atomically last: it is the commit point, so a crash before it leaves the
    previous state naming only whole files;
  * the best-pass snapshot holds file references (the pass-end models are
    the current models), so it writes nothing;
  * step directories no longer referenced are pruned after the commit.

On ranks (`RankCheckpoint`) a random effect takes the reference's elastic
row-sharded layout, `<cid>.shard<k>of<n>.npz` with the keys `kind`
(`random_shard`), `matrix`, `variances` when present, `shard_index`,
`n_shards`, `row_start` and `n_entities`: rank k first receives the rows of
its contiguous block of the global (E + 1, D) matrices from their owners
(one `RankMesh.exchange`) and writes that block alone; rank 0 alone writes a
replicated (fixed-effect) model. The commit is a collective: the ranks
agree every new file's checksum in one `owned_to_global` (each rank
contributes after its files are durable, so the agreement is the barrier),
rank 0 writes state.json (with the reference's `multihost` record of which
rank wrote each file) and prunes, and a vote of the ranks (`all_true`) is
rank 0's receipt, so no rank runs ahead of a step that did not commit.

Reading: every file is read under the `resume_load` fault site and the
bounded retry; a row-sharded random effect's blocks are reassembled in row
order and cut to the logical entity count (`_model_from_row_blocks`), so a
checkpoint of any world size resumes in one process or on any number of
ranks, and the JAX package's mesh checkpoints load here.

Integrity: every model file's crc32 is recorded in state.json at the commit
and checked on load; a missing, unreadable, torn or foreign file raises
`CheckpointIntegrityError` (on ranks, naming the rank that wrote a missing
shard).

Background write: `begin_model_write` starts one step's model write on a
thread (under a `ckpt_write` span parented to the caller's), so the caller
can run the step's validation meanwhile; `save(staged=...)` joins it before
state.json is replaced, and a background write whose retries were spent is
redone synchronously, so the commit protocol is unchanged. On ranks the
write holds a collective and stays on the main thread.

Refresh audit: `append_delta_record` / `read_delta_records` keep each
incremental fit's record in `delta_records.jsonl` beside the checkpoint
(the reference's file and keys).

Faults: every atomic write fires the `checkpoint_write` site, and a model
write or the state.json commit runs under the bounded `retry`
(utils/faults.py); a read retries transient failures but not a missing
file. The delta records are not ported.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import shutil
import tempfile
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation.suite import EvaluationResults, EvaluatorType
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.utils import faults, telemetry

logger = logging.getLogger(__name__)

STATE_FILE = "state.json"
STEPS_DIR = "steps"


class CheckpointIntegrityError(ValueError):
    """A state.json-referenced checkpoint file is missing, torn, or does
    not match its recorded checksum."""


def _checksum(data: bytes) -> str:
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def _atomic_write(path: str, data: bytes) -> None:
    faults.fault_point("checkpoint_write")
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # The rename itself on stable storage, not just the bytes.
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _write_model_bytes(path: str, data: bytes) -> str:
    """One model file written atomically under the bounded retry; returns
    its content checksum."""
    faults.retry(lambda: _atomic_write(path, data), label=f"checkpoint write {path}")
    return _checksum(data)


def _save_model_npz(path: str, model) -> str:
    """Write the model npz (one blob); returns its content checksum."""
    if isinstance(model, FixedEffectModel):
        arrays = {"kind": np.asarray("fixed"), "means": _host(model.coefficients.means)}
        if model.coefficients.variances is not None:
            arrays["variances"] = _host(model.coefficients.variances)
    elif isinstance(model, RandomEffectModel):
        arrays = {"kind": np.asarray("random"), "matrix": _host(model.coefficients_matrix)}
        if model.variances_matrix is not None:
            arrays["variances"] = _host(model.variances_matrix)
    else:
        raise TypeError(f"unknown model type {type(model)}")
    return _write_model_bytes(path, _npz_bytes(arrays))


def _save_row_block(path: str, k: int, n: int, start: int, matrix: torch.Tensor,
                    var: Optional[torch.Tensor], n_entities: int) -> str:
    """One shard file of the elastic layout (the reference's keys); returns
    its checksum."""
    arrays = {"kind": np.asarray("random_shard"), "matrix": _host(matrix),
              "shard_index": np.asarray(k), "n_shards": np.asarray(n),
              "row_start": np.asarray(start), "n_entities": np.asarray(n_entities)}
    if var is not None:
        arrays["variances"] = _host(var)
    return _write_model_bytes(path, _npz_bytes(arrays))


def _flat_rels(values):
    """model_files values are a str (single blob) or a list of shard paths."""
    for v in values:
        if isinstance(v, str):
            yield v
        else:
            yield from v


def _resume_read_policy() -> faults.RetryPolicy:
    """The bounded retry of a read on resume: transient failures (and the
    armed `resume_load` site) read again; a missing file is not transient."""
    base = faults.default_policy()
    return dataclasses.replace(
        base, is_transient=lambda exc: not isinstance(exc, FileNotFoundError) and base.is_transient(exc))


def _read_checkpoint_bytes(path: str) -> bytes:
    def attempt() -> bytes:
        faults.fault_point("resume_load")
        with open(path, "rb") as f:
            return f.read()

    return faults.retry(attempt, _resume_read_policy(), label=f"checkpoint read {path}")


def _read_verified(path: str, expected: Optional[str], what: str, remedy: str) -> Dict[str, np.ndarray]:
    """One npz read back: present, readable, matching its checksum, and a
    valid npz; anything else is a CheckpointIntegrityError (an injected
    fault whose retries ran out surfaces as itself)."""
    try:
        data = _read_checkpoint_bytes(path)
    except faults.InjectedFault:
        raise
    except FileNotFoundError:
        raise CheckpointIntegrityError(
            f"checkpoint is missing {what} {path} (state.json references it, so the "
            f"checkpoint is incomplete) {remedy}") from None
    except OSError as exc:
        raise CheckpointIntegrityError(f"checkpoint {what} {path} is unreadable ({exc}) {remedy}") from exc
    if expected is not None and _checksum(data) != expected:
        raise CheckpointIntegrityError(
            f"corrupt/torn checkpoint file {path}: content checksum {_checksum(data)} does "
            f"not match the recorded {expected} {remedy}")
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            return {name: np.asarray(z[name]) for name in z.files}
    except Exception as exc:  # BadZipFile, truncated npz, ...
        raise CheckpointIntegrityError(
            f"corrupt/torn checkpoint file {path} ({type(exc).__name__}: {exc}) {remedy}") from exc


def _tensor(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _model_from_row_blocks(blocks, task, n_entities: Optional[int], device) -> RandomEffectModel:
    """One random effect from (row_start, matrix, variances or None) row
    blocks, concatenated in row order and cut to its logical rows (a
    mesh-padded matrix keeps its first n_entities + 1: the entities and
    the pinned zero row). A single blob is one block."""
    blocks = sorted(blocks, key=lambda b: b[0])
    matrix = np.concatenate([m for _, m, _ in blocks], axis=0)
    var = None
    if all(v is not None for _, _, v in blocks):
        var = np.concatenate([v for _, _, v in blocks], axis=0)
    if n_entities is not None and matrix.shape[0] > n_entities + 1:
        matrix = matrix[: n_entities + 1]
        var = None if var is None else var[: n_entities + 1]
    return RandomEffectModel(_tensor(matrix, device), _tensor(var, device), task)


def _load_model_npz(path: str, task, expected: Optional[str], device):
    directory = os.path.dirname(os.path.dirname(os.path.dirname(path)))
    remedy = f"— delete the checkpoint directory {directory or '.'} to start fresh"
    arrays = _read_verified(path, expected, "model file", remedy)
    kind = str(arrays.get("kind"))
    var = arrays.get("variances")
    if kind == "fixed" and "means" in arrays:
        return FixedEffectModel(Coefficients(_tensor(arrays["means"], device), _tensor(var, device)), task)
    if kind == "random" and "matrix" in arrays:
        n_ent = int(arrays["n_entities"]) if "n_entities" in arrays else None
        return _model_from_row_blocks([(0, arrays["matrix"], var)], task, n_ent, device)
    raise CheckpointIntegrityError(
        f"{path}: unknown model kind {kind!r} (corrupted or foreign checkpoint file) {remedy}")


def _load_sharded_model(directory: str, rels: List[str], task, checksums: Mapping[str, str], device):
    """One random effect from its per-shard files: each verified, its
    recorded shard index and count matching its place in state.json's
    list, the blocks reassembled by `_model_from_row_blocks`."""
    remedy = f"— delete the checkpoint directory {directory or '.'} to start fresh"
    n = len(rels)
    blocks = []
    n_entities: Optional[int] = None
    for pos, rel in enumerate(rels):
        path = os.path.join(directory, rel)
        arrays = _read_verified(path, checksums.get(rel), "shard file", remedy)
        if str(arrays.get("kind")) != "random_shard" or "matrix" not in arrays:
            raise CheckpointIntegrityError(
                f"{path}: not a random-effect shard file (kind={arrays.get('kind')!r}) {remedy}")
        if int(arrays["shard_index"]) != pos or int(arrays["n_shards"]) != n:
            raise CheckpointIntegrityError(
                f"{path}: records shard {int(arrays['shard_index'])} of {int(arrays['n_shards'])} "
                f"but state.json lists it as shard {pos} of {n} (mixed checkpoints?) {remedy}")
        if "n_entities" in arrays:
            n_entities = int(arrays["n_entities"])
        blocks.append((int(arrays["row_start"]), arrays["matrix"], arrays.get("variances")))
    return _model_from_row_blocks(blocks, task, n_entities, device)


def _results_to_json(res: EvaluationResults) -> dict:
    return {"primary": str(res.primary), "results": dict(res.results)}


def _results_from_json(doc: Optional[dict]) -> Optional[EvaluationResults]:
    if doc is None:
        return None
    return EvaluationResults(primary=EvaluatorType.parse(doc["primary"]), results=dict(doc["results"]))


@dataclasses.dataclass
class CheckpointState:
    """Host-side mirror of state.json."""

    completed_steps: int  # coordinate updates finished
    seed: int
    models: Dict[str, object]
    best_models: Dict[str, object]
    best_results: Optional[EvaluationResults]
    validation_history: List[Tuple[int, str, EvaluationResults]]


class CoordinateDescentCheckpoint:
    """Reader/writer for one run's checkpoint directory."""

    def __init__(self, directory: str):
        self.directory = directory
        # cid -> relative npz path (str), or the ordered shard-path list of
        # a loaded row-sharded checkpoint, currently representing the coordinate.
        self._model_files: Dict[str, object] = {}
        self._best_files: Dict[str, object] = {}
        # relative npz path -> content checksum, committed with state.json.
        self._checksums: Dict[str, str] = {}

    def exists(self) -> bool:
        return os.path.isfile(os.path.join(self.directory, STATE_FILE))

    def stored_config_key(self) -> Optional[str]:
        """The fingerprint the on-disk state was committed under (None when
        there is no checkpoint, it has no key, or state.json is unreadable)."""
        try:
            with open(os.path.join(self.directory, STATE_FILE)) as f:
                key = json.load(f).get("config_key")
        except (OSError, ValueError):
            return None
        return key if isinstance(key, str) else None

    def clear(self) -> None:
        """Discard the on-disk checkpoint; state.json (the commit point)
        goes first, so a crash mid-clear leaves no state naming deleted steps."""
        try:
            os.remove(os.path.join(self.directory, STATE_FILE))
        except OSError:
            pass
        shutil.rmtree(os.path.join(self.directory, STEPS_DIR), ignore_errors=True)
        self._model_files = {}
        self._best_files = {}
        self._checksums = {}

    def begin_model_write(self, *, completed_steps: int, cid: str, model) -> tuple:
        """Start step `completed_steps`'s write of `cid`'s model on a
        background thread; returns the handle `(steps, cid, rel, future,
        thread)` for `save(staged=...)`, which joins it before the commit.
        The model is not changed once accepted, so the thread reads
        consistent arrays."""
        rel = os.path.join(STEPS_DIR, str(completed_steps), f"{cid}.npz")
        fut: Future = Future()
        handoff = telemetry.span_handoff()

        def run():
            try:
                with telemetry.adopt_span(handoff), telemetry.span(
                        "ckpt_write", step=completed_steps, coordinate=cid):
                    fut.set_result(self._write_model_files(rel, model))
            except BaseException as exc:  # noqa: BLE001 - joined in save()
                fut.set_exception(exc)

        thread = threading.Thread(target=run, daemon=True, name="photon-ckpt-write")
        thread.start()
        return (completed_steps, cid, rel, fut, thread)

    def save(
        self,
        *,
        completed_steps: int,
        seed: int,
        config_key: str,
        models: Dict[str, object],
        trained_cid: Optional[str],
        best_is_current: bool,
        best_results: Optional[EvaluationResults],
        validation_history,
        staged: Optional[tuple] = None,
    ) -> None:
        """Commit one coordinate update. `trained_cid` is the coordinate
        updated this step (None for a rejected update); a coordinate with no
        file yet (a warm start's model at the first save) is written too.
        When `best_is_current`, the best snapshot re-references the current
        files. `staged` is a `begin_model_write` handle: its thread is
        joined first, and its files stand for that coordinate's write; if
        its write failed after its retries, the model is written here
        again, under the same retries."""
        step_rel = os.path.join(STEPS_DIR, str(completed_steps))
        staged_cid = None
        if staged is not None:
            s_steps, s_cid, _, s_fut, s_thread = staged
            s_thread.join()
            if s_steps == completed_steps and s_cid == trained_cid:
                try:
                    s_rel_files, s_checksums = s_fut.result()
                except Exception:
                    logger.warning("background checkpoint write of %r failed; rewriting "
                                   "synchronously", s_cid, exc_info=True)
                    faults.COUNTERS.increment("fallback_sync_ckpt_writes")
                else:
                    self._checksums.update(s_checksums)
                    self._model_files[s_cid] = s_rel_files
                    staged_cid = s_cid
        for cid, model in models.items():
            if cid == staged_cid:
                continue
            if cid == trained_cid or cid not in self._model_files:
                rel_files, checksums = self._write_model_files(
                    os.path.join(step_rel, f"{cid}.npz"), model)
                self._checksums.update(checksums)
                self._model_files[cid] = rel_files
        if best_is_current and best_results is not None:
            self._best_files = dict(self._model_files)
        live = set(_flat_rels(self._model_files.values())) | set(_flat_rels(self._best_files.values()))
        self._checksums = {rel: c for rel, c in self._checksums.items() if rel in live}
        state = {
            "completed_steps": completed_steps,
            "seed": seed,
            "config_key": config_key,
            "model_files": dict(self._model_files),
            "best_files": dict(self._best_files) if best_results is not None else {},
            "checksums": dict(self._checksums),
            "best_results": None if best_results is None else _results_to_json(best_results),
            "validation_history": [[it, cid, _results_to_json(res)]
                                   for it, cid, res in validation_history],
        }
        self._commit(state)

    def _write_model_files(self, rel: str, model):
        """Write one coordinate's model files under `rel`; returns (rel or
        the list of shard paths, {rel: checksum} of the files written). The
        hook `RankCheckpoint` overrides; the step bookkeeping and the commit
        above it are shared."""
        return rel, {rel: _save_model_npz(os.path.join(self.directory, rel), model)}

    def _commit(self, state: dict) -> None:
        """Write state.json, the commit point for the whole step (under the
        bounded retry), then prune unreferenced step directories."""
        data = json.dumps(state, indent=2).encode()
        path = os.path.join(self.directory, STATE_FILE)
        faults.retry(lambda: _atomic_write(path, data), label=f"checkpoint commit {path}")
        self._prune(state)

    def _prune(self, state: dict) -> None:
        """Remove step directories no longer referenced (best effort)."""
        live = {os.path.dirname(rel) for rel in _flat_rels(
            list(state["model_files"].values()) + list(state["best_files"].values()))}
        root = os.path.join(self.directory, STEPS_DIR)
        if not os.path.isdir(root):
            return
        for name in os.listdir(root):
            if os.path.join(STEPS_DIR, name) not in live:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    def load(self, task, *, config_key: Optional[str] = None, device="cpu") -> CheckpointState:
        """The committed state, every model on `device` (a row-sharded one
        reassembled). A checkpoint written on ranks records which rank wrote
        each file: a file of it that state.json names and that is missing
        raises `CheckpointIntegrityError` before any is read, naming that
        rank."""
        with open(os.path.join(self.directory, STATE_FILE)) as f:
            state = json.load(f)
        writers = (state.get("multihost") or {}).get("shard_hosts")
        if writers is not None:
            referenced = set(_flat_rels(state.get("model_files", {}).values())) | set(
                _flat_rels(state.get("best_files", {}).values()))
            missing = sorted(r for r in referenced
                             if not os.path.exists(os.path.join(self.directory, r)))
            if missing:
                named = ", ".join(f"{r} (written by rank {writers[r]})" if r in writers else r
                                  for r in missing)
                raise CheckpointIntegrityError(
                    f"torn checkpoint at {self.directory}: state.json references missing files — "
                    f"{named}. Restore them or delete the checkpoint directory to start fresh.")
        if config_key is not None and state.get("config_key") != config_key:
            raise ValueError(
                f"checkpoint at {self.directory} was written for a different run configuration "
                "— refusing to resume (delete the checkpoint directory to start fresh)")
        self._model_files = dict(state["model_files"])
        self._best_files = dict(state.get("best_files", {}))
        # A state.json without checksums loads unverified; files written
        # from now on gain checksums at the next commit.
        self._checksums = dict(state.get("checksums", {}))
        models = {cid: self._load_one(rel, task, device) for cid, rel in self._model_files.items()}
        best = {cid: self._load_one(rel, task, device) for cid, rel in self._best_files.items()}
        return CheckpointState(
            completed_steps=int(state["completed_steps"]),
            seed=int(state["seed"]),
            models=models,
            best_models=best,
            best_results=_results_from_json(state.get("best_results")),
            validation_history=[(int(it), cid, _results_from_json(res))
                                for it, cid, res in state["validation_history"]],
        )

    def _load_one(self, rel, task, device):
        if isinstance(rel, str):
            return _load_model_npz(os.path.join(self.directory, rel), task,
                                   self._checksums.get(rel), device)
        return _load_sharded_model(self.directory, list(rel), task, self._checksums, device)


class RankCheckpoint(CoordinateDescentCheckpoint):
    """The checkpoint of a fit on ranks (parallel/mesh.py): every rank
    constructs one over the same directory and takes every step of the
    protocol with the others (see the module docstring). A random effect's
    model is this rank's store; it is written as this rank's row block of
    the elastic layout (`RandomEffectCoordinate.row_block`), a fixed effect
    by rank 0 alone. `load` gives the models of all ranks, which the caller
    cuts to each rank's store (`local_model`). `save_timings` holds each
    save's seconds: the row-block exchange, the file writes, and the commit
    (the checksum agreement, which waits for the slowest rank's writes,
    rank 0's state.json, and the receipt vote)."""

    def __init__(self, directory: str, coordinates: Mapping[str, object]):
        super().__init__(directory)
        self.coordinates = coordinates
        self.mesh = next(iter(coordinates.values())).dataset.mesh
        if self.mesh is None:
            raise ValueError("a RankCheckpoint needs coordinates on ranks")
        # rel -> the rank that wrote it (state.json's `multihost.shard_hosts`).
        self._writers: Dict[str, int] = {}
        self._new: List[Tuple[str, int]] = []  # this step's files, every rank's, in order
        self._step_s: Dict[str, float] = {}
        self.save_timings: List[Dict[str, float]] = []
        # More keys of state.json's `multihost` record.
        self.record: Dict[str, object] = {}

    def begin_model_write(self, *, completed_steps: int, cid: str, model) -> tuple:
        """Refused: a rank's write moves its rows to their block's writer in
        a collective, which must run on the main thread in rank order."""
        raise NotImplementedError(
            "the background model write is not available on ranks: the row-block write holds "
            "a collective, which runs on the main thread in rank order")

    def _write_model_files(self, rel: str, model):
        mesh, cid = self.mesh, os.path.basename(rel)[: -len(".npz")]
        if isinstance(model, RandomEffectModel):
            t0 = time.perf_counter()
            k, n, start, matrix, var = self.coordinates[cid].row_block(model)
            self._step_s["exchange_s"] = self._step_s.get("exchange_s", 0.0) + time.perf_counter() - t0
            rels = [f"{rel[: -len('.npz')]}.shard{j}of{n}.npz" for j in range(n)]
            self._new += [(r, j) for j, r in enumerate(rels)]
            t0 = time.perf_counter()
            n_entities = self.coordinates[cid].re_dataset.num_entities
            with telemetry.span("ckpt_write_shard", file=rels[k]):
                ck = _save_row_block(os.path.join(self.directory, rels[k]), k, n, start, matrix,
                                     var, n_entities)
            self._step_s["write_s"] = self._step_s.get("write_s", 0.0) + time.perf_counter() - t0
            return rels, {rels[k]: ck}
        self._new.append((rel, 0))
        if mesh.rank != 0:
            return rel, {}
        t0 = time.perf_counter()
        out = super()._write_model_files(rel, model)
        self._step_s["write_s"] = self._step_s.get("write_s", 0.0) + time.perf_counter() - t0
        return out

    def _agree_checksums(self) -> None:
        """Every rank's checksums of this step's files, on every rank: each
        file's crc32 at its position, contributed by the rank that wrote it
        (exact in float64), in one `owned_to_global`."""
        mesh, new = self.mesh, self._new
        if not new:  # a rejected update writes nothing, on every rank
            return
        mine = [i for i, (_, writer) in enumerate(new) if writer == mesh.rank]
        values = torch.tensor([float(int(self._checksums[new[i][0]].split(":")[1], 16)) for i in mine],
                              dtype=torch.float64)
        crcs = mesh.owned_to_global(values, torch.tensor(mine, dtype=torch.int64), len(new))
        for (rel, writer), crc in zip(new, crcs.cpu().tolist()):
            self._checksums[rel] = f"crc32:{int(crc):08x}"
            self._writers[rel] = writer

    def _commit(self, state: dict) -> None:
        mesh = self.mesh
        t0 = time.perf_counter()
        self._agree_checksums()
        live = set(_flat_rels(state["model_files"].values())) | set(_flat_rels(state["best_files"].values()))
        self._checksums = {r: c for r, c in self._checksums.items() if r in live}
        self._writers = {r: w for r, w in self._writers.items() if r in live}
        state["checksums"] = dict(self._checksums)
        state["multihost"] = {"num_hosts": mesh.world_size, "shard_hosts": dict(self._writers),
                              **self.record}
        error = None
        if mesh.rank == 0:
            try:
                super()._commit(state)
            except Exception as exc:  # every rank learns of it through the vote
                error = exc
        committed = mesh.all_true(error is None)
        self._step_s["commit_s"] = time.perf_counter() - t0
        self.save_timings.append(dict(step=int(state["completed_steps"]), **self._step_s))
        self._new, self._step_s = [], {}
        if error is not None:
            raise error
        if not committed:
            raise RuntimeError(f"rank 0 failed to commit step {state['completed_steps']} of the "
                               f"checkpoint at {self.directory}")

    def clear(self) -> None:
        """Rank 0 discards the on-disk checkpoint once every rank has read
        it, and every rank returns after that."""
        self.mesh.all_true(True)
        if self.mesh.rank == 0:
            super().clear()
        else:
            self._model_files, self._best_files, self._checksums = {}, {}, {}
        self._writers = {}
        self.mesh.all_true(True)

    def load(self, task, *, config_key: Optional[str] = None, device="cpu") -> CheckpointState:
        """The committed state, every model that of all ranks, on `device`."""
        out = super().load(task, config_key=config_key, device=device)
        with open(os.path.join(self.directory, STATE_FILE)) as f:
            writers = (json.load(f).get("multihost") or {}).get("shard_hosts", {})
        self._writers = {r: int(w) for r, w in writers.items()}
        return out


# --------------------------------------------------- delta-fit audit records

DELTA_RECORDS_FILE = "delta_records.jsonl"


def append_delta_record(directory: str, record: Mapping[str, object]) -> str:
    """Append one incremental fit's audit record (its plan and the
    characterized parity, game/incremental.incremental_fit) to the run's
    `delta_records.jsonl`: an atomic rewrite and rename under the
    `checkpoint_write` site, so a crash mid-append leaves the previous file
    whole. The reference's file and keys; `clear()` leaves it. Returns its
    path."""
    path = os.path.join(directory, DELTA_RECORDS_FILE)
    lines = b""
    if os.path.exists(path):
        with open(path, "rb") as f:
            lines = f.read()
    lines += json.dumps(dict(record), sort_keys=True).encode() + b"\n"
    _atomic_write(path, lines)
    return path


def read_delta_records(directory: str) -> List[Dict[str, object]]:
    """The run's incremental-fit audit trail, oldest first ([] before the
    first delta fit)."""
    path = os.path.join(directory, DELTA_RECORDS_FILE)
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        return [json.loads(line) for line in f.read().splitlines() if line]
