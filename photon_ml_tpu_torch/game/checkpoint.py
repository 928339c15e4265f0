"""Checkpoint-restart of the coordinate-descent outer loop.

The port's own copy of the one-process parts of
`photon_ml_tpu/game/checkpoint.py`, with the same files, keys and commit
protocol, so a checkpoint either package writes resumes in the other.

Durable state after each coordinate update:
  * every coordinate's current model, in the training representation
    (projected and normalized spaces); scores and residuals are recomputed
    from the models on resume, so they are never written;
  * the step cursor, the run's configuration fingerprint (`config_key`; a
    resume under another configuration is refused), the seed (down-sampling
    draws derive from (seed, step), so a resumed run draws the same
    samples), the best-pass snapshot and the validation history.

Write protocol:
  * each step writes one model file, `steps/<step>/<cid>.npz` (only the
    coordinate trained that step, plus any coordinate that has no file
    yet), a single npz blob with the reference's keys;
  * `state.json` maps every coordinate to its current file and is replaced
    atomically last: it is the commit point, so a crash before it leaves the
    previous state naming only whole files;
  * the best-pass snapshot holds file references (the pass-end models are
    the current models), so it writes nothing;
  * step directories no longer referenced are pruned after the commit.

Integrity: every model file's crc32 is recorded in state.json at the commit
and checked on load; a missing, unreadable, torn or foreign file raises
`CheckpointIntegrityError`.

The reader also takes the JAX package's row-sharded random-effect layout
(`<cid>.shard<k>of<n>.npz`, a list of files in state.json, written by a
mesh run), reassembled on the host in row order and cut to the logical
entity count, so such a checkpoint resumes on one card. The writer writes
the single blob only. The fault-injection sites and retry policy, the
background model write and the delta records are not ported here.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import tempfile
import zlib
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation.suite import EvaluationResults, EvaluatorType
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, RandomEffectModel

STATE_FILE = "state.json"
STEPS_DIR = "steps"


class CheckpointIntegrityError(ValueError):
    """A state.json-referenced checkpoint file is missing, torn, or does
    not match its recorded checksum."""


def _checksum(data: bytes) -> str:
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def _atomic_write(path: str, data: bytes) -> None:
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


def _save_model_npz(path: str, model) -> str:
    """Write the model npz atomically; returns its content checksum."""
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
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    _atomic_write(path, data)
    return _checksum(data)


def _flat_rels(values):
    """model_files values are a str (single blob) or a list of shard paths."""
    for v in values:
        if isinstance(v, str):
            yield v
        else:
            yield from v


def _read_verified(path: str, expected: Optional[str], what: str, remedy: str) -> Dict[str, np.ndarray]:
    """One npz read back: present, readable, matching its checksum, and a
    valid npz; anything else is a CheckpointIntegrityError."""
    try:
        with open(path, "rb") as f:
            data = f.read()
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


def _random_effect(matrix, var, task, n_entities: Optional[int], device) -> RandomEffectModel:
    """A random effect cut to its logical rows: a mesh-padded matrix keeps
    its first n_entities + 1 rows (the entities and the pinned zero row)."""
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
        return _random_effect(arrays["matrix"], var, task, n_ent, device)
    raise CheckpointIntegrityError(
        f"{path}: unknown model kind {kind!r} (corrupted or foreign checkpoint file) {remedy}")


def _load_sharded_model(directory: str, rels: List[str], task, checksums: Mapping[str, str], device):
    """One random effect from the JAX package's per-shard files: each
    verified, its recorded shard index and count matching its place in
    state.json's list, the blocks concatenated in row order."""
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
    blocks.sort(key=lambda b: b[0])
    matrix = np.concatenate([m for _, m, _ in blocks], axis=0)
    var = None
    if all(v is not None for _, _, v in blocks):
        var = np.concatenate([v for _, _, v in blocks], axis=0)
    return _random_effect(matrix, var, task, n_entities, device)


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
    ) -> None:
        """Commit one coordinate update. `trained_cid` is the coordinate
        updated this step (None for a rejected update); a coordinate with no
        file yet (a warm start's model at the first save) is written too.
        When `best_is_current`, the best snapshot re-references the current
        files."""
        step_rel = os.path.join(STEPS_DIR, str(completed_steps))
        for cid, model in models.items():
            if cid == trained_cid or cid not in self._model_files:
                rel = os.path.join(step_rel, f"{cid}.npz")
                self._checksums[rel] = _save_model_npz(os.path.join(self.directory, rel), model)
                self._model_files[cid] = rel
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

    def _commit(self, state: dict) -> None:
        """Write state.json, the commit point for the whole step, then prune
        unreferenced step directories."""
        _atomic_write(os.path.join(self.directory, STATE_FILE), json.dumps(state, indent=2).encode())
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
        """The committed state, every model on `device`."""
        with open(os.path.join(self.directory, STATE_FILE)) as f:
            state = json.load(f)
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
