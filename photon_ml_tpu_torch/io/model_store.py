"""GAME model persistence in the reference's directory layout.

Port of `photon_ml_tpu/io/model_store.py` (photon-client
ModelProcessingUtils.scala:59-625). The layout is an interchange format:
a directory written by either package loads in the other.

    <dir>/model-metadata.json                      ("modelType" + opt configs)
    <dir>/fixed-effect/<coordinateId>/id-info      (one line: featureShardId)
    <dir>/fixed-effect/<coordinateId>/coefficients/part-00000.avro
         (one BayesianLinearModelAvro record)
    <dir>/random-effect/<coordinateId>/id-info     (lines: randomEffectType, featureShardId)
    <dir>/random-effect/<coordinateId>/coefficients/part-<k>.avro
         (one BayesianLinearModelAvro per entity, modelId = entity id)

Coefficients are (name, term, value) records resolved through the feature
IndexMap in both directions; |value| <= `sparsity_threshold` is dropped,
and variances ride along (non-finite ones written as 0, zeros dropped).

Each kind of file has one route, fixed by its kind: the fixed effect's
single record and the feature summaries go through the Python codec
(io/avro.py); a random effect's part files, one record an entity, are
written by the native columnar writer (native/avro_writer.cc) and read by
the native decoder (native/avro_reader.cc), record for record what the
reference's per-record codec writes and reads, deflate blocks included. A
random effect loads into float32 (E, D) matrices, filled row by row.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap, feature_key
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.native import avro_reader, avro_writer
from photon_ml_tpu_torch.types import TaskType

FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
COEFFICIENTS = "coefficients"
ID_INFO = "id-info"
METADATA_FILE = "model-metadata.json"
MODEL_TYPE = "modelType"
DEFAULT_AVRO_FILE = "part-00000.avro"
# Entity records a random effect's part file holds (the reference's default).
RECORDS_PER_FILE = 100_000

# modelClass strings the reference writes (AvroUtils.convertGLMModelTo...),
# verbatim: they are part of the interchange format.
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION: "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION: "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION: "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}


def _split_key(key: str) -> Tuple[str, str]:
    if DELIMITER in key:
        name, term = key.split(DELIMITER, 1)
        return name, term
    return key, ""


def _coeffs_to_ntv(vector: np.ndarray, index_map: IndexMap, threshold: float) -> List[dict]:
    out = []
    for idx in np.flatnonzero(np.abs(vector) > threshold):
        key = index_map.get_feature_name(int(idx))
        if key is None:
            continue
        name, term = _split_key(key)
        out.append({"name": name, "term": term, "value": float(vector[idx])})
    return out


def _ntv_to_coeffs(records: Sequence[dict], index_map: IndexMap) -> np.ndarray:
    vec = np.zeros(index_map.size, np.float64)
    for r in records:
        idx = index_map.get_index(feature_key(r["name"], r["term"]))
        if idx >= 0:
            vec[idx] = r["value"]
    return vec


def _glm_record(model_id: str, task: Optional[TaskType], means: np.ndarray,
                variances: Optional[np.ndarray], index_map: IndexMap, threshold: float) -> dict:
    rec = {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS.get(task) if task else None,
        "means": _coeffs_to_ntv(means, index_map, threshold),
        "variances": None,
        "lossFunction": None,
    }
    if variances is not None:
        finite = np.where(np.isfinite(variances), variances, 0.0)
        rec["variances"] = _coeffs_to_ntv(finite, index_map, 0.0)
    return rec


def _feature_name_table(index_map: IndexMap, dim: int) -> Tuple[bytes, np.ndarray]:
    """Each index's Avro-encoded (name, term) strings, concatenated, with
    dim + 1 offsets; an index without a name gets an empty range."""
    buf = io.BytesIO()
    enc = avro_io.BinaryEncoder(buf)
    offs = np.zeros(dim + 1, np.int64)
    for j in range(dim):
        key = index_map.get_feature_name(j)
        if key is not None:
            name, term = _split_key(key)
            enc.write_string(name)
            enc.write_string(term)
        offs[j + 1] = buf.tell()
    return buf.getvalue(), offs


@dataclasses.dataclass
class FixedEffectArtifact:
    """Host-side fixed-effect coordinate payload for save/load."""

    feature_shard: str
    means: np.ndarray
    variances: Optional[np.ndarray] = None


@dataclasses.dataclass
class RandomEffectArtifact:
    """Host-side random-effect coordinate payload: one row per entity id."""

    random_effect_type: str
    feature_shard: str
    entity_ids: List[str]
    means: np.ndarray  # (E, D)
    variances: Optional[np.ndarray] = None  # (E, D)


@dataclasses.dataclass
class GameModelArtifact:
    """A GAME model as saved/loaded: coordinate id -> artifact + metadata."""

    task: TaskType
    coordinates: Dict[str, object]  # FixedEffectArtifact | RandomEffectArtifact
    opt_configs: Dict[str, dict] = dataclasses.field(default_factory=dict)


def save_game_model(
    output_dir: str,
    artifact: GameModelArtifact,
    index_maps: Mapping[str, IndexMap],
    *,
    sparsity_threshold: float = 0.0,
) -> None:
    """saveGameModelToHDFS (ModelProcessingUtils.scala:77-141)."""
    avro_writer.require_deflate()
    os.makedirs(output_dir, exist_ok=True)
    _save_metadata(output_dir, artifact)
    for cid, coord in artifact.coordinates.items():
        if isinstance(coord, FixedEffectArtifact):
            cdir = os.path.join(output_dir, FIXED_EFFECT, cid)
            os.makedirs(os.path.join(cdir, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(cdir, ID_INFO), "w") as f:
                f.write(coord.feature_shard + "\n")
            rec = _glm_record(FIXED_EFFECT, artifact.task, coord.means, coord.variances,
                              index_maps[coord.feature_shard], sparsity_threshold)
            avro_io.write_container(os.path.join(cdir, COEFFICIENTS, DEFAULT_AVRO_FILE),
                                    schemas.BAYESIAN_LINEAR_MODEL, [rec])
        elif isinstance(coord, RandomEffectArtifact):
            cdir = os.path.join(output_dir, RANDOM_EFFECT, cid)
            os.makedirs(os.path.join(cdir, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(cdir, ID_INFO), "w") as f:
                f.write(coord.random_effect_type + "\n" + coord.feature_shard + "\n")
            _save_random_effect(os.path.join(cdir, COEFFICIENTS), artifact.task, coord,
                                index_maps[coord.feature_shard], sparsity_threshold)
        else:
            raise TypeError(f"unknown coordinate artifact {type(coord)} for {cid!r}")


def _save_random_effect(out_dir: str, task: Optional[TaskType], coord: RandomEffectArtifact,
                        index_map: IndexMap, threshold: float) -> None:
    """One record an entity, in entity order, split into part files of
    RECORDS_PER_FILE as the reference splits them, by the native columnar
    writer."""
    means = np.asarray(coord.means)
    variances = None if coord.variances is None else np.asarray(coord.variances)
    n = len(coord.entity_ids)
    if means.ndim != 2 or means.shape[0] != n:
        raise ValueError(f"means {means.shape} do not hold one row for each of {n} entities")
    blob, offs = _feature_name_table(index_map, means.shape[1])
    model_class = _MODEL_CLASS.get(task) if task else None
    lo = 0
    for k, size in enumerate(avro_io.part_file_sizes(n, RECORDS_PER_FILE)):
        hi = lo + size
        avro_writer.write_models_columnar(
            avro_io.part_file_path(out_dir, k), means[lo:hi],
            None if variances is None else variances[lo:hi], threshold,
            coord.entity_ids[lo:hi], model_class, blob, offs)
        lo = hi


def load_game_model(models_dir: str, index_maps: Mapping[str, IndexMap]) -> GameModelArtifact:
    """loadGameModelFromHDFS (ModelProcessingUtils.scala:143-265). A fixed
    effect loads as float64 vectors; a random effect as float32 (E, D)
    matrices, one row an entity in part-file order."""
    task = _load_metadata_task(models_dir)
    coords: Dict[str, object] = {}

    fe_dir = os.path.join(models_dir, FIXED_EFFECT)
    if os.path.isdir(fe_dir):
        for cid in sorted(os.listdir(fe_dir)):
            cdir = os.path.join(fe_dir, cid)
            with open(os.path.join(cdir, ID_INFO)) as f:
                shard = f.read().split()[0]
            imap = index_maps[shard]
            _, recs = avro_io.read_container(os.path.join(cdir, COEFFICIENTS, DEFAULT_AVRO_FILE))
            rec = recs[0]
            means = _ntv_to_coeffs(rec["means"], imap)
            variances = _ntv_to_coeffs(rec["variances"], imap) if rec.get("variances") else None
            coords[cid] = FixedEffectArtifact(shard, means, variances)

    re_dir = os.path.join(models_dir, RANDOM_EFFECT)
    if os.path.isdir(re_dir):
        for cid in sorted(os.listdir(re_dir)):
            cdir = os.path.join(re_dir, cid)
            with open(os.path.join(cdir, ID_INFO)) as f:
                lines = f.read().split()
            re_type, shard = lines[0], lines[1]
            coords[cid] = _load_random_effect(os.path.join(cdir, COEFFICIENTS), re_type, shard,
                                              index_maps[shard])

    if not coords:
        raise FileNotFoundError(f"No models could be loaded from: {models_dir}")
    return GameModelArtifact(task=task, coordinates=coords,
                             opt_configs=_load_metadata_opt_configs(models_dir))


_MODEL_BAGS = ("means", "variances")


def _load_random_effect(coef_dir: str, re_type: str, shard: str,
                        index_map: IndexMap) -> RandomEffectArtifact:
    """Each part file decoded column-wise by the native decoder (modelId as
    a tag, means and variances as two feature bags), then scattered into
    its float32 block. A coordinate has variances when every record of
    every part holds a non-empty variances array, as the per-record loader
    decides."""
    entity_ids: List[str] = []
    mean_blocks: List[np.ndarray] = []
    var_blocks: List[Optional[np.ndarray]] = []
    for part in avro_io.list_container_files(coef_dir):
        with open(part, "rb") as f:
            data = f.read()
        schema, codec, sync, body = avro_io.read_header(data, part)
        program = avro_reader.compile_program(
            schema, response="", fallback_label="", offset="", weight="", uid="",
            metadata_map="", bag_names=_MODEL_BAGS, tag_fields=("modelId",))
        if program is None:
            raise ValueError(f"{part}: not a BayesianLinearModelAvro file")
        d = avro_reader.decode_file_native(data, body, codec, sync, program, DELIMITER, path=part)
        n = len(d.labels)
        if n == 0:
            continue  # empty part files (partitions > entities) are inert
        ids = d.tag_ids[:, 0]
        if (ids < 0).any():
            raise ValueError(f"{part}: a record without a modelId")
        entity_ids.extend(np.asarray(d.tag_values, dtype=object)[ids].tolist())
        cols = np.fromiter((index_map.get_index(k) for k in d.keys), np.int64, count=len(d.keys))
        blocks = []
        for b in range(len(_MODEL_BAGS)):
            block = np.zeros((n, index_map.size), np.float32)
            rows = np.repeat(np.arange(n), np.diff(d.bag_indptr[b]))
            c = cols[d.bag_keys[b]] if len(d.bag_keys[b]) else np.zeros(0, np.int64)
            keep = c >= 0
            block[rows[keep], c[keep]] = d.bag_vals[b][keep]
            blocks.append(block)
        mean_blocks.append(blocks[0])
        var_blocks.append(blocks[1] if bool((np.diff(d.bag_indptr[1]) > 0).all()) else None)
    means = np.concatenate(mean_blocks) if mean_blocks else np.zeros((0, index_map.size), np.float32)
    variances = (np.concatenate(var_blocks)
                 if var_blocks and all(v is not None for v in var_blocks) else None)
    return RandomEffectArtifact(re_type, shard, entity_ids, means, variances)


def write_basic_statistics(output_dir: str, stats, index_map: IndexMap) -> int:
    """Feature-shard summary as FeatureSummarizationResultAvro records
    (ModelProcessingUtils.writeBasicStatistics:516-606): one record per
    feature (intercept excluded) with the metrics map {max, min, mean,
    normL1, normL2, numNonzeros, variance}, written to
    `<output_dir>/part-00000.avro` in feature-id order. `stats` is a
    data.stats.FeatureDataStatistics. Returns the record count."""
    host = lambda t: np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t, np.float64)
    cols = {
        "max": host(stats.max),
        "min": host(stats.min),
        "mean": host(stats.mean),
        "normL1": host(stats.norm_l1),
        "normL2": host(stats.norm_l2),
        "numNonzeros": host(stats.num_nonzeros),
        "variance": host(stats.variance),
    }
    skip = stats.intercept_index if stats.intercept_index is not None else -1

    def records():
        for key, idx in sorted(index_map.items(), key=lambda kv: kv[1]):
            if idx == skip:
                continue
            name, term = _split_key(key)
            yield {"featureName": name, "featureTerm": term,
                   "metrics": {m: float(col[idx]) for m, col in cols.items()}}

    os.makedirs(output_dir, exist_ok=True)
    return avro_io.write_container(os.path.join(output_dir, DEFAULT_AVRO_FILE),
                                   schemas.FEATURE_SUMMARIZATION, records())


def _save_metadata(output_dir: str, artifact: GameModelArtifact) -> None:
    """saveGameModelMetadataToHDFS (:489-514) + gameOptConfigToJson (:408-487)."""
    doc = {MODEL_TYPE: artifact.task.value, "optimizationConfigurations": artifact.opt_configs}
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump(doc, f, indent=2)


def _load_metadata_task(models_dir: str) -> TaskType:
    """loadGameModelMetadataFromHDFS (:608+): extract "modelType"."""
    path = os.path.join(models_dir, METADATA_FILE)
    with open(path) as f:
        doc = json.load(f)
    if MODEL_TYPE not in doc:
        raise RuntimeError(f"Couldn't find '{MODEL_TYPE}' in metadata file: {path}")
    return TaskType(doc[MODEL_TYPE])


def _load_metadata_opt_configs(models_dir: str) -> Dict[str, dict]:
    with open(os.path.join(models_dir, METADATA_FILE)) as f:
        return json.load(f).get("optimizationConfigurations", {})
