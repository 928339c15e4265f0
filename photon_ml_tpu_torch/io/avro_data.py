"""Avro training data -> the port's GameDataset, and the Python record writer.

Port of `photon_ml_tpu/io/avro_data.py` (single process). Records go
straight to the columnar GameDataset: per feature shard, the union of its
feature bags (keys `name + DELIMITER + term`) plus an optional intercept,
packed to ELL planes; labels, offsets and weights as columns; id tags from
record fields or the metadata map. Index maps are built per shard from the
data, or supplied (then unseen features are dropped).

The route is decided before anything is decoded: when every file's schema
compiles to a native op program, the native decoder reads them
(io/avro_fast.py, `ingest_path` "native" or "native-stream"); otherwise the
Python codec does, in chunks of the planner's `ingest_chunk_rows` records
(PHOTON_STREAM_CHUNK_ROWS, else the plan's, else 262,144: "python").
Both routes read with quarantine, as the reference's ingest does: a corrupt
block costs its rows, is counted in `quarantined_blocks`, and the read goes
on; a file with no good block raises. Nothing falls back to another route.
Every read records its stage times in `dataset.ingest_timing`
(contracts.INGEST_TIMING_REQUIRED_KEYS).
"""

from __future__ import annotations

import dataclasses
import time
from itertools import islice
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from photon_ml_tpu_torch.contracts import INGEST_STAGES
from photon_ml_tpu_torch.data.containers import pack_csr_to_ell
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.data.index_map import DELIMITER, INTERCEPT_KEY, IndexMap, feature_key
from photon_ml_tpu_torch.device import DeviceLike
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import avro_fast, schemas
from photon_ml_tpu_torch.timing import StageTimes
from photon_ml_tpu_torch.utils import telemetry

# InputColumnsNames defaults (photon-api data/InputColumnsNames.scala:65-73).
RESPONSE = "response"
LABEL = "label"
OFFSET = "offset"
WEIGHT = "weight"
UID = "uid"
META_DATA_MAP = "metadataMap"


@dataclasses.dataclass(frozen=True)
class InputColumnNames:
    """Configurable record-field names (InputColumnsNames.scala:65-73)."""

    response: str = RESPONSE
    offset: str = OFFSET
    weight: str = WEIGHT
    uid: str = UID
    metadata_map: str = META_DATA_MAP

    _KEYS = (RESPONSE, OFFSET, WEIGHT, UID, META_DATA_MAP)

    def __post_init__(self):
        # A collision like response='weight' would read labels from the
        # weight field.
        names = [self.response, self.offset, self.weight, self.uid, self.metadata_map]
        if len(set(names)) != len(names):
            raise ValueError(f"input column names must be unique, got {names}")

    @classmethod
    def parse(cls, spec: str) -> "InputColumnNames":
        """Parse "response=the_label,weight=w,..." (unknown keys rejected)."""
        kwargs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            key = key.strip()
            if key not in cls._KEYS or not value:
                raise ValueError(f"input column spec {part!r}: expected default=actual with "
                                 f"default in {cls._KEYS}")
            field = "metadata_map" if key == META_DATA_MAP else key
            if field in kwargs:
                raise ValueError(f"duplicate input column spec for {key!r}")
            kwargs[field] = value.strip()
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class FeatureShardConfig:
    """One feature shard = union of feature bags + optional intercept
    (FeatureShardConfiguration.scala:26)."""

    feature_bags: Tuple[str, ...] = ("features",)
    has_intercept: bool = True


def _record_features(record: dict, bags: Sequence[str]) -> List[Tuple[str, float]]:
    out: List[Tuple[str, float]] = []
    for bag in bags:
        for f in record.get(bag) or ():
            out.append((feature_key(f["name"], f.get("term", "")), float(f["value"])))
    return out


def _balanced_slice(files: List[str], process_index: int, process_count: int) -> List[str]:
    """Process `process_index`'s files of `files`, balanced by bytes over
    `process_count` processes (greedy largest-first onto the lightest
    process, ties by path), as the JAX package's reader splits them. Every
    process computes the same split from the same listing and sizes. Byte
    balance is not row balance."""
    import heapq
    import os

    sizes = [os.path.getsize(f) for f in files]
    order = sorted(range(len(files)), key=lambda i: (-sizes[i], files[i]))
    heap = [(0, p) for p in range(process_count)]
    heapq.heapify(heap)
    mine: List[str] = []
    for i in order:
        load, p = heapq.heappop(heap)
        if p == process_index:
            mine.append(files[i])
        heapq.heappush(heap, (load + sizes[i], p))
    return sorted(mine)


def read_game_dataset(
    path: Union[str, Sequence[str]],
    shard_configs: Mapping[str, FeatureShardConfig],
    *,
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    id_tag_fields: Sequence[str] = (),
    columns: InputColumnNames = InputColumnNames(),
    device: DeviceLike = "cuda",
) -> Tuple[GameDataset, Dict[str, IndexMap]]:
    """Avro file(s) or directories -> (GameDataset on `device`, per-shard
    IndexMaps).

    `path` may be one path or a sequence; records concatenate in the given
    order, the part files of a directory in `list_container_files` order.
    `id_tag_fields` names record fields (or metadata-map keys) to capture as
    id tags. With `index_maps`, unseen features are dropped; otherwise maps
    are built from the data."""
    paths = [path] if isinstance(path, str) else list(path)
    files: List[str] = []
    for p in paths:
        files.extend(avro_io.list_container_files(p))
    if not files:
        raise ValueError(f"no Avro container files under {paths}")

    times = StageTimes()
    t_ingest = time.perf_counter()
    compiled = avro_fast.compile_native(files, shard_configs, id_tag_fields, columns, LABEL)
    if compiled is not None:
        shards, labels, offsets, weights, id_tags, tag_codes, built = avro_fast.read_native(
            compiled, shard_configs, index_maps, id_tag_fields, columns, UID, times)
    else:
        shards, labels, offsets, weights, id_tags, built = _read_python_chunked(
            files, shard_configs, index_maps, id_tag_fields, columns, times)
        tag_codes = {}
    with telemetry.span("upload"):  # the host arrays onto `device`
        ds = GameDataset.build(shards, labels, offsets=offsets, weights=weights, id_tags=id_tags,
                               tag_codes=tag_codes, device=device)
    ds.ingest_timing = ingest_timing(times, time.perf_counter() - t_ingest)
    return ds, built


def ingest_timing(times: StageTimes, total_s: float) -> Dict[str, object]:
    """The INGEST_TIMING_REQUIRED_KEYS dict of one ingest. Synchronous, the
    stages plus `other` tile the ingest wall; streamed, decode is recorded
    where it ran (worker threads), so the stage sum can exceed the wall."""
    timing: Dict[str, object] = {k: times.get(k) for k in INGEST_STAGES}
    timing["other"] = max(0.0, total_s - sum(timing[k] for k in INGEST_STAGES))
    timing["ingest_path"] = times.get_note("ingest_path") or "python"
    timing["streaming"] = times.get_note("streaming") == "1"
    timing["chunks"] = int(times.get_note("chunks") or "1")
    return timing


def distinct_feature_keys(paths: Sequence[str], bags: Sequence[str]) -> Dict[str, set]:
    """The distinct feature keys (`feature_key(name, term)`) of each bag over
    the Avro files under `paths`, for the indexing drivers. The records are
    decoded by the native block decoder where every file's schema compiles
    (the route `read_game_dataset` takes), else by the Python codec."""
    files: List[str] = []
    for p in paths:
        files.extend(avro_io.list_container_files(p))
    bag_list = list(dict.fromkeys(bags))
    compiled = avro_fast.compile_native(
        files, {"keys": FeatureShardConfig(tuple(bag_list), False)}, (), InputColumnNames(), LABEL)
    if compiled is None:
        out: Dict[str, set] = {b: set() for b in bag_list}
        for path in files:
            for _, record in avro_io.iter_container(path):
                for bag in bag_list:
                    for f in record.get(bag) or ():
                        out[bag].add(feature_key(f["name"], f.get("term", "") or ""))
        return out
    asm = avro_fast._IngestAssembler(len(bag_list))
    avro_fast._decode_all(compiled, asm, StageTimes(), quarantine=False)
    bag_gkeys = asm.finalize()[4]
    keys = np.asarray(asm.key_list, dtype=object)
    return {b: set(keys[np.unique(bag_gkeys[i])].tolist()) for i, b in enumerate(bag_list)}


def _read_python_chunked(
    files: Sequence[str],
    shard_configs: Mapping[str, FeatureShardConfig],
    index_maps: Optional[Mapping[str, IndexMap]],
    id_tag_fields: Sequence[str],
    cols: InputColumnNames,
    times: StageTimes,
):
    """The Python codec's route, in chunks of the planned `ingest_chunk_rows`
    records: each chunk decodes, converts to columnar parts, and is freed,
    so decoded records are resident one chunk at a time. Chunk boundaries
    do not change results, so the planner may move them."""
    from photon_ml_tpu_torch import planner

    chunk_rows = int(planner.planned_value("ingest_chunk_rows"))

    def _records():
        # Training ingest is row-shaped: a corrupt block costs its rows
        # (counted in quarantined_blocks), not the file, as on the native
        # route.
        for p in files:
            for _, rec in avro_io.iter_container(p, quarantine=True):
                yield rec

    def _get(rec: dict, field: str, default: float) -> float:
        v = rec.get(field)
        return default if v is None else float(v)

    n = 0
    n_chunks = 0
    labels_p: List[np.ndarray] = []
    offsets_p: List[np.ndarray] = []
    weights_p: List[np.ndarray] = []
    parsed: Dict[str, List[List[Tuple[str, float]]]] = {shard: [] for shard in shard_configs}
    keysets: Dict[str, set] = {shard: set() for shard in shard_configs}
    tag_parts: Dict[str, List[np.ndarray]] = {t: [] for t in id_tag_fields}
    uid_parts: List[np.ndarray] = []
    any_uid = False
    stream = iter(_records())
    while True:
        with times.stage("decode"):
            records = list(islice(stream, chunk_rows))
        if not records:
            break
        n_chunks += 1
        m = len(records)
        with times.stage("assemble"):
            for shard, cfg in shard_configs.items():
                rows = [_record_features(rec, cfg.feature_bags) for rec in records]
                parsed[shard].extend(rows)
                if index_maps is None or shard not in index_maps:
                    ks = keysets[shard]
                    for row in rows:
                        ks.update(k for k, _ in row)
            la = np.empty(m, np.float32)
            of = np.empty(m, np.float32)
            we = np.empty(m, np.float32)
            for i, rec in enumerate(records):
                la[i] = _get(rec, cols.response if cols.response in rec else LABEL, 0.0)
                of[i] = _get(rec, cols.offset, 0.0)
                we[i] = _get(rec, cols.weight, 1.0)
            labels_p.append(la)
            offsets_p.append(of)
            weights_p.append(we)
        with times.stage("tags"):
            for tag in id_tag_fields:
                # Direct record field; "map.key" into a map-typed column;
                # then the metadata map.
                field, _, map_key = tag.partition(".")
                vals = []
                for rec in records:
                    v = rec.get(tag)
                    if v is None and map_key:
                        inner = rec.get(field)
                        if isinstance(inner, dict):
                            v = inner.get(map_key)
                    if v is None:
                        v = (rec.get(cols.metadata_map) or {}).get(tag, "")
                    vals.append(str(v))
                tag_parts[tag].append(np.asarray(vals))
            uids = [rec.get(cols.uid) for rec in records]
            any_uid = any_uid or any(u is not None for u in uids)
            uid_parts.append(np.asarray([str(u) if u is not None else "" for u in uids]))
        n += m
        del records
    if n == 0:
        raise ValueError(f"no records found in {list(files)}")
    times.note("ingest_path", "python")
    times.note("chunks", str(n_chunks))
    times.note("streaming", "0")

    concat = avro_fast.concat_parts
    labels = concat(labels_p, np.float32)
    offsets = concat(offsets_p, np.float32)
    weights = concat(weights_p, np.float32)
    id_tags: Dict[str, np.ndarray] = {tag: concat(tag_parts[tag], object) for tag in id_tag_fields}
    if any_uid:
        id_tags[UID] = concat(uid_parts, object)

    built: Dict[str, IndexMap] = {}
    for shard, cfg in shard_configs.items():
        if index_maps is not None and shard in index_maps:
            built[shard] = index_maps[shard]
        else:
            built[shard] = IndexMap.from_feature_names(keysets[shard], add_intercept=cfg.has_intercept)

    shards = {}
    for shard, cfg in shard_configs.items():
        imap = built[shard]
        intercept_idx = imap.intercept_index
        if cfg.has_intercept and intercept_idx is None:
            raise ValueError(
                f"feature shard '{shard}' is configured with an intercept but the index map "
                "has no intercept entry; rebuild it with the intercept key or set "
                "has_intercept=False")
        indptr = np.zeros(n + 1, np.int64)
        idx_buf: List[int] = []
        val_buf: List[float] = []
        with times.stage("assemble"):
            for i, row in enumerate(parsed[shard]):
                for key, value in row:
                    j = imap.get_index(key)
                    if j >= 0:
                        idx_buf.append(j)
                        val_buf.append(value)
                if cfg.has_intercept:
                    idx_buf.append(intercept_idx)
                    val_buf.append(1.0)
                indptr[i + 1] = len(idx_buf)
        with times.stage("ell"):
            shards[shard] = pack_csr_to_ell(indptr, np.asarray(idx_buf, np.int64),
                                            np.asarray(val_buf, np.float32), imap.size)
    return shards, labels, offsets, weights, id_tags, built


def write_training_examples(
    path: str,
    features: Sequence[Sequence[Tuple[str, float]]],
    labels: Sequence[float],
    *,
    offsets: Optional[Sequence[float]] = None,
    weights: Optional[Sequence[float]] = None,
    uids: Optional[Sequence[str]] = None,
    id_tags: Optional[Mapping[str, Sequence]] = None,
    codec: str = "deflate",
) -> int:
    """AvroDataWriter equivalent: write TrainingExampleAvro records with the
    Python codec. `features[i]` is a list of (feature_key, value); keys are
    split back into (name, term) on DELIMITER, and the intercept key is
    left out (it is appended at read time)."""

    def records():
        for i, label in enumerate(labels):
            feats = []
            for key, value in features[i]:
                if key == INTERCEPT_KEY:
                    continue
                name, _, term = key.partition(DELIMITER)
                feats.append({"name": name, "term": term, "value": float(value)})
            meta = None
            if id_tags:
                meta = {k: str(v[i]) for k, v in id_tags.items()}
            yield {
                "uid": None if uids is None else str(uids[i]),
                "label": float(label),
                "features": feats,
                "weight": 1.0 if weights is None else float(weights[i]),
                "offset": 0.0 if offsets is None else float(offsets[i]),
                "metadataMap": meta,
            }

    return avro_io.write_container(path, schemas.TRAINING_EXAMPLE, records(), codec=codec)
