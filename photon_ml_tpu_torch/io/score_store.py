"""Score persistence: ScoredItem <-> ScoringResultAvro part files.

Port of `photon_ml_tpu/io/score_store.py` (photon-client
ScoreProcessingUtils.scala:29-88, ScoredItem.scala:37; the scoring
driver's saveScoresToHDFS output, GameScoringDriver.scala:229-260).

One writer and one reader. `save_scores` writes the records the
reference's per-record writer writes, deflate blocks and all, with the
native columnar writer (native/avro_writer.cc), part file by part file,
each part's columns moved from the device to the host once.
`load_score_columns` reads them back column-wise with the native block
decoder; `load_scores` makes the reference's ScoredItems of those columns.
Records with a metadataMap (the port writes none) are refused.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.native import avro_reader, avro_writer

# Records a part file holds (the reference's save_scores default).
RECORDS_PER_FILE = 500_000


@dataclasses.dataclass
class ScoredItem:
    """One scored datum (ScoredItem.scala:37)."""

    prediction_score: float
    uid: Optional[str] = None
    label: Optional[float] = None
    weight: Optional[float] = None
    ids: Dict[str, str] = dataclasses.field(default_factory=dict)


def _host(col, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a tensor (on any device) or array-like, on the host."""
    part = col[lo:hi]
    if isinstance(part, torch.Tensor):
        return part.detach().cpu().numpy()
    return np.asarray(part)


def _string_codes(values) -> Tuple[np.ndarray, List[str]]:
    """(codes, table) of a column whose records hold str(value)."""
    table, codes = np.unique(np.asarray(values), return_inverse=True)
    return codes.reshape(-1), [str(v) for v in table.tolist()]


def save_scores(
    output_dir: str,
    scores,
    model_id: str,
    *,
    uids: Optional[Sequence] = None,
    labels=None,
    weights=None,
) -> int:
    """Write scores (a tensor on any device, or an array) as
    ScoringResultAvro part files of RECORDS_PER_FILE records; returns the
    record count. Integer uids are formatted by the writer; other uids are
    written from their distinct values."""
    avro_writer.require_deflate()
    n = len(scores)
    os.makedirs(output_dir, exist_ok=True)
    uid_ints = uid_strings = None
    if uids is not None:
        u = np.asarray(uids)
        if u.dtype.kind in "iu":
            uid_ints = u
        else:
            uid_strings = _string_codes(u)
    lo = 0
    for k, size in enumerate(avro_io.part_file_sizes(n, RECORDS_PER_FILE)):
        hi = lo + size
        avro_writer.write_scores_columnar(
            avro_io.part_file_path(output_dir, k), _host(scores, lo, hi), model_id,
            uid_ints=None if uid_ints is None else uid_ints[lo:hi],
            uid_strings=None if uid_strings is None else (uid_strings[0][lo:hi], uid_strings[1]),
            labels=None if labels is None else _host(labels, lo, hi),
            weights=None if weights is None else _host(weights, lo, hi))
        lo = hi
    return n


@dataclasses.dataclass
class ScoreColumns:
    """ScoringResultAvro records as columns, in file order. Null labels and
    weights read 0.0 with their `has_*` False; a null uid is None."""

    scores: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    has_label: np.ndarray
    has_weight: np.ndarray
    uids: List[Optional[str]]

    def __len__(self) -> int:
        return len(self.scores)


def _same_layout(schema) -> bool:
    fields = schema.get("fields") if isinstance(schema, dict) else None
    return fields is not None and [(f["name"], f["type"]) for f in fields] == [
        (f["name"], f["type"]) for f in schemas.SCORING_RESULT["fields"]]


def load_score_columns(path: str) -> ScoreColumns:
    """Every ScoringResultAvro record under `path` (a part-file directory
    or one file), decoded block by block by the native decoder. A file of
    another schema raises."""
    blocks: List[avro_reader.ScoreBlock] = []
    for part in avro_io.list_container_files(path):
        with open(part, "rb") as f:
            data = f.read()
        schema, codec, sync, pos = avro_io.read_header(data, part)
        if not _same_layout(schema):
            raise ValueError(f"{part}: not a ScoringResultAvro file")
        if codec not in ("null", "deflate"):
            raise ValueError(f"{part}: unsupported codec {codec!r}")
        dec = avro_io.BinaryDecoder(data, pos)
        while dec.remaining > 0:
            start = dec.pos
            count, size = dec.read_long(), dec.read_long()
            if count < 0 or size < 0 or size > dec.remaining:
                raise ValueError(f"{part}: corrupt block at byte {start}")
            block = dec.read_fixed(size)
            if dec.read_fixed(avro_io.SYNC_SIZE) != sync:
                raise ValueError(f"{part}: corrupt block at byte {start} (sync marker mismatch)")
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            blocks.append(avro_reader.decode_scores_block(block, count, part))
    cat = lambda f, dt: np.concatenate([f(b) for b in blocks]) if blocks else np.zeros(0, dt)
    present = cat(lambda b: b.present, np.uint8)
    return ScoreColumns(
        scores=cat(lambda b: b.scores, np.float64), labels=cat(lambda b: b.labels, np.float64),
        weights=cat(lambda b: b.weights, np.float64), has_label=(present & 2) > 0,
        has_weight=(present & 4) > 0, uids=[u for b in blocks for u in b.uids])


def load_scores(path: str) -> List[ScoredItem]:
    """ScoringResultAvro records back as ScoredItems
    (ScoreProcessingUtils.loadScoredItemsFromHDFS)."""
    c = load_score_columns(path)
    return [
        ScoredItem(
            prediction_score=float(c.scores[i]),
            uid=c.uids[i],
            label=float(c.labels[i]) if c.has_label[i] else None,
            weight=float(c.weights[i]) if c.has_weight[i] else None,
        )
        for i in range(len(c))
    ]
