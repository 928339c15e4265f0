"""ctypes bindings for the native columnar Avro writers.

Port of `photon_ml_tpu/native/avro_writer.py`.
`write_training_examples_columnar` writes one null-codec container file
from columnar arrays (labels + CSR feature entries over an interned name
table + optional per-record entity tags) at native speed: the
export/generation counterpart of the block-level native reader.
`write_models_columnar` and `write_scores_columnar` write the model and
score stores' large files (io/model_store.py, io/score_store.py) the same
way, record for record what the reference's per-record writer writes, in
deflate blocks compressed on the host's cores. They need the library built
with zlib (`require_deflate`). There is no Python fallback here.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.native.build import load_native

_CONFIGURED = False


def _lib() -> ctypes.CDLL:
    global _CONFIGURED
    lib = load_native()
    if not _CONFIGURED:
        lib.photon_avro_write_training.restype = ctypes.c_int64
        lib.photon_avro_write_training.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_char_p,  # sync
            ctypes.c_int64,  # n
            ctypes.POINTER(ctypes.c_double),  # labels
            ctypes.POINTER(ctypes.c_double),  # offsets (nullable)
            ctypes.POINTER(ctypes.c_double),  # weights (nullable)
            ctypes.POINTER(ctypes.c_int64),  # indptr
            ctypes.POINTER(ctypes.c_int32),  # name_ids
            ctypes.POINTER(ctypes.c_double),  # values
            ctypes.c_char_p,  # name_bytes
            ctypes.POINTER(ctypes.c_int64),  # name_offs
            ctypes.c_int64,  # n_names
            ctypes.c_char_p,  # tag_key (nullable)
            ctypes.c_char_p,  # tag_bytes (nullable)
            ctypes.POINTER(ctypes.c_int64),  # tag_offs (nullable)
            ctypes.c_int32,  # n_int_tags
            ctypes.c_char_p,  # int_tag_keys (nul-separated, nullable)
            ctypes.POINTER(ctypes.c_int64),  # int_tag_vals (nullable)
            ctypes.c_int64,  # block_records
        ]
        for name, ftype in (("photon_avro_write_models_f32", ctypes.c_float),
                            ("photon_avro_write_models_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_char_p,  # path
                ctypes.c_char_p,  # sync
                ctypes.c_int64,  # n
                ctypes.c_int64,  # d
                ctypes.POINTER(ftype),  # means
                ctypes.POINTER(ftype),  # variances (nullable)
                ctypes.c_double,  # threshold
                ctypes.c_char_p,  # id_bytes
                ctypes.POINTER(ctypes.c_int64),  # id_offs
                ctypes.c_char_p,  # model_class (nullable)
                ctypes.c_char_p,  # feat_blob
                ctypes.POINTER(ctypes.c_int64),  # feat_offs
                ctypes.c_int32,  # threads
            ]
        lib.photon_avro_write_scores.restype = ctypes.c_int64
        lib.photon_avro_write_scores.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_char_p,  # sync
            ctypes.c_int64,  # n
            ctypes.POINTER(ctypes.c_double),  # scores
            ctypes.POINTER(ctypes.c_double),  # labels (nullable)
            ctypes.POINTER(ctypes.c_double),  # weights (nullable)
            ctypes.c_char_p,  # model_id
            ctypes.c_int32,  # uid_kind
            ctypes.POINTER(ctypes.c_int64),  # uid_vals (nullable)
            ctypes.c_char_p,  # uid_tbl_bytes (nullable)
            ctypes.POINTER(ctypes.c_int64),  # uid_tbl_offs (nullable)
            ctypes.c_int32,  # threads
        ]
        lib.photon_avro_has_deflate.restype = ctypes.c_int32
        lib.photon_avro_has_deflate.argtypes = []
        _CONFIGURED = True
    return lib


def require_deflate() -> None:
    """Raise unless the native library writes deflate blocks (built with
    zlib): the model and score stores call this before any work."""
    if not _lib().photon_avro_has_deflate():
        raise ValueError("the model and score stores write deflate containers, and the native "
                         "Avro library was built without zlib (no zlib headers or library on "
                         "this host)")


def _threads() -> int:
    return len(os.sched_getaffinity(0))


def _write_header(path: str, schema, codec: str = "null") -> bytes:
    """Write a container header for `schema` and `codec`; returns the sync
    marker the native writer appends after every block."""
    sync = os.urandom(16)
    with open(path, "wb") as f:
        f.write(avro_io.MAGIC)
        head = avro_io.BinaryEncoder(f)
        meta = {
            "avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode(),
        }
        head.write_long(len(meta))
        for k, v in meta.items():
            head.write_string(k)
            head.write_bytes(v)
        head.write_long(0)
        f.write(sync)
    return sync


def _check(rc: int, path: str) -> None:
    """Never leave a structurally-valid-but-truncated container behind: a
    later reader would silently see only the flushed blocks."""
    if rc < 0:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise OSError(f"native Avro writer failed for {path}")


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pack_strings(strings: Sequence[str]):
    offs = np.zeros(len(strings) + 1, np.int64)
    parts = []
    total = 0
    for i, s in enumerate(strings):
        b = s.encode("utf-8")
        parts.append(b)
        total += len(b)
        offs[i + 1] = total
    return b"".join(parts), offs


def write_training_examples_columnar(
    path: str,
    labels: np.ndarray,
    feature_indptr: np.ndarray,
    feature_name_ids: np.ndarray,
    feature_values: np.ndarray,
    feature_names: Sequence[str],
    *,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    tag_key: Optional[str] = None,
    tag_values: Optional[Sequence[str]] = None,
    int_tags: Optional[dict] = None,
    block_records: int = 4096,
) -> int:
    """Write TrainingExampleAvro records from columnar arrays; returns n.

    `feature_name_ids[e]` indexes `feature_names` (bare names; terms are
    written empty, matching write_training_examples' key handling for
    delimiter-free keys). `tag_values` (with `tag_key`) writes one
    metadataMap entry per record. `int_tags` maps tag key -> per-record
    int64 array; values are formatted as decimal strings inside the native
    writer, so entity-id tags at 10^7-row scale never touch Python string
    handling (the reader's integer TAG branch is the symmetric fast path).
    """
    labels = np.ascontiguousarray(labels, np.float64)
    n = len(labels)
    indptr = np.ascontiguousarray(feature_indptr, np.int64)
    name_ids = np.ascontiguousarray(feature_name_ids, np.int32)
    values = np.ascontiguousarray(feature_values, np.float64)
    if len(indptr) != n + 1:
        raise ValueError("feature_indptr must have n+1 entries")
    if int(indptr[-1]) != len(name_ids) or len(name_ids) != len(values):
        raise ValueError("feature entry arrays disagree with indptr")
    if (tag_key is None) != (tag_values is None):
        raise ValueError("tag_key and tag_values must be passed together")
    int_tag_arrs = {}
    if int_tags:
        for k, v in int_tags.items():
            arr = np.ascontiguousarray(v, np.int64)
            if len(arr) != n:
                raise ValueError(f"int tag {k!r} must have one value per record")
            int_tag_arrs[str(k)] = arr
    # Range-check up front: the native writer would stop mid-file.
    if len(name_ids) and (
        int(name_ids.min()) < 0 or int(name_ids.max()) >= len(feature_names)
    ):
        raise OSError("feature_name_ids out of range for feature_names")
    lib = _lib()

    sync = _write_header(path, schemas.TRAINING_EXAMPLE)
    name_bytes, name_offs = _pack_strings(list(feature_names))
    dptr = ctypes.POINTER(ctypes.c_double)
    off_arr = (
        np.ascontiguousarray(offsets, np.float64) if offsets is not None else None
    )
    wt_arr = (
        np.ascontiguousarray(weights, np.float64) if weights is not None else None
    )
    if tag_key is not None and tag_values is not None:
        tag_bytes, tag_offs = _pack_strings([str(t) for t in tag_values])
        if len(tag_offs) != n + 1:
            raise ValueError("tag_values must have one entry per record")
        tag_key_b = tag_key.encode("utf-8")
        tag_offs_p = tag_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    else:
        tag_bytes, tag_key_b, tag_offs_p = None, None, None
    if int_tag_arrs:
        int_keys_b = b"".join(k.encode("utf-8") + b"\x00" for k in int_tag_arrs)
        int_vals = np.ascontiguousarray(
            np.stack([int_tag_arrs[k] for k in int_tag_arrs]), np.int64
        )
        int_vals_p = int_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        n_int = len(int_tag_arrs)
    else:
        int_keys_b, int_vals_p, n_int = None, None, 0
    rc = lib.photon_avro_write_training(
        path.encode(),
        sync,
        n,
        labels.ctypes.data_as(dptr),
        off_arr.ctypes.data_as(dptr) if off_arr is not None else None,
        wt_arr.ctypes.data_as(dptr) if wt_arr is not None else None,
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        name_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(dptr),
        name_bytes,
        name_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(feature_names),
        tag_key_b,
        tag_bytes,
        tag_offs_p,
        n_int,
        int_keys_b,
        int_vals_p,
        block_records,
    )
    _check(rc, path)
    return n


def write_models_columnar(
    path: str,
    means: np.ndarray,
    variances: Optional[np.ndarray],
    threshold: float,
    model_ids: Sequence[str],
    model_class: Optional[str],
    feature_blob: bytes,
    feature_offs: np.ndarray,
) -> int:
    """Write one BayesianLinearModelAvro record per row of `means` ((n, d),
    float32 or float64; `variances` the same shape or None) as a deflate
    container. `feature_offs` (d + 1) delimits, in `feature_blob`, each
    index's encoded (name, term) pair, empty where the index has no name.
    Returns n."""
    dtype = np.float32 if means.dtype == np.float32 else np.float64
    means = np.ascontiguousarray(means, dtype)
    n, d = means.shape
    if variances is not None:
        variances = np.ascontiguousarray(variances, dtype)
        if variances.shape != means.shape:
            raise ValueError(f"variances {variances.shape} do not match means {means.shape}")
    feature_offs = np.ascontiguousarray(feature_offs, np.int64)
    if len(model_ids) != n or len(feature_offs) != d + 1:
        raise ValueError("model_ids must have one id a row and feature_offs d + 1 entries")
    id_bytes, id_offs = _pack_strings([str(m) for m in model_ids])
    lib = _lib()
    fn = lib.photon_avro_write_models_f32 if dtype == np.float32 else lib.photon_avro_write_models_f64
    ptr = ctypes.POINTER(ctypes.c_float if dtype == np.float32 else ctypes.c_double)
    sync = _write_header(path, schemas.BAYESIAN_LINEAR_MODEL, "deflate")
    rc = fn(path.encode(), sync, n, d, means.ctypes.data_as(ptr),
            None if variances is None else variances.ctypes.data_as(ptr), float(threshold),
            id_bytes, _i64p(id_offs), None if model_class is None else model_class.encode("utf-8"),
            feature_blob, _i64p(feature_offs), _threads())
    _check(rc, path)
    return n


def write_scores_columnar(
    path: str,
    scores: np.ndarray,
    model_id: str,
    *,
    uid_ints: Optional[np.ndarray] = None,
    uid_strings: Optional[Tuple[np.ndarray, Sequence[str]]] = None,
    labels: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
) -> int:
    """Write one ScoringResultAvro record per score, with a null
    metadataMap, as a deflate container. A uid is an integer written in
    decimal (`uid_ints`) or a string given as (codes, table)
    (`uid_strings`), or null when neither is given. Returns n."""
    dptr = ctypes.POINTER(ctypes.c_double)
    scores = np.ascontiguousarray(scores, np.float64)
    n = len(scores)

    def col(a):
        if a is None:
            return None
        a = np.ascontiguousarray(a, np.float64)
        if len(a) != n:
            raise ValueError("every column must have one value a score")
        return a

    labels, weights = col(labels), col(weights)
    uid_kind, uid_vals, uid_tbl, uid_tbl_offs = 0, None, None, None
    if uid_ints is not None:
        uid_kind, uid_vals = 1, np.ascontiguousarray(uid_ints, np.int64)
    elif uid_strings is not None:
        codes, table = uid_strings
        uid_kind, uid_vals = 2, np.ascontiguousarray(codes, np.int64)
        uid_tbl, uid_tbl_offs = _pack_strings(list(table))
        if len(uid_vals) and (uid_vals.min() < 0 or uid_vals.max() >= len(table)):
            raise ValueError("uid codes out of range for their table")
    if uid_vals is not None and len(uid_vals) != n:
        raise ValueError("uids must have one value a score")
    lib = _lib()
    sync = _write_header(path, schemas.SCORING_RESULT, "deflate")
    rc = lib.photon_avro_write_scores(
        path.encode(), sync, n, scores.ctypes.data_as(dptr),
        None if labels is None else labels.ctypes.data_as(dptr),
        None if weights is None else weights.ctypes.data_as(dptr),
        model_id.encode("utf-8"), uid_kind, None if uid_vals is None else _i64p(uid_vals),
        uid_tbl, None if uid_tbl_offs is None else _i64p(uid_tbl_offs), _threads())
    _check(rc, path)
    return n
