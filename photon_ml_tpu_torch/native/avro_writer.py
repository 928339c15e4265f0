"""ctypes binding for the native columnar TrainingExampleAvro writer.

Port of `photon_ml_tpu/native/avro_writer.py`.
`write_training_examples_columnar` writes one null-codec container file
from columnar arrays (labels + CSR feature entries over an interned name
table + optional per-record entity tags) at native speed: the
export/generation counterpart of the block-level native reader. There is no
Python fallback here; the Python record writer is the separate
`io/avro_data.write_training_examples`.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Optional, Sequence

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
        _CONFIGURED = True
    return lib


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

    sync = os.urandom(16)
    with open(path, "wb") as f:
        f.write(avro_io.MAGIC)
        head = avro_io.BinaryEncoder(f)
        meta = {
            "avro.schema": json.dumps(schemas.TRAINING_EXAMPLE).encode(),
            "avro.codec": b"null",
        }
        head.write_long(len(meta))
        for k, v in meta.items():
            head.write_string(k)
            head.write_bytes(v)
        head.write_long(0)
        f.write(sync)

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
    if rc < 0:
        # Never leave a structurally-valid-but-truncated container behind:
        # a later reader would silently see only the flushed blocks.
        try:
            os.unlink(path)
        except OSError:
            pass
        raise OSError(f"native Avro writer failed for {path}")
    return n

